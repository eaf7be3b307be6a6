"""The attention core's shortened key walk against the full walk, on one GPU.

Each tile kernel stops its key walk at its batch element's last live key
(csrc/attention.cuh::live_extent): a key is dead where its key-padding bias
is -1e9 or below. A bias of -9.9e8 leaves a masked key live to the kernels
and its probability exactly 0 all the same, so it forces the full walk on
the same inputs. ``check`` runs the six kernels (bf16 and f32: forward, dq,
dk/dv) both ways and requires every output bitwise equal. A row with no
live key walks in full either way and keeps its bias in both runs: each of
its logits rounds to the bias itself, whose value then moves the rounding
of the row's exp arguments (bf16: x log2 e - m log2 e), so -9.9e8 would
give it other probabilities. Its walk shows in the counts.

- bf16 and f32 operands, head dims 128 (bf16: the resident forward) and 192
  (the two-pass forward, the backward's column chunks), S = 197, B = 9,
  H = 4, dropout off and in-kernel at rate 0.1; the forward's out, and the
  backward's dq, dk, dv and recomputed out;
- the key-padding rows: live prefixes of 1, 40, 63, 64, 65, 128 and 196
  keys (the 65 row's dead keys at -inf), one row whose live keys lie on
  both sides of a dead 64-key tile, and one row with no live key.

It also counts the score tiles the kernels walked while a profiler records
(``ops.attention_key_tiles``) against what the rows' extents give. With
``--time``, it then times the forward and the backward at MDM's shapes
(S = 197, 4 heads of 128; sampling B = 256, bf16 training B = 512, f32
training B = 64) on lengths drawn from 40-196 as the benchmark's traffic
draws them, shortened walk against full walk in turns (CUDA events).

    python -m mdm_tpu_torch.scripts.key_walk_check [--time]
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from ..ops import _chain as C
from ..ops._mask import row_bias_contrib

S, H, RATE, SEED = 197, 4, 0.1, 20261018
LIVE = (1, 40, 63, 64, 65, 128, 196)  # live prefixes; 65's dead keys carry -inf
FULL_WALK = -9.9e8  # a masked key's bias that the kernels count as live


def key_rows(device) -> torch.Tensor:
    """f32 [9, S] key-padding rows: the LIVE prefixes, a live-dead-live row
    (keys 0-63 and 128-159 live) and a row with no live key."""
    dead = torch.ones(len(LIVE) + 2, S, dtype=torch.bool)
    for b, n in enumerate(LIVE):
        dead[b, :n] = False
    dead[len(LIVE), :64] = dead[len(LIVE), 128:160] = False
    rows = row_bias_contrib(dead)
    rows[LIVE.index(65), 65:] = -math.inf
    return rows.to(device)


def full_walk(rows: torch.Tensor) -> torch.Tensor:
    """The rows with every dead key at FULL_WALK, but a row with no live
    key, which walks in full as it is."""
    dead = rows <= -1e9
    dead &= ~dead.all(dim=-1, keepdim=True)
    return torch.where(dead, torch.full_like(rows, FULL_WALK), rows)


def extents(rows: torch.Tensor) -> list:
    """One past each row's last live key; S for a row with no live key."""
    out = []
    for row in rows.cpu():
        live = torch.nonzero(~(row <= -1e9)).flatten()
        out.append(int(live[-1]) + 1 if len(live) else row.numel())
    return out


def expected_tiles(ext: list, dtype: torch.dtype, dh: int, backward: bool) -> tuple:
    """(walked, full) score tiles of one call at these extents: the bf16
    kernels' 64-key tiles and the f32 ones' 32-key stream tiles, over each
    block of each head (the backward's forward recomputes the out)."""
    pdh = C.padded_head_dim(dh)
    blocks = -(-S // 64)  # 64-row query tiles (forward, dq), 64-key blocks (dk/dv)
    tile = 64 if dtype == torch.bfloat16 else 32
    per_walk = -(-S // tile)
    if dtype == torch.bfloat16:
        dq_chunks = kv_chunks = 1 if pdh <= 128 else (pdh // 64 if pdh % 128 else pdh // 128)
    else:
        dq_chunks, kv_chunks = 1, 1 if pdh <= 128 else 2
    walked = full = 0
    for e in ext:
        row_walk = -(-e // tile)
        walked += blocks * row_walk
        full += blocks * per_walk
        if backward:
            walked += blocks * dq_chunks * row_walk
            full += blocks * dq_chunks * per_walk
            walked += kv_chunks * sum(per_walk for kb in range(blocks) if 64 * kb < e)
            full += kv_chunks * blocks * per_walk
    return H * walked, H * full


def _operands(dtype, dh, B, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, H, S, dh, generator=g).to(dtype).to(device) for _ in range(4)]


def _forward(q, k, v, rows, rate, dh, got=None):
    """[out] of the forward; into ``got`` where given, else NaN-filled new tensors."""
    B = q.shape[0]
    out = torch.full_like(q, float("nan")) if got is None else got[0]
    view = C.bhsd_view(H, S, dh)
    C.attention_fwd(q, k, v, view, out, view, B, S, H, dh, rows, C.row_bias_strides(S),
                    C.dropout_args(None, SEED, rate))
    return [out]


def _backward(q, k, v, do, rows, rate, dh, got=None):
    """[dq, dk, dv, the recomputed out] of the backward, as ``_forward``."""
    B = q.shape[0]
    got = [torch.full_like(q, float("nan")) for _ in range(4)] if got is None else got
    view = C.bhsd_view(H, S, dh)
    C.attention_bwd(q, k, v, view, do, view, *got[:3], B, S, H, dh, rows, C.row_bias_strides(S),
                    C.dropout_args(None, SEED, rate), got[3])
    return got


def check(device="cuda") -> dict:
    """Every case bitwise equal to the full walk and every count as the
    extents give; raises AssertionError otherwise. Returns the cases run and
    the share of score tiles walked."""
    from ..ops import attention_key_tiles

    rows = key_rows(device)
    forced = full_walk(rows)
    ext = extents(rows)
    cases, walked_all, full_all = 0, 0, 0
    attention_key_tiles()
    for dtype in (torch.bfloat16, torch.float32):
        for dh in (128, 192):
            q, k, v, do = _operands(dtype, dh, rows.shape[0], device)
            for rate in (0.0, RATE):
                for name, run, names in (
                        ("forward", lambda r: _forward(q, k, v, r, rate, dh), ("out",)),
                        ("backward", lambda r: _backward(q, k, v, do, r, rate, dh),
                         ("dq", "dk", "dv", "out"))):
                    what = f"{name} {str(dtype).split('.')[-1]} Dh={dh} rate={rate}"
                    want = run(forced)
                    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                        got = run(rows)
                        torch.cuda.synchronize()
                    counted = attention_key_tiles()
                    for n, a, b in zip(names, got, want):
                        if not torch.equal(a, b):
                            bad = (a != b).nonzero()[:4].tolist()
                            raise AssertionError(f"{what}: {n} differs from the full walk at "
                                                 f"{bad}")
                    expect = expected_tiles(ext, dtype, dh, name == "backward")
                    if counted != expect:
                        raise AssertionError(f"{what}: counted {counted} score tiles (walked, "
                                             f"full), the extents give {expect}")
                    walked_all, full_all = walked_all + counted[0], full_all + counted[1]
                    cases += 1
    if attention_key_tiles() != (0, 0):
        raise AssertionError("launches outside a profiler were counted")
    return dict(cases=cases, extents=ext, walked_share=walked_all / full_all)


def _ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def traffic_rows(B, device, seed=1) -> torch.Tensor:
    """MDM's key-padding rows: the condition token and 40-196 live frames
    (uniform, as the benchmark's traffic draws them), the rest masked."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(40, 197, (B,), generator=g)
    dead = torch.arange(S)[None, :] > lengths[:, None]
    return row_bias_contrib(dead).to(device)


def time_shapes(device="cuda") -> list:
    """ms of the shortened and the full walk at MDM's shapes, in turns
    (full, short, short, full), and the share of score tiles walked."""
    out = []
    for what, dtype, B, backward in (("sampling forward bf16", torch.bfloat16, 256, False),
                                     ("training forward bf16", torch.bfloat16, 512, False),
                                     ("training backward bf16", torch.bfloat16, 512, True),
                                     ("training forward f32", torch.float32, 64, False),
                                     ("training backward f32", torch.float32, 64, True)):
        q, k, v, do = _operands(dtype, 128, B, device)
        rows = traffic_rows(B, device)
        rate = RATE if "training" in what else 0.0
        got = [torch.empty_like(q) for _ in range(4)]
        run = ((lambda r: _backward(q, k, v, do, r, rate, 128, got)) if backward
               else (lambda r: _forward(q, k, v, r, rate, 128, got)))
        forced = full_walk(rows)
        f1, s1, s2, f2 = (_ms(lambda r=r: run(r)) for r in (forced, rows, rows, forced))
        walked, full = expected_tiles(extents(rows), dtype, 128, backward)
        row = dict(what=what, B=B, short_ms=(s1 + s2) / 2, full_ms=(f1 + f2) / 2,
                   walked_share=walked / full)
        row["gain"] = row["full_ms"] / row["short_ms"] - 1
        out.append(row)
        print("key walk", json.dumps(row), flush=True)
    return out


def main(argv=None) -> None:
    from ._card import card_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true", help="also time MDM's shapes")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    print("key walk check", json.dumps(check()), flush=True)
    if args.time:
        time_shapes()


if __name__ == "__main__":
    main()
