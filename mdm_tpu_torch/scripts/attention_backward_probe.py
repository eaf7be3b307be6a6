"""The attention backward core (csrc/attention_bwd.cu, and attention_wide.cu
above head dim 256) alone on one GPU.

Prints the card, the build's time, then one JSON line: each backward
instance's registers and spill bytes (the build's ptxas report), the dq
and dk/dv kernels' resident blocks per SM for each bias form, and the
backward's time at the flagship training shape (B=128, S=197, H=4,
[B, S, H*Dh] bf16 operands, a key-padding row, in-kernel dropout at rate
0.1: kernel #8's core) at head dims 128, 96 and 256, and at 32 heads of 4
and of 12, 2 heads of 512 and 1 of 1024 (HEADS), with and without the recomputed out
(#3's ctx), and at Dh=128 without dropout and without the mask; the
forward beside each, and each backward's bound. CUDA events, mean of 20
calls after 3 warm; then the device time of each kernel of one Dh=128
backward with ctx under torch.profiler.
``--edges`` first runs chip_smoke.py's backward and forward edge phases.

    python -m mdm_tpu_torch.scripts.attention_backward_probe [--edges]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..ops import _build
from ..ops import _chain as C
from ._card import card_line

KERNELS = ("attn_bwd_dq_bf16", "attn_bwd_dkv_bf16", "attn_fwd_bf16", "attn_bwd_dq_wide",
           "attn_bwd_dkv_wide", "attn_fwd_wide")
B, S, H = 128, 197, 4
# (head dim, heads) measured: the flagship's 4 heads of 128, 96 and 256 (a
# padded and the widest tile instance), and the d_model % 128 == 0
# configurations past them: 32 heads of 4 and of 12 at d_model 128 and
# 384 (2-byte row copies), 2 heads of 512 and 1 of 1024 at d_model 1024
# (the wide kernels).
HEADS = ((128, 4), (96, 4), (256, 4), (4, 32), (12, 32), (512, 2), (1024, 1))


def _ms(fn, iters: int = 20) -> float:
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


def _operands(dh: int, heads: int = H):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D = heads * dh
    q, k, v, do = (torch.randn(B, S, D, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    mask = torch.zeros(B, S, device=dev)
    mask[::3, S - 40:] = -1e9
    return q, k, v, do, mask, C.bsd_view(S, D, dh)


def measure() -> dict:
    """ms of the backward core per head dim of HEADS, with and without ctx,
    and at Dh=128 without dropout or mask; the forward beside it."""
    times = {}
    for dh, heads in HEADS:
        q, k, v, do, mask, view = _operands(dh, heads)
        name = f"Dh={dh}" if heads == H else f"Dh={dh} H={heads}"
        grads = [torch.empty_like(q) for _ in range(3)]
        ctx = torch.empty_like(q)
        cases = [("", mask, C.dropout_args(None, 5, 0.1), None),
                 (" + ctx", mask, C.dropout_args(None, 5, 0.1), ctx)]
        if dh == 128:
            cases += [(" no dropout", mask, C.dropout_args(None, 0, 0.0), None),
                      (" no dropout, no mask", None, C.dropout_args(None, 0, 0.0), None)]
        for case, m, drop, c in cases:
            strides = C.row_bias_strides(S) if m is not None else (0, 0, 0)
            times[f"{name}{case}"] = _ms(lambda: C.attention_bwd(
                q, k, v, view, do, view, *grads, B, S, heads, dh, m, strides, drop, c))
        out = torch.empty(q.shape, device=q.device)
        times[f"{name} forward f32 out"] = _ms(lambda: C.attention_fwd(
            q, k, v, view, out, view, B, S, heads, dh, mask, C.row_bias_strides(S),
            C.dropout_args(None, 5, 0.1)))
    return times


def bounds() -> dict:
    """The least ms of each backward of HEADS at its shape: the larger of
    its bytes (q, k, v, dO and the mask read, dq, dk, dv written, once)
    over 3.35 TB/s and its products' FLOPs (8 B S^2 D) over 989 TFLOP/s
    bf16, the H100 SXM's HBM rate and dense peak."""
    out = {}
    for dh, heads in HEADS:
        D = heads * dh
        t_bytes = (7 * B * S * D * 2 + B * S * 4) / 3.35e12
        t_ops = 8 * B * S * S * D / 989e12
        out[f"Dh={dh}" if heads == H else f"Dh={dh} H={heads}"] = dict(
            ms=max(t_bytes, t_ops) * 1e3, by="bytes" if t_bytes >= t_ops else "operations")
    return out


def kernel_split() -> dict:
    """Device ms per kernel of one Dh=128 backward with ctx (dropout, mask)
    under torch.profiler, averaged over 10 calls."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do, mask, view = _operands(128)
    grads = [torch.empty_like(q) for _ in range(3)]
    ctx = torch.empty_like(q)
    run = lambda: C.attention_bwd(q, k, v, view, do, view, *grads, B, S, H, 128, mask,
                                  C.row_bias_strides(S), C.dropout_args(None, 5, 0.1), ctx)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for kernel in KERNELS:
            if kernel in e.key:
                split[kernel] = split.get(kernel, 0.0) + e.self_device_time_total / 1e3 / 10
    return split


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--edges", action="store_true",
                        help="first run chip_smoke.py's backward and forward edge phases")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_backward_probe: no CUDA device is visible")
    print(card_line())
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log").read_text()
    report = {k: _build.ptxas_report(log, k) for k in KERNELS}
    occupancy = {f"Dh={dh} bias={form} {kern}": C.attention_bwd_occupancy(dh, form, kern)
                 for dh in C.HEAD_DIMS for form in (0, 1, 2) for kern in C.BWD_KERNELS}
    print(json.dumps({"ptxas": report, "blocks_per_sm": occupancy}))
    if args.edges:
        sys.path.insert(0, os.getcwd())
        import chip_smoke

        torch.backends.cuda.matmul.allow_tf32 = False
        chip_smoke.phase_backward_edges(torch, torch.device("cuda"))
        chip_smoke.phase_forward_edges(torch, torch.device("cuda"))
    print(json.dumps({"ms": measure(), "bound_ms": bounds(),
                      "device_ms_per_kernel_dh128_ctx": kernel_split()}))


if __name__ == "__main__":
    main()
