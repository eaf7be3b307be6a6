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
``--f32`` measures the f32 core instead (csrc/attention_f32.cu, f32
operands) at the tile instances' head dims of HEADS_F32, after the plan
its kernels hold (stages, shared bytes, blocks per SM), and splits one
Dh=128 backward with ctx by kernel; its bounds count each f32 FLOP as
three TF32 passes at 495 TFLOP/s (``fma_ms``: at the 67 of f32 FMA).
``--f32-wide`` times the f32 wide instance (the row kernels of
csrc/attention.cu, head dims above 256) at WIDE_F32 with a key-padding
row and no dropout, forward and backward, beside the plain version in
PyTorch and ``F.scaled_dot_product_attention`` (f32, TF32 off), and their
bounds; it calls only entry points that predate the f32 tile kernels, so
that it times an older checkout's the same way.

    python -m mdm_tpu_torch.scripts.attention_backward_probe [--edges | --f32 | --f32-wide]
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
# f32: the tile kernels' head dims (above 256 the row kernels, one block a
# query row, take seconds a call at this shape).
HEADS_F32 = ((128, 4), (96, 4), (192, 4), (256, 4), (4, 32))
KERNELS_F32 = ("attn_bwd_dq_f32_tiled", "attn_bwd_dkv_f32_tiled", "attn_fwd_f32_tiled")
# f32 above 256: d_model 1024 in 2 heads of 512 and 1 of 1024, at B, S.
WIDE_F32 = ((512, 2), (1024, 1))
HBM, TF32, F32_FMA = 3.35e12, 495e12, 67e12  # H100 SXM: bytes/s, FLOP/s


def _ms(fn, iters: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _operands(dh: int, heads: int = H, dtype=torch.bfloat16):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D = heads * dh
    q, k, v, do = (torch.randn(B, S, D, generator=g, device=dev).to(dtype) for _ in range(4))
    mask = torch.zeros(B, S, device=dev)
    mask[::3, S - 40:] = -1e9
    return q, k, v, do, mask, C.bsd_view(S, D, dh)


def measure(dtype=torch.bfloat16) -> dict:
    """ms of the backward core per head dim of HEADS (HEADS_F32 in f32),
    with and without ctx, and at Dh=128 without dropout or mask; the
    forward beside it."""
    times = {}
    for dh, heads in HEADS if dtype == torch.bfloat16 else HEADS_F32:
        q, k, v, do, mask, view = _operands(dh, heads, dtype)
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


def _bound(nbytes: float, flops: float, peak: float) -> dict:
    t_bytes, t_ops = nbytes / HBM, flops / peak
    return dict(ms=max(t_bytes, t_ops) * 1e3, by="bytes" if t_bytes >= t_ops else "operations")


def bounds(dtype=torch.bfloat16) -> dict:
    """The least ms of each backward of HEADS (HEADS_F32) at its shape: the
    larger of its bytes (q, k, v, dO and the mask read, dq, dk, dv written,
    once) over 3.35 TB/s and its products' FLOPs (8 B S^2 D) over 989
    TFLOP/s bf16, the H100 SXM's HBM rate and peak; in f32 three times the
    FLOPs over the TF32 peak (``fma_ms``: once over f32 FMA's)."""
    out = {}
    size = 2 if dtype == torch.bfloat16 else 4
    for dh, heads in HEADS if dtype == torch.bfloat16 else HEADS_F32:
        D = heads * dh
        nbytes, flops = 7 * B * S * D * size + B * S * 4, 8 * B * S * S * D
        row = (_bound(nbytes, flops, 989e12) if dtype == torch.bfloat16 else
               dict(_bound(nbytes, 3 * flops, TF32), fma_ms=_bound(nbytes, flops, F32_FMA)["ms"]))
        out[f"Dh={dh}" if heads == H else f"Dh={dh} H={heads}"] = row
    return out


def measure_wide_f32(batch: int = B, iters: int = 5) -> dict:
    """The f32 wide instance at WIDE_F32 ([batch, S, d_model] f32, a
    key-padding row, no dropout): forward and backward ms (CUDA events,
    mean of ``iters`` calls after 2 warm), the plain version's (softmax of
    the scaled logits plus the mask, then the product with v, and its
    autograd backward) and ``F.scaled_dot_product_attention``'s, TF32 off;
    each with its bound as in ``bounds`` (the forward: q, k, v, the mask
    read, out written; 4 B S^2 D FLOPs)."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    t = lambda fn: _ms(fn, iters, warm=2)
    for dh, heads in WIDE_F32:
        q, k, v, do, mask, view = _operands(dh, heads, torch.float32)
        Bw = batch
        q, k, v, do, mask = (x[:Bw].contiguous() for x in (q, k, v, do, mask))
        D = heads * dh
        res, grads = torch.empty_like(q), [torch.empty_like(q) for _ in range(3)]
        drop, strides = C.dropout_args(None, 0, 0.0), C.row_bias_strides(S)
        heads_of = lambda x: x.view(Bw, S, heads, dh).transpose(1, 2)
        bias = mask[:, None, None, :]

        def plain(q, k, v):
            logits = heads_of(q) @ heads_of(k).transpose(-1, -2) * dh ** -0.5 + bias
            return torch.softmax(logits, dim=-1) @ heads_of(v)

        library = lambda q, k, v: F.scaled_dot_product_attention(
            heads_of(q), heads_of(k), heads_of(v), attn_mask=bias)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        dh_out = heads_of(do)
        p_out, l_out = plain(*leaves), library(*leaves)
        fwd_bytes, bwd_bytes = 4 * 4 * Bw * S * D + 4 * Bw * S, 7 * 4 * Bw * S * D + 4 * Bw * S
        flops = 4 * Bw * S * S * D
        with torch.no_grad():
            row = dict(
                fwd_ms=t(lambda: C.attention_fwd(q, k, v, view, res, view, Bw, S, heads, dh,
                                                 mask, strides, drop)),
                bwd_ms=t(lambda: C.attention_bwd(q, k, v, view, do, view, *grads, Bw, S,
                                                 heads, dh, mask, strides, drop)),
                plain_fwd_ms=t(lambda: plain(q, k, v)), library_fwd_ms=t(lambda: library(q, k, v)))
        row.update(
            plain_bwd_ms=t(lambda: torch.autograd.grad(p_out, leaves, dh_out, retain_graph=True)),
            library_bwd_ms=t(lambda: torch.autograd.grad(l_out, leaves, dh_out,
                                                         retain_graph=True)),
            bound_fwd=_bound(fwd_bytes, 3 * flops, TF32),
            bound_bwd=_bound(bwd_bytes, 6 * flops, TF32),
            fma_bound_ms=dict(fwd=_bound(fwd_bytes, flops, F32_FMA)["ms"],
                              bwd=_bound(bwd_bytes, 2 * flops, F32_FMA)["ms"]))
        out[f"B={Bw} S={S} Dh={dh} H={heads}"] = row
    return out


def kernel_split(dtype=torch.bfloat16, rate: float = 0.1) -> dict:
    """Device ms per kernel of one Dh=128 backward with ctx (dropout at
    rate, mask) under torch.profiler, averaged over 10 calls."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do, mask, view = _operands(128, H, dtype)
    grads = [torch.empty_like(q) for _ in range(3)]
    ctx = torch.empty_like(q)
    run = lambda: C.attention_bwd(q, k, v, view, do, view, *grads, B, S, H, 128, mask,
                                  C.row_bias_strides(S), C.dropout_args(None, 5, rate), ctx)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for kernel in KERNELS if dtype == torch.bfloat16 else KERNELS_F32:
            if kernel in e.key:
                split[kernel] = split.get(kernel, 0.0) + e.self_device_time_total / 1e3 / 10
    return split


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--edges", action="store_true",
                      help="first run chip_smoke.py's backward and forward edge phases")
    mode.add_argument("--f32", action="store_true", help="the f32 core instead")
    mode.add_argument("--f32-wide", action="store_true",
                      help="the f32 row kernels above head dim 256 instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_backward_probe: no CUDA device is visible")
    print(card_line())
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log").read_text()
    if args.f32_wide:
        print(json.dumps({"f32_wide": measure_wide_f32()}))
        return
    if args.f32:
        f32 = torch.float32
        print(json.dumps({"ptxas": {k: _build.ptxas_report(log, k) for k in KERNELS_F32},
                          "plan": {dh: C.attention_f32_plan_on_card(dh) for dh, _ in HEADS_F32}}))
        print(json.dumps({"ms": measure(f32), "bound_ms": bounds(f32),
                          "device_ms_per_kernel_dh128_ctx": kernel_split(f32),
                          "device_ms_per_kernel_dh128_ctx_no_dropout": kernel_split(f32, 0.0)}))
        return
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
