"""The wgmma product kernel (csrc/gemm_sm90.cu) alone on one GPU.

Prints the card, then one JSON line: each kernel instance's registers and
spill bytes (the build's ptxas report) and resident blocks per SM, and for
each product of the main paths (the sampling layer at the CFG batch, M = 64
x 197, and the training layer, M = 128 x 197, at the flagship widths) its
time, FLOPs, bound, fraction of the bf16 peak, error against the plain
product and ``torch.matmul``'s time for the same product (timed only); then
the whole sampling layer (#1, ops/layer_inference.py) at B = 64 and 2. Each
time twice: ``ms``, CUDA events over 50 calls issued back to back after 3
warm (the card's time, or the host's where it issues slower than the card
runs), and ``device_ms``, the same calls captured once in a CUDA graph and
replayed (the card's time alone); ``host_us`` is the host's time to issue
one call. Last, the device time of each kernel of the B = 64 layer under
torch.profiler (last, because its hooks slow the process's later launches).
With --edges it first holds the kernel against the plain product at the
edges of its tiling (``check_edges``).

    python -m mdm_tpu_torch.scripts.gemm_probe [--edges]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..ops import _build
from ..ops._chain import gemm, wgmma_occupancy, wgmma_plan
from ..ops.layer_inference import fused_layer_inference
from ._card import card_line

KERNEL = "gemm_bf16_wgmma"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's specification)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (the same)
# name -> (M, N, K, out_f32, gelu): every bf16 x . W^T product of the AUTO
# sampling layer (#1) and the AUTO training layer's forward (#2, #4).
MAIN_PATH_PRODUCTS = {
    "sampling q/k/v": (64 * 197, 1536, 512, False, False),
    "sampling out projection": (64 * 197, 512, 512, False, False),
    "sampling linear1 + GELU": (64 * 197, 1024, 512, False, True),
    "sampling linear2 (f32 out)": (64 * 197, 512, 1024, True, False),
    "training q/k/v": (128 * 197, 1536, 512, False, False),
    "training out projection": (128 * 197, 512, 512, False, False),
    "training linear1 (f32 out)": (128 * 197, 1024, 512, True, False),
    "training linear2 (f32 out)": (128 * 197, 512, 1024, True, False),
}
EDGE_M = (1, 64, 127, 128, 129, 394, 12608, 25216)  # both sides of the 128-row tile, the paths' M
# The paths' four (N, K), then two ragged ones: N past a 128-column tile
# (the bias guard, the clipped store) and K past a 64-deep tile (the TMA's
# zero fill), as an ff_size that is a multiple of 8 but not of 128 gives.
EDGE_NK = ((1536, 512), (512, 512), (1024, 512), (512, 1024), (136, 72), (1000, 1000))
# Kernel vs plain, max |kernel - plain| <= REL x max |plain|. bf16 out: the
# value is rounded to 8 bits of mantissa (half an ulp, 2^-9 of the value),
# and a sum in another order may round across the boundary (one ulp, 2^-8);
# 2^-7 is two ulps of the largest value. f32 out: summation order alone,
# chip_smoke.py's F32_TOL.
REL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-4}


def operands(M: int, N: int, K: int, seed: int = 0, device="cuda"):
    """bf16 a [M, K], w [N, K] (scaled K^-1/2) and bias [N], from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(N, K, generator=g, device=device) * K ** -0.5).to(torch.bfloat16)
    b = (torch.randn(N, generator=g, device=device) * 0.1).to(torch.bfloat16)
    return a, w, b


def plain(a, w, bias, out_f32: bool, gelu: bool) -> torch.Tensor:
    """The same product in f32 with torch ops: a.float() @ w.float().T + b."""
    y = a.float() @ w.float().T
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = torch.nn.functional.gelu(y)
    return y if out_f32 else y.to(a.dtype)


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def check_edges() -> dict:
    """The kernel against ``plain`` at every EDGE_M x EDGE_NK, bias on and
    off, GELU on and off, bf16 and f32 out (384 cases), each run twice and
    required bitwise equal. Raises on a miss; returns the worst error per
    output dtype and the number of cases."""
    worst, cases = {"bfloat16": 0.0, "float32": 0.0}, 0
    for N, K in EDGE_NK:
        a_all, w, b = operands(max(EDGE_M), N, K)
        for M in EDGE_M:
            a = a_all[:M]
            for with_bias in (True, False):
                bias = b if with_bias else None
                for gelu in (False, True):
                    for out_f32 in (False, True):
                        dt = torch.float32 if out_f32 else torch.bfloat16
                        run = lambda: gemm(a, w, bias=bias, out_f32=out_f32, gelu=gelu)
                        out = run()
                        what = f"M={M} N={N} K={K} bias={with_bias} gelu={gelu} out={dt}"
                        if out.dtype != dt or tuple(out.shape) != (M, N):
                            raise AssertionError(f"{what}: got {out.dtype} {tuple(out.shape)}")
                        err = rel_err(out, plain(a, w, bias, out_f32, gelu))
                        if not err <= REL[dt]:  # also catches a NaN
                            raise AssertionError(f"{what}: kernel vs plain {err:.3g} of max "
                                                 f"|plain| (bound {REL[dt]})")
                        if not torch.equal(out, run()):
                            raise AssertionError(f"{what}: two runs differ")
                        name = str(dt).split(".")[-1]
                        worst[name] = max(worst[name], err)
                        cases += 1
    return dict(cases=cases, worst_rel_err=worst, rel_tol={str(k).split(".")[-1]: v
                                                          for k, v in REL.items()})


def _ms(fn, iters: int = 50) -> float:
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


def device_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """ms per call of fn on the card alone: ``calls`` calls captured in one
    CUDA graph (after 3 warm on a side stream), replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_us(fn, calls: int = 100) -> float:
    """µs of host time to issue one call of fn (host clock over calls
    issued back to back, before the closing synchronise)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issue / calls * 1e6


def _layer_call(B: int, S: int = 197, D: int = 512, F: int = 1024, H: int = 4):
    """One call of #1 (fused_layer_inference) at the flagship layer, bf16,
    no mask, on operands drawn from a seed."""
    g = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device="cuda") * sc).to(torch.bfloat16)
    x = r(B, S, D)
    ws = [r(3 * D, D, sc=D ** -0.5), r(3 * D, sc=0.1), r(D, D, sc=D ** -0.5), r(D, sc=0.1),
          1 + r(D, sc=0.1), r(D, sc=0.1), r(F, D, sc=D ** -0.5), r(F, sc=0.1),
          r(D, F, sc=F ** -0.5), r(D, sc=0.1), 1 + r(D, sc=0.1), r(D, sc=0.1)]
    return lambda: fused_layer_inference(x, *ws, H)


def layer_costs(B: int) -> dict:
    """#1 at batch B: ms, device_ms and host_us per call."""
    call = _layer_call(B)
    return dict(B=B, ms=_ms(call), device_ms=device_ms(call), host_us=host_us(call))


def layer_kernels(B: int = 64, calls: int = 10) -> dict:
    """µs per layer call of each kernel of #1, by name, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    call = _layer_call(B)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    short = lambda key: key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
    return {short(e.key): e.self_device_time_total / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}


def measure(name: str) -> dict:
    """One main-path product: the kernel's and torch.matmul's times (in
    turns: matmul, kernel, kernel, matmul; then both on the card alone),
    its bound and share of peak."""
    M, N, K, out_f32, gelu = MAIN_PATH_PRODUCTS[name]
    a, w, b = operands(M, N, K)
    kernel = lambda: gemm(a, w, bias=b, out_f32=out_f32, gelu=gelu)
    err = rel_err(kernel(), plain(a, w, b, out_f32, gelu))
    wt = w.T
    library = lambda: torch.matmul(a, wt)
    l1, k1, k2, l2 = (_ms(f) for f in (library, kernel, kernel, library))
    ms = (k1 + k2) / 2
    dev_ms, lib_dev_ms = device_ms(kernel), device_ms(library)
    flops = 2 * M * N * K
    nbytes = 2 * (M * K + N * K + N) + M * N * (4 if out_f32 else 2)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    plan = wgmma_plan(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(M=M, N=N, K=K, out="float32" if out_f32 else "bfloat16", gelu=gelu, ms=ms,
                device_ms=dev_ms, flops=flops, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                peak_fraction=t_ops / dev_ms, rel_err=err, library_ms=(l1 + l2) / 2,
                library_device_ms=lib_dev_ms, tiles=plan["tiles"], waves=plan["waves"])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--edges", action="store_true", help="check the tiling edges first")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gemm_probe: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    so = _build.build()
    _build.load_library()
    print(card_line())
    report = {"ptxas": _build.ptxas_report(so.with_suffix(".log").read_text(), KERNEL),
              "blocks_per_sm": {f"out_f32={o} gelu={g}": wgmma_occupancy(o, g)
                                for o in (False, True) for g in (False, True)}}
    if args.edges:
        report["edges"] = check_edges()
    report["products"] = {name: measure(name) for name in MAIN_PATH_PRODUCTS}
    report["layer"] = [layer_costs(B) for B in (64, 2)]
    report["layer_kernels_us"] = layer_kernels()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
