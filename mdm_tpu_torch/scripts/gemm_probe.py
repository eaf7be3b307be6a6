"""The product kernels (csrc/gemm_sm90.cu, bf16; csrc/gemm.cu, f32) alone on
one GPU.

Prints the card, then one JSON line: each kernel instance's registers and
spill bytes (the build's ptxas report) and resident blocks per SM, and for
each product of the main paths (the sampling layer at the CFG batch, M = 64
x 197, and the training layer, 128 x 197 rows, forward and backward, at the
flagship widths) its time, FLOPs, bound, fraction of the bf16 peak, error
against the plain product and ``torch.matmul``'s time for the same product
(timed only); then
the whole sampling layer (#1, ops/layer_inference.py) at B = 64 and 2. Each
time twice: ``ms``, CUDA events over 50 calls issued back to back after 3
warm (the card's time, or the host's where it issues slower than the card
runs), and ``device_ms``, the same calls captured once in a CUDA graph and
replayed (the card's time alone); ``host_us`` is the host's time to issue
one call. Last, the device time of each kernel of the B = 64 layer under
torch.profiler (last, because its hooks slow the process's later launches).
With --edges it first holds the kernel against the plain product at the
edges of its tiling (``check_edges``). With --f32 it measures the f32
product kernel instead (3xTF32, csrc/gemm.cu): its edges
(``check_f32_edges``), then each f32 product of the main paths at
compute_dtype="float32" (F32_PRODUCTS) against ``torch.matmul`` with TF32
off, with its bound and share of peak at three TF32 passes a FLOP (the
least f32 accuracy takes on the tensor cores) and its bound at the f32 FMA
peak beside them.

    python -m mdm_tpu_torch.scripts.gemm_probe [--edges | --f32]
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import torch

from ..ops import _build
from ..ops._chain import gemm, split_rows, splits_for, wgmma_occupancy, wgmma_plan
from ..ops.layer_inference import fused_layer_inference
from ._card import card_line

KERNEL = "gemm_bf16_wgmma"
F32_KERNEL = "gemm_f32_tf32x3"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's specification)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (the same)
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (the same)
TF32_FLOPS_PER_S = 495e12  # dense TF32 tensor-core peak (the same); 3xTF32 runs three passes
T = 128 * 197  # the training layer's rows, B x S
# name -> (M, N, K, options): every bf16 product of the AUTO sampling layer
# (#1) and of the AUTO training layer, forward (#2, #4) and backward (#3,
# #5). Options: gelu, out_f32, a_km (A stored [K, M]), b_kn (B stored [K,
# N]), residual (an f32 [M, N] added last), split (split-K by splits_for).
# The forward forms add a bias, as their call sites do.
MAIN_PATH_PRODUCTS = {
    "sampling q/k/v": (64 * 197, 1536, 512, {}),
    "sampling out projection": (64 * 197, 512, 512, {}),
    "sampling linear1 + GELU": (64 * 197, 1024, 512, dict(gelu=True)),
    "sampling linear2 (f32 out)": (64 * 197, 512, 1024, dict(out_f32=True)),
    "training q/k/v": (T, 1536, 512, {}),
    "training out projection": (T, 512, 512, {}),
    "training linear1 (f32 out)": (T, 1024, 512, dict(out_f32=True)),
    "training linear2 (f32 out)": (T, 512, 1024, dict(out_f32=True)),
    "training dctx = dO Wo": (T, 512, 512, dict(b_kn=True)),
    "training dWo = dO^T ctx (split-K)": (512, 512, T, dict(a_km=True, b_kn=True, out_f32=True,
                                                            split=True)),
    "training dWqkv = dqkv^T x (split-K)": (1536, 512, T, dict(a_km=True, b_kn=True,
                                                              out_f32=True, split=True)),
    "training dx = dqkv Wqkv": (T, 512, 1536, dict(b_kn=True)),
    "training dW2 = do^T hd (split-K)": (512, 1024, T, dict(a_km=True, b_kn=True, out_f32=True,
                                                           split=True)),
    "training dhd = do W2 (f32 out)": (T, 1024, 512, dict(b_kn=True, out_f32=True)),
    "training dW1 = du^T y (split-K)": (1024, 512, T, dict(a_km=True, b_kn=True, out_f32=True,
                                                          split=True)),
    "training dy = ds2 + du W1 (f32 out)": (T, 512, 1024, dict(b_kn=True, out_f32=True,
                                                               residual=True)),
}
# The f32 products of the same paths at compute_dtype="float32" (every
# CLI's default; f32 operands and output), the training rows at B = 128,
# and DistilBERT's self-attention block (#2's rate-0 entry: 32 prompts of
# 64 tokens, D = 768): the x . W^T forms carry a bias as their call sites
# do. The tail's linear2 adds no residual (the row kernel does).
F32_PRODUCTS = {
    "sampling q/k/v": (64 * 197, 1536, 512, {}),
    "sampling out projection": (64 * 197, 512, 512, {}),
    "sampling linear1 + GELU": (64 * 197, 1024, 512, dict(gelu=True)),
    "sampling linear2": (64 * 197, 512, 1024, {}),
    "training q/k/v": (T, 1536, 512, {}),
    "training out projection": (T, 512, 512, {}),
    "training linear1": (T, 1024, 512, {}),
    "training linear2": (T, 512, 1024, {}),
    "training dctx = dO Wo": (T, 512, 512, dict(b_kn=True)),
    "training dWo = dO^T ctx (split-K)": (512, 512, T, dict(a_km=True, b_kn=True, split=True)),
    "training dWqkv = dqkv^T x (split-K)": (1536, 512, T, dict(a_km=True, b_kn=True,
                                                              split=True)),
    "training dx = dqkv Wqkv": (T, 512, 1536, dict(b_kn=True)),
    "training dW2 = do^T hd (split-K)": (512, 1024, T, dict(a_km=True, b_kn=True, split=True)),
    "training dhd = do W2": (T, 1024, 512, dict(b_kn=True)),
    "training dW1 = du^T y (split-K)": (1024, 512, T, dict(a_km=True, b_kn=True, split=True)),
    "training dy = ds2 + du W1": (T, 512, 1024, dict(b_kn=True, residual=True)),
    "DistilBERT q/k/v": (32 * 64, 2304, 768, {}),
    "DistilBERT out projection": (32 * 64, 768, 768, {}),
}
EDGE_M = (1, 64, 127, 128, 129, 394, 12608, 25216)  # both sides of the 128-row tile, the paths' M
# The paths' four (N, K), then two ragged ones: N past a 128-column tile
# (the bias guard, the clipped store) and K past a 64-deep tile (the TMA's
# zero fill), as an ff_size that is a multiple of 8 but not of 128 gives.
EDGE_NK = ((1536, 512), (512, 512), (1024, 512), (512, 1024), (136, 72), (1000, 1000))
# dY . W (B stored [K, N]): rows EDGE_M by the backward's (N, K) and the
# ragged ones.
EDGE_NK_DYW = ((512, 512), (512, 1536), (1024, 512), (512, 1024), (136, 72), (1000, 1000))
# dY^T . X (both stored [K, .]): outputs on both sides of the 128 x 128
# tile and the four weight gradients, reduced over K rows on both sides of
# the 64-deep tile, the serving batch and the training rows.
EDGE_MN_DW = ((8, 8), (120, 136), (128, 128), (136, 120), (512, 512), (1536, 512), (512, 1024),
              (1024, 512))
EDGE_K_DW = (1, 63, 64, 65, 394, T)
# Kernel vs plain, max |kernel - plain| <= REL x max |plain|. bf16 out: the
# value is rounded to 8 bits of mantissa (half an ulp, 2^-9 of the value),
# and a sum in another order may round across the boundary (one ulp, 2^-8);
# 2^-7 is two ulps of the largest value. f32 out: summation order alone,
# chip_smoke.py's F32_TOL.
REL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-4}


def operands(M: int, N: int, K: int, seed: int = 0, device="cuda", a_km: bool = False,
             b_kn: bool = False, residual: bool = False, dtype=torch.bfloat16):
    """a (stored [K, M] when a_km, else [M, K]), b (stored [K, N] when b_kn,
    else [N, K]; scaled K^-1/2) and bias [N] in dtype (bf16 unless given)
    and, when residual, an f32 r [M, N], from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(*((K, M) if a_km else (M, K)), generator=g, device=device).to(dtype)
    w = (torch.randn(*((K, N) if b_kn else (N, K)), generator=g, device=device)
         * K ** -0.5).to(dtype)
    b = (torch.randn(N, generator=g, device=device) * 0.1).to(dtype)
    r = torch.randn(M, N, generator=g, device=device) if residual else None
    return a, w, b, r


def _op(a, w, a_km, b_kn):
    """op(A), op(B) as views: A or A^T [M, K], B^T or B [K, N]."""
    return (a.T if a_km else a), (w if b_kn else w.T)


def plain(a, w, bias, out_f32: bool, gelu: bool, a_km: bool = False, b_kn: bool = False,
          r=None) -> torch.Tensor:
    """The same product in f32 with torch ops: op(a).float() @ op(w).float()
    (+ b), GELU, (+ r)."""
    x, y = _op(a, w, a_km, b_kn)
    y = x.float() @ y.float()
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = torch.nn.functional.gelu(y)
    if r is not None:
        y = y + r
    return y if out_f32 else y.to(a.dtype)


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _check(worst, what, run, ref, dt, shape) -> None:
    """One edge case: dtype and shape, error within REL, two runs bitwise."""
    out = run()
    if out.dtype != dt or tuple(out.shape) != shape:
        raise AssertionError(f"{what}: got {out.dtype} {tuple(out.shape)}")
    err = rel_err(out, ref)
    if not err <= REL[dt]:  # also catches a NaN
        raise AssertionError(f"{what}: kernel vs plain {err:.3g} of max |plain| (bound {REL[dt]})")
    if not torch.equal(out, run()):
        raise AssertionError(f"{what}: two runs differ")
    name = str(dt).split(".")[-1]
    worst[name] = max(worst[name], err)


def check_edges() -> dict:
    """The kernel against ``plain`` at the edges of its tiling, each case run
    twice and required bitwise equal; raises on a miss. x . W^T: every
    EDGE_M x EDGE_NK, bias on and off, GELU on and off, bf16 and f32 out
    (384 cases). dY . W: EDGE_M x EDGE_NK_DYW, the residual on and off, bf16
    and f32 out (192). dY^T . X: EDGE_MN_DW x EDGE_K_DW, one split, bf16 and
    f32 out (96), then f32 split-K at every count splits_for gives and one
    more (none empty). Last, each form from a new
    thread, bitwise as from this one. Returns the worst error per output
    dtype and the cases per form."""
    worst, cases = {"bfloat16": 0.0, "float32": 0.0}, {}
    outs = ((False, torch.bfloat16), (True, torch.float32))
    for N, K in EDGE_NK:
        a_all, w, b, _ = operands(max(EDGE_M), N, K)
        for M in EDGE_M:
            a = a_all[:M]
            for bias in (b, None):
                for gelu in (False, True):
                    for out_f32, dt in outs:
                        _check(worst, f"x.W^T M={M} N={N} K={K} bias={bias is not None} "
                               f"gelu={gelu} out={dt}",
                               lambda: gemm(a, w, bias=bias, out_f32=out_f32, gelu=gelu),
                               plain(a, w, bias, out_f32, gelu), dt, (M, N))
                        cases["x.W^T"] = cases.get("x.W^T", 0) + 1
    for N, K in EDGE_NK_DYW:
        a_all, w, _, r_all = operands(max(EDGE_M), N, K, b_kn=True, residual=True)
        for M in EDGE_M:
            a, r_m = a_all[:M], r_all[:M]
            for r in (None, r_m):
                for out_f32, dt in outs:
                    _check(worst, f"dY.W M={M} N={N} K={K} residual={r is not None} out={dt}",
                           lambda: gemm(a, w, b_kn=True, r=r, out_f32=out_f32),
                           plain(a, w, None, out_f32, False, b_kn=True, r=r), dt, (M, N))
                    cases["dY.W"] = cases.get("dY.W", 0) + 1
    for M, N in EDGE_MN_DW:
        for K in EDGE_K_DW:
            a, w, _, _ = operands(M, N, K, a_km=True, b_kn=True)
            opts = dict(a_km=True, b_kn=True)
            for out_f32, dt in outs:
                _check(worst, f"dY^T.X M={M} N={N} K={K} out={dt}",
                       lambda: gemm(a, w, out_f32=out_f32, **opts),
                       plain(a, w, None, out_f32, False, **opts), dt, (M, N))
                cases["dY^T.X"] = cases.get("dY^T.X", 0) + 1
            rule = splits_for(M, N, K)
            ref = plain(a, w, None, True, False, **opts)
            for splits in sorted({rule, rule + 1} - {1}):
                if (splits - 1) * split_rows(K, splits) >= K:
                    continue  # a split would be empty: the wrapper refuses it
                _check(worst, f"dY^T.X M={M} N={N} K={K} splits={splits}",
                       lambda: gemm(a, w, out_f32=True, splits=splits, **opts), ref,
                       torch.float32, (M, N))
                cases["dY^T.X split-K"] = cases.get("dY^T.X split-K", 0) + 1
    # Each form once more from a thread that made no CUDA call before (as
    # autograd's device thread runs a backward): bitwise the same.
    for M, N, K, opts in ((394, 512, 512, {}), (394, 512, 512, dict(b_kn=True)),
                          (512, 512, 394, dict(a_km=True, b_kn=True))):
        a, w, _, _ = operands(M, N, K, **opts)
        got = []
        worker = threading.Thread(target=lambda: got.append(gemm(a, w, **opts)))
        worker.start()
        worker.join()
        if not (got and torch.equal(got[0], gemm(a, w, **opts))):
            raise AssertionError(f"{opts}: a product from a new thread failed or differs")
        cases["new thread"] = cases.get("new thread", 0) + 1
    return dict(cases=cases, worst_rel_err=worst, rel_tol={str(k).split(".")[-1]: v
                                                          for k, v in REL.items()})


# f32 edges (csrc/gemm.cu's 128 x 64 x 32 tiles): rows on both sides of
# the 128-row tile and the paths' M; (N, K) of the paths, one each side of
# the 64-column tile and the 32-deep K tile, and odd ones whose rows are no
# multiple of 4 floats (4-byte copies).
F32_EDGE_M = (1, 127, 128, 129, 394, 2048, 12608)
F32_EDGE_NK = ((512, 512), (1536, 512), (512, 1024), (2304, 768), (63, 31), (65, 33), (1, 1),
               (136, 72), (1000, 1000), (7, 13))
F32_EDGE_MN_DW = ((8, 8), (127, 65), (128, 64), (512, 512), (1536, 512), (7, 13))
F32_EDGE_K_DW = (1, 31, 33, 394, 25216)


def check_f32_edges() -> dict:
    """The f32 kernel against ``plain`` (f32 operands: cuBLAS f32, TF32 off)
    at the edges of its tiling, within REL's f32 bound, each case twice and
    bitwise equal; raises on a miss. x . W^T: F32_EDGE_M x F32_EDGE_NK with
    bias and GELU, and without; dY . W: the same rows and (N, K), with the
    residual and without; dY^T . X: F32_EDGE_MN_DW x F32_EDGE_K_DW, one
    split, then at splits_for's count and one more. Returns the worst error
    and the cases per form."""
    f32 = torch.float32
    worst, cases = {"float32": 0.0}, {}

    def case(form, what, run, ref, shape):
        _check(worst, f"f32 {form} {what}", run, ref, f32, shape)
        cases[form] = cases.get(form, 0) + 1

    for N, K in F32_EDGE_NK:
        a_all, w, b, _ = operands(max(F32_EDGE_M), N, K, dtype=f32)
        d_all, wt, _, r_all = operands(max(F32_EDGE_M), N, K, b_kn=True, residual=True,
                                       dtype=f32)
        for M in F32_EDGE_M:
            a, d, r = a_all[:M], d_all[:M], r_all[:M]
            for on in (False, True):
                bias = b if on else None
                case("x.W^T", f"M={M} N={N} K={K} bias+gelu={on}",
                     lambda: gemm(a, w, bias=bias, gelu=on), plain(a, w, bias, True, on), (M, N))
                rr = r if on else None
                case("dY.W", f"M={M} N={N} K={K} residual={on}",
                     lambda: gemm(d, wt, b_kn=True, r=rr),
                     plain(d, wt, None, True, False, b_kn=True, r=rr), (M, N))
    opts = dict(a_km=True, b_kn=True)
    for M, N in F32_EDGE_MN_DW:
        for K in F32_EDGE_K_DW:
            a, w, _, _ = operands(M, N, K, dtype=f32, **opts)
            ref = plain(a, w, None, True, False, **opts)
            for splits in sorted({1, splits_for(M, N, K), splits_for(M, N, K) + 1}):
                case("dY^T.X", f"M={M} N={N} K={K} splits={splits}",
                     lambda: gemm(a, w, splits=splits, **opts), ref, (M, N))
    return dict(cases=cases, worst_rel_err=worst, rel_tol=REL[f32])


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


def kernel_us(fn, calls: int = 10, warm: int = 1) -> dict:
    """µs per call of fn of each kernel it launches, by name (kernels of
    one name summed), under torch.profiler after ``warm`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    short = lambda key: key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
    per = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            per[short(e.key)] = per.get(short(e.key), 0.0) + e.self_device_time_total / calls
    return per


def layer_kernels(B: int = 64, calls: int = 10) -> dict:
    """µs per layer call of each kernel of #1, by name, under torch.profiler."""
    return kernel_us(_layer_call(B), calls)


def measure(name: str, f32: bool = False) -> dict:
    """One main-path product (MAIN_PATH_PRODUCTS, bf16; F32_PRODUCTS when
    f32): the kernel's and torch.matmul's times (in turns: matmul, kernel,
    kernel, matmul; then both on the card alone), its bound and share of
    peak (bf16's; in f32 the TF32 peak over three passes, and the bound at
    f32 FMA's peak beside it)."""
    M, N, K, opts = (F32_PRODUCTS if f32 else MAIN_PATH_PRODUCTS)[name]
    dtype = torch.float32 if f32 else torch.bfloat16
    a_km, b_kn = opts.get("a_km", False), opts.get("b_kn", False)
    out_f32, gelu = f32 or opts.get("out_f32", False), opts.get("gelu", False)
    a, w, b, r = operands(M, N, K, a_km=a_km, b_kn=b_kn, residual=opts.get("residual", False),
                          dtype=dtype)
    b = None if a_km or b_kn else b  # the backward forms add no bias
    splits = splits_for(M, N, K) if opts.get("split") else 1
    kernel = lambda: gemm(a, w, a_km=a_km, b_kn=b_kn, bias=b, r=r, out_f32=out_f32, gelu=gelu,
                          splits=splits)
    err = rel_err(kernel(), plain(a, w, b, out_f32, gelu, a_km, b_kn, r))
    x, y = _op(a, w, a_km, b_kn)
    library = lambda: torch.matmul(x, y)
    l1, k1, k2, l2 = (_ms(f) for f in (library, kernel, kernel, library))
    ms = (k1 + k2) / 2
    dev_ms, lib_dev_ms = device_ms(kernel), device_ms(library)
    flops, size = 2 * M * N * K, a.element_size()
    nbytes = (size * (M * K + N * K) + (0 if b is None else size * N)
              + (0 if r is None else 4 * M * N) + M * N * (4 if out_f32 else 2))
    peak = TF32_FLOPS_PER_S / 3 if f32 else BF16_FLOPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(M=M, N=N, K=K, out="float32" if out_f32 else "bfloat16", gelu=gelu, a_km=a_km,
               b_kn=b_kn, residual=r is not None, splits=splits, ms=ms, device_ms=dev_ms,
               flops=flops, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               peak_fraction=t_ops / dev_ms, rel_err=err, library_ms=(l1 + l2) / 2,
               library_device_ms=lib_dev_ms)
    if f32:
        row["fma_bound_ms"] = max(flops / F32_FLOPS_PER_S * 1e3, t_bytes)
    else:
        plan = wgmma_plan(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count,
                          splits)
        row.update(tiles=plan["tiles"], waves=plan["waves"])
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--edges", action="store_true", help="check the tiling edges first")
    mode.add_argument("--f32", action="store_true", help="the f32 product kernel instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gemm_probe: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    so = _build.build()
    _build.load_library()
    print(card_line())
    log = so.with_suffix(".log").read_text()
    if args.f32:
        report = {"ptxas": _build.ptxas_report(log, F32_KERNEL), "edges": check_f32_edges(),
                  "products": {name: measure(name, f32=True) for name in F32_PRODUCTS}}
        print(json.dumps(report))
        return
    report = {"ptxas": _build.ptxas_report(log, KERNEL),
              "blocks_per_sm": {f"{form} out_f32={o}": wgmma_occupancy(o, g, *t)
                                for form, g, t in (("x.W^T", False, ()), ("x.W^T+GELU", True, ()),
                                                   ("dY.W", False, (False, True)),
                                                   ("dY^T.X", False, (True, True)))
                                for o in (False, True)}}
    if args.edges:
        report["edges"] = check_edges()
    report["products"] = {name: measure(name) for name in MAIN_PATH_PRODUCTS}
    report["layer"] = [layer_costs(B) for B in (64, 2)]
    report["layer_kernels_us"] = layer_kernels()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
