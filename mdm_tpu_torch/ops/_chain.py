"""Launch helpers shared by the kernel chains (layer_inference, the
attention modules, encoder_tail): operand preparation, the products of
``csrc/gemm_sm90.cu`` and ``csrc/gemm.cu`` and the column sums of the
latter, the attention core of ``csrc/attention.cu`` and the dropout
arguments of ``csrc/philox.cuh``.

Every helper launches asynchronously on the tensor's current stream,
allocates its outputs with ``torch.empty`` and raises on a nonzero
``cudaError_t`` from the launch. None of them runs on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _build
from .dropout_bits import keep_threshold

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 192, 256)  # the attention kernels' instances (padded head dims)
_SMS = 132  # H100 SXM streaming multiprocessors: the split-K target
WGMMA_TILE = (128, 128, 64)  # csrc/gemm_sm90.cu's block tile (rows, columns, K depth)
GEMM_LAUNCHES = {"wgmma": 0, "wmma": 0, "fma": 0}  # launches per product kernel (see gemm_kernel)


def dev(t: torch.Tensor, dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """Contiguous, 16-byte aligned tensor in dt (t itself when it already
    is: the chains call this on every operand of every launch, so the
    common case costs no torch op)."""
    if (dt is None or t.dtype == dt) and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = (t if dt is None else t.to(dt)).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t):
    """The address of a tensor; an int is an address already."""
    return t if t is None or isinstance(t, int) else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of t's card (the accessor
    PyTorch's own generated kernels use: no Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_dtype(x: torch.Tensor, what: str) -> int:
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: kernel dtype must be float32 or bfloat16, got {x.dtype}")
    return DTYPES[x.dtype]


def check_shapes(x: torch.Tensor, operands, what: str) -> None:
    """Raise ValueError unless every (tensor, shape) pair has that shape and
    lies on x's device."""
    for i, (t, shape) in enumerate(operands):
        if t is not None and (tuple(t.shape) != tuple(shape) or t.device != x.device):
            raise ValueError(f"{what} operand {i + 1}: {tuple(t.shape)} on {t.device}, "
                             f"expected {tuple(shape)} on {x.device}")


def dropout_args(bits: Optional[torch.Tensor], seed: int, rate: float):
    """(bits, seed, threshold, 1/(1-rate), mode) of philox.cuh::Dropout:
    mode 0 draws nothing (rate 0), 1 reads the injected uint32 bits, 2 draws
    in-kernel Philox from the int32 seed."""
    if rate <= 0.0:
        return None, 0, 0, 1.0, 0
    inv_keep = float(np.float32(1.0 / (1.0 - rate)))
    mode = 2 if bits is None else 1
    seed = (int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31  # the int32 the kernel takes
    return ptr(bits), seed, keep_threshold(rate), inv_keep, mode


def splits_for(m: int, n: int, k: int) -> int:
    """Fixed split-K count for a weight gradient [m, n] reduced over k rows:
    enough 128x64 tiles x splits to cover the SMs twice, each split at least
    1024 rows deep."""
    tiles = -(-m // 128) * -(-n // 64)
    return max(1, min(2 * _SMS // tiles, k // 1024))


def gemm_kernel(a: torch.Tensor, b: torch.Tensor, *, a_km: bool = False, b_kn: bool = False,
                bias: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None,
                splits: int = 1) -> str:
    """The kernel that runs ``gemm``'s product, by a fixed rule: "wgmma"
    (``csrc/gemm_sm90.cu``) for every bf16 x . W^T product (a_km and b_kn
    off), "wmma" (``csrc/gemm.cu``) for the other bf16 forms (dY . W,
    dY^T . X split-K), "fma" (``csrc/gemm.cu``) for float32.

    Raises ValueError on an operand the chosen kernel cannot take, never
    routing it elsewhere: for "wgmma" more than one split, a K or N that is
    not a multiple of 8 (the TMA's 16-byte row strides), an operand that is
    not contiguous or whose base is not 16-byte aligned, or a residual r."""
    if a.dtype not in DTYPES or b.dtype != a.dtype or (bias is not None and bias.dtype != a.dtype):
        raise ValueError(f"gemm: operands must share float32 or bfloat16, got {a.dtype}, "
                         f"{b.dtype} and bias {None if bias is None else bias.dtype}")
    if a.dtype == torch.float32:
        return "fma"
    if a_km or b_kn:
        return "wmma"
    if splits != 1:
        raise ValueError(f"gemm: the wgmma kernel runs no split-K, got splits={splits}")
    K, N = a.shape[1], b.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"gemm: the wgmma kernel needs K and N multiples of 8, got K={K} N={N}")
    if r is not None:
        raise ValueError("gemm: the wgmma kernel adds no residual")
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"gemm: the wgmma kernel needs {name} contiguous and 16-byte "
                             f"aligned (see dev())")
    return "wgmma"


def wgmma_plan(M: int, N: int, K: int, sms: int = _SMS) -> dict:
    """csrc/gemm_sm90.cu's schedule of a product: 128x128 output tiles
    walked by min(tiles, sms) persistent blocks, each tile K / 64 stages
    deep; waves is tiles / sms (a whole number when the tiles quantise onto
    the SMs)."""
    bm, bn, bk = WGMMA_TILE
    row_tiles, col_tiles = -(-M // bm), -(-N // bn)
    tiles = row_tiles * col_tiles
    return dict(row_tiles=row_tiles, col_tiles=col_tiles, tiles=tiles, waves=tiles / sms,
                k_steps=-(-K // bk), grid=_wgmma_grid(M, N, sms))


def _wgmma_grid(M: int, N: int, sms: int) -> int:
    return min(-(-M // WGMMA_TILE[0]) * -(-N // WGMMA_TILE[1]), sms)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm(a: torch.Tensor, b: torch.Tensor, *, a_km: bool = False, b_kn: bool = False,
         bias: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None,
         out_f32: bool = False, gelu: bool = False, splits: int = 1) -> torch.Tensor:
    """C = act(op(A) . op(B) (+ bias)) (+ r), f32 accumulation, on the
    kernel ``gemm_kernel`` names (one more in its ``GEMM_LAUNCHES``); act is
    the exact GELU when gelu, else the identity.

    op(A) is A [M, K], or A^T when a_km (A stored [K, M]); op(B) is B^T for
    a torch weight B [N, K], or B itself when b_kn (B stored [K, N]). C is
    f32 when out_f32, else A's dtype. splits > 1 reduces K in that many
    fixed chunks summed in order (no atomics): C must be f32, no bias or r."""
    M, K = (a.shape[1], a.shape[0]) if a_km else (a.shape[0], a.shape[1])
    N = b.shape[1] if b_kn else b.shape[0]
    if (b.shape[0] if b_kn else b.shape[1]) != K:
        raise ValueError(f"gemm: inner dimensions differ, {tuple(a.shape)} and {tuple(b.shape)}")
    kernel = gemm_kernel(a, b, a_km=a_km, b_kn=b_kn, bias=bias, r=r, splits=splits)
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else a.dtype, device=a.device)
    lib = _build.load_library()
    if kernel == "wgmma":
        grid = _wgmma_grid(M, N, _sm_count(a.get_device()))
        _build.check(lib.mdm_gemm_wgmma(ptr(a), ptr(b), ptr(bias), ptr(out), M, N, K,
                                        int(out_f32), int(gelu), grid, stream(a)), "gemm")
    else:
        work = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
                if splits > 1 else None)
        _build.check(lib.mdm_gemm(ptr(a), ptr(b), ptr(bias), ptr(r), ptr(out), ptr(work), M, N,
                                  K, int(a_km), int(b_kn), DTYPES[a.dtype], int(out_f32), splits,
                                  int(gelu), stream(a)), "gemm")
    GEMM_LAUNCHES[kernel] += 1
    return out


def wgmma_occupancy(out_f32: bool, gelu: bool) -> int:
    """Resident blocks per SM of the wgmma product kernel's instance:
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load_library().mdm_gemm_wgmma_occupancy(
        int(out_f32), int(gelu), ctypes.addressof(blocks)), "gemm occupancy")
    return blocks.value


def bsd_view(S: int, D: int, head_dim: int, ld: Optional[int] = None):
    """(batch, head, row) strides of [B, S, H*Dh] rows of ld elements (D
    unless packed), head h at columns h*Dh (csrc/attention.cu::View)."""
    ld = D if ld is None else ld
    return S * ld, head_dim, ld


def bhsd_view(H: int, S: int, head_dim: int):
    """(batch, head, row) strides of a contiguous [B, H, S, Dh] tensor."""
    return H * S * head_dim, S * head_dim, head_dim


def row_bias_strides(S: int):
    """(batch, head, query row) strides of a key-padding row bias [B, S]."""
    return S, 0, 0


def check_head_dim(D: int, num_heads: int, what: str) -> int:
    """D // num_heads, or ValueError where the attention kernels take no
    such head dim: not a multiple of 8 (their rows are 16-byte copies) or
    above 256 (the accumulators would not fit the registers). The others
    run in the least of HEAD_DIMS that holds them (csrc/attention.cuh)."""
    if D % num_heads:
        raise ValueError(f"{what}: d_model {D} is not divisible by {num_heads} heads")
    dh = D // num_heads
    if dh % 8 or not 8 <= dh <= HEAD_DIMS[-1]:
        raise ValueError(f"{what}: head dim {dh} of {D} / {num_heads} heads is not a "
                         f"multiple of 8 from 8 to {HEAD_DIMS[-1]}")
    return dh


def attention_fwd(q, k, v, view, out, out_view, B: int, S: int, H: int, head_dim: int,
                  bias=None, bias_strides=(0, 0, 0), drop=(None, 0, 0, 1.0, 0)) -> None:
    """out = dropout(softmax(q k^T / sqrt(Dh) + bias)) v per (batch, head)
    (csrc/attention.cu). q, k, v share ``view``, out (f32 or q's dtype) has
    ``out_view``; bias is additive f32 with ``bias_strides`` or None; drop is
    ``dropout_args``'s tuple. k and v may be given as addresses (their
    column blocks in a packed tensor that starts with q)."""
    lib = _build.load_library()
    _build.check(lib.mdm_attention_fwd(ptr(q), ptr(k), ptr(v), *view, ptr(bias), *bias_strides,
                                       *drop, ptr(out), *out_view, DTYPES[out.dtype], B, S, H,
                                       head_dim, check_dtype(q, "attention"), stream(q)),
                 "attention forward")


def attention_fwd_occupancy(head_dim: int, out_dtype: torch.dtype, bias_form: int,
                            resident: bool = True) -> int:
    """Resident blocks per SM of ``attention_fwd``'s bf16 kernel storing
    out_dtype, for bias_form 0 (none), 1 (a key-padding row) or 2 (a full
    [S, S] tile), in its resident-row instance (S <= 256) or its two-pass
    one (the only one above head dim 128):
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load_library().mdm_attention_fwd_occupancy(
        head_dim, DTYPES[out_dtype], bias_form, int(resident), ctypes.addressof(blocks)),
        "attention occupancy")
    return blocks.value


BWD_KERNELS = ("dq", "dkv")  # the bf16 backward's two kernels, in launch order


def attention_bwd_occupancy(head_dim: int, bias_form: int, kernel: str) -> int:
    """Resident blocks per SM (of 4 warps) of the bf16 backward's ``kernel``
    (one of BWD_KERNELS) for bias_form 0, 1 or 2:
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load_library().mdm_attention_bwd_occupancy(
        head_dim, bias_form, BWD_KERNELS.index(kernel), ctypes.addressof(blocks)),
        "attention backward occupancy")
    return blocks.value


def attention_bwd(q, k, v, view, dout, out_view, dq, dk, dv, B: int, S: int, H: int,
                  head_dim: int, bias=None, bias_strides=(0, 0, 0), drop=(None, 0, 0, 1.0, 0),
                  ctx=None) -> None:
    """dq, dk, dv (q's view and dtype) of ``attention_fwd`` given dout (q's
    dtype, out_view): p recomputed, the bits replayed; the forward's out
    recomputed into ctx when it is given."""
    if not dq.dtype == dk.dtype == dv.dtype == q.dtype:
        raise ValueError(f"attention gradients must be in q's dtype {q.dtype}")
    stats = torch.empty((3, B * H * S), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    _build.check(lib.mdm_attention_bwd(ptr(q), ptr(k), ptr(v), *view, ptr(bias), *bias_strides,
                                       *drop, ptr(dout), ptr(ctx), *out_view, ptr(dq), ptr(dk),
                                       ptr(dv), ptr(stats), B, S, H, head_dim,
                                       check_dtype(q, "attention"), stream(q)),
                 "attention backward")


def colsum(t: torch.Tensor, chunks: int = 64) -> torch.Tensor:
    """f32 [N] sum over the rows of t [M, N] in a fixed order: row chunks,
    then the chunks' sums in chunk order."""
    M, N = t.shape
    chunks = max(1, min(chunks, M))
    out = torch.empty((N,), dtype=torch.float32, device=t.device)
    work = torch.empty((chunks, N), dtype=torch.float32, device=t.device)
    lib = _build.load_library()
    _build.check(lib.mdm_colsum(ptr(t), ptr(out), ptr(work), M, N, chunks, DTYPES[t.dtype],
                                stream(t)), "colsum")
    return out
