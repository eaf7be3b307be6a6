"""Launch helpers shared by the kernel chains (layer_inference, the
attention modules, encoder_tail): operand preparation, the products and
column sums of ``csrc/gemm.cu``, the attention core of
``csrc/attention.cu`` and the dropout arguments of ``csrc/philox.cuh``.

Every helper launches asynchronously on the tensor's current stream,
allocates its outputs with ``torch.empty`` and raises on a nonzero
``cudaError_t`` from the launch. None of them runs on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .dropout_bits import keep_threshold

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the head dims the attention kernels are instantiated for
_SMS = 132  # H100 SXM streaming multiprocessors: the split-K target


def dev(t: torch.Tensor, dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """Contiguous, 16-byte aligned tensor in dt (a no-op when it already is)."""
    t = (t if dt is None else t.to(dt)).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


def gemm(a: torch.Tensor, b: torch.Tensor, *, a_km: bool = False, b_kn: bool = False,
         bias: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None,
         out_f32: bool = False, gelu: bool = False, splits: int = 1) -> torch.Tensor:
    """C = act(op(A) . op(B) (+ bias)) (+ r), f32 accumulation (csrc/gemm.cu);
    act is the exact GELU when gelu, else the identity.

    op(A) is A [M, K], or A^T when a_km (A stored [K, M]); op(B) is B^T for
    a torch weight B [N, K], or B itself when b_kn (B stored [K, N]). C is
    f32 when out_f32, else A's dtype. splits > 1 reduces K in that many
    fixed chunks summed in order (no atomics): C must be f32, no bias or r."""
    M, K = (a.shape[1], a.shape[0]) if a_km else (a.shape[0], a.shape[1])
    N = b.shape[1] if b_kn else b.shape[0]
    if (b.shape[0] if b_kn else b.shape[1]) != K:
        raise ValueError(f"gemm: inner dimensions differ, {tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else a.dtype, device=a.device)
    work = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    lib = _build.load_library()
    _build.check(lib.mdm_gemm(ptr(a), ptr(b), ptr(bias), ptr(r), ptr(out), ptr(work), M, N, K,
                              int(a_km), int(b_kn), DTYPES[a.dtype], int(out_f32), splits,
                              int(gelu), stream(a)), "gemm")
    return out


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
    if D % num_heads or D // num_heads not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim of {D} / {num_heads} heads not in {HEAD_DIMS}")
    return D // num_heads


def attention_fwd(q, k, v, view, out, out_view, B: int, S: int, H: int, head_dim: int,
                  bias=None, bias_strides=(0, 0, 0), drop=(None, 0, 0, 1.0, 0)) -> None:
    """out = dropout(softmax(q k^T / sqrt(Dh) + bias)) v per (batch, head)
    (csrc/attention.cu). q, k, v share ``view``, out (f32 or q's dtype) has
    ``out_view``; bias is additive f32 with ``bias_strides`` or None; drop is
    ``dropout_args``'s tuple."""
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
    one: cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load_library().mdm_attention_fwd_occupancy(
        head_dim, DTYPES[out_dtype], bias_form, int(resident), ctypes.addressof(blocks)),
        "attention occupancy")
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
