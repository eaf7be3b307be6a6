"""One whole post-LN encoder layer, forward only, as a chain of Hopper kernels.

Replaces mdm_tpu/ops/layer_inference.py::fused_layer_inference, the Pallas
kernel that runs a layer as one program per batch cell with every weight
resident in VMEM. A flagship layer's ~4.2 MB of bf16 weights do not fit in
an SM's shared memory, so the layer here is seven launches of the
hand-written kernels in ``mdm_tpu_torch/csrc/layer_inference.cu``:

    qkv  = x . Wqkv^T + bqkv          gemm_bias_act        (dt)
    ctx  = softmax(qk^T/sqrt(Dh)+m) v attention_rowmask    (dt)
    attn = ctx . Wo^T + bo            gemm_bias_act        (dt)
    y    = LN1(x + attn)              residual_layernorm   (dt, and y32 in f32)
    h    = gelu(y . W1^T + b1)        gemm_bias_act        (dt)
    o    = h . W2^T + b2              gemm_bias_act        (f32)
    z    = LN2(y32 + o)               residual_layernorm   (dt)

What bounds it on an H100, and what the design does about it:

- At the CFG batch of sampling (B=64 rows of S=197 at the flagship) the
  four GEMMs carry ~90% of the layer's ~58 GFLOP, so it is bound by
  tensor-core throughput. The bf16 GEMMs run WMMA tensor-core fragments
  with f32 accumulators on cp.async double-buffered tiles, the attention
  runs Q.K^T and P.V on WMMA fragments; the f32 path
  (compute_dtype="float32") runs plain FMA kernels.
- At serving batch 1 (B=2 after CFG) a layer is a few microseconds of work
  and the bound is the launch count: 7 per layer, 56 per denoiser forward.
  Every launch goes asynchronously onto the current stream; the wrapper
  allocates with torch.empty (the caching allocator) and never
  synchronises, so the host runs ahead of the card.

The precision contract is the TPU kernel's: f32 accumulation, and rounding
to the working type only at q/k/v, P, ctx, attn, y, the GELU output and z;
the LN2 residual y32 + o stays f32; LayerNorm variance is E[s^2] - E[s]^2.

``layer_inference_reference`` is the plain PyTorch version with the same
signature and the same rounding points. ``fused_layer_inference`` uses it
for a tensor on the CPU; on a CUDA tensor it launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from ._mask import row_bias_contrib

LAUNCHES = 0  # kernel-chain launches of fused_layer_inference (one per layer call)

_LN_EPS = 1e-5
_INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _scale(head_dim: int) -> float:
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _layernorm(s: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row LayerNorm in f32 with one-pass variance (encoder_tail.py::_ln_fwd)."""
    mu = s.mean(dim=-1, keepdim=True)
    var = (s * s).mean(dim=-1, keepdim=True) - mu * mu
    return (s - mu) * torch.rsqrt(var + _LN_EPS) * g + b


def layer_inference_reference(
    x: torch.Tensor,  # [B, S, D], heads packed in D
    wqkv, bqkv,  # self_attn.in_proj_weight [3D, D] / in_proj_bias [3D]
    wo, bo,  # self_attn.out_proj [D, D] / [D]
    g1, bl1,  # norm1 weight / bias [D]
    w1, b1,  # linear1 [F, D] / [F]
    w2, b2,  # linear2 [D, F] / [D]
    g2, bl2,  # norm2 weight / bias [D]
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool True=ignore, or additive f32
) -> torch.Tensor:
    """Plain PyTorch version of the kernel chain, at the kernel's rounding
    points: every product is ``a.float() @ w.float().T + b.float()`` (the
    TPU kernel's preferred_element_type=f32), parameters are first rounded
    to x's dtype as the kernel's wrapper does."""
    B, S, D = x.shape
    dt = x.dtype
    H = num_heads
    Dh = D // H
    par = lambda t: t.to(dt).float()
    lin = lambda a, w, b: a.float() @ par(w).T + par(b)

    qkv = lin(x, wqkv, bqkv).to(dt)
    q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2) for t in qkv.split(D, dim=-1))
    logits = q.float() @ k.float().transpose(-1, -2) * _scale(Dh)
    if key_padding_mask is not None:
        logits = logits + row_bias_contrib(key_padding_mask)[:, None, None, :]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    ctx = (p.to(dt).float() @ v.float()).to(dt).transpose(1, 2).reshape(B, S, D)
    attn = lin(ctx, wo, bo).to(dt)

    y32 = _layernorm(x.float() + attn.float(), par(g1), par(bl1))
    u = lin(y32.to(dt), w1, b1)
    hd = (u * 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))).to(dt)
    o = lin(hd, w2, b2)
    return _layernorm(y32 + o, par(g2), par(bl2)).to(dt)


def check_kernel_operands(x: torch.Tensor, weights, num_heads: int,
                          key_padding_mask: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError for operands the CUDA kernels do not take: a
    device, dtype or shape the kernels would read out of bounds with."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {x.dtype}")
    B, S, D = x.shape
    F = weights[6].shape[0]
    if D % num_heads:
        raise ValueError(f"d_model {D} is not divisible by num_heads {num_heads}")
    if D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {D // num_heads} not in {_HEAD_DIMS}")
    if D % 16 or F % 16:
        raise ValueError(f"d_model {D} and ff_size {F} must be multiples of 16")
    shapes = [(3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,), (F, D), (F,), (D, F), (D,),
              (D,), (D,)]
    operands = list(zip(weights, shapes))
    if key_padding_mask is not None:
        operands.append((key_padding_mask, (B, S)))
    for i, (t, shape) in enumerate(operands):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"operand {i + 1}: {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {x.device}")


def _dev(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Contiguous, 16-byte aligned copy in dt (a no-op when it already is)."""
    t = t.to(dt).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_layer_inference(
    x, wqkv, bqkv, wo, bo, g1, bl1, w1, b1, w2, b2, g2, bl2,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One full post-LN encoder layer, forward only (sampling/eval).

    Same signature as ``layer_inference_reference``. On a CPU tensor it runs
    that plain version; on a CUDA tensor it runs the kernel chain and adds
    one to ``LAUNCHES``. There is no fallback: a build or launch failure
    raises."""
    if x.device.type == "cpu":
        return layer_inference_reference(
            x, wqkv, bqkv, wo, bo, g1, bl1, w1, b1, w2, b2, g2, bl2,
            num_heads, key_padding_mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_inference runs on cpu or cuda, not {x.device}")
    global LAUNCHES
    weights = (wqkv, bqkv, wo, bo, g1, bl1, w1, b1, w2, b2, g2, bl2)
    check_kernel_operands(x, weights, num_heads, key_padding_mask)
    F = w1.shape[0]
    B, S, D = x.shape
    M = B * S
    dt = x.dtype
    code = _DTYPES[dt]
    xs = _dev(x, dt)
    wqkv, bqkv, wo, bo, g1, bl1, w1, b1, w2, b2, g2, bl2 = (_dev(t, dt) for t in weights)
    mask = None
    if key_padding_mask is not None:
        mask = _dev(row_bias_contrib(key_padding_mask), torch.float32)

    lib = _build.load_library()
    with torch.cuda.device(x.device):
        empty = lambda n, t=dt: torch.empty((M, n), dtype=t, device=x.device)
        qkv, ctx, attn, y, h, z = empty(3 * D), empty(D), empty(D), empty(D), empty(F), empty(D)
        y32, o = empty(D, torch.float32), empty(D, torch.float32)
        st = torch.cuda.current_stream(x.device).cuda_stream
        p = lambda t: None if t is None else t.data_ptr()
        gemm = lib.mdm_gemm_bias_act
        _build.check(gemm(p(xs), p(wqkv), p(bqkv), p(qkv), M, 3 * D, D, code, 0, 0, st), "qkv gemm")
        _build.check(lib.mdm_attention_rowmask(p(qkv), p(mask), p(ctx), B, S, num_heads,
                                               D // num_heads, code, st), "attention")
        _build.check(gemm(p(ctx), p(wo), p(bo), p(attn), M, D, D, code, 0, 0, st), "out_proj gemm")
        _build.check(lib.mdm_residual_layernorm(p(xs), p(attn), p(g1), p(bl1), p(y), p(y32),
                                                M, D, code, 0, st), "norm1")
        _build.check(gemm(p(y), p(w1), p(b1), p(h), M, F, D, code, 0, 1, st), "linear1 gemm")
        _build.check(gemm(p(h), p(w2), p(b2), p(o), M, D, F, code, 1, 0, st), "linear2 gemm")
        _build.check(lib.mdm_residual_layernorm(p(y32), p(o), p(g2), p(bl2), p(z), None,
                                                M, D, code, 1, st), "norm2")
    LAUNCHES += 1
    return z.view(B, S, D)
