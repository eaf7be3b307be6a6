"""One whole post-LN encoder layer, forward only, as a chain of Hopper kernels.

Replaces mdm_tpu/ops/layer_inference.py::fused_layer_inference, the Pallas
kernel that runs a layer as one program per batch cell with every weight
resident in VMEM. A flagship layer's ~4.2 MB of bf16 weights do not fit in
an SM's shared memory, so the layer here is a chain of the hand-written
kernels in ``mdm_tpu_torch/csrc/``. The TPU kernel's own note says its
attention half is "identical math to attention_train_block's rate-0
forward", so that is what runs it here:

    attn = ctx . Wo^T + bo, ctx = softmax(qk^T/sqrt(Dh)+m) v,
    q|k|v = x . Wqkv^T + bqkv         attention_train_block's forward chain
                                      at rate 0: gemm, attention_fwd, gemm (dt)
    y    = LN1(x + attn)              residual_layernorm   (dt, and y32 in f32)
    h    = gelu(y . W1^T + b1)        gemm, GELU epilogue  (dt)
    o    = h . W2^T + b2              gemm                 (f32)
    z    = LN2(y32 + o)               residual_layernorm   (dt)

What bounds it on an H100, and what the design does about it:

- At the CFG batch of sampling (B=64 rows of S=197 at the flagship) the
  four products carry ~90% of the layer's ~58 GFLOP, so it is bound by
  tensor-core throughput. The bf16 products run ``csrc/gemm_sm90.cu``
  (wgmma fed by TMA, persistent over 128x128 tiles), the attention the
  forward core of ``csrc/attention.cu``; the LayerNorm
  (``csrc/layer_inference.cu``) reads each row once. The f32 path
  (compute_dtype="float32") runs the FMA products and the f32 attention.
- At serving batch 1 (B=2 after CFG) a layer is a few microseconds of work
  and the bound is the launch count: 7 per layer, 56 per denoiser forward.
  Every launch goes asynchronously onto the current stream; the wrapper
  allocates with torch.empty (the caching allocator) and never
  synchronises, so the host runs ahead of the card.

The precision contract is the TPU kernel's: f32 accumulation, and rounding
to the working type only at q/k/v, P, ctx, attn, y, the GELU output and z;
the LN2 residual y32 + o stays f32; LayerNorm variance is E[s^2] - E[s]^2.

``layer_inference_reference`` is the plain PyTorch version with the same
signature and the same rounding points: the training block's and tail's
plain versions at rate 0, whose rounding points these are too.
``fused_layer_inference`` uses it for a tensor on the CPU; on a CUDA
tensor it launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._chain import DTYPES, check_head_dim, dev, gemm, ptr, stream
from .attention_train_block import _fwd_chain, _mask_row, train_attention_block_reference
from .encoder_tail import encoder_tail_reference

LAUNCHES = 0  # kernel-chain launches of fused_layer_inference (one per layer call)


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
    attn = train_attention_block_reference(x, wqkv, bqkv, wo, bo, num_heads,
                                           key_padding_mask=key_padding_mask)
    return encoder_tail_reference(x, attn, g1, bl1, w1, b1, w2, b2, g2, bl2)


def check_kernel_operands(x: torch.Tensor, weights, num_heads: int,
                          key_padding_mask: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError for operands the CUDA kernels do not take: a
    device, dtype or shape the kernels would read out of bounds with."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {x.dtype}")
    B, S, D = x.shape
    F = weights[6].shape[0]
    check_head_dim(D, num_heads, "fused_layer_inference")
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


def residual_layernorm(a: torch.Tensor, r: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
                       dt: torch.dtype, keep_f32: bool = False):
    """LN(a + r) * g + beta over the rows of [M, D] a and r (both dt, or
    both f32), in f32 (csrc/layer_inference.cu). Returns the result in dt
    and, when keep_f32, in f32 too (else None)."""
    M, D = a.shape
    out = torch.empty((M, D), dtype=dt, device=a.device)
    out32 = torch.empty((M, D), dtype=torch.float32, device=a.device) if keep_f32 else None
    inputs_f32 = int(a.dtype == torch.float32 and dt != torch.float32)
    _build.check(_build.load_library().mdm_residual_layernorm(
        ptr(a), ptr(r), ptr(g), ptr(beta), ptr(out), ptr(out32), M, D, DTYPES[dt], inputs_f32,
        stream(a)), "residual layernorm")
    return out, out32


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
    B, S, D = x.shape
    dt = x.dtype
    xs = dev(x, dt)
    wqkv, bqkv, wo, bo, g1, bl1, w1, b1, w2, b2, g2, bl2 = (dev(t, dt) for t in weights)
    with torch.cuda.device(x.device):
        x2 = xs.view(B * S, D)
        attn = _fwd_chain(x2, S, wqkv, bqkv, wo, bo, _mask_row(x, key_padding_mask), None,
                          num_heads, 0.0, 0)[0]
        y, y32 = residual_layernorm(x2, attn, g1, bl1, dt, keep_f32=True)
        h = gemm(y, w1, bias=b1, gelu=True)
        o = gemm(h, w2, bias=b2, out_f32=True)
        z, _ = residual_layernorm(y32, o, g2, bl2, dt)
    LAUNCHES += 1
    return z.view(B, S, D)
