"""The training self-attention block with probability dropout, forward and
backward, as chains of hand-written Hopper kernels.

Replaces mdm_tpu/ops/attention_train_block.py: ``_call_fwd`` (kernel #2,
``pallas_call`` at :286,294) and ``_call_bwd`` (kernel #3, at :334,344),
which run one program per batch cell with the four [D, D] weights resident
in VMEM. On the card the block is three launches forward and seven
backward (``csrc/gemm_sm90.cu`` and ``csrc/gemm.cu``, ``csrc/attention.cu``):

    forward   qkv  = x . Wqkv^T + bqkv                  gemm        (dt)
              ctx  = dropout(softmax(q k^T/sqrt(Dh) + m)) v
                                                        attn_fwd    (dt)
              out  = ctx . Wo^T + bo                    gemm        (dt)
    backward  dctx = dO . Wo                            gemm        (dt)
              ctx, dq, dk, dv (recomputed p, replayed bits)
                                                        attn_fwd, attn_bwd_dq,
                                                        attn_bwd_dkv
              dWo  = dO^T ctx, dWqkv = dqkv^T x         gemm, split-K (f32)
              dbo, dbqkv                                colsum      (f32)
              dx   = dqkv . Wqkv                        gemm        (dt)

What bounds it on an H100, and what the design does about it: at the
flagship step (B=128, S=197, D=512) the products carry ~85% of the ~0.3
TFLOP of a layer's forward and backward, so it is bound by tensor-core
throughput; the forward's two products and the backward's four run the
wgmma kernel of ``csrc/gemm_sm90.cu``, with f32 accumulation.
No [B, H, S, S] tensor is stored in either direction: the backward
recomputes the probabilities and replays the dropout bits, which are
Philox4x32-10 keyed on the element's (batch, head, row, column), never on
a tile or thread. The weight gradients reduce over all B*S rows in fixed
split-K chunks summed in order, and the column sums in fixed row chunks:
no float atomics, so two backward runs are bitwise equal. The backward
reuses the forward's qkv instead of recomputing it (one GEMM less, 6*M*D
bytes of activation memory more per layer).

The rounding points are the TPU kernel's: q/k/v, the dropped probabilities
w = keep ? p/(1-rate) : 0, ctx and out to dt; backward dctx, the recomputed
ctx, dv, dlog, dq, dk to dt, dx accumulated in f32 over the three
projections then cast to dt; dbo sums dO in f32. The weight and bias
gradients come back rounded to dt, as ``_block_core_bwd``'s ``cast``.

``train_attention_block_reference`` and ``train_attention_block_bwd_reference``
are the plain PyTorch versions with those rounding points; the wrapper
runs them for a CPU tensor, drawing the same Philox bits on the CPU
(ops/dropout_bits.py) when none are injected.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._chain import (attention_bwd, attention_fwd, bsd_view, check_dtype, check_head_dim,
                     check_shapes, colsum, dev, dropout_args, gemm, row_bias_strides, splits_for)
from ._mask import row_bias_contrib
from .attention import attention_probs, attention_scale, merge_heads, split_heads
from .dropout_bits import dropout_bits, keep_factors

LAUNCHES = {"fwd": 0, "bwd": 0}  # kernel-chain launches, one per block call


def _probs(x, wqkv, bqkv, num_heads, key_padding_mask):
    """q, k, v [B, H, S, Dh] in dt and the softmax p [B, H, S, S] in f32."""
    dt = x.dtype
    D = x.shape[-1]
    qkv = (x.float() @ wqkv.to(dt).float().T + bqkv.to(dt).float()).to(dt)
    q, k, v = (split_heads(t, num_heads) for t in qkv.split(D, dim=-1))
    bias = None
    if key_padding_mask is not None:
        bias = row_bias_contrib(key_padding_mask)[:, None, None, :]
    return q, k, v, attention_probs(q, k, bias)


def _keep(bits, rate):
    if rate <= 0.0:
        return None
    if bits is None:
        raise ValueError("rate > 0 needs the dropout bits")
    return keep_factors(bits, rate)


def train_attention_block_reference(
    x: torch.Tensor,  # [B, S, D] heads packed in D
    wqkv, bqkv,  # self_attn.in_proj_weight [3D, D] / in_proj_bias [3D]
    wo, bo,  # self_attn.out_proj [D, D] / [D]
    num_heads: int,
    rate: float = 0.0,
    bits: Optional[torch.Tensor] = None,  # [B, H, S, S] uint32, needed when rate > 0
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool True=ignore, or additive f32
) -> torch.Tensor:
    """Plain forward at _fwd_kernel's rounding points; parameters are first
    rounded to x's dtype as the kernel's wrapper does."""
    dt = x.dtype
    _, _, v, p = _probs(x, wqkv, bqkv, num_heads, key_padding_mask)
    keep = _keep(bits, rate)
    w = (p if keep is None else p * keep).to(dt)
    ctx = merge_heads((w.float() @ v.float()).to(dt))
    return (ctx.float() @ wo.to(dt).float().T + bo.to(dt).float()).to(dt)


def train_attention_block_bwd_reference(
    x, wqkv, bqkv, wo, num_heads: int, dout: torch.Tensor, rate: float = 0.0,
    bits: Optional[torch.Tensor] = None, key_padding_mask: Optional[torch.Tensor] = None,
):
    """Plain backward at _bwd_kernel's rounding points. Returns (dx in dt,
    dWqkv [3D, D], dbqkv [3D], dWo [D, D], dbo [D]), the last four in f32
    (summed over the batch, as the TPU kernel's accumulators)."""
    dt = x.dtype
    D = x.shape[-1]
    q, k, v, p = _probs(x, wqkv, bqkv, num_heads, key_padding_mask)
    keep = _keep(bits, rate)
    w16 = (p if keep is None else p * keep).to(dt)
    dob = dout.to(dt)
    dctx = split_heads((dob.float() @ wo.to(dt).float()).to(dt), num_heads)  # dctx_h in dt
    ctx = merge_heads((w16.float() @ v.float()).to(dt))
    dwo = torch.einsum("bsn,bsk->nk", dob.float(), ctx.float())
    dbo = dout.float().sum(dim=(0, 1))
    dv = (w16.float().transpose(-1, -2) @ dctx.float()).to(dt)
    dp = dctx.float() @ v.float().transpose(-1, -2)
    if keep is not None:
        dp = keep * dp
    scale = attention_scale(D // num_heads)
    dlog = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(dt)
    dq = (dlog.float() @ k.float()).to(dt)
    dk = (dlog.float().transpose(-1, -2) @ q.float()).to(dt)
    dqkv = torch.cat([merge_heads(dq), merge_heads(dk), merge_heads(dv)], dim=-1)  # [B, S, 3D] dt
    dwqkv = torch.einsum("bsn,bsk->nk", dqkv.float(), x.float())
    dbqkv = dqkv.float().sum(dim=(0, 1))
    dx = (dqkv.float() @ wqkv.to(dt).float()).to(dt)
    return dx, dwqkv, dbqkv, dwo, dbo


def _check(x, wqkv, bqkv, wo, bo, num_heads, mask, bits):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    check_dtype(x, "attention block")
    B, S, D = x.shape
    check_head_dim(D, num_heads, "attention block")
    check_shapes(x, [(wqkv, (3 * D, D)), (bqkv, (3 * D,)), (wo, (D, D)), (bo, (D,)),
                     (mask, (B, S)), (bits, (B, num_heads, S, S))], "attention block")
    if bits is not None and bits.dtype != torch.uint32:
        raise ValueError(f"bits must be uint32, got {bits.dtype}")


def _fwd_cuda(x, wqkv, bqkv, wo, bo, mask, bits, num_heads, rate, seed, boff=0):
    """The forward chain; returns (out [B, S, D], qkv [B*S, 3D])."""
    _check(x, wqkv, bqkv, wo, bo, num_heads, mask, bits)
    B, S, D = x.shape
    out, qkv = _fwd_chain(dev(x).view(B * S, D), S, dev(wqkv), dev(bqkv), dev(wo), dev(bo), mask,
                          bits, num_heads, rate, seed, boff)
    return out.view(B, S, D), qkv


def _fwd_chain(x, S, wqkv, bqkv, wo, bo, mask, bits, num_heads, rate, seed, boff=0):
    """``_fwd_cuda`` on rows x [B*S, D] already checked and made ``dev``:
    (out [B*S, D], qkv). Every torch op here costs host time on every layer
    call, so k and v go to the attention as addresses, not views."""
    M, D = x.shape
    Dh = D // num_heads
    qkv = gemm(x, wqkv, bias=bqkv)
    ctx = torch.empty((M, D), dtype=x.dtype, device=x.device)
    col = D * qkv.element_size()
    attention_fwd(qkv, qkv.data_ptr() + col, qkv.data_ptr() + 2 * col, bsd_view(S, D, Dh, 3 * D),
                  ctx, bsd_view(S, D, Dh), M // S, S, num_heads, Dh, mask, row_bias_strides(S),
                  dropout_args(bits, seed, rate, boff))
    return gemm(ctx, wo, bias=bo), qkv


def _bwd_cuda(x, qkv, wqkv, wo, mask, bits, num_heads, rate, seed, boff, dout):
    B, S, D = x.shape
    M, dt = B * S, x.dtype
    xs = dev(x).view(M, D)
    do = dev(dout, dt).view(M, D)
    wqkv, wo = dev(wqkv), dev(wo)
    dctx = gemm(do, wo, b_kn=True)
    ctx = torch.empty((M, D), dtype=dt, device=x.device)
    dqkv = torch.empty((M, 3 * D), dtype=dt, device=x.device)
    Dh = D // num_heads
    packed = bsd_view(S, D, Dh, 3 * D)
    attention_bwd(*_split(qkv, D), packed, dctx, bsd_view(S, D, Dh), *_split(dqkv, D), B, S,
                  num_heads, Dh, mask, row_bias_strides(S), dropout_args(bits, seed, rate, boff),
                  ctx)
    dwo = gemm(do, ctx, a_km=True, b_kn=True, out_f32=True, splits=splits_for(D, D, M))
    dbo = colsum(do)
    dwqkv = gemm(dqkv, xs, a_km=True, b_kn=True, out_f32=True, splits=splits_for(3 * D, D, M))
    dbqkv = colsum(dqkv)
    dx = gemm(dqkv, wqkv, b_kn=True)
    return dx.view(B, S, D), dwqkv, dbqkv, dwo, dbo


def _split(qkv: torch.Tensor, D: int):
    """The q, k, v column blocks of a packed [M, 3D] tensor, as views."""
    return qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]


class _TrainBlock(torch.autograd.Function):
    """Seed-replay VJP: the backward recomputes p and replays the bits
    under the forward's seed and batch offset. Every tensor it reads (on
    the card also the forward's q/k/v) is saved through
    ``save_for_backward``, so a checkpointed layer (``MDMConfig.remat``)
    drops and recomputes them."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, mask, bits, num_heads, rate, seed, boff):
        ctx.meta = (num_heads, rate, seed, boff)
        qkv = None
        if x.device.type == "cuda":
            out, qkv = _fwd_cuda(x, wqkv, bqkv, wo, bo, mask, bits, num_heads, rate, seed, boff)
            LAUNCHES["fwd"] += 1
        else:
            if rate > 0.0 and bits is None:  # the kernel's own Philox stream, drawn on the CPU
                bits = dropout_bits(seed, x.shape[0], num_heads, x.shape[1], device=x.device,
                                    batch_offset=boff)
            out = train_attention_block_reference(x, wqkv, bqkv, wo, bo, num_heads, rate, bits,
                                                  mask)
        ctx.save_for_backward(x, wqkv, bqkv, wo, mask, bits, qkv)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, wqkv, bqkv, wo, mask, bits, qkv = ctx.saved_tensors
        num_heads, rate, seed, boff = ctx.meta
        if qkv is not None:
            grads = _bwd_cuda(x, qkv, wqkv, wo, mask, bits, num_heads, rate, seed, boff, dout)
            LAUNCHES["bwd"] += 1
        else:
            grads = train_attention_block_bwd_reference(x, wqkv, bqkv, wo, num_heads, dout,
                                                        rate, bits, mask)
        dx, dwqkv, dbqkv, dwo, dbo = grads
        dt = x.dtype
        return (dx, dwqkv.to(dt), dbqkv.to(dt), dwo.to(dt), dbo.to(dt),
                None, None, None, None, None, None)


def _mask_row(x, key_padding_mask):
    if key_padding_mask is None:
        return None
    m = row_bias_contrib(key_padding_mask)
    return dev(m) if x.device.type == "cuda" else m


def fused_train_attention_block(
    x: torch.Tensor,  # [B, S, D] heads packed in D
    wqkv, bqkv, wo, bo,  # torch layout: in_proj [3D, D] / [3D], out_proj [D, D] / [D]
    num_heads: int,
    rate: float,
    seed: int,  # int32, drawn per layer per step
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool True=ignore, or additive f32
    bits: Optional[torch.Tensor] = None,  # [B, H, S, S] uint32: injected (use_prng=False)
    batch_offset: int = 0,  # global batch index of row 0 (data parallelism)
) -> torch.Tensor:
    """Whole training attention block with probability dropout,
    differentiable in x and the four weights and biases.

    Parameters are cast to x's dtype inside the autograd graph, so their
    gradients come back rounded to it. On a CPU tensor the plain versions
    run; on a CUDA tensor the kernel chains run (forward and backward each
    add one to ``LAUNCHES``) or raise. ``bits`` replaces the in-kernel
    Philox draw with the given bits; ``batch_offset`` moves the draw's
    batch word, so rows [b0, b0 + B) drawn at b0 are those rows of a
    whole-batch call."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_train_attention_block runs on cpu or cuda, not {x.device}")
    dt = x.dtype
    if bits is not None and x.device.type == "cuda":
        bits = dev(bits)
    return _TrainBlock.apply(x, wqkv.to(dt), bqkv.to(dt), wo.to(dt), bo.to(dt),
                             _mask_row(x, key_padding_mask), bits, num_heads, float(rate),
                             int(seed), int(batch_offset))


@torch.no_grad()
def fused_block_attention_inference(
    x: torch.Tensor, wqkv, bqkv, wo, bo, num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward-only block at rate 0 (sampling): the training forward chain
    with no dropout; not differentiable."""
    if x.device.type == "cpu":
        return train_attention_block_reference(x, wqkv, bqkv, wo, bo, num_heads,
                                               key_padding_mask=key_padding_mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_attention_inference runs on cpu or cuda, not {x.device}")
    dt = x.dtype
    out = _fwd_cuda(x, wqkv.to(dt), bqkv.to(dt), wo.to(dt), bo.to(dt),
                    _mask_row(x, key_padding_mask), None, num_heads, 0.0, 0)[0]
    LAUNCHES["fwd"] += 1
    return out
