"""Training attention with probability dropout on the model's [B, S, H*Dh]
layout, forward and backward, as hand-written Hopper kernels.

Replaces mdm_tpu/ops/attention_dropout.py::fused_dropout_attention: the
Pallas kernels ``_call_fwd`` (kernel #7, ``pallas_call`` at :181,187) and
``_call_bwd`` (kernel #8, at :214,220) run one program per batch cell, draw
the keep mask from the TPU PRNG and replay it in the backward, which
recomputes the probabilities: nothing of size [B, H, S, S] is stored. It is
the training self-attention of the JAX package's opt-in
``enable_pallas_train_attention`` route (``models/layers.py``
use_dropout_kernel), which the training shootout's ``drop`` variant drives;
the q/k/v and out projections stay outside the kernel. Kernel #9, the bits
dump, is ops/dropout_bits.py::dropout_bits.

On the card (``csrc/attention.cu``, the core the train block shares, with
the [B, S, H*Dh] view and the key-padding row):

    forward   out = dropout(softmax(q k^T / sqrt(Dh) + m)) v      attn_fwd
    backward  dq  (row statistics, per query tile)                attn_bwd_dq
              dk, dv (per key tile, from those statistics)        attn_bwd_dkv

The keep mask is Philox4x32-10 keyed on (seed; batch, head, query row, key
column), drawn in-kernel in both directions: the stream ``dropout_bits``
dumps, so an injected dump gives the in-kernel result bit for bit. Keep
where bits < t with t = ``keep_threshold(rate)``, kept values scaled by
np.float32(1 / (1 - rate)). dq, dk and dv are each written by one block,
without float atomics, so two backward runs are bitwise equal.

What bounds it on an H100: at the flagship step (B=128, S=197, D=512, H=4,
bf16) the forward's products are 10.2 GFLOP, ~10 us of tensor-core time,
and its operands and f32 output ~129 MB (with injected bits ~208 MB), ~39
us at 3.35 TB/s; the exp and Philox words per probability come on top. The
backward reads q, k, v and dout (rounded to q's dtype) and writes three
bf16 gradients, ~181 MB.

Rounding points: p in f32; w = keep ? p / (1 - rate) : 0 rounded to v's
dtype before w . v; out accumulated in f32 and returned in f32, as the JAX
function's (its pre-scale promotes a bf16 q to f32). Backward: dout
rounded to q's dtype; dw = dout . v^T and delta = rowsum(keep dw p) in f32;
dv = w^T . dout; dlog = p (keep dw - delta) / sqrt(Dh) rounded to q's
dtype; dq = dlog . k and dk = dlog^T . q, the three accumulated in f32
and stored in q's dtype (round to nearest even, as torch's cast). The JAX
backward runs all of it in f32 and returns f32 gradients; in bf16 the two
differ by those roundings (the CPU tests hold them at a bf16 tolerance).
torch's autograd casts a gradient to its input's dtype in any case, so dq,
dk and dv enter the projections' backward rounded to bf16 where JAX
carries f32. The plain backward returns them unrounded, in f32.

``dropout_attention_reference`` and ``dropout_attention_bwd_reference``
are the plain PyTorch versions; the wrapper runs them for a CPU tensor,
drawing the kernel's Philox bits on the CPU when none are injected. A
query row whose every real key is masked is not supported (see
ops/attention_v2.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from ._chain import (attention_bwd, attention_fwd, bsd_view, check_dtype, check_head_dim,
                     check_shapes, dev, dropout_args, row_bias_strides)
from ._mask import row_bias_contrib
from .attention import attention_probs, attention_scale, merge_heads, split_heads
from .attention_train_block import _keep
from .dropout_bits import dropout_bits

LAUNCHES = {"fwd": 0, "bwd": 0}  # kernel launches of fused_dropout_attention per direction


def _row_bias(key_padding_mask):
    return None if key_padding_mask is None else row_bias_contrib(key_padding_mask)[:, None,
                                                                                     None, :]


def dropout_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,  # [B, S, D] heads packed in D
    num_heads: int,
    rate: float = 0.0,
    bits: Optional[torch.Tensor] = None,  # [B, H, S, S] uint32, needed when rate > 0
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool True=ignore, or additive f32
) -> torch.Tensor:
    """Plain forward at the kernel's rounding points -> f32 [B, S, D]."""
    p = attention_probs(split_heads(q, num_heads), split_heads(k, num_heads),
                        _row_bias(key_padding_mask))
    keep = _keep(bits, rate)
    w = (p if keep is None else p * keep).to(v.dtype)
    return merge_heads(w.float() @ split_heads(v, num_heads).float())


def dropout_attention_bwd_reference(q, k, v, num_heads: int, dout: torch.Tensor,
                                    rate: float = 0.0, bits: Optional[torch.Tensor] = None,
                                    key_padding_mask: Optional[torch.Tensor] = None):
    """Plain backward at the kernel's rounding points -> f32 (dq, dk, dv),
    each [B, S, D]."""
    dt = q.dtype
    qh, kh, vh = (split_heads(t, num_heads) for t in (q, k, v))
    p = attention_probs(qh, kh, _row_bias(key_padding_mask))
    keep = _keep(bits, rate)
    w = (p if keep is None else p * keep).to(dt).float()
    dctx = split_heads(dout.to(dt), num_heads).float()
    dv = w.transpose(-1, -2) @ dctx
    dp = dctx @ vh.float().transpose(-1, -2)
    if keep is not None:
        dp = keep * dp
    scale = attention_scale(qh.shape[-1])
    dlog = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(dt).float()
    dq = dlog @ kh.float()
    dk = dlog.transpose(-1, -2) @ qh.float()
    return merge_heads(dq), merge_heads(dk), merge_heads(dv)


def _check(q, k, v, num_heads, mask, bits):
    if q.dim() != 3:
        raise ValueError(f"q must be [B, S, D], got {tuple(q.shape)}")
    B, S, D = q.shape
    check_dtype(q, "fused_dropout_attention")
    check_shapes(q, [(k, q.shape), (v, q.shape), (mask, (B, S)), (bits, (B, num_heads, S, S))],
                 "fused_dropout_attention")
    if bits is not None and bits.dtype != torch.uint32:
        raise ValueError(f"bits must be uint32, got {bits.dtype}")
    return check_head_dim(D, num_heads, "fused_dropout_attention")


def _fwd_cuda(q, k, v, mask, bits, num_heads, rate, seed, boff=0):
    Dh = _check(q, k, v, num_heads, mask, bits)
    B, S, D = q.shape
    out = torch.empty((B, S, D), dtype=torch.float32, device=q.device)
    view = bsd_view(S, D, Dh)
    attention_fwd(q, k, v, view, out, view, B, S, num_heads, Dh, mask, row_bias_strides(S),
                  dropout_args(bits, seed, rate, boff))
    return out


def _bwd_cuda(q, k, v, mask, bits, num_heads, rate, seed, boff, dout):
    B, S, D = q.shape
    Dh = D // num_heads
    grads = [torch.empty((B, S, D), dtype=q.dtype, device=q.device) for _ in range(3)]
    view = bsd_view(S, D, Dh)
    attention_bwd(q, k, v, view, dev(dout, q.dtype), view, *grads, B, S, num_heads, Dh, mask,
                  row_bias_strides(S), dropout_args(bits, seed, rate, boff))
    return grads


class _DropoutAttention(torch.autograd.Function):
    """Seed-replay VJP: the backward recomputes p and replays the bits.
    Every tensor it reads is saved through ``save_for_backward``, so a
    checkpointed layer (``MDMConfig.remat``) drops and recomputes them."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bits, num_heads, rate, seed, boff):
        ctx.meta = (num_heads, rate, seed, boff)
        if q.device.type == "cuda":
            out = _fwd_cuda(q, k, v, mask, bits, num_heads, rate, seed, boff)
            LAUNCHES["fwd"] += 1
        else:
            if rate > 0.0 and bits is None:  # the kernel's own Philox stream, drawn on the CPU
                bits = dropout_bits(seed, q.shape[0], num_heads, q.shape[1], device=q.device,
                                    batch_offset=boff)
            out = dropout_attention_reference(q, k, v, num_heads, rate, bits, mask)
        ctx.save_for_backward(q, k, v, mask, bits)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, bits = ctx.saved_tensors
        num_heads, rate, seed, boff = ctx.meta
        if q.device.type == "cuda":
            grads = _bwd_cuda(q, k, v, mask, bits, num_heads, rate, seed, boff, dout)
            LAUNCHES["bwd"] += 1
        else:
            grads = dropout_attention_bwd_reference(q, k, v, num_heads, dout, rate, bits, mask)
        return (*grads, None, None, None, None, None, None)


def fused_dropout_attention(
    q: torch.Tensor,  # [B, S, D] heads packed in D
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    rate: float,
    seed: int,  # int32, drawn per layer per step
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool True=ignore, or additive f32
    bits: Optional[torch.Tensor] = None,  # [B, H, S, S] uint32: injected (use_prng=False)
    batch_offset: int = 0,  # global batch index of row 0 (data parallelism)
) -> torch.Tensor:
    """Training attention with probability dropout, differentiable in q, k
    and v; f32 [B, S, D] output.

    On a CPU tensor the plain versions run; on a CUDA tensor the kernels
    run (forward and backward each add one to ``LAUNCHES``) or raise.
    ``bits`` replaces the in-kernel Philox draw with the given bits;
    ``batch_offset`` moves the draw's batch word."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dropout_attention runs on cpu or cuda, not {q.device}")
    mask = None if key_padding_mask is None else row_bias_contrib(key_padding_mask)
    if q.device.type == "cuda":
        dt = q.dtype
        q, k, v = dev(q), dev(k, dt), dev(v, dt)
        mask = None if mask is None else dev(mask)
        bits = None if bits is None else dev(bits)
    return _DropoutAttention.apply(q, k, v, mask, bits, num_heads, float(rate), int(seed),
                                   int(batch_offset))
