"""Fused multi-head attention on [B, H, S, Dh] with a full additive bias,
forward only, as one hand-written Hopper kernel.

Replaces mdm_tpu/ops/attention.py::fused_attention, whose Pallas kernel
``_fused_attention_pallas`` (kernel #10, ``pallas_call`` at :76) runs one
program per (batch, head) with q, k, v and the [S, S] bias tile in VMEM,
on operands padded to 128 rows and 128 head columns. On the card it is the
forward of ``csrc/attention.cu`` with the head-major view and a bias of
shape [B, 1|H, 1|S, S]: no padding, any S, any head dim.

What bounds it on an H100: at the sampling shape (B=64, H=4, S=197,
Dh=128, bf16) the products are 5.1 GFLOP, ~5 us of tensor-core time, while
the operands, the f32 output and a full [B, H, S, S] f32 bias move ~105 MB,
~31 us at 3.35 TB/s: the bytes bound it, the bias most of all. The kernel
reads each key tile twice (row statistics, then p . v) from L2.

The arithmetic is the TPU kernel's: logits q . k^T in f32, scaled by
1/sqrt(Dh), plus the bias; a two-pass softmax in f32; p rounded to v's
dtype before p . v, accumulated in f32. The output is f32, as the JAX
function's: its pre-scale ``q * (1.0 / np.sqrt(Dh))`` promotes a bf16 q to
f32 (``out_shape`` is q's dtype). The kernel multiplies bf16 q . k^T by the
scale in f32 instead, which differs from (q s) . k^T by f32 rounding only.

``xla_attention`` is the plain PyTorch version at those rounding points;
``fused_attention`` runs it for a CPU tensor. (The JAX ``xla_attention``
rounds the logits and the output to q's dtype; in f32 the two agree.) A
query row whose every real key is masked averages v over the padded keys
in JAX but over the S real keys here; MDM never builds such a row.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._chain import attention_fwd, bhsd_view, check_dtype, check_head_dim, check_shapes, dev

LAUNCHES = 0  # kernel launches of fused_attention


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*Dh] -> a [B, H, S, Dh] view."""
    B, S, D = t.shape
    return t.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] -> [B, S, H*Dh]."""
    B, H, S, Dh = t.shape
    return t.transpose(1, 2).reshape(B, S, H * Dh)


def attention_scale(head_dim: int) -> float:
    """np.float32(1 / sqrt(Dh)), the kernels' softmax scale."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def attention_probs(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """f32 softmax(q k^T / sqrt(Dh) + bias) of [B, H, S, Dh] q and k; bias
    broadcasts against [B, H, S, S]."""
    logits = q.float() @ k.float().transpose(-1, -2) * attention_scale(q.shape[-1])
    if bias is not None:
        logits = logits + bias.float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel: [B, H, S, Dh] operands, bias
    [B, 1|H, 1|S, S] additive or None -> f32 [B, H, S, Dh]."""
    p = attention_probs(q, k, bias)
    return p.to(v.dtype).float() @ v.float()


def _bias_strides(bias: torch.Tensor, B: int, H: int, S: int):
    """(batch, head, query row) strides of a [B, 1|H, 1|S, S] bias."""
    if bias.dim() != 4 or bias.shape[0] != B or bias.shape[1] not in (1, H) \
            or bias.shape[2] not in (1, S) or bias.shape[3] != S:
        raise ValueError(f"bias must be [B, 1|H, 1|S, S] = [{B}, 1|{H}, 1|{S}, {S}], "
                         f"got {tuple(bias.shape)}")
    Hb, Sb = bias.shape[1], bias.shape[2]
    return Hb * Sb * S, 0 if Hb == 1 else Sb * S, S if Sb == S else 0


def fused_attention(
    q: torch.Tensor,  # [B, H, S, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # [B, 1|H, 1|S, S] additive
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + bias) v per (batch, head), f32 output.

    On a CPU tensor it runs ``xla_attention``; on a CUDA tensor it launches
    the kernel (adding one to ``LAUNCHES``) or raises."""
    if q.device.type == "cpu":
        return xla_attention(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, Dh], got {tuple(q.shape)}")
    B, H, S, Dh = q.shape
    check_shapes(q, [(k, q.shape), (v, q.shape)], "fused_attention")
    check_dtype(q, "fused_attention")
    check_head_dim(H * Dh, H, "fused_attention")
    dt = q.dtype
    strides = (0, 0, 0)
    if bias is not None:
        strides = _bias_strides(bias, B, H, S)
        check_shapes(q, [(bias, bias.shape)], "fused_attention bias")
        bias = dev(bias, torch.float32)
    out = torch.empty((B, H, S, Dh), dtype=torch.float32, device=q.device)
    view = bhsd_view(H, S, Dh)
    attention_fwd(dev(q), dev(k, dt), dev(v, dt), view, out, view, B, S, H, Dh, bias, strides)
    global LAUNCHES
    LAUNCHES += 1
    return out
