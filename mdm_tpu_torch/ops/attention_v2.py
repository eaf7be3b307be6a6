"""Fused attention on the model's [B, S, H*Dh] layout with a key-padding
row, forward only, as one hand-written Hopper kernel.

Replaces mdm_tpu/ops/attention_v2.py::fused_attention_v2, whose Pallas
kernel ``_fused_attention_v2`` (kernel #11, ``pallas_call`` at :69) runs
one program per batch cell and loops over the heads, on q/k/v padded to
128 rows. It is the deterministic self-attention of the JAX package's
opt-in ``enable_pallas_attention`` route (``models/layers.py`` use_v2),
which the sampling shootout's ``pallas`` variant drives. On the card it is
the forward of ``csrc/attention.cu`` with the [B, S, H*Dh] view (head h at
columns h*Dh, no transposes) and the row bias: one block per (batch, head,
64-row query tile), no padding.

What bounds it on an H100: at the sampling shape (CFG batch 64, S=197,
D=512, H=4, bf16) the products are 5.1 GFLOP, ~5 us of tensor-core time,
and the operands and the f32 output ~65 MB, ~19 us at 3.35 TB/s: the bytes
bound it.

The arithmetic and the f32 output are those of ops/attention.py (the JAX
wrapper's pre-scale promotes a bf16 q to f32, so the JAX output is f32 and
the layer casts it to its compute dtype). The mask is
``ops/_mask.py::row_bias_contrib``'s: a bool row becomes 0/-1e9, a float
row passes unchanged. A query row whose every real key is masked averages
v over the padded keys in JAX but over the S real keys here; MDM never
builds such a row (the condition token is always kept).
"""
from __future__ import annotations

from typing import Optional

import torch

from ._chain import (attention_fwd, bsd_view, check_dtype, check_head_dim, check_shapes, dev,
                     row_bias_strides)
from ._mask import row_bias_contrib
from .attention import merge_heads, split_heads, xla_attention

LAUNCHES = 0  # kernel launches of fused_attention_v2


def attention_v2_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: [B, S, D] q, k, v (heads packed in D) -> f32 [B, S, D]."""
    bias = None if key_padding_mask is None else row_bias_contrib(key_padding_mask)[:, None,
                                                                                    None, :]
    return merge_heads(xla_attention(split_heads(q, num_heads), split_heads(k, num_heads),
                                     split_heads(v, num_heads), bias))


def fused_attention_v2(
    q: torch.Tensor,  # [B, S, D] heads packed in D
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool True=ignore, or additive f32
) -> torch.Tensor:
    """Multi-head attention with a key-padding row, f32 [B, S, D] output.

    On a CPU tensor it runs ``attention_v2_reference``; on a CUDA tensor it
    launches the kernel (adding one to ``LAUNCHES``) or raises."""
    if q.device.type == "cpu":
        return attention_v2_reference(q, k, v, num_heads, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_v2 runs on cpu or cuda, not {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, S, D], got {tuple(q.shape)}")
    B, S, D = q.shape
    check_dtype(q, "fused_attention_v2")
    Dh = check_head_dim(D, num_heads, "fused_attention_v2")
    check_shapes(q, [(k, q.shape), (v, q.shape), (key_padding_mask, (B, S))],
                 "fused_attention_v2")
    mask = None if key_padding_mask is None else dev(row_bias_contrib(key_padding_mask))
    out = torch.empty((B, S, D), dtype=torch.float32, device=q.device)
    view = bsd_view(S, D, Dh)
    dt = q.dtype
    attention_fwd(dev(q), dev(k, dt), dev(v, dt), view, out, view, B, S, num_heads, Dh, mask,
                  row_bias_strides(S))
    global LAUNCHES
    LAUNCHES += 1
    return out
