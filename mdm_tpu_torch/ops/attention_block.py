"""The forward-only attention block: q/k/v projections, attention and the
out projection, as a chain of hand-written Hopper kernels.

Replaces mdm_tpu/ops/attention_block.py::fused_attention_block, whose
Pallas kernel ``_fused_block`` (kernel #12, ``pallas_call`` at :84) runs
the whole block per batch cell with the four [D, D] weights in VMEM. No
model route of the JAX package calls it; it is a direct entry point, kept
here with the JAX signature: weights in the x . W layout ([D_in, D_out]),
a bool key-padding mask only (the JAX wrapper binarises any mask through
``jnp.where(mask, -1e9, 0)``; a float mask raises here).

On the card it is the rate-0 forward chain of ops/attention_train_block.py,
three launches: the packed q/k/v projection on ``csrc/gemm_sm90.cu`` (f32 bias
added to the f32 accumulator, then rounded to x's dtype, as
``attention_block.py:46-50``), the attention core of ``csrc/attention.cu``
(scale on the f32 logits, p rounded to x's dtype before p . v), and the out
projection on ``csrc/gemm_sm90.cu``. What bounds it on an H100: at the
sampling shape (B=64, S=197, D=512, bf16) the four projections carry 26.4
of the block's 31.5 GFLOP: tensor-core throughput, wgmma with f32
accumulation.

``attention_block_reference`` is the plain PyTorch version at those
rounding points (the train block's plain forward at rate 0).
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention_train_block import _fwd_cuda, _mask_row, train_attention_block_reference

LAUNCHES = 0  # kernel-chain launches of fused_attention_block


def _packed(wq, bq, wk, bk, wv, bv, wo):
    """JAX-layout [D, D] kernels -> torch in_proj [3D, D] / [3D], out_proj [D, D]."""
    return torch.cat([wq.T, wk.T, wv.T]), torch.cat([bq, bk, bv]), wo.T


def _bool_mask(key_padding_mask):
    if key_padding_mask is not None and key_padding_mask.dtype != torch.bool:
        raise ValueError("fused_attention_block takes a bool key_padding_mask only, "
                         f"got {key_padding_mask.dtype}")
    return key_padding_mask


def attention_block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
                              key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain forward: [B, S, D] x, [D, D] kernels and [D] biases -> [B, S, D]
    in x's dtype."""
    wqkv, bqkv, wo_t = _packed(wq, bq, wk, bk, wv, bv, wo)
    return train_attention_block_reference(x, wqkv, bqkv, wo_t, bo, num_heads,
                                           key_padding_mask=_bool_mask(key_padding_mask))


@torch.no_grad()
def fused_attention_block(
    x: torch.Tensor,  # [B, S, D]
    wq, bq, wk, bk, wv, bv, wo, bo,  # [D, D] kernels (x . W) / [D] biases
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] bool True=ignore
) -> torch.Tensor:
    """Self-attention block, forward only, in x's dtype.

    On a CPU tensor it runs ``attention_block_reference``; on a CUDA tensor
    it launches the chain (adding one to ``LAUNCHES``) or raises."""
    if x.device.type == "cpu":
        return attention_block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads,
                                         key_padding_mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block runs on cpu or cuda, not {x.device}")
    dt = x.dtype
    wqkv, bqkv, wo_t = (t.to(dt) for t in _packed(wq, bq, wk, bk, wv, bv, wo))
    mask = _bool_mask(key_padding_mask)
    out = _fwd_cuda(x, wqkv, bqkv, wo_t, bo.to(dt), _mask_row(x, mask), None, num_heads, 0.0,
                    0)[0]
    global LAUNCHES
    LAUNCHES += 1
    return out
