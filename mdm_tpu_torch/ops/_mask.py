"""Key-padding handling shared by the attention kernels.

Counterpart of mdm_tpu/ops/_mask.py. Every kernel consumes an ADDITIVE f32
row bias added to the attention logits. Callers pass either a bool mask
[B, S] (True = ignore, the torch key_padding_mask convention, converted to
0/-1e9 here) or an already additive float row [B, S], which is forwarded
unchanged so that finite biases survive the kernel path.
"""
from __future__ import annotations

import torch


def row_bias_contrib(mask_or_bias: torch.Tensor) -> torch.Tensor:
    """[B, S] bool mask or float additive row -> f32 additive row [B, S]."""
    if mask_or_bias.dtype == torch.bool:
        zero = torch.zeros((), dtype=torch.float32, device=mask_or_bias.device)
        return torch.where(mask_or_bias, zero - 1e9, zero)
    return mask_or_bias.to(torch.float32)
