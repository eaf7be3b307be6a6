"""GRU action classifier (action2motion) for HumanAct12 evaluation.

Counterpart of mdm_tpu/eval/classifiers.py (reference
eval/a2m/action2motion/models.py, MotionDiscriminator /
MotionDiscriminatorForFID): a multi-layer GRU over xyz joint sequences,
the last valid hidden state -> tanh linear -> logits; the 30-d tanh layer
doubles as the FID feature.

The GRU is one ``nn.GRU`` over all T frames (cuDNN on the card), read at
``lengths - 1`` on the device: no packing, no host sync. Parameter names
are the reference's (``recurrent.weight_ih_l0``, ..., ``linear1``,
``linear2``; the gate order r, z, n is torch's own), so its state dicts
load with ``load_state_dict``; ``flax_layout`` carries mdm_tpu's flax
parameters both ways (``networks.load_flax_params`` / ``flax_params``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .networks import Layout, _dense


class MotionDiscriminator(nn.Module):
    """[B, T, input_size] + lengths -> dict(features [B, 30], yhat [B, C])."""

    def __init__(self, input_size: int, hidden_size: int = 128, hidden_layers: int = 2,
                 output_size: int = 12):
        super().__init__()
        self.recurrent = nn.GRU(input_size, hidden_size, hidden_layers, batch_first=True)
        self.linear1 = nn.Linear(hidden_size, 30)
        self.linear2 = nn.Linear(30, output_size)
        self.hidden_layers = hidden_layers

    def forward(self, x: torch.Tensor, lengths) -> Dict[str, torch.Tensor]:
        # A zero initial state: the reference draws a random one per call
        # (models.py:40-41); zeros are deterministic on both sides of the
        # metric, as mdm_tpu's.
        h, _ = self.recurrent(x)
        lengths = torch.as_tensor(lengths, device=x.device).long()
        last = h[torch.arange(x.shape[0], device=x.device), lengths - 1]
        feat = torch.tanh(self.linear1(last))
        return {"features": feat, "yhat": self.linear2(feat)}

    def flax_layout(self) -> Layout:
        out = []
        for k in range(self.hidden_layers):
            r = self.recurrent
            out += [((f"w_ih_l{k}",), getattr(r, f"weight_ih_l{k}"), "T"),
                    ((f"w_hh_l{k}",), getattr(r, f"weight_hh_l{k}"), "T"),
                    ((f"b_ih_l{k}",), getattr(r, f"bias_ih_l{k}"), ""),
                    ((f"b_hh_l{k}",), getattr(r, f"bias_hh_l{k}"), "")]
        return out + _dense(("linear1",), self.linear1) + _dense(("linear2",), self.linear2)


def convert_motion_discriminator(sd: Mapping, hidden_layers: int = 2) -> Dict[str, torch.Tensor]:
    """The reference MotionDiscriminator's state dict -> the state dict this
    module loads (the same names; anything else in ``sd`` is left out)."""
    names = ["linear1.weight", "linear1.bias", "linear2.weight", "linear2.bias"]
    names += [f"recurrent.{w}_l{k}" for k in range(hidden_layers)
              for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    return {k: torch.as_tensor(np.asarray(sd[k], np.float32)) for k in names}
