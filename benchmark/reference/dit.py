"""Plain float32 PyTorch DiT over motion frames, on a dict of parameters
named as the program's ``state_dict`` (``arch="dit"``), for the check of
``traffic/generate_dit.py``.

DiT (Peebles & Xie, arXiv:2212.09748; facebookresearch/DiT ``models.py``,
``DiT_XL_2``'s block): c = MLP_t(freq256(t)) + y_embedder(text); each block
(shift1, scale1, gate1, shift2, scale2, gate2) = Linear(d, 6d)(SiLU(c)),
x += gate1 * Attn(LN(x) (1 + scale1) + shift1), x += gate2 * MLP(LN(x) (1 +
scale2) + shift2), LayerNorm without affine at eps 1e-6, the MLP with GELU's
tanh form; the final layer Linear(LN(x) (1 + scale) + shift). Departures
from DiT, for motion: a frame is a token (a Linear where DiT patches an
image), 1-D sin-cos positions, the pooled CLIP text through ``y_embedder``
in place of the label table (zeroed for a dropped condition), padded frames
masked as keys (-1e9), x0 out with no learned sigma.

The same function as the tests' ``tests/plain_dit.py`` (bitwise, in float32
on the CPU), with every product through a ``Precision`` for the control.
Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision

Params = Dict[str, torch.Tensor]
FREQ_DIM = 256


def _linear(name: str, n_out: int, n_in: int):
    return [(f"{name}.weight", (n_out, n_in), "w"), (f"{name}.bias", (n_out,), "b")]


def dit_params(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in the program's order; kinds
    as ``models.py``'s: "w" N(0, 1/fan_in), "b" N(0, 0.02^2). The modulation
    and output linears are drawn like the others, not zero as DiT starts
    them, so that every block does work."""
    d, f, feats = cfg["latent_dim"], cfg["ff_size"], cfg["njoints"] * cfg["nfeats"]
    specs = [*_linear("t_embedder.mlp.0", d, FREQ_DIM), *_linear("t_embedder.mlp.2", d, d),
             *_linear("y_embedder", d, cfg["text_dim"]), *_linear("x_embedder", d, feats)]
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}"
        specs += [*_linear(f"{p}.attn.qkv", 3 * d, d), *_linear(f"{p}.attn.proj", d, d),
                  *_linear(f"{p}.mlp.fc1", f, d), *_linear(f"{p}.mlp.fc2", d, f),
                  *_linear(f"{p}.adaLN_modulation.1", 6 * d, d)]
    return specs + [*_linear("final_layer.adaLN_modulation.1", 2 * d, d),
                    *_linear("final_layer.linear", feats, d)]


def _lin(prec: Precision, x, P: Params, name: str):
    return prec.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def timestep_frequencies(t: torch.Tensor, dim: int = FREQ_DIM, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32) / half)
    args = t[:, None].float() * freqs[None].to(t.device)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_1d(length: int, d: int) -> torch.Tensor:
    omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
    out = np.arange(length, dtype=np.float64)[:, None] * omega[None]
    return torch.from_numpy(np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32))


def _modulated(x, shift, scale):
    h = F.layer_norm(x, x.shape[-1:], eps=1e-6)
    return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _attention(prec: Precision, x, P: Params, name: str, heads: int, bias):
    B, S, D = x.shape
    Dh = D // heads
    qkv = _lin(prec, x, P, f"{name}.qkv").reshape(B, S, 3, heads, Dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(Dh)
    if bias is not None:
        logits = logits + bias
    o = prec.mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(B, S, D)
    return _lin(prec, o, P, f"{name}.proj")


def dit_forward(P: Params, cfg: dict, x, t, text_embed, *, prec: Precision,
                frames_mask: Optional[torch.Tensor] = None,
                cond_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, S, F], t [B], text_embed [B, Dt] pooled, frames_mask [B, S] bool
    (True = valid), cond_drop [B] bool -> x0_hat [B, S, F]."""
    x = x.float()
    B, S, _ = x.shape
    d, H = cfg["latent_dim"], cfg["num_heads"]
    c = _lin(prec, F.silu(_lin(prec, timestep_frequencies(t), P, "t_embedder.mlp.0")), P,
             "t_embedder.mlp.2")
    if text_embed is not None:
        te = text_embed.float()
        if cond_drop is not None:
            te = te * (1.0 - cond_drop.float())[:, None]
        c = c + _lin(prec, te, P, "y_embedder")
    bias = None
    if cfg.get("mask_frames") and frames_mask is not None:
        bias = torch.where(~frames_mask, -1e9, 0.0).float()[:, None, None, :]
    h = _lin(prec, x, P, "x_embedder") + sincos_1d(S, d).to(x.device)[None]
    sc = F.silu(c)
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}"
        sh1, sc1, g1, sh2, sc2, g2 = _lin(prec, sc, P, f"{p}.adaLN_modulation.1").chunk(6, dim=-1)
        h = h + g1[:, None, :] * _attention(prec, _modulated(h, sh1, sc1), P, f"{p}.attn", H,
                                            bias)
        m = F.gelu(_lin(prec, _modulated(h, sh2, sc2), P, f"{p}.mlp.fc1"), approximate="tanh")
        h = h + g2[:, None, :] * _lin(prec, m, P, f"{p}.mlp.fc2")
    shift, scale = _lin(prec, sc, P, "final_layer.adaLN_modulation.1").chunk(2, dim=-1)
    return _lin(prec, _modulated(h, shift, scale), P, "final_layer.linear")
