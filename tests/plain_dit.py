"""A plain float32 PyTorch DiT denoiser over motion frames, the oracle of
tests/test_torch_dit.py. It imports nothing of the port and no JAX.

DiT (Peebles & Xie, "Scalable Diffusion Models with Transformers",
arXiv:2212.09748; facebookresearch/DiT ``models.py``), written from its
equations on a dict of parameters named as the port's ``state_dict``:

- c = MLP_t(freq256(t)) + y_embedder(text): ``TimestepEmbedder`` ([cos, sin]
  of 128 frequencies, max period 1e4, Linear(256, d), SiLU, Linear(d, d));
- each block: (shift1, scale1, gate1, shift2, scale2, gate2) =
  Linear(d, 6d)(SiLU(c)), then x += gate1 * Attn(LN(x) (1 + scale1) +
  shift1) and x += gate2 * MLP(LN(x) (1 + scale2) + shift2), LayerNorm
  without affine at eps 1e-6, qkv and proj with biases, the MLP with GELU's
  tanh form;
- final layer: Linear(LN(x) (1 + scale) + shift), (shift, scale) =
  Linear(d, 2d)(SiLU(c)).

Departures from ``facebookresearch/DiT``, for motion: each frame is one
token (``x_embedder`` a Linear on the frame's features where DiT patches an
image), the positions are DiT's 1-D sin-cos table where DiT takes its 2-D
one, the text projection ``y_embedder`` (a Linear on the pooled CLIP
embedding, zeroed for a dropped condition) takes the place of the label
table, padded frames are masked as keys (additive -1e9), and the output is
x0 with no learned sigma (DiT predicts the noise and a variance).

Every product is ``(a @ b)`` in float32 with TF32 off, a linear
``(x.reshape(-1, K) @ W.t()).reshape(...) + b``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _lin(x: torch.Tensor, P: Params, name: str) -> torch.Tensor:
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    return (x.reshape(-1, x.shape[-1]) @ w.t()).reshape(*x.shape[:-1], w.shape[0]) + b


def timestep_frequencies(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32) / half)
    args = t[:, None].float() * freqs[None].to(t.device)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_1d(length: int, d: int) -> torch.Tensor:
    omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
    out = np.arange(length, dtype=np.float64)[:, None] * omega[None]
    return torch.from_numpy(np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32))


def _modulated(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    h = F.layer_norm(x, x.shape[-1:], eps=1e-6)
    return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _attention(x: torch.Tensor, P: Params, name: str, heads: int, bias) -> torch.Tensor:
    B, S, D = x.shape
    Dh = D // heads
    qkv = _lin(x, P, f"{name}.qkv").reshape(B, S, 3, heads, Dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
    if bias is not None:
        logits = logits + bias
    o = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(B, S, D)
    return _lin(o, P, f"{name}.proj")


def dit_forward(P: Params, cfg: dict, x: torch.Tensor, t: torch.Tensor,
                text_embed: Optional[torch.Tensor], frames_mask: Optional[torch.Tensor] = None,
                cond_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, S, F], t [B], text_embed [B, Dt] pooled, frames_mask [B, S] bool
    (True = valid; masked as keys where ``cfg["mask_frames"]``), cond_drop
    [B] bool -> x0_hat [B, S, F]. ``cfg``: latent_dim, num_layers,
    num_heads."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(P, cfg, x.float(), t, text_embed, frames_mask, cond_drop)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _forward(P, cfg, x, t, text_embed, frames_mask, cond_drop):
    B, S, _ = x.shape
    d, H = cfg["latent_dim"], cfg["num_heads"]
    c = _lin(F.silu(_lin(timestep_frequencies(t), P, "t_embedder.mlp.0")), P, "t_embedder.mlp.2")
    if text_embed is not None:
        te = text_embed.float()
        if cond_drop is not None:
            te = te * (1.0 - cond_drop.float())[:, None]
        c = c + _lin(te, P, "y_embedder")
    bias = None
    if cfg.get("mask_frames") and frames_mask is not None:
        bias = torch.where(~frames_mask, -1e9, 0.0).float()[:, None, None, :]
    h = _lin(x, P, "x_embedder") + sincos_1d(S, d).to(x.device)[None]
    sc = F.silu(c)
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}"
        sh1, sc1, g1, sh2, sc2, g2 = _lin(sc, P, f"{p}.adaLN_modulation.1").chunk(6, dim=-1)
        h = h + g1[:, None, :] * _attention(_modulated(h, sh1, sc1), P, f"{p}.attn", H, bias)
        m = F.gelu(_lin(_modulated(h, sh2, sc2), P, f"{p}.mlp.fc1"), approximate="tanh")
        h = h + g2[:, None, :] * _lin(m, P, f"{p}.mlp.fc2")
    shift, scale = _lin(sc, P, "final_layer.adaLN_modulation.1").chunk(2, dim=-1)
    return _lin(_modulated(h, shift, scale), P, "final_layer.linear")
