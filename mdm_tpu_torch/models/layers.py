"""Transformer building blocks with torch checkpoint layout.

Counterpart of mdm_tpu/models/layers.py. The encoder layer holds
torch.nn.TransformerEncoderLayer's own parameter names
(``self_attn.in_proj_weight`` [3D, D], ``in_proj_bias``,
``self_attn.out_proj``, ``linear1``, ``linear2``, ``norm1``, ``norm2``) —
the layout mdm_tpu/models/convert.py reads — so published checkpoints load
without conversion. Its deterministic forward is the whole-layer kernel
chain (ops/layer_inference.py), as the JAX package's AUTO sampling path
is; its training forward is the train attention block followed by the
encoder tail (ops/attention_train_block.py, ops/encoder_tail.py), as the
AUTO single-device train step is (JAX layers.py:377-386).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention_train_block import fused_train_attention_block
from ..ops.encoder_tail import fused_encoder_tail
from ..ops.layer_inference import fused_layer_inference

_INT32_MAX = 2 ** 31 - 1


def draw_seeds(rng: Optional[torch.Generator], n: int) -> list:
    """n int32 dropout seeds from a CPU generator (JAX's per-layer
    ``randint(make_rng("dropout"), (), 0, int32 max)``); drawn on the host,
    so passing them to a kernel never waits for the card. No generator
    gives zeros, for rate-0 training."""
    if rng is None:
        return [0] * n
    return torch.randint(0, _INT32_MAX, (n,), generator=rng).tolist()


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU, torch's F.gelu default (the checkpoint parity surface)."""
    return torch.nn.functional.gelu(x, approximate="none")


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic sin/cos positional table [max_len, d_model], built in f64."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def key_padding_bias(padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Sk] bool (True = ignore) -> additive f32 bias [B, 1, 1, Sk]."""
    if padding_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=padding_mask.device)
    return torch.where(padding_mask, zero - 1e9, zero)[:, None, None, :]


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """In-place N(0, 1/fan_in) draw for a torch [out, in] weight."""
    w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[-1]))


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every Linear/LayerNorm/attention parameter below
    ``module``, drawn on the CPU from ``generator`` (flax's defaults:
    lecun-normal kernels, zero biases, unit LayerNorm scales)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, _SelfAttention):
                for w in m.in_proj_weight.chunk(3):  # q, k, v: three [D, D] kernels
                    _lecun_normal_(w, generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class _SelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj + out_proj)
    without its math: the layer kernel consumes them directly."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch default semantics, exact-erf GELU)."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.self_attn = _SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self._cast = None  # (key, weights in the compute dtype)

    def _params(self):
        a = self.self_attn
        return (a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                self.norm1.weight, self.norm1.bias, self.linear1.weight, self.linear1.bias,
                self.linear2.weight, self.linear2.bias, self.norm2.weight, self.norm2.bias)

    def _kernel_weights(self, dt: torch.dtype):
        """The parameters in dtype dt, detached, cast once and reused until a
        parameter is replaced or updated in place (load_state_dict, .to):
        for sampling only, since no gradient flows through the cache."""
        params = self._params()
        if all(p.dtype == dt for p in params):
            return params
        key = (dt,) + tuple((p.data_ptr(), p._version) for p in params)
        if self._cast is None or self._cast[0] != key:
            with torch.no_grad():
                self._cast = (key, tuple(p.detach().to(dt) for p in params))
        return self._cast[1]

    def forward(self, x: torch.Tensor, padding_bias: Optional[torch.Tensor] = None,
                deterministic: bool = True, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``rng``: the step's CPU generator, from which a training forward
        draws this layer's two dropout seeds (attention block, tail)."""
        kpm = None
        if padding_bias is not None:
            kpm = padding_bias.reshape(padding_bias.shape[0], -1)[:, -x.shape[1]:].float()
        cdt = self.compute_dtype or x.dtype
        if deterministic:
            return fused_layer_inference(x.to(cdt), *self._kernel_weights(cdt),
                                         self.num_heads, key_padding_mask=kpm)
        if rng is None and self.dropout > 0.0:
            raise ValueError("a training forward with dropout needs the step's generator")
        seed_attn, seed_tail = draw_seeds(rng, 2)
        # The casts sit inside the autograd graph: the parameter gradients
        # come back rounded to cdt, as the JAX wrappers' casts make them.
        a = self.self_attn
        x = x.to(cdt)
        attn = fused_train_attention_block(
            x, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
            self.num_heads, self.dropout, seed_attn, key_padding_mask=kpm)
        return fused_encoder_tail(
            x, attn, self.norm1.weight, self.norm1.bias, self.linear1.weight, self.linear1.bias,
            self.linear2.weight, self.linear2.bias, self.norm2.weight, self.norm2.bias,
            self.dropout, seed_tail)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_size: int, num_layers: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, ff_size, compute_dtype, dropout)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        bias = key_padding_bias(padding_mask)
        for layer in self.layers:
            x = layer(x, bias, deterministic, rng)
        return x


class TimestepEmbedder(nn.Module):
    """PE-table lookup + 2-layer SiLU MLP (reference mdm.py:316-330); keys
    ``time_embed.0`` / ``time_embed.2`` as in the torch checkpoints."""

    def __init__(self, latent_dim: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(max_len, latent_dim)),
                             persistent=False)
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(), nn.Linear(latent_dim, latent_dim))

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps])
