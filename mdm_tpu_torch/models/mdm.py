"""MDM denoiser, trans_enc and trans_dec architectures, in PyTorch.

Counterpart of mdm_tpu/models/mdm.py (MDM.__call__ :213-348,
cfg_denoiser_cached :351-385 and cfg_denoiser :388-424) for sampling and,
for ``trans_enc``, training: ``cond_mode`` ``text`` (a pooled embedding,
or DistilBERT-shaped token states with ``text_tokens``) or ``no_cond``,
``emb_policy`` ``add`` or ``cat``, optional ``mask_frames``, the DiP
prefix completion (``context_len``/``pred_len``) and the ``trans_dec``
decoder with its optional ``emb_trans_dec`` time token. Layout
``x: [B, T, D]``; conditioning is a :class:`Conditioning` dataclass of
tensors. Parameter names follow the reference torch MDM, so its
state_dicts load directly. A training forward (``deterministic=False``)
draws every dropout seed from the step's CPU ``torch.Generator``: the
sequence dropout's seed and each layer's two (attention, then the tail),
whichever route the kernel flags pick. Every mask comes from the Philox
stream of ops/dropout_bits.py keyed on its seed, so the card and the CPU
drop the same elements in a step.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops.dropout_bits import keep_threshold, sequence_dropout_bits
from .layers import (TimestepEmbedder, TransformerDecoder, TransformerEncoder, draw_seeds,
                     init_weights_)

_ACTION_TO_MOTION = "ROADMAP Queue 1 item 2 (the action-to-motion family)"
_TODO = {
    "arch": f"{_ACTION_TO_MOTION}: gru, with its batch-axis recurrence",
    "cond_mode": f"{_ACTION_TO_MOTION}: action conditioning",
    "data_rep": f"{_ACTION_TO_MOTION}: the rot_vel input/output process",
}
_SUPPORTED = {
    "arch": ("trans_enc", "trans_dec"),
    "cond_mode": ("text", "no_cond"),
    "data_rep": ("hml_vec", "rot6d", "xyz"),
}


@dataclass(frozen=True)
class MDMConfig:
    njoints: int = 263
    nfeats: int = 1
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    data_rep: str = "hml_vec"
    arch: str = "trans_enc"
    cond_mode: str = "text"  # text | no_cond
    text_dim: int = 512  # CLIP pooled width (768 for DistilBERT tokens)
    text_tokens: bool = False  # True: [B, L, text_dim] token memory (BERT)
    emb_trans_dec: bool = False  # trans_dec: the time embedding as a leading token
    emb_policy: str = "add"  # add | cat
    pos_embed_max_len: int = 5000
    mask_frames: bool = False
    # DiP prefix completion
    context_len: int = 0
    pred_len: int = 0
    dropout: float = 0.1
    compute_dtype: str = "float32"  # float32 | bfloat16
    remat: bool = False  # rematerialised layers: not ported

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats

    @property
    def is_prefix_comp(self) -> bool:
        return self.context_len + self.pred_len > 0


@dataclass(frozen=True)
class Conditioning:
    """Fixed-shape conditioning tensors; None = absent."""

    frames_mask: Optional[torch.Tensor] = None  # [B, T] bool, True = valid frame
    # [B, text_dim] pooled embedding, or [B, L, text_dim] token states (text_tokens)
    text_embed: Optional[torch.Tensor] = None
    text_tokens_mask: Optional[torch.Tensor] = None  # [B, L] bool, True = real token
    prefix: Optional[torch.Tensor] = None  # [B, context_len, D] DiP prefix window
    cond_drop: Optional[torch.Tensor] = None  # [B] bool: drop the condition (CFG)

    def replace(self, **changes) -> "Conditioning":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Conditioning":
        return Conditioning(**{f.name: None if getattr(self, f.name) is None
                               else getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


def _mask_cond(cond: torch.Tensor, drop: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the condition for dropped samples (reference mask_cond)."""
    if drop is None:
        return cond
    keep = 1.0 - drop.to(cond.dtype)
    return cond * keep.reshape((-1,) + (1,) * (cond.dim() - 1))


def sequence_dropout(x: torch.Tensor, rate: float, rng: torch.Generator) -> torch.Tensor:
    """flax nn.Dropout on the input sequence: keep with probability 1-rate,
    scale kept values by 1/(1-rate) in x's dtype. The mask is Philox keyed
    on one seed drawn from the step's CPU ``rng`` (``sequence_dropout_bits``:
    the dump kernel on the card), the keep rule the kernels'."""
    bits = sequence_dropout_bits(draw_seeds(rng, 1)[0], *x.shape, device=x.device)
    keep = bits.to(torch.int64) < keep_threshold(rate)  # uint32 has no CPU compare
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class InputProcess(nn.Module):
    def __init__(self, input_feats: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(input_feats, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, F] -> [B, S, d]
        return self.poseEmbedding(x)


class OutputProcess(nn.Module):
    def __init__(self, input_feats: int, latent_dim: int):
        super().__init__()
        self.poseFinal = nn.Linear(latent_dim, input_feats)

    def forward(self, h: torch.Tensor) -> torch.Tensor:  # [B, S, d] -> [B, S, F]
        return self.poseFinal(h)


class MDM(nn.Module):
    """Motion Diffusion Model denoiser: (x_t, t, cond) -> x0_hat."""

    def __init__(self, config: MDMConfig):
        super().__init__()
        for name, allowed in _SUPPORTED.items():
            if getattr(config, name) not in allowed:
                raise NotImplementedError(
                    f"MDMConfig.{name}={getattr(config, name)!r} is not ported yet: {_TODO[name]}")
        if config.remat:
            raise NotImplementedError("MDMConfig.remat=True is not ported yet: ROADMAP Queue 1 "
                                      "item 5 (Training: remat)")
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        d = config.latent_dim
        self.embed_timestep = TimestepEmbedder(d, config.pos_embed_max_len)
        if config.cond_mode == "text":
            self.embed_text = nn.Linear(config.text_dim, d)
        self.input_process = InputProcess(config.input_feats, d)
        stack = (d, config.num_heads, config.ff_size, config.num_layers, self.compute_dtype,
                 config.dropout)
        if config.arch == "trans_enc":
            self.seqTransEncoder = TransformerEncoder(*stack)
        else:
            self.seqTransDecoder = TransformerDecoder(*stack)
        self.output_process = OutputProcess(config.input_feats, d)

    def init_weights(self, generator: torch.Generator) -> "MDM":
        """Seeded random weights drawn from a CPU ``generator``."""
        init_weights_(self, generator)
        return self

    def _condition(self, cond: Conditioning, time_emb: torch.Tensor):
        """The conditioning tokens [B, E, d] and their padding mask [B, E]
        (True = ignore; None = none), which the decoder reads as memory
        padding (mdm_tpu/models/mdm.py:249-281)."""
        cfg = self.config
        if cfg.cond_mode != "text":
            return time_emb[:, None, :], None
        if cond.text_embed is None:
            raise ValueError("cond_mode='text' requires Conditioning.text_embed")
        te = cond.text_embed
        if not cfg.text_tokens and te.dim() == 2:
            te = te[:, None, :]  # [B, 1, Dt]
        text_emb = self.embed_text(_mask_cond(te, cond.cond_drop))  # [B, L, d]
        pad = None if cond.text_tokens_mask is None else ~cond.text_tokens_mask
        if cfg.emb_policy == "add":
            return text_emb + time_emb[:, None, :], pad
        if pad is not None:
            pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
        return torch.cat([time_emb[:, None, :], text_emb], dim=1), pad

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                cond: Conditioning = Conditioning(), deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``rng``: the step's CPU generator; a training forward
        (``deterministic=False``) with dropout draws all its masks from it.
        With prefix completion ``x`` holds the predicted frames only: the
        model prepends ``cond.prefix`` and returns the frames after it."""
        cfg = self.config
        B = x.shape[0]
        cdt = self.compute_dtype
        time_emb = self.embed_timestep(timesteps)  # [B, d]

        frames_mask = cond.frames_mask
        if cfg.is_prefix_comp:
            if cond.prefix is None:
                raise ValueError("prefix completion requires Conditioning.prefix")
            x = torch.cat([cond.prefix.to(x.dtype), x], dim=1)
            if frames_mask is not None:
                ones = torch.ones((B, cfg.context_len), dtype=frames_mask.dtype,
                                  device=frames_mask.device)
                frames_mask = torch.cat([ones, frames_mask], dim=1)
        emb_tokens, memory_mask = self._condition(cond, time_emb)

        S = x.shape[1]
        h = self.input_process(x).to(cdt)
        pad_mask = None
        if cfg.mask_frames and frames_mask is not None:
            pad_mask = ~frames_mask[:, :S]

        if cfg.arch == "trans_enc":
            n_emb = emb_tokens.shape[1]
            seq = torch.cat([emb_tokens.to(cdt), h], dim=1)
        else:
            n_emb = 1 if cfg.emb_trans_dec else 0
            seq = torch.cat([time_emb[:, None, :].to(cdt), h], dim=1) if n_emb else h
        pe = self.embed_timestep.pe  # the one sinusoidal table, shared as in the reference
        seq = seq + pe[: seq.shape[1]][None].to(cdt)
        if not deterministic and cfg.dropout > 0.0:
            if rng is None:
                raise ValueError("a training forward with dropout needs the step's generator")
            seq = sequence_dropout(seq, cfg.dropout, rng)
        if pad_mask is not None and n_emb:
            pad_mask = torch.cat(
                [torch.zeros((B, n_emb), dtype=torch.bool, device=x.device), pad_mask], dim=1)
        if cfg.arch == "trans_enc":
            out = self.seqTransEncoder(seq, pad_mask, deterministic, rng)
        else:
            out = self.seqTransDecoder(seq, emb_tokens.to(cdt), pad_mask, memory_mask,
                                       deterministic)
        out = out[:, n_emb + (cfg.context_len if cfg.is_prefix_comp else 0):]
        return self.output_process(out.float())


def cfg_denoiser(model: nn.Module, guidance_scale: float):
    """Classifier-free guidance as ONE double-batched forward.

    Returns model_fn(x, t, cond) computing ``uncond + s * (cond - uncond)``
    with both branches in one batch (the reference runs two forwards,
    sampler_util.py:27-34). Every conditioning field is duplicated; the
    second half drops the condition."""

    def model_fn(x: torch.Tensor, t: torch.Tensor, cond: Conditioning) -> torch.Tensor:
        B = x.shape[0]
        dup = lambda v: None if v is None else torch.cat([v, v], dim=0)
        drop = torch.cat([torch.zeros(B, dtype=torch.bool, device=x.device),
                          torch.ones(B, dtype=torch.bool, device=x.device)])
        cond2 = Conditioning(**{f.name: dup(getattr(cond, f.name))
                                for f in dataclasses.fields(cond)}).replace(cond_drop=drop)
        out = model(dup(x), dup(t), cond2)
        out_cond, out_uncond = out[:B], out[B:]
        return out_uncond + guidance_scale * (out_cond - out_uncond)

    return model_fn


def cfg_denoiser_cached(model: nn.Module, guidance_scale: float, cache_interval: int = 2):
    """CFG with a cached unconditional branch: the unconditional output is
    recomputed every ``cache_interval`` steps and reused in between, so a
    step costs 1 + 1/interval forwards instead of 2 (of half the batch).

    Returns ``(model_fn(x, t, cond, state) -> (out, state), first_state)``.
    The step counter is a Python int, so choosing to recompute reads
    nothing from the card (the JAX package's ``lax.cond``,
    mdm_tpu/models/mdm.py:351-385)."""

    def model_fn(x: torch.Tensor, t: torch.Tensor, cond: Conditioning, state):
        out_cond = model(x, t, cond)
        out_uncond = state["uncond"]
        if state["i"] % cache_interval == 0:
            drop = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            out_uncond = model(x, t, cond.replace(cond_drop=drop))
        out = out_uncond + guidance_scale * (out_cond - out_uncond)
        return out, {"uncond": out_uncond, "i": state["i"] + 1}

    return model_fn, {"uncond": None, "i": 0}
