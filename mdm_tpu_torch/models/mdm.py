"""MDM denoiser, trans_enc, trans_dec and gru architectures, in PyTorch.

Counterpart of mdm_tpu/models/mdm.py (MDM.__call__ :213-348,
cfg_denoiser_cached :351-385 and cfg_denoiser :388-424) for sampling and
training: ``cond_mode`` ``text`` (a pooled embedding, or DistilBERT-shaped
token states with ``text_tokens``), ``action`` (a learned table) or
``no_cond``, ``emb_policy`` ``add`` or ``cat``, optional ``mask_frames``,
the DiP prefix completion (``context_len``/``pred_len``) and goal
conditioning (``multi_target_cond``), the ``trans_dec`` decoder with its
optional ``emb_trans_dec`` time token, the ``gru`` recurrence and the
``rot_vel`` input/output processes. Layout ``x: [B, T, D]``; conditioning
is a :class:`Conditioning` dataclass of tensors. Parameter names follow
the reference torch MDM, so its state_dicts load directly. A training
forward (``deterministic=False``) draws every dropout seed from the step's
CPU ``torch.Generator``: the sequence dropout's seed, then each layer's
(``N_SEEDS`` of models/layers.py), whichever route the kernel flags pick.
Every mask comes from the Philox stream of ops/dropout_bits.py keyed on its
seed, so the card and the CPU drop the same elements in a step.
``remat`` rematerialises each transformer layer in the backward.
``MDM.forward`` is one ``denoiser.forward`` span (utils/tracing.py).

``arch="dit"`` is DiT (Peebles & Xie, arXiv:2212.09748; facebookresearch/DiT
``models.py``) over motion frames, for generation: the condition c =
MLP_t(freq256(t)) + W_text . text modulates every block (AdaLN-Zero,
layers.py::DiTBlock), positions are DiT's fixed 1-D sin-cos table, each
frame is a token (S = the frames, no condition token), and the final layer
is Linear(LN(x) (1 + scale) + shift), predicting x0 with no learned sigma.
The timestep and text embedding and the one product that gives every
block's modulation are one ``denoiser.condition`` span. Parameter names are
DiT's (``t_embedder``, ``y_embedder`` for its label table, ``x_embedder``,
``blocks``, ``final_layer``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .. import ops
from ..core.goals import ALL_GOAL_JOINT_NAMES, extended_goal_names
from ..ops._mask import row_bias_contrib
from ..ops.adaln import adaln_modulate, modulation
from ..ops.dropout_bits import keep_threshold, sequence_dropout_bits
from ..utils.tracing import span, traced
from .layers import (DiTBlock, TimestepEmbedder, TransformerDecoder, TransformerEncoder,
                     draw_seeds, init_weights_)

_SUPPORTED = {
    "arch": ("trans_enc", "trans_dec", "gru", "dit"),
    "cond_mode": ("text", "action", "no_cond"),
    "data_rep": ("hml_vec", "rot6d", "xyz", "rot_vel"),
}


@dataclass(frozen=True)
class MDMConfig:
    njoints: int = 263
    nfeats: int = 1
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    data_rep: str = "hml_vec"  # hml_vec | rot6d | xyz | rot_vel
    arch: str = "trans_enc"  # trans_enc | trans_dec | gru | dit
    cond_mode: str = "text"  # text | action | no_cond
    text_dim: int = 512  # CLIP pooled width (768 for DistilBERT tokens)
    text_tokens: bool = False  # True: [B, L, text_dim] token memory (BERT)
    num_actions: int = 1
    emb_trans_dec: bool = False  # trans_dec: the time embedding as a leading token
    emb_policy: str = "add"  # add | cat
    pos_embed_max_len: int = 5000
    mask_frames: bool = False
    # DiP prefix completion
    context_len: int = 0
    pred_len: int = 0
    # multi-target goal conditioning
    multi_target_cond: bool = False
    multi_encoder_type: str = "multi"  # multi | single | split
    target_enc_layers: int = 1
    num_goal_joints: int = 6  # pelvis + 5 end effectors (humanml)
    dropout: float = 0.1
    compute_dtype: str = "float32"  # float32 | bfloat16
    remat: bool = False  # rematerialise the transformer layers (train memory saver)

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats

    @property
    def is_prefix_comp(self) -> bool:
        return self.context_len + self.pred_len > 0

    @property
    def goal_names(self) -> List[str]:
        """The goal rows' names, which key EmbedTargetLoc's per-joint
        parameters in the reference checkpoints (mdm_tpu/models/convert.py
        :133-162): humanml's goal joints, the one named set."""
        if self.num_goal_joints != len(ALL_GOAL_JOINT_NAMES):
            raise ValueError(f"num_goal_joints={self.num_goal_joints}: the goal rows are named "
                             f"only for humanml's {len(ALL_GOAL_JOINT_NAMES)} goal joints")
        return extended_goal_names()


@dataclass(frozen=True)
class Conditioning:
    """Fixed-shape conditioning tensors; None = absent."""

    frames_mask: Optional[torch.Tensor] = None  # [B, T] bool, True = valid frame
    # [B, text_dim] pooled embedding, or [B, L, text_dim] token states (text_tokens)
    text_embed: Optional[torch.Tensor] = None
    text_tokens_mask: Optional[torch.Tensor] = None  # [B, L] bool, True = real token
    action: Optional[torch.Tensor] = None  # [B] int action index
    prefix: Optional[torch.Tensor] = None  # [B, context_len, D] DiP prefix window
    cond_drop: Optional[torch.Tensor] = None  # [B] bool: drop the condition (CFG)
    # goal conditioning: [B, G+2, 3] target locations, [B, G+2] validity
    # (the heading row included), [B] bool: drop the target (CFG)
    target_cond: Optional[torch.Tensor] = None
    target_validity: Optional[torch.Tensor] = None
    target_uncond: Optional[torch.Tensor] = None

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
    the dump kernel on the card), the keep rule the kernels'; a
    data-parallel rank draws its rows of the whole batch's mask
    (``ops.shard_seed_offset``)."""
    bits = sequence_dropout_bits(draw_seeds(rng, 1)[0], *x.shape, device=x.device,
                                 batch_offset=ops.shard_seed_offset())
    keep = bits.to(torch.int64) < keep_threshold(rate)  # uint32 has no CPU compare
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class EmbedAction(nn.Module):
    """The action table [num_actions, d] (mdm_tpu/models/mdm.py:113-123)."""

    def __init__(self, num_actions: int, latent_dim: int):
        super().__init__()
        self.action_embedding = nn.Parameter(torch.zeros(num_actions, latent_dim))

    def forward(self, action: torch.Tensor) -> torch.Tensor:
        return self.action_embedding[action]


class _MixWeights(nn.Module):
    """The goal rows' mixing weights, under the reference's name."""

    def __init__(self, n: int):
        super().__init__()
        self.weights = nn.Parameter(torch.ones(n))


def _mlp(n_in: int, width: int, hidden: int) -> nn.Sequential:
    """Linear(n_in, width), then ``hidden`` x (SiLU, Linear(width, width)):
    the reference's ``Sequential`` indices 0, 2, 4, ..."""
    layers = [nn.Linear(n_in, width)]
    for _ in range(hidden):
        layers += [nn.SiLU(), nn.Linear(width, width)]
    return nn.Sequential(*layers)


class EmbedTargetLoc(nn.Module):
    """Goal-location encoder, target [B, G, 3] and validity [B, G] -> [B, d]
    (mdm_tpu/models/mdm.py:126-175), in the reference torch layout: ``multi``
    a 3 -> d -> d MLP per goal row (``target_loc_emb.{name}``), masked by
    validity and mixed by normalised weights (``target_all_loc_emb``);
    ``single`` one MLP over the flattened (location, validity) rows
    (``mlp``); ``split`` a mini-MLP per row giving d / G columns each
    (``mini_mlps.{g}``)."""

    def __init__(self, latent_dim: int, names: List[str], encoder_type: str = "multi",
                 num_layers: int = 1):
        super().__init__()
        self.encoder_type = encoder_type
        G = len(names)
        if encoder_type == "multi":
            self.target_loc_emb = nn.ModuleDict({n: _mlp(3, latent_dim, 1) for n in names})
            self.target_all_loc_emb = _MixWeights(G)
        elif encoder_type == "single":
            self.mlp = _mlp(4 * G, latent_dim, num_layers)
        elif encoder_type == "split":
            if latent_dim % G:
                raise ValueError(f"multi_encoder_type 'split' needs latent_dim % {G} == 0")
            self.mini_mlps = nn.ModuleList(_mlp(4, latent_dim // G, num_layers) for _ in names)
        else:
            raise ValueError(f"multi_encoder_type {encoder_type!r}: multi, single or split")

    def forward(self, target: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
        v = validity.to(target.dtype)
        if self.encoder_type == "multi":
            h = torch.stack([mlp(target[:, g]) for g, mlp in
                             enumerate(self.target_loc_emb.values())], dim=1) * v[..., None]
            mix = self.target_all_loc_emb.weights
            return torch.einsum("g,bgd->bd", mix / mix.sum(), h)
        x = torch.cat([target, v[..., None]], dim=-1)  # [B, G, 4]
        if self.encoder_type == "single":
            return self.mlp(x.reshape(x.shape[0], -1))
        return torch.cat([mlp(x[:, g]) for g, mlp in enumerate(self.mini_mlps)], dim=-1)


class InputProcess(nn.Module):
    """``poseEmbedding``; with ``rot_vel``, ``velEmbedding`` on frames 1.. ."""

    def __init__(self, data_rep: str, input_feats: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(input_feats, latent_dim)
        if data_rep == "rot_vel":
            self.velEmbedding = nn.Linear(input_feats, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, F] -> [B, S, d]
        if not hasattr(self, "velEmbedding"):
            return self.poseEmbedding(x)
        return torch.cat([self.poseEmbedding(x[:, :1]), self.velEmbedding(x[:, 1:])], dim=1)


class OutputProcess(nn.Module):
    """``poseFinal``; with ``rot_vel``, ``velFinal`` on frames 1.. ."""

    def __init__(self, data_rep: str, input_feats: int, latent_dim: int):
        super().__init__()
        self.poseFinal = nn.Linear(latent_dim, input_feats)
        if data_rep == "rot_vel":
            self.velFinal = nn.Linear(latent_dim, input_feats)

    def forward(self, h: torch.Tensor) -> torch.Tensor:  # [B, S, d] -> [B, S, F]
        if not hasattr(self, "velFinal"):
            return self.poseFinal(h)
        return torch.cat([self.poseFinal(h[:, :1]), self.velFinal(h[:, 1:])], dim=1)


def timestep_frequencies(t: torch.Tensor, dim: int = 256,
                         max_period: float = 10000.0) -> torch.Tensor:
    """DiT's ``TimestepEmbedder.timestep_embedding``: [cos, sin] of t times
    dim / 2 frequencies from 1 down to 1 / max_period, in f32, [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_1d(length: int, d: int) -> torch.Tensor:
    """DiT's ``get_1d_sincos_pos_embed_from_grid`` over positions 0..length-1:
    [sin | cos] of position x 1 / 10000^(i / (d / 2)), built in f64, f32."""
    omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
    out = np.arange(length, dtype=np.float64)[:, None] * omega[None]
    return torch.from_numpy(np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32))


class DiTTimestepEmbedder(nn.Module):
    """freq256(t), then Linear(256, d), SiLU, Linear(d, d) (DiT's names)."""

    FREQ_DIM = 256

    def __init__(self, d: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(self.FREQ_DIM, d), nn.SiLU(), nn.Linear(d, d))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_frequencies(t, self.FREQ_DIM))


class DiTFinalLayer(nn.Module):
    """Linear(LN(x) (1 + scale) + shift), (shift, scale) from
    ``adaLN_modulation`` = (SiLU, Linear(d, 2d)) of the condition."""

    def __init__(self, d: int, out_feats: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))
        self.linear = nn.Linear(d, out_feats)


class MDM(nn.Module):
    """Motion Diffusion Model denoiser: (x_t, t, cond) -> x0_hat."""

    def __init__(self, config: MDMConfig):
        super().__init__()
        for name, allowed in _SUPPORTED.items():
            if getattr(config, name) not in allowed:
                raise ValueError(f"MDMConfig.{name}={getattr(config, name)!r}: one of {allowed}")
        if config.arch == "gru" and config.compute_dtype != "float32":
            # mdm_tpu's GRU scan refuses it: its carry starts in the compute
            # dtype and leaves in f32, the dtype of its weights.
            raise ValueError("arch='gru' runs in float32 only, as in mdm_tpu")
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        d = config.latent_dim
        if config.arch == "dit":
            self._build_dit(config)
            return
        self.embed_timestep = TimestepEmbedder(d, config.pos_embed_max_len)
        if config.multi_target_cond:
            self.embed_target_cond = EmbedTargetLoc(d, config.goal_names,
                                                    config.multi_encoder_type,
                                                    config.target_enc_layers)
        if config.cond_mode == "text":
            self.embed_text = nn.Linear(config.text_dim, d)
        elif config.cond_mode == "action":
            self.embed_action = EmbedAction(config.num_actions, d)
        # gru reads [x, the first conditioning token] per frame
        in_feats = config.input_feats + (d if config.arch == "gru" else 0)
        self.input_process = InputProcess(config.data_rep, in_feats, d)
        stack = (d, config.num_heads, config.ff_size, config.num_layers, self.compute_dtype,
                 config.dropout, config.remat)
        if config.arch == "trans_enc":
            self.seqTransEncoder = TransformerEncoder(*stack)
        elif config.arch == "trans_dec":
            self.seqTransDecoder = TransformerDecoder(*stack)
        else:
            self.gru = nn.GRU(d, d, num_layers=config.num_layers, batch_first=True)
        self.output_process = OutputProcess(config.data_rep, config.input_feats, d)

    def _build_dit(self, config: MDMConfig) -> None:
        if (config.cond_mode != "text" or config.text_tokens or config.is_prefix_comp
                or config.multi_target_cond or config.data_rep == "rot_vel"):
            raise ValueError("arch='dit' takes a pooled text condition: no token memory, action, "
                             "unconditioned model, prefix completion, goals or rot_vel")
        d = config.latent_dim
        self.t_embedder = DiTTimestepEmbedder(d)
        self.y_embedder = nn.Linear(config.text_dim, d)
        self.x_embedder = nn.Linear(config.input_feats, d)
        self.register_buffer("pos_embed", sincos_1d(config.pos_embed_max_len, d),
                             persistent=False)
        self.blocks = nn.ModuleList(DiTBlock(d, config.num_heads, config.ff_size)
                                    for _ in range(config.num_layers))
        self.final_layer = DiTFinalLayer(d, config.input_feats)
        self._mod_cast = None  # (key, the stacked modulation weight and bias in the compute dtype)

    def _init_dit(self, generator: torch.Generator) -> None:
        """DiT's ``initialize_weights``: Xavier-uniform linears with zero
        biases, N(0, 0.02^2) for the timestep MLP, and zero (AdaLN-Zero) for
        every modulation linear and the output linear, so that each block
        starts as the identity and the model's output at zero. The text
        projection, in place of DiT's label table, is a linear like the others."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = math.sqrt(6.0 / (m.in_features + m.out_features))
                    m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound)
                    m.bias.zero_()
            for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator) * 0.02)
            for lin in self._modulation_linears() + [self.final_layer.linear]:
                lin.weight.zero_()
                lin.bias.zero_()

    def init_weights(self, generator: torch.Generator) -> "MDM":
        """Seeded random weights drawn from a CPU ``generator``: flax's
        defaults (``init_weights_``), then its normal(1.0) for the action
        table and the goal rows' mixing weights; DiT's own for ``dit``."""
        if self.config.arch == "dit":
            self._init_dit(generator)
            return self
        init_weights_(self, generator)
        tables = [m.action_embedding for m in self.modules() if isinstance(m, EmbedAction)]
        tables += [m.weights for m in self.modules() if isinstance(m, _MixWeights)]
        with torch.no_grad():
            for p in tables:
                p.copy_(torch.randn(p.shape, generator=generator))
        return self

    def _condition(self, cond: Conditioning, time_emb: torch.Tensor):
        """The conditioning tokens [B, E, d] and their padding mask [B, E]
        (True = ignore; None = none), which the decoder reads as memory
        padding (mdm_tpu/models/mdm.py:249-281)."""
        cfg = self.config
        if cfg.cond_mode == "no_cond":
            return time_emb[:, None, :], None
        if cfg.cond_mode == "action":
            if cond.action is None:
                raise ValueError("cond_mode='action' requires Conditioning.action ([B] int)")
            action_emb = _mask_cond(self.embed_action(cond.action), cond.cond_drop)
            return (time_emb + action_emb)[:, None, :], None
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

    def _modulation_linears(self) -> List[nn.Linear]:
        return [b.adaLN_modulation[1] for b in self.blocks] + [self.final_layer.adaLN_modulation[1]]

    def _modulation_weights(self, dt: torch.dtype):
        """Every block's modulation linear and the final layer's, stacked
        [L 6d + 2d, d] with their biases, in dt: made once and kept until a
        parameter is replaced or updated in place (sampling only)."""
        lins = self._modulation_linears()
        key = (dt,) + tuple((p.data_ptr(), p._version) for m in lins for p in (m.weight, m.bias))
        if self._mod_cast is None or self._mod_cast[0] != key:
            with torch.no_grad():
                self._mod_cast = (key, torch.cat([m.weight for m in lins]).to(dt),
                                  torch.cat([m.bias for m in lins]).to(dt))
        return self._mod_cast[1:]

    def _dit_forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Conditioning,
                     deterministic: bool) -> torch.Tensor:
        """DiT's forward (module docstring): x [B, S, F] -> x0_hat [B, S, F]."""
        cfg = self.config
        if not deterministic or torch.is_grad_enabled():
            raise ValueError("arch='dit' runs forward only, for sampling under torch.no_grad() "
                             "or inference_mode(): its kernels have no backward yet")
        S, d, cdt = x.shape[1], cfg.latent_dim, self.compute_dtype
        with span("denoiser.condition"):
            if cond.text_embed is None:
                raise ValueError("cond_mode='text' requires Conditioning.text_embed")
            c = (self.t_embedder(timesteps)
                 + self.y_embedder(_mask_cond(cond.text_embed.float(), cond.cond_drop)))
            mod = modulation(c, *self._modulation_weights(cdt), cdt)  # [B, L 6d + 2d] f32
        rows = lambda k: mod[:, k * d:(k + 1) * d]  # the k-th [B, d] block of rows
        key_bias = None
        if cfg.mask_frames and cond.frames_mask is not None:
            key_bias = row_bias_contrib(~cond.frames_mask[:, :S])
        h = (self.x_embedder(x.float()) + self.pos_embed[:S]).to(cdt)
        _, hm = adaln_modulate(h, None, None, rows(0), rows(1))
        for i, block in enumerate(self.blocks):
            nxt = 6 * (i + 1)  # the next block's shift and scale, or the final layer's
            with span("denoiser.layer"):
                h, hm = block(h, hm, mod[:, 6 * i * d:nxt * d], rows(nxt), rows(nxt + 1),
                              key_bias)
        return self.final_layer.linear(hm.float())

    @traced("denoiser.forward")
    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                cond: Conditioning = Conditioning(), deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``rng``: the step's CPU generator; a training forward
        (``deterministic=False``) with dropout draws all its masks from it.
        With prefix completion ``x`` holds the predicted frames only: the
        model prepends ``cond.prefix`` and returns the frames after it."""
        cfg = self.config
        if cfg.arch == "dit":
            return self._dit_forward(x, timesteps, cond, deterministic)
        B = x.shape[0]
        cdt = self.compute_dtype
        time_emb = self.embed_timestep(timesteps)  # [B, d]
        if cfg.multi_target_cond and cond.target_cond is not None:
            target_emb = self.embed_target_cond(cond.target_cond, cond.target_validity)
            time_emb = time_emb + _mask_cond(target_emb, cond.target_uncond)

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
        if cfg.arch == "gru":
            x = torch.cat([x, emb_tokens[:, :1].expand(B, S, -1).to(x.dtype)], dim=-1)
        h = self.input_process(x).to(cdt)
        pad_mask = None
        if cfg.mask_frames and frames_mask is not None:
            pad_mask = ~frames_mask[:, :S]

        if cfg.arch == "trans_enc":
            n_emb = emb_tokens.shape[1]
            seq = torch.cat([emb_tokens.to(cdt), h], dim=1)
        else:
            n_emb = 1 if cfg.arch == "trans_dec" and cfg.emb_trans_dec else 0
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
        elif cfg.arch == "trans_dec":
            out = self.seqTransDecoder(seq, emb_tokens.to(cdt), pad_mask, memory_mask,
                                       deterministic, rng)
        else:
            # The reference quirk (mdm_tpu/models/mdm.py:331-341): its
            # batch-first GRU is fed [S, B, d], so the recurrence runs
            # across the batch, each sample's output depending on those
            # before it.
            out = self.gru(seq.transpose(0, 1))[0].transpose(0, 1)
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
