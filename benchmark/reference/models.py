"""Plain float32 PyTorch forwards of the benchmark's models, on a dict of
parameters named as the published torch checkpoints name them.

- MDM (Tevet et al., arXiv:2209.14916; GuyTevet/motion-diffusion-model,
  ``model/mdm.py``): a linear pose embedding, the sinusoidal table, a
  timestep MLP, the text projection added to the time token, then
  ``trans_enc``, a post-LN ``nn.TransformerEncoder`` with the condition
  token first, or ``trans_dec`` (DiP, arXiv:2410.03441), a post-LN
  ``nn.TransformerDecoder`` over the prefix and the predicted frames with
  the text tokens as memory. Exact-erf GELU, LayerNorm eps 1e-5, padding
  keys at -1e9. A training forward drops the input sequence, the
  attention probabilities and the three sites of each layer's tail with
  the masks of ``philox.py``, from seeds drawn as ``train_seeds`` says.
- CLIP ViT-B/32's text tower (Radford et al., 2021): pre-LN blocks, causal
  attention, QuickGELU, the state at the highest token id projected.
- DistilBERT (Sanh et al., 2019): post-LN blocks, LayerNorm eps 1e-12, key
  padding.

Every product runs through a ``Precision``. Nothing here imports the
program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import philox
from .precision import Precision

Params = Dict[str, torch.Tensor]
_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Parameter lists: (name, shape, kind). ``kind`` says how the benchmark
# draws it: "w" N(0, 1/fan_in), "b" N(0, 0.02^2), "ln_w" 1 + N(0, 0.1^2),
# "ln_b" N(0, 0.1^2), "emb" N(0, 0.02^2), "pos" N(0, 0.01^2).
# ---------------------------------------------------------------------------

def _linear(name: str, n_out: int, n_in: int):
    return [(f"{name}.weight", (n_out, n_in), "w"), (f"{name}.bias", (n_out,), "b")]


def _norm(name: str, d: int):
    return [(f"{name}.weight", (d,), "ln_w"), (f"{name}.bias", (d,), "ln_b")]


def _attention(name: str, d: int):
    return [(f"{name}.in_proj_weight", (3 * d, d), "w"), (f"{name}.in_proj_bias", (3 * d,), "b"),
            *_linear(f"{name}.out_proj", d, d)]


def mdm_params(cfg: dict) -> List[Tuple[str, tuple, str]]:
    d, f, feats = cfg["latent_dim"], cfg["ff_size"], cfg["njoints"] * cfg["nfeats"]
    specs = [*_linear("embed_timestep.time_embed.0", d, d),
             *_linear("embed_timestep.time_embed.2", d, d),
             *_linear("embed_text", d, cfg["text_dim"]),
             *_linear("input_process.poseEmbedding", d, feats)]
    stack = "seqTransEncoder" if cfg["arch"] == "trans_enc" else "seqTransDecoder"
    for i in range(cfg["num_layers"]):
        p = f"{stack}.layers.{i}"
        specs += _attention(f"{p}.self_attn", d)
        if cfg["arch"] == "trans_dec":
            specs += _attention(f"{p}.multihead_attn", d)
        specs += [*_linear(f"{p}.linear1", f, d), *_linear(f"{p}.linear2", d, f),
                  *_norm(f"{p}.norm1", d), *_norm(f"{p}.norm2", d)]
        if cfg["arch"] == "trans_dec":
            specs += _norm(f"{p}.norm3", d)
    return specs + _linear("output_process.poseFinal", feats, d)


def clip_params(cfg: dict):
    w = cfg["width"]
    specs = [("token_embedding.weight", (cfg["vocab_size"], w), "emb"),
             ("positional_embedding", (cfg["context_length"], w), "pos")]
    for i in range(cfg["layers"]):
        p = f"transformer.resblocks.{i}"
        specs += [*_norm(f"{p}.ln_1", w), *_attention(f"{p}.attn", w), *_norm(f"{p}.ln_2", w),
                  *_linear(f"{p}.mlp.c_fc", 4 * w, w), *_linear(f"{p}.mlp.c_proj", w, 4 * w)]
    # text_projection is applied as x @ P, [width, embed]: its fan-in is the width
    return specs + _norm("ln_final", w) + [("text_projection", (w, cfg["embed_dim"]), "proj")]


def distilbert_params(cfg: dict):
    d = cfg["dim"]
    specs = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], d), "emb"),
             ("embeddings.position_embeddings.weight", (cfg["max_position_embeddings"], d), "emb"),
             *_norm("embeddings.LayerNorm", d)]
    for i in range(cfg["n_layers"]):
        p = f"transformer.layer.{i}"
        specs += [*_attention(f"{p}.attention", d), *_norm(f"{p}.sa_layer_norm", d),
                  *_linear(f"{p}.ffn.lin1", cfg["hidden_dim"], d),
                  *_linear(f"{p}.ffn.lin2", d, cfg["hidden_dim"]),
                  *_norm(f"{p}.output_layer_norm", d)]
    return specs


def tower_params(cfg: dict):
    return clip_params(cfg) if cfg["type"] == "clip" else distilbert_params(cfg)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _ln(x, P: Params, name: str, eps: float):
    return F.layer_norm(x.float(), x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _lin(prec: Precision, x, P: Params, name: str):
    return prec.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


_TABLES: Dict[tuple, torch.Tensor] = {}


def sinusoidal_table(max_len: int, d: int, device=None) -> torch.Tensor:
    """MDM's PositionalEncoding table [max_len, d], computed in float64,
    kept per device after its first use."""
    key = (max_len, d, str(device))
    if key not in _TABLES:
        _TABLES[key] = _table(max_len, d).to(device)
    return _TABLES[key]


def _table(max_len: int, d: int) -> torch.Tensor:
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe = np.zeros((max_len, d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32))


def key_bias(pad: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Sk] bool, True = ignore -> additive [B, 1, 1, Sk]."""
    if pad is None:
        return None
    return torch.where(pad, -1e9, 0.0).float()[:, None, None, :]


def attention(prec: Precision, P: Params, name: str, xq, xkv, heads: int, bias=None,
              drop: Optional[torch.Tensor] = None):
    """``nn.MultiheadAttention`` with its packed projections; ``drop``: keep
    factors of the probabilities [B, H, Sq, Sk]."""
    W, b = P[f"{name}.in_proj_weight"], P[f"{name}.in_proj_bias"]
    B, Sq, D = xq.shape
    Sk, Dh = xkv.shape[1], D // heads
    q = prec.linear(xq, W[:D], b[:D])
    k = prec.linear(xkv, W[D:2 * D], b[D:2 * D])
    v = prec.linear(xkv, W[2 * D:], b[2 * D:])
    split = lambda t, s: t.reshape(B, s, heads, Dh).transpose(1, 2)
    logits = prec.mm(split(q, Sq), split(k, Sk).transpose(-1, -2)) / math.sqrt(Dh)
    if bias is not None:
        logits = logits + bias
    p = torch.softmax(logits, dim=-1)
    if drop is not None:
        p = p * drop
    o = prec.mm(p, split(v, Sk)).transpose(1, 2).reshape(B, Sq, D)
    return _lin(prec, o, P, f"{name}.out_proj")


def _ffn_tail(prec, P, p, x, attn_out, norms, keep):
    """Post-LN: norm_a(x + drop0(attn)), the GELU FFN with drop1 on its
    hidden units and drop2 on its output, norm_b(y + ...)."""
    k0, k1, k2 = keep
    y = _ln(x + (attn_out if k0 is None else attn_out * k0), P, f"{p}.{norms[0]}", 1e-5)
    h = F.gelu(_lin(prec, y, P, f"{p}.linear1"))
    h = _lin(prec, h if k1 is None else h * k1, P, f"{p}.linear2")
    return _ln(y + (h if k2 is None else h * k2), P, f"{p}.{norms[1]}", 1e-5)


def train_seeds(rng: torch.Generator, num_layers: int, per_layer: int) -> Tuple[int, list]:
    """A training forward's dropout seeds from the step's CPU generator: the
    input sequence's, then each layer's ``per_layer`` (attention, tail for
    an encoder layer), each ``randint(0, 2^31 - 1)`` in one call a layer."""
    seq = torch.randint(0, _INT32_MAX, (1,), generator=rng).tolist()[0]
    layers = [torch.randint(0, _INT32_MAX, (per_layer,), generator=rng).tolist()
              for _ in range(num_layers)]
    return seq, layers


# ---------------------------------------------------------------------------
# MDM
# ---------------------------------------------------------------------------

def mdm_forward(P: Params, cfg: dict, x, timesteps, text_embed, *, prec: Precision,
                text_mask=None, frames_mask=None, prefix=None, cond_drop=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """x [B, T, F] (the predicted frames under prefix completion),
    timesteps [B] of the diffusion process, text_embed [B, Dt] pooled or
    [B, L, Dt] tokens with text_mask [B, L] (True = real token),
    frames_mask [B, T] (True = valid), cond_drop [B] bool. ``rng``: a
    training forward's CPU generator (dropout at ``cfg["dropout"]``);
    without it the forward is deterministic. Returns x0_hat [B, T, F]."""
    d, H = cfg["latent_dim"], cfg["num_heads"]
    B, dev = x.shape[0], x.device
    rate = cfg["dropout"] if rng is not None else 0.0
    pe = sinusoidal_table(cfg.get("pos_embed_max_len", 5000), d, dev)
    t_in = pe[timesteps]
    time_emb = _lin(prec, F.silu(_lin(prec, t_in, P, "embed_timestep.time_embed.0")), P,
                    "embed_timestep.time_embed.2")
    te = text_embed.float()
    if te.dim() == 2:
        te = te[:, None, :]
    if cond_drop is not None:
        te = te * (1.0 - cond_drop.float()).reshape(-1, 1, 1)
    emb = _lin(prec, te, P, "embed_text") + time_emb[:, None, :]  # [B, L, d]

    context = cfg.get("context_len", 0)
    if prefix is not None:
        x = torch.cat([prefix.float(), x.float()], dim=1)
        if frames_mask is not None:
            frames_mask = torch.cat([torch.ones((B, context), dtype=torch.bool, device=dev),
                                     frames_mask], dim=1)
    h = _lin(prec, x.float(), P, "input_process.poseEmbedding")
    pad = ~frames_mask if (cfg.get("mask_frames") and frames_mask is not None) else None
    if cfg["arch"] == "trans_enc":
        seq = torch.cat([emb, h], dim=1)
        if pad is not None:
            pad = torch.cat([torch.zeros((B, emb.shape[1]), dtype=torch.bool, device=dev), pad], 1)
        n_emb = emb.shape[1]
    else:
        seq, n_emb = h, 0
    S = seq.shape[1]
    seq = seq + pe[:S][None]
    seeds = None
    if rate > 0:
        per_layer = 2 if cfg["arch"] == "trans_enc" else 4
        seq_seed, seeds = train_seeds(rng, cfg["num_layers"], per_layer)
        seq = seq * philox.keep_factors(seq_seed, B, 0, S, d, rate, dev)
    bias = key_bias(pad)
    F_ = cfg["ff_size"]
    if cfg["arch"] == "trans_enc":
        for i in range(cfg["num_layers"]):
            p = f"seqTransEncoder.layers.{i}"
            drop_p = keep = None
            if seeds is not None:
                a_seed, t_seed = seeds[i]
                drop_p = philox.keep_factors(a_seed, B, range(H), S, S, rate, dev)
                keep = tuple(philox.keep_factors(t_seed, B, site, S, n, rate, dev)
                             for site, n in ((0, d), (1, F_), (2, d)))
            a = attention(prec, P, f"{p}.self_attn", seq, seq, H, bias, drop_p)
            seq = _ffn_tail(prec, P, p, seq, a, ("norm1", "norm2"), keep or (None,) * 3)
    else:
        mem_bias = key_bias(~text_mask.bool()) if text_mask is not None else None
        L = emb.shape[1]
        for i in range(cfg["num_layers"]):
            p = f"seqTransDecoder.layers.{i}"
            drop_s = drop_o = drop_c = None
            keep = (None,) * 3
            if seeds is not None:
                s_self, s_out, s_cross, s_tail = seeds[i]
                drop_s = philox.keep_factors(s_self, B, range(H), S, S, rate, dev)
                drop_o = philox.keep_factors(s_out, B, 0, S, d, rate, dev)
                drop_c = philox.keep_factors(s_cross, B, range(H), S, L, rate, dev)
                keep = tuple(philox.keep_factors(s_tail, B, site, S, n, rate, dev)
                             for site, n in ((0, d), (1, F_), (2, d)))
            a = attention(prec, P, f"{p}.self_attn", seq, seq, H, bias, drop_s)
            seq = _ln(seq + (a if drop_o is None else a * drop_o), P, f"{p}.norm1", 1e-5)
            c = attention(prec, P, f"{p}.multihead_attn", seq, emb, H, mem_bias, drop_c)
            seq = _ffn_tail(prec, P, p, seq, c, ("norm2", "norm3"), keep)
    out = seq[:, n_emb + (context if prefix is not None else 0):]
    return _lin(prec, out, P, "output_process.poseFinal")


# ---------------------------------------------------------------------------
# Text towers
# ---------------------------------------------------------------------------

def clip_forward(P: Params, cfg: dict, tokens: torch.Tensor, *, prec: Precision) -> torch.Tensor:
    """tokens [B, L] int -> pooled, projected embedding [B, embed_dim]."""
    B, L = tokens.shape
    x = P["token_embedding.weight"][tokens.long()] + P["positional_embedding"][None, :L]
    causal = torch.full((L, L), -1e9, device=tokens.device).triu(1)[None, None]
    for i in range(cfg["layers"]):
        p = f"transformer.resblocks.{i}"
        h = _ln(x, P, f"{p}.ln_1", 1e-5)
        x = x + attention(prec, P, f"{p}.attn", h, h, cfg["heads"], causal)
        h = _lin(prec, _ln(x, P, f"{p}.ln_2", 1e-5), P, f"{p}.mlp.c_fc")
        x = x + _lin(prec, h * torch.sigmoid(1.702 * h), P, f"{p}.mlp.c_proj")
    x = _ln(x, P, "ln_final", 1e-5)
    pooled = x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)]
    return prec.mm(pooled, P["text_projection"])


def distilbert_forward(P: Params, cfg: dict, tokens: torch.Tensor, mask: torch.Tensor, *,
                       prec: Precision) -> torch.Tensor:
    """(tokens [B, L], mask [B, L] True = real) -> last hidden state [B, L, dim]."""
    L = tokens.shape[1]
    x = (P["embeddings.word_embeddings.weight"][tokens.long()]
         + P["embeddings.position_embeddings.weight"][None, :L])
    x = _ln(x, P, "embeddings.LayerNorm", 1e-12)
    bias = key_bias(~mask.bool())
    for i in range(cfg["n_layers"]):
        p = f"transformer.layer.{i}"
        x = _ln(x + attention(prec, P, f"{p}.attention", x, x, cfg["n_heads"], bias), P,
                f"{p}.sa_layer_norm", 1e-12)
        h = _lin(prec, F.gelu(_lin(prec, x, P, f"{p}.ffn.lin1")), P, f"{p}.ffn.lin2")
        x = _ln(x + h, P, f"{p}.output_layer_norm", 1e-12)
    return x


def tower_forward(P: Params, cfg: dict, tokens, mask, *, prec: Precision):
    if cfg["type"] == "clip":
        return clip_forward(P, cfg, tokens, prec=prec)
    return distilbert_forward(P, cfg, tokens, mask, prec=prec)

