"""Frozen text encoders: the CLIP text tower and DistilBERT, in PyTorch.

Counterpart of mdm_tpu/models/text_encoders.py. MDM conditions on OpenAI
CLIP ViT-B/32's pooled text embedding or on DistilBERT's token states (DiP).
Both towers run in float32, once per prompt batch; the embedding is then
reused by every diffusion step.

The modules keep the published checkpoints' parameter names: OpenAI's
``clip`` text keys (``token_embedding``, ``positional_embedding``,
``transformer.resblocks.{i}.{ln_1,attn,ln_2,mlp.c_fc,mlp.c_proj}``,
``ln_final``, ``text_projection``) and HuggingFace's DistilBertModel keys
(``embeddings.*``, ``transformer.layer.{i}.*``), except that each attention's
q/k/v projections are packed into the ``in_proj_weight`` [3D, D] that the
port's ``MultiHeadAttention`` takes. The converters map an OpenAI or HF
state dict straight to these modules' state dicts.

Kernels: the attention is ``layers.MultiHeadAttention`` and takes its routes
under its gates. DistilBERT's self-attention carries a key-padding row and a
width divisible by 128 (768, 12 heads of 64), so under AUTO it is the rate-0
attention block (kernel #2's ``fused_block_attention_inference``), f32, six
launches per prompt batch. CLIP's causal bias is a full [1, 1, 77, 77],
which no kernel takes: it stays on the einsum route, as in mdm_tpu.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .layers import MultiHeadAttention, gelu_exact, key_padding_bias


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


def _f32(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Every value as a float32 CPU tensor (OpenAI's released weights are fp16)."""
    return {k: v.detach().cpu().float() if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}


def _infer_layers(sd: Mapping, prefix: str) -> int:
    """Transformer depth from numbered state-dict keys (prefix.<i>. ...)."""
    idx = {int(m.group(1)) for k in sd if (m := re.match(re.escape(prefix) + r"(\d+)\.", k))}
    if not idx:
        raise KeyError(f"no layers found under {prefix!r}")
    return max(idx) + 1


def _pack_qkv(sd: Mapping, names, prefix: str) -> Dict[str, torch.Tensor]:
    """Three q/k/v Linear layers as the packed ``in_proj_weight`` /
    ``in_proj_bias`` of the port's attention."""
    return {f"{prefix}.in_proj_weight": torch.cat([sd[f"{n}.weight"] for n in names]),
            f"{prefix}.in_proj_bias": torch.cat([sd[f"{n}.bias"] for n in names])}


def _copy(sd: Mapping, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.weight": sd[f"{src}.weight"], f"{dst}.bias": sd[f"{src}.bias"]}


# ---------------------------------------------------------------------------
# CLIP text tower (ViT-B/32: width 512, 12 layers, 8 heads, context 77)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    context_length: int = 77
    embed_dim: int = 512  # projection output

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor]) -> "ClipTextConfig":
        """The sizes a state dict of ``ClipTextEncoder`` holds; heads are
        width // 64, as OpenAI's CLIP builds its text tower."""
        vocab, width = sd["token_embedding.weight"].shape
        return cls(vocab_size=vocab, width=width, layers=_infer_layers(sd, "transformer.resblocks."),
                   heads=max(1, width // 64), context_length=sd["positional_embedding"].shape[0],
                   embed_dim=sd["text_projection"].shape[1])


class ClipResBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x)), quick GELU."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiHeadAttention(width, heads, dropout=0.0)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict(c_fc=nn.Linear(width, 4 * width), gelu=QuickGELU(),
                                             c_proj=nn.Linear(4 * width, width)))

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, attn_bias=causal_bias)
        return x + self.mlp(self.ln_2(x))


class ClipTextEncoder(nn.Module):
    """tokens [B, L] int -> pooled embedding [B, embed_dim] (f32).

    Pooling follows CLIP: the hidden state at argmax(tokens) (the EOT token,
    which has the highest id) through the text projection. MDM's
    tokenize-to-22-then-zero-pad-to-77 is upstream of this module and does
    not move the argmax."""

    def __init__(self, config: ClipTextConfig = ClipTextConfig()):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ClipResBlock(cfg.width, cfg.heads) for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(cfg.width, cfg.embed_dim))
        nn.init.normal_(self.positional_embedding, std=0.01)
        nn.init.normal_(self.text_projection, std=0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding[None, :L]
        causal = torch.full((L, L), -1e9, dtype=torch.float32, device=x.device).triu(1)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


def convert_openai_clip_text(sd: Mapping, layers: int = 0) -> Dict[str, torch.Tensor]:
    """An OpenAI ``clip`` checkpoint's text keys -> ``ClipTextEncoder``'s
    state dict: the same names, with the visual tower, ``logit_scale`` and
    the blocks past ``layers`` left out (layers=0 infers the depth)."""
    sd = _f32(sd)
    layers = layers or _infer_layers(sd, "transformer.resblocks.")
    top = ("token_embedding.weight", "positional_embedding", "text_projection",
           "ln_final.weight", "ln_final.bias")
    out = {k: sd[k] for k in top}
    out.update({k: v for k, v in sd.items() if k.startswith("transformer.resblocks.")
                and int(k.split(".")[2]) < layers})
    return out


def convert_hf_clip_text(sd: Mapping, layers: int = 0) -> Dict[str, torch.Tensor]:
    """A HuggingFace CLIPTextModelWithProjection state dict ->
    ``ClipTextEncoder``'s (no projection: the identity, as mdm_tpu's
    converter). layers=0 infers the depth."""
    sd = _f32({k.removeprefix("text_model."): v for k, v in sd.items()})
    layers = layers or _infer_layers(sd, "encoder.layers.")
    width = sd["final_layer_norm.weight"].shape[0]
    out = {
        "token_embedding.weight": sd["embeddings.token_embedding.weight"],
        "positional_embedding": sd["embeddings.position_embedding.weight"],
        "text_projection": (sd["text_projection.weight"].T.contiguous()
                            if "text_projection.weight" in sd else torch.eye(width)),
        **_copy(sd, "final_layer_norm", "ln_final"),
    }
    for i in range(layers):
        p, q = f"encoder.layers.{i}", f"transformer.resblocks.{i}"
        a = f"{p}.self_attn"
        out.update({**_copy(sd, f"{p}.layer_norm1", f"{q}.ln_1"),
                    **_copy(sd, f"{p}.layer_norm2", f"{q}.ln_2"),
                    **_pack_qkv(sd, (f"{a}.q_proj", f"{a}.k_proj", f"{a}.v_proj"), f"{q}.attn"),
                    **_copy(sd, f"{a}.out_proj", f"{q}.attn.out_proj"),
                    **_copy(sd, f"{p}.mlp.fc1", f"{q}.mlp.c_fc"),
                    **_copy(sd, f"{p}.mlp.fc2", f"{q}.mlp.c_proj")})
    return out


# ---------------------------------------------------------------------------
# DistilBERT (6 layers, 768, post-LN, learned positions)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_position_embeddings: int = 512

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor]) -> "DistilBertConfig":
        """The sizes a state dict of ``DistilBertEncoder`` holds; heads are
        dim // 64, DistilBERT's head width."""
        vocab, dim = sd["embeddings.word_embeddings.weight"].shape
        return cls(vocab_size=vocab, dim=dim, n_layers=_infer_layers(sd, "transformer.layer."),
                   n_heads=max(1, dim // 64),
                   hidden_dim=sd["transformer.layer.0.ffn.lin1.weight"].shape[0],
                   max_position_embeddings=sd["embeddings.position_embeddings.weight"].shape[0])


class DistilBertLayer(nn.Module):
    """Post-LN layer: LN(x + attn(x)), then LN(x + lin2(gelu(lin1(x))))."""

    def __init__(self, dim: int, n_heads: int, hidden_dim: int):
        super().__init__()
        self.attention = MultiHeadAttention(dim, n_heads, dropout=0.0)
        self.sa_layer_norm = nn.LayerNorm(dim, eps=1e-12)
        self.ffn = nn.Module()
        self.ffn.lin1 = nn.Linear(dim, hidden_dim)
        self.ffn.lin2 = nn.Linear(hidden_dim, dim)
        self.output_layer_norm = nn.LayerNorm(dim, eps=1e-12)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        x = self.sa_layer_norm(x + self.attention(x, x, x, attn_bias=attn_bias))
        h = self.ffn.lin2(gelu_exact(self.ffn.lin1(x)))
        return self.output_layer_norm(x + h)


class DistilBertEncoder(nn.Module):
    """(tokens [B, L], attention_mask [B, L] bool, True = real token) ->
    last hidden state [B, L, dim] (f32). Padded positions are computed
    too; MDM masks them."""

    def __init__(self, config: DistilBertConfig = DistilBertConfig()):
        super().__init__()
        cfg = self.config = config
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.embeddings.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.dim)
        self.embeddings.LayerNorm = nn.LayerNorm(cfg.dim, eps=1e-12)
        self.transformer = nn.Module()
        self.transformer.layer = nn.ModuleList(
            DistilBertLayer(cfg.dim, cfg.n_heads, cfg.hidden_dim) for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        L = tokens.shape[1]
        emb = self.embeddings
        x = emb.word_embeddings(tokens.long()) + emb.position_embeddings.weight[None, :L]
        x = emb.LayerNorm(x)
        bias = key_padding_bias(~attention_mask.bool())  # [B, 1, 1, L], -1e9 at padding
        for layer in self.transformer.layer:
            x = layer(x, bias)
        return x


def convert_hf_distilbert(sd: Mapping, layers: int = 0) -> Dict[str, torch.Tensor]:
    """A HuggingFace DistilBertModel state dict -> ``DistilBertEncoder``'s
    (the q/k/v_lin layers packed, ``out_lin`` as ``out_proj``; a
    ``distilbert.`` prefix and keys outside the encoder are dropped).
    layers=0 infers the depth."""
    sd = _f32({k.removeprefix("distilbert."): v for k, v in sd.items()})
    layers = layers or _infer_layers(sd, "transformer.layer.")
    out = {"embeddings.word_embeddings.weight": sd["embeddings.word_embeddings.weight"],
           "embeddings.position_embeddings.weight": sd["embeddings.position_embeddings.weight"],
           **_copy(sd, "embeddings.LayerNorm", "embeddings.LayerNorm")}
    for i in range(layers):
        p = f"transformer.layer.{i}"
        a = f"{p}.attention"
        out.update({**_pack_qkv(sd, (f"{a}.q_lin", f"{a}.k_lin", f"{a}.v_lin"), a),
                    **_copy(sd, f"{a}.out_lin", f"{a}.out_proj"),
                    **{k: v for n in ("sa_layer_norm", "ffn.lin1", "ffn.lin2", "output_layer_norm")
                       for k, v in _copy(sd, f"{p}.{n}", f"{p}.{n}").items()}})
    return out
