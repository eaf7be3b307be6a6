"""Carry mdm_tpu (flax) parameters into the port's torch state_dict.

The inverse of mdm_tpu/models/convert.py (:28-162): flax Dense kernels
[in, out] become torch Linear weights [out, in]; the q/k/v Dense layers of
each attention block (the decoder's ``self_attn`` and ``multihead_attn``
alike) are packed into ``in_proj_weight`` [3D, D] and ``in_proj_bias``
[3D]; LayerNorm ``scale`` becomes ``weight``; the GRU's fused kernels
[in, 3D] become nn.GRU's ``weight_ih_l{k}`` [3D, in]; the goal encoder's
stacked per-row kernels become one Linear per row, named as the reference
names them. The tree arrives as nested dicts of numpy arrays (callers
convert with ``jax.tree_util.tree_map(np.asarray, params)``), so this
module needs no jax.
``train_state_from_flax`` carries a whole JAX ``TrainState`` (params, the
optax AdamW moments and count, EMA, step) into the port's train state: the
moments and the EMA have the params' tree, so they map the same way.
``clip_text_from_flax`` and ``distilbert_from_flax`` carry mdm_tpu's text
towers (models/text_encoders.py) into the port's.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .mdm import MDMConfig


def _linear(p: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(p["kernel"]).T,
            f"{prefix}.bias": np.asarray(p["bias"])}


def _layernorm(p: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(p["scale"]),
            f"{prefix}.bias": np.asarray(p["bias"])}


def _attention(a: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """q/k/v Dense layers packed into ``in_proj_weight``/``in_proj_bias``,
    and ``out_proj``."""
    names = ("q_proj", "k_proj", "v_proj")
    return {
        f"{prefix}.in_proj_weight": np.concatenate(
            [np.asarray(a[n]["kernel"]).T for n in names], axis=0),
        f"{prefix}.in_proj_bias": np.concatenate(
            [np.asarray(a[n]["bias"]) for n in names], axis=0),
        **_linear(a["out_proj"], f"{prefix}.out_proj"),
    }


def _layer(p: Mapping, prefix: str, attentions, norms) -> Dict[str, np.ndarray]:
    out = {**_linear(p["linear1"], f"{prefix}.linear1"),
           **_linear(p["linear2"], f"{prefix}.linear2")}
    for name in attentions:
        out.update(_attention(p[name], f"{prefix}.{name}"))
    for name in norms:
        out.update(_layernorm(p[name], f"{prefix}.{name}"))
    return out


def _encoder_layer(p: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return _layer(p, prefix, ("self_attn",), ("norm1", "norm2"))


def _decoder_layer(p: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return _layer(p, prefix, ("self_attn", "multihead_attn"), ("norm1", "norm2", "norm3"))


def _gru(p: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """JAX's fused-gate GRU kernels [in, 3D] -> nn.GRU's [3D, in], gate
    order (r, z, n) on both sides (inverse of convert.py:75-83)."""
    out = {}
    for k in range(num_layers):
        out[f"gru.weight_ih_l{k}"] = np.asarray(p[f"w_ih_l{k}"]).T
        out[f"gru.weight_hh_l{k}"] = np.asarray(p[f"w_hh_l{k}"]).T
        out[f"gru.bias_ih_l{k}"] = np.asarray(p[f"b_ih_l{k}"])
        out[f"gru.bias_hh_l{k}"] = np.asarray(p[f"b_hh_l{k}"])
    return out


def _stacked(w, b, name) -> Dict[str, np.ndarray]:
    """EmbedTargetLoc's stacked kernels [G, in, out] and biases [G, out]
    as G torch Linears, row g named ``name(g)``."""
    out = {}
    for g in range(np.asarray(w).shape[0]):
        out[f"{name(g)}.weight"] = np.asarray(w[g]).T
        out[f"{name(g)}.bias"] = np.asarray(b[g])
    return out


def _target_loc(p: Mapping, config: MDMConfig) -> Dict[str, np.ndarray]:
    """EmbedTargetLoc's stacked tree -> the reference torch layout
    (inverse of convert.py:133-162)."""
    pre, names = "embed_target_cond", config.goal_names
    if config.multi_encoder_type == "multi":
        return {**_stacked(p["w1"], p["b1"], lambda g: f"{pre}.target_loc_emb.{names[g]}.0"),
                **_stacked(p["w2"], p["b2"], lambda g: f"{pre}.target_loc_emb.{names[g]}.2"),
                f"{pre}.target_all_loc_emb.weights": np.asarray(p["mix_weights"])}
    if config.multi_encoder_type == "single":
        out = _linear(p["in"], f"{pre}.mlp.0")
        for i in range(config.target_enc_layers):
            out.update(_linear(p[f"hidden_{i}"], f"{pre}.mlp.{2 * (i + 1)}"))
        return out
    out = _stacked(p["w1"], p["b1"], lambda g: f"{pre}.mini_mlps.{g}.0")
    for i in range(config.target_enc_layers):
        out.update(_stacked(p[f"w{i + 2}"], p[f"b{i + 2}"],
                            lambda g: f"{pre}.mini_mlps.{g}.{2 * (i + 1)}"))
    return out


def state_dict_from_flax(params: Mapping, config: MDMConfig) -> Dict[str, torch.Tensor]:
    """flax MDM params (``model.init``'s ``{"params": ...}`` or its inner
    tree) -> a state_dict that ``MDM(config).load_state_dict(.., strict=True)``
    accepts."""
    p = params.get("params", params)
    sd = {
        **_linear(p["embed_timestep"]["time_embed_0"], "embed_timestep.time_embed.0"),
        **_linear(p["embed_timestep"]["time_embed_2"], "embed_timestep.time_embed.2"),
    }
    for process, names in (("input_process", ("poseEmbedding", "velEmbedding")),
                           ("output_process", ("poseFinal", "velFinal"))):
        for name in names:
            if name in p[process]:
                sd.update(_linear(p[process][name], f"{process}.{name}"))
    if config.cond_mode == "text":
        sd.update(_linear(p["embed_text"], "embed_text"))
    elif config.cond_mode == "action":
        sd["embed_action.action_embedding"] = np.asarray(p["embed_action"]["action_embedding"])
    if config.multi_target_cond:
        sd.update(_target_loc(p["embed_target_cond"], config))
    if config.arch == "gru":
        sd.update(_gru(p["gru"], config.num_layers))
    else:
        stack, layer = (("seqTransEncoder", _encoder_layer) if config.arch == "trans_enc"
                        else ("seqTransDecoder", _decoder_layer))
        for i in range(config.num_layers):
            sd.update(layer(p[stack][f"layers_{i}"], f"{stack}.layers.{i}"))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}


def _tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in sd.items()}


def clip_text_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """mdm_tpu's ClipTextEncoder params -> the state dict of the port's."""
    p = params.get("params", params)
    sd = {"token_embedding.weight": p["token_embedding"],
          "positional_embedding": p["positional_embedding"],
          "text_projection": p["text_projection"], **_layernorm(p["ln_final"], "ln_final")}
    for i in range(sum(k.startswith("resblocks_") for k in p)):
        b, q = p[f"resblocks_{i}"], f"transformer.resblocks.{i}"
        sd.update({**_layernorm(b["ln_1"], f"{q}.ln_1"), **_layernorm(b["ln_2"], f"{q}.ln_2"),
                   **_attention(b["attn"], f"{q}.attn"), **_linear(b["c_fc"], f"{q}.mlp.c_fc"),
                   **_linear(b["c_proj"], f"{q}.mlp.c_proj")})
    return _tensors(sd)


def distilbert_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """mdm_tpu's DistilBertEncoder params -> the state dict of the port's."""
    p = params.get("params", params)
    sd = {"embeddings.word_embeddings.weight": p["word_embeddings"],
          "embeddings.position_embeddings.weight": p["position_embeddings"],
          **_layernorm(p["emb_layer_norm"], "embeddings.LayerNorm")}
    for i in range(sum(k.startswith("layer_") for k in p)):
        b, q = p[f"layer_{i}"], f"transformer.layer.{i}"
        sd.update({**_attention(b["attention"], f"{q}.attention"),
                   **_layernorm(b["sa_layer_norm"], f"{q}.sa_layer_norm"),
                   **_linear(b["ffn_lin1"], f"{q}.ffn.lin1"),
                   **_linear(b["ffn_lin2"], f"{q}.ffn.lin2"),
                   **_layernorm(b["output_layer_norm"], f"{q}.output_layer_norm")})
    return _tensors(sd)


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside a chain's tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


@torch.no_grad()
def train_state_from_flax(state, into):
    """Load a JAX TrainState (numpy leaves) into the port's TrainState
    ``into`` (mdm_tpu_torch.train.state), whose model has the same config:
    parameters, AdamW's exp_avg/exp_avg_sq/step from optax's mu/nu/count,
    the EMA and the step. Returns ``into``."""
    config = into.model.config
    into.model.load_state_dict(state_dict_from_flax(state.params, config), strict=True)
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu) in the TrainState's opt_state")
    mu, nu = state_dict_from_flax(adam.mu, config), state_dict_from_flax(adam.nu, config)
    count = float(np.asarray(adam.count))
    for name, p in into.model.named_parameters():
        into.optimizer.state[p] = {"step": torch.tensor(count), "exp_avg": mu[name].to(p.device),
                                   "exp_avg_sq": nu[name].to(p.device)}
    if into.ema_params is not None:
        for name, t in state_dict_from_flax(state.ema_params, config).items():
            into.ema_params[name].copy_(t)
    into.step = int(np.asarray(state.step))
    return into
