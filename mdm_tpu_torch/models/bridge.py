"""Carry mdm_tpu (flax) parameters into the port's torch state_dict.

The inverse of mdm_tpu/models/convert.py (:28-60, :96-127): flax Dense
kernels [in, out] become torch Linear weights [out, in]; the q/k/v Dense
layers of each attention block (the decoder's ``self_attn`` and
``multihead_attn`` alike) are packed into ``in_proj_weight`` [3D, D] and
``in_proj_bias`` [3D]; LayerNorm ``scale`` becomes ``weight``. The tree
arrives as nested dicts of numpy arrays (callers convert with
``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no jax.
``train_state_from_flax`` carries a whole JAX ``TrainState`` (params, the
optax AdamW moments and count, EMA, step) into the port's train state: the
moments and the EMA have the params' tree, so they map the same way.
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


def state_dict_from_flax(params: Mapping, config: MDMConfig) -> Dict[str, torch.Tensor]:
    """flax MDM params (``model.init``'s ``{"params": ...}`` or its inner
    tree) -> a state_dict that ``MDM(config).load_state_dict(.., strict=True)``
    accepts."""
    p = params.get("params", params)
    sd = {
        **_linear(p["embed_timestep"]["time_embed_0"], "embed_timestep.time_embed.0"),
        **_linear(p["embed_timestep"]["time_embed_2"], "embed_timestep.time_embed.2"),
        **_linear(p["input_process"]["poseEmbedding"], "input_process.poseEmbedding"),
        **_linear(p["output_process"]["poseFinal"], "output_process.poseFinal"),
    }
    if config.cond_mode == "text":
        sd.update(_linear(p["embed_text"], "embed_text"))
    stack, layer = (("seqTransEncoder", _encoder_layer) if config.arch == "trans_enc"
                    else ("seqTransDecoder", _decoder_layer))
    for i in range(config.num_layers):
        sd.update(layer(p[stack][f"layers_{i}"], f"{stack}.layers.{i}"))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}


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
