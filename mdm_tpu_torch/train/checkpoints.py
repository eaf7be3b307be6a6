"""Checkpoint save and restore with torch.save, and the run's args.json.

Counterpart of mdm_tpu/train/checkpoints.py (:19-60; reference
train/training_loop.py:385-444): one checkpoint per step under save_dir,
named ``ckpt_{step:09d}`` as in the JAX package (a file here, written by
``torch.save`` of the whole train state), the run config as args.json
beside them, resume from the highest step, and the (EMA) parameters alone
for sampling (``restore_params_only``), and any checkpoint as numpy
arrays whatever world wrote it (``restore_pytree_numpy``; in a
multi-process world rank 0 writes the one file and every rank reads it
onto its own device). A tensor-parallel state (``tp_rules.shard_state_``)
is saved gathered, in the one-process layout, so every reader takes it as
it is, and restores onto a tensor-parallel state as this rank's part. A
checkpoint that mdm_tpu wrote is
an orbax directory, which the port does not read: converting one is
ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from .state import TrainState

CKPT_RE = re.compile(r"^ckpt_(\d+)$")


def save_args(save_dir: str, args: Dict[str, Any]):
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "args.json"), "w") as f:
        json.dump(args, f, indent=2, sort_keys=True, default=str)


def load_args(save_dir_or_ckpt: str) -> Dict[str, Any]:
    """args.json of a run dir, or of the run dir holding a checkpoint."""
    d = save_dir_or_ckpt
    if not os.path.isdir(d):
        d = os.path.dirname(d)
    with open(os.path.join(d, "args.json")) as f:
        return json.load(f)


def save_checkpoint(save_dir: str, step: int, state: TrainState) -> str:
    """Write the whole train state; a reader never sees a partial file. A
    tensor-parallel state is first gathered over its model group
    (``tp_rules.gather_state``, a collective every rank calls), and rank 0
    alone writes the one-process file; every rank returns its path."""
    path = os.path.abspath(os.path.join(save_dir, f"ckpt_{step:09d}"))
    if state.tp is not None:
        from ..parallel.multihost import is_primary
        from ..parallel.tp_rules import gather_state

        sd = gather_state(state)
        if not is_primary():
            return path
    else:
        sd = state.state_dict()
    os.makedirs(save_dir, exist_ok=True)
    torch.save(sd, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def find_resume_checkpoint(save_dir: str) -> Optional[Tuple[str, int]]:
    """Highest-step checkpoint in save_dir (reference training_loop.py:385-397)."""
    if not os.path.isdir(save_dir):
        return None
    best = None
    for name in os.listdir(save_dir):
        m = CKPT_RE.match(name)
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (os.path.join(save_dir, name), int(m.group(1)))
    return best


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state`` (bit for bit) and return it; a
    tensor-parallel state loads the whole tensors and keeps its part."""
    sd = _load(path, next(state.model.parameters()).device)
    if state.tp is not None:
        from ..parallel.tp_rules import local_state_dict

        sd = local_state_dict(sd, state)
    state.load_state_dict(sd)
    return state


def _load(path: str, device) -> Dict[str, Any]:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint written by mdm_tpu, which "
            "mdm_tpu_torch does not read (its checkpoints are torch.save files); "
            "converting one is ROADMAP Queue 1 item 11")
    return torch.load(path, map_location=device, weights_only=True)


def restore_pytree_numpy(path: str):
    """A checkpoint as nested dicts and lists of numpy arrays (the tensors
    read onto the CPU; other values as saved), whatever world and device
    wrote it: mdm_tpu/train/checkpoints.py:65-98's counterpart for the
    port's own files."""
    def to_numpy(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, dict):
            return {k: to_numpy(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(to_numpy(x) for x in v)
        return v

    return to_numpy(_load(path, "cpu"))


def restore_params_only(path: str, model: torch.nn.Module, use_ema: bool = True
                        ) -> torch.nn.Module:
    """Load a checkpoint's parameters into ``model`` (in place; the optimizer
    state is not read) and return it: the EMA parameters when ``use_ema``
    and the checkpoint has them, else the trained ones (mdm_tpu's
    restore_params_only, mdm_tpu/train/checkpoints.py:99-106)."""
    device = next(model.parameters()).device
    sd = _load(path, device)
    weights = dict(sd["model"])
    if use_ema and sd.get("ema_params") is not None:
        weights.update(sd["ema_params"])
    model.load_state_dict(weights)
    return model
