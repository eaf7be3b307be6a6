"""Checkpoint save and restore with torch.save, and the run's args.json.

Counterpart of mdm_tpu/train/checkpoints.py (:19-60; reference
train/training_loop.py:385-444): one checkpoint per step under save_dir,
named ``ckpt_{step:09d}`` as in the JAX package (a file here, written by
``torch.save`` of the whole train state), the run config as args.json
beside them, and resume from the highest step.
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
    """Write the whole train state; a reader never sees a partial file."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(save_dir, f"ckpt_{step:09d}"))
    torch.save(state.state_dict(), path + ".tmp")
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
    """Load a checkpoint into ``state`` (bit for bit) and return it."""
    device = next(state.model.parameters()).device
    state.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return state
