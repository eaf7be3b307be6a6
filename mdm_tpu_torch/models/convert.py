"""Load reference PyTorch MDM checkpoints into the port's MDM.

Counterpart of mdm_tpu/models/convert.py. The published checkpoints are
torch state dicts saved by the reference training loop (CLIP keys stripped;
with EMA a dict ``{'model', 'model_avg'}``). The port's MDM keeps the
reference's parameter names and torch layouts (models/mdm.py,
models/layers.py), so most keys carry over as they are. What the
conversion does:

- drops ``clip_model.*`` and the reference's sinusoidal position tables
  (``sequence_pos_encoder.pe``, ``embed_timestep.sequence_pos_encoder.pe``),
  which the port rebuilds;
- orders the goal encoder's per-row parameters as the port's model names
  its rows: ``target_loc_emb.<name>.*`` by name, ``mini_mlps.<g>.*`` and the
  mixing weights by the reference's row order, which is mdm_tpu's joint-name
  order (``goal_joint_names`` + traj, heading).
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core.goals import ALL_GOAL_JOINT_NAMES, extended_goal_names
from .mdm import MDMConfig

_DROPPED = re.compile(r"^clip_model\.|(^|\.)sequence_pos_encoder\.pe$")


def _goal_rows(sd: Dict[str, torch.Tensor], config: MDMConfig,
               goal_joint_names: Optional[List[str]]) -> Dict[str, torch.Tensor]:
    """The goal encoder's keys renumbered from the checkpoint's row order
    (``goal_joint_names`` + traj, heading) to the port's (config.goal_names)."""
    theirs = extended_goal_names(goal_joint_names or ALL_GOAL_JOINT_NAMES)
    ours = config.goal_names
    if sorted(theirs) != sorted(ours):
        raise ValueError(f"goal rows {theirs} do not name the model's rows {ours}")
    src = [theirs.index(n) for n in ours]  # our row g <- their row src[g]
    pre = "embed_target_cond."
    out = {}
    for k, v in sd.items():
        m = re.match(re.escape(pre) + r"mini_mlps\.(\d+)\.(.*)$", k)
        if m:
            out[f"{pre}mini_mlps.{src.index(int(m.group(1)))}.{m.group(2)}"] = v
        elif k == f"{pre}target_all_loc_emb.weights":
            out[k] = v[src]
        else:
            out[k] = v
    return out


def convert_mdm_state_dict(sd: Mapping, config: MDMConfig,
                           goal_joint_names: Optional[List[str]] = None
                           ) -> Dict[str, torch.Tensor]:
    """A reference MDM state dict (tensors or numpy arrays) -> the state dict
    that ``MDM(config).load_state_dict(.., strict=True)`` accepts."""
    out = {k: v.detach().float() if isinstance(v, torch.Tensor)
           else torch.as_tensor(np.asarray(v, dtype=np.float32))
           for k, v in sd.items() if not _DROPPED.search(k)}
    if config.multi_target_cond:
        out = _goal_rows(out, config, goal_joint_names)
    return out


def load_torch_checkpoint(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference .pt checkpoint as a state dict of CPU tensors: the
    wrapped ``{'model'[, 'model_avg']}`` format (the EMA copy when
    ``use_ema`` and present, as the reference's load_saved_model) or a raw
    state dict. Read with ``weights_only=True``: tensors and dicts only."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, Mapping) and isinstance(sd.get("model"), Mapping):
        sd = sd["model_avg"] if (use_ema and "model_avg" in sd) else sd["model"]
    return {k: v.detach().cpu() for k, v in sd.items()}
