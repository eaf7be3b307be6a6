"""Small utilities (counterpart of mdm_tpu/utils/misc.py; reference
utils/misc.py equivalents that survive the functional redesign)."""
from __future__ import annotations

import numpy as np
import torch


def freeze_joints(x: torch.Tensor, joints_to_freeze) -> torch.Tensor:
    """Freeze selected joints' rotations to their first-frame values.

    x: [B, T, J, F] (canonical layout; reference misc.py:69-74 uses
    [B, J, F, T]). Returns a copy with the frozen joints broadcast from t=0.
    """
    idx = torch.as_tensor(list(joints_to_freeze), device=x.device)
    out = x.clone()
    out[:, :, idx, :] = x[:, :1, idx, :].expand_as(x[:, :, idx, :])
    return out


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
