"""Train-time goal conditioning (DiP target conditioning).

Counterpart of mdm_tpu/train/goal_cond.py: ``goal_cond_modifier`` gives a
host batch its goal validity (and, if asked, its targets),
``make_target_cond_fn`` extracts the targets inside the train step, and
``make_target_loss_builder`` gives the step the target loss of
``lambda_target_loc`` (masked_goal_l2 on the prediction's goal tensor).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.goals import get_target_location, goal_loss_mask, sample_goal
from ..diffusion.losses import masked_goal_l2


def goal_cond_modifier(
    batch: Dict,
    rng: np.random.Generator,
    mean: np.ndarray,
    std: np.ndarray,
    joints_num: int = 22,
    force_joints: Optional[str] = None,
    compute_target: bool = True,
) -> Dict:
    """The batch with ``target_validity`` and ``is_heading`` (numpy, drawn
    from ``rng`` as mdm_tpu's are) and, with ``compute_target``, the GT
    ``target_cond`` [B, G+2, 3] of ``batch["x"]``. Without it the train
    step extracts the targets (``make_train_step(target_cond_fn=...)``)."""
    x = torch.as_tensor(batch["x"])
    validity, is_heading = sample_goal(x.shape[0], rng, force_joints=force_joints)
    batch = dict(batch)
    if compute_target:
        batch["target_cond"] = get_target_location(
            x, *_stats(mean, std, x), joints_num, validity=torch.from_numpy(validity).to(x.device))
    batch["target_validity"] = validity
    batch["is_heading"] = is_heading
    return batch


def _stats(mean, std, like: torch.Tensor):
    return tuple(torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)
                 for a in (mean, std))


def make_target_cond_fn(mean: np.ndarray, std: np.ndarray, joints_num: int = 22) -> Callable:
    """fn(x_start, validity) -> GT targets, for the extraction inside the
    train step."""

    def fn(x_start, validity):
        return get_target_location(x_start, *_stats(mean, std, x_start), joints_num,
                                   validity=validity)

    return fn


def make_target_loss_builder(mean: np.ndarray, std: np.ndarray, joints_num: int = 22
                             ) -> Callable:
    """-> target_loss_builder(batch) for ``make_train_step``: None when the
    batch has no targets, else model output -> per-sample goal loss."""

    def builder(batch: Dict) -> Optional[Callable]:
        cond = batch["cond"]
        if cond.target_cond is None or cond.target_validity is None:
            return None
        validity, ref_goal = cond.target_validity, cond.target_cond
        loc_mask, is_heading = goal_loss_mask(validity), validity[:, -1]
        stats = _stats(mean, std, ref_goal)

        def fn(model_output):
            pred = get_target_location(model_output, *stats, joints_num, validity=validity)
            return masked_goal_l2(pred, ref_goal, loc_mask, is_heading)

        return fn

    return builder
