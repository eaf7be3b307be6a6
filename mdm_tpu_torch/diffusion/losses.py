"""Diffusion training losses: masked L2 and the geometric terms.

Counterpart of mdm_tpu/diffusion/losses.py (:24-199; reference
gaussian_diffusion.py:1224-1354 and utils/loss_util.py). Layout: features
``x: [B, T, D]`` with ``mask: [B, T, 1]`` (True = valid frame); the
geometric terms work on decoded joints ``[B, T, J, 3]`` from an injected
``get_xyz``. The port's schedule has no learned variance and no
PREVIOUS_X prediction, so the ``vb`` term and that target do not arise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from . import gaussian as G
from .schedule import MeanType, Schedule, VarType


def masked_l2(
    a: torch.Tensor,
    b: torch.Tensor,
    mask: torch.Tensor,
    *,
    loss_fn: Callable = lambda x, y: (x - y) ** 2,
    epsilon: float = 1e-8,
    entries_norm: bool = True,
) -> torch.Tensor:
    """Per-sample mean of the squared error over unmasked elements.

    ``mask`` broadcasts against ``a``; when it is per frame, ``entries_norm``
    scales the normaliser by the feature elements per frame (reference
    loss_util.py:13-31)."""
    loss = G.sum_flat(loss_fn(a, b) * mask.to(a.dtype))
    non_zero = G.sum_flat(mask.to(a.dtype))
    if entries_norm:
        non_zero = non_zero * (math.prod(a.shape[1:]) // math.prod(mask.shape[1:]))
    return loss / (non_zero + epsilon)


def angle_l2(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Squared wrapped angular difference (period pi), reference loss_util.py:5-8."""
    a = torch.remainder(a1 - a2 + math.pi / 2, math.pi) - math.pi / 2
    return a ** 2


def masked_goal_l2(pred_goal: torch.Tensor, ref_goal: torch.Tensor, loc_mask: torch.Tensor,
                   is_heading: torch.Tensor) -> torch.Tensor:
    """Goal loss: per-joint location L2 + wrapped heading L2. pred/ref_goal
    [B, G+1, 3] (last row: heading angle in [..., 0]); loc_mask [B, G, 3];
    is_heading [B] bool."""
    loc_loss = masked_l2(pred_goal[:, :-1], ref_goal[:, :-1], loc_mask, entries_norm=False)
    heading_loss = masked_l2(pred_goal[:, -1:, :1], ref_goal[:, -1:, :1],
                             is_heading[:, None, None], loss_fn=angle_l2, entries_norm=False)
    return loc_loss + heading_loss


@dataclass(frozen=True)
class LossConfig:
    """Static loss weights and flags (reference GaussianDiffusion.__init__)."""

    mean_type: MeanType = MeanType.START_X
    var_type: VarType = VarType.FIXED_SMALL
    lambda_rcxyz: float = 0.0
    lambda_vel: float = 0.0
    lambda_vel_rcxyz: float = 0.0
    lambda_fc: float = 0.0
    lambda_target_loc: float = 0.0
    fc_joints: tuple = (7, 10, 8, 11)  # a2m foot contacts: L_Ankle, L_Foot, R_Ankle, R_Foot
    fc_threshold: float = 0.01
    vel_drop_last_feats: int = 0  # vel_mse leaves out the last features (a2m root row)
    rescale_vb: bool = False


def training_losses(
    sched: Schedule,
    model_output: torch.Tensor,
    x_start: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    mask: torch.Tensor,
    config: LossConfig = LossConfig(),
    *,
    get_xyz: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    target_loss_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Per-sample loss terms of the model output on x_t.

    get_xyz: features [B, T, D] -> joints [B, T, J, 3], for the rcxyz,
    vel_rcxyz and fc terms. target_loss_fn: model output -> per-sample goal
    loss."""
    if config.var_type not in (VarType.FIXED_SMALL, VarType.FIXED_LARGE):
        raise NotImplementedError("learned-variance training (the vb term) is not ported yet: "
                                  "ROADMAP Queue 1 item 5 (Training: vb)")
    terms: Dict[str, torch.Tensor] = {}
    target = x_start if config.mean_type == MeanType.START_X else noise

    terms["rot_mse"] = masked_l2(target, model_output, mask)

    if config.lambda_rcxyz > 0 or config.lambda_vel_rcxyz > 0 or config.lambda_fc > 0:
        if get_xyz is None:
            raise ValueError("geometric losses need a get_xyz decoder")
        target_xyz, pred_xyz = get_xyz(target), get_xyz(model_output)
        mask_xyz = mask[..., None]  # [B, T, 1, 1]

    if config.lambda_rcxyz > 0:
        terms["rcxyz_mse"] = masked_l2(target_xyz, pred_xyz, mask_xyz)

    if config.lambda_vel_rcxyz > 0:
        tv = target_xyz[:, 1:] - target_xyz[:, :-1]
        pv = pred_xyz[:, 1:] - pred_xyz[:, :-1]
        terms["vel_xyz_mse"] = masked_l2(tv, pv, mask_xyz[:, 1:])

    if config.lambda_fc > 0:
        fj = list(config.fc_joints)
        gt_j = target_xyz[:, :, fj]  # [B, T, 4, 3]
        gt_vel = torch.linalg.vector_norm(gt_j[:, 1:] - gt_j[:, :-1], dim=-1)  # [B, T-1, 4]
        contact = (gt_vel <= config.fc_threshold)[..., None]
        pred_j = pred_xyz[:, :, fj]
        pred_vel = (pred_j[:, 1:] - pred_j[:, :-1]) * contact
        terms["fc"] = masked_l2(pred_vel, torch.zeros_like(pred_vel), mask[..., None][:, 1:])

    if config.lambda_vel > 0:
        d = config.vel_drop_last_feats
        sl = slice(None, -d if d > 0 else None)
        tv = target[:, 1:, sl] - target[:, :-1, sl]
        pv = model_output[:, 1:, sl] - model_output[:, :-1, sl]
        terms["vel_mse"] = masked_l2(tv, pv, mask[:, 1:])

    if config.lambda_target_loc > 0:
        if target_loss_fn is None:
            raise ValueError("lambda_target_loc > 0 needs a target_loss_fn")
        terms["target_loc"] = target_loss_fn(model_output)

    loss = terms["rot_mse"]
    for weight, name in ((config.lambda_vel, "vel_mse"), (config.lambda_rcxyz, "rcxyz_mse"),
                         (config.lambda_vel_rcxyz, "vel_xyz_mse"),
                         (config.lambda_target_loc, "target_loc"), (config.lambda_fc, "fc")):
        if name in terms:
            loss = loss + weight * terms[name]
    terms["loss"] = loss
    return terms
