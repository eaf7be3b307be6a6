"""DiP multi-target goal conditioning: target extraction and goal sampling.

Counterpart of mdm_tpu/core/goals.py: the requested joints of each sample
are a boolean validity matrix [B, G+2] over (goal joints..., traj,
heading). Goal tensor layout [B, G+2, 3]: the goal joints' last-frame
world locations, then the planar trajectory (the pelvis with y zeroed),
then the heading angle in [..., 0]. ``sample_goal`` and
``get_allowed_joint_options`` are numpy on the host; the rest is torch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import quaternions as Q
from .hml_codec import (HML_EE_JOINT_NAMES, HML_JOINT_NAMES, recover_from_ric,
                        recover_root_rot_heading_ang)

ALL_GOAL_JOINT_NAMES: List[str] = ["pelvis"] + HML_EE_JOINT_NAMES


def extended_goal_names(all_goal_joint_names: Sequence[str] = ALL_GOAL_JOINT_NAMES):
    return list(all_goal_joint_names) + ["traj", "heading"]


def goal_joint_indices(all_goal_joint_names: Sequence[str] = ALL_GOAL_JOINT_NAMES):
    """HML joint index for each goal row (the traj row reuses the pelvis)."""
    idx = [HML_JOINT_NAMES.index(n) for n in all_goal_joint_names]
    idx.append(HML_JOINT_NAMES.index("pelvis"))
    return np.asarray(idx, dtype=np.int64)


def get_target_location(
    motion: torch.Tensor,  # [B, T, D] normalized hml features
    mean: torch.Tensor,
    std: torch.Tensor,
    joints_num: int = 22,
    all_goal_joint_names: Sequence[str] = ALL_GOAL_JOINT_NAMES,
    validity: Optional[torch.Tensor] = None,  # [B, G+2] bool
) -> torch.Tensor:
    """Last-frame goal tensor [B, G+2, 3] from a motion batch: every row
    decoded, the rows not requested zeroed by ``validity``."""
    joints = recover_from_ric(motion * std + mean, joints_num)  # [B, T, J, 3]
    last = joints[:, -1]
    target = last[:, torch.as_tensor(goal_joint_indices(all_goal_joint_names),
                                     device=motion.device)]  # [B, G+1, 3]
    planar = torch.tensor([1.0, 0.0, 1.0], dtype=motion.dtype, device=motion.device)
    target = torch.cat([target[:, :-1], target[:, -1:] * planar], dim=1)  # traj: no height
    heading = recover_root_rot_heading_ang(last)  # [B, 1]
    heading_row = torch.cat([heading, heading.new_zeros(heading.shape[0], 2)], dim=-1)[:, None]
    target = torch.cat([target, heading_row], dim=1)  # [B, G+2, 3]
    if validity is not None:
        target = target * validity[..., None].to(target.dtype)
    return target


def sample_goal(
    batch_size: int,
    rng: np.random.Generator,
    force_joints: Optional[str] = None,
    all_goal_joint_names: Sequence[str] = ALL_GOAL_JOINT_NAMES,
    none_prob: float = 0.5,
    max_goal_joints: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random per-sample goal configuration for training: (validity [B,
    G+2] bool with the heading row, is_heading [B]). Up to two goals from
    {None, traj, pelvis, end effectors} with P(None) = 0.5 and heading a
    fair coin, unless ``force_joints`` names a curriculum; the same draws
    from ``rng`` as mdm_tpu's."""
    names = extended_goal_names(all_goal_joint_names)
    validity = np.zeros((batch_size, len(names)), dtype=bool)
    is_heading = np.zeros(batch_size, dtype=bool)

    if force_joints is None:
        choices = ["None", "traj", "pelvis"] + list(HML_EE_JOINT_NAMES)
        probs = np.full(len(choices), (1 - none_prob) / (len(choices) - 1))
        probs[0] = none_prob
        for b in range(batch_size):
            picks = rng.choice(choices, size=max_goal_joints, replace=True, p=probs)
            for p in set(picks):
                if p != "None":
                    validity[b, names.index(p)] = True
            is_heading[b] = rng.random() < 0.5
            validity[b, names.index("heading")] = is_heading[b]
        return validity, is_heading

    options = get_allowed_joint_options(force_joints)
    for b in range(batch_size):
        opt = list(options[rng.integers(len(options))])
        if "heading" in opt:
            is_heading[b] = True
            opt.remove("heading")
        for name in opt:
            validity[b, names.index(name)] = True
        validity[b, names.index("heading")] = is_heading[b]
    return validity, is_heading


def get_allowed_joint_options(config_name: str) -> List[List[str]]:
    """Named goal-joint curricula (reference motion_process.py:656-668)."""
    if config_name == "DIMP_FULL":
        return [["pelvis", "heading"], ["pelvis", "head"], ["traj", "heading"],
                ["right_wrist", "heading"], ["left_wrist", "heading"],
                ["right_foot", "heading"], ["left_foot", "heading"]]
    if config_name == "DIMP_FINAL":
        return [["pelvis", "heading"], ["traj", "heading"],
                ["right_wrist", "heading"], ["left_wrist", "heading"],
                ["right_foot", "heading"], ["left_foot", "heading"], []]
    if config_name == "DIMP_SLIM":
        return [["pelvis", "heading"], ["pelvis", "head"], ["traj", "heading"],
                ["left_wrist", "heading"], ["left_foot", "heading"]]
    if config_name == "DIMP_BENCH":
        return [["pelvis", "heading"], ["pelvis", "head"]]
    if config_name == "PURE_T2M":
        return [[]]
    return [config_name.split(",")]


def goal_loss_mask(validity: torch.Tensor) -> torch.Tensor:
    """Validity [B, G+2] -> location-loss mask [B, G+1, 3], the traj row's
    vertical axis masked out."""
    B, G2 = validity.shape
    loc = validity[:, :-1, None].expand(B, G2 - 1, 3).clone()
    loc[:, -1, 1] = False
    return loc


def traj_global2vel(traj_positions: torch.Tensor,  # [B, T, 2] world xz
                    traj_yaw: torch.Tensor,  # [B, T] heading (rad)
                    ) -> torch.Tensor:
    """Global planar trajectory -> the first 3 hml channels per step
    [B, T-1, 3]: yaw velocity (arcsin) and the rotated linear velocity."""
    zeros = torch.zeros_like(traj_yaw)
    quat = Q.euler_to_quaternion(torch.stack([zeros, traj_yaw, zeros], dim=-1), "yxz",
                                 deg=False)  # [B, T, 4]
    delta = traj_positions[:, 1:] - traj_positions[:, :-1]
    vel = torch.stack([delta[..., 0], torch.zeros_like(delta[..., 0]), delta[..., 1]], dim=-1)
    vel = Q.qrot(quat[:, 1:], vel)
    r_vel = Q.qmul(quat[:, 1:], Q.qinv(quat[:, :-1]))
    return torch.stack([torch.arcsin(r_vel[..., 2]), vel[..., 0], vel[..., 2]], dim=-1)
