"""HumanML3D / KIT-ML feature decode ("hml_vec" -> joint positions).

Counterpart of mdm_tpu/core/hml_codec.py (:59-106, and the heading angle
of :138). The per-frame vector is
``[root_rot_vel(1) | root_lin_vel_xz(2) | root_y(1) | ric (J-1)*3 | rot
(J-1)*6 | local_vel J*3 | foot_contact(4)]``; decode integrates the root
yaw and planar velocity and rotates the root-relative joints into the world
frame (reference motion_process.py:366-452).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import quaternions as Q

HML_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot", "right_foot",
    "neck", "left_collar", "right_collar", "head", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
]
HML_EE_JOINT_NAMES = ["left_foot", "right_foot", "left_wrist", "right_wrist", "head"]


def feature_dim(joints_num: int) -> int:
    return 4 + (joints_num - 1) * 3 + (joints_num - 1) * 6 + joints_num * 3 + 4


def recover_root_rot_pos(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """data [..., T, D] -> (r_rot_quat [..., T, 4], r_pos [..., T, 3])."""
    rot_vel = data[..., 0]
    # Frame t accumulates the velocities of frames < t (exclusive prefix sum).
    shifted = torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1)
    r_rot_ang = torch.cumsum(shifted, dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)

    r_pos_local = torch.zeros(data.shape[:-1] + (3,), dtype=data.dtype, device=data.device)
    r_pos_local[..., 1:, 0] = data[..., :-1, 1]  # planar velocity of frames < t
    r_pos_local[..., 1:, 2] = data[..., :-1, 2]
    # Rotate each step's local velocity into the world frame, then integrate.
    r_pos = torch.cumsum(Q.qrot(Q.qinv(r_rot_quat), r_pos_local), dim=-2)
    r_pos[..., 1] = data[..., 3]
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """Decode hml features [..., T, D] to joint positions [..., T, J, 3]."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4: (joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    # Rotate local joints into the world frame by the inverse root yaw.
    inv_rot = Q.qinv(r_rot_quat)[..., None, :].expand(positions.shape[:-1] + (4,))
    positions = Q.qrot(inv_rot, positions)
    positions[..., 0] += r_pos[..., None, 0]
    positions[..., 2] += r_pos[..., None, 2]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def recover_root_rot_heading_ang(joints: torch.Tensor) -> torch.Tensor:
    """Heading angle (rad) from joint positions [B, J, 3] -> [B, 1]: the
    forward direction, up x (hips + shoulders across), as atan2(x, z)."""
    r_hip, l_hip, sdr_r, sdr_l = 2, 1, 17, 16
    across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
    across = across / torch.linalg.vector_norm(across, dim=-1, keepdim=True).clamp_min(1e-12)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=joints.dtype, device=joints.device)
    forward = torch.linalg.cross(up.expand_as(across), across, dim=-1)
    forward = forward / torch.linalg.vector_norm(forward, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.atan2(forward[:, 0], forward[:, 2])[:, None]
