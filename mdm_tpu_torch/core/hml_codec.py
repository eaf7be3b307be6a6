"""HumanML3D / KIT-ML motion feature codec ("hml_vec").

Counterpart of mdm_tpu/core/hml_codec.py. The per-frame vector is
``[root_rot_vel(1) | root_lin_vel_xz(2) | root_y(1) | ric (J-1)*3 | rot
(J-1)*6 | local_vel J*3 | foot_contact(4)]`` (263 for HumanML's 22 joints,
251 for KIT's 21).

- Decode, in torch on any device (reference motion_process.py:366-452):
  ``recover_from_ric`` integrates the root yaw and planar velocity and
  rotates the root-relative joints into the world frame (every sampling
  call); ``recover_from_rot`` decodes the rotation channels by forward
  kinematics; ``recover_rot`` returns them as cont6d.
- Encode, on the host (offline preprocessing, motion_process.py:43-355):
  ``process_file`` puts a joint sequence [T, J, 3] on the floor, at the
  origin, facing Z+, and ``extract_features`` turns it into [T-1, D]
  features, as a user prepares their own joints for ``cli.train``. It runs
  numpy in float64 with mdm_tpu's rounding points: every quaternion call
  (qrot, qmul, qinv, qbetween, quaternion_to_cont6d) goes through float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import quaternions as Q
from .skeleton import KIT_FACE_JOINTS, T2M_FACE_JOINTS, Skeleton, kit_skeleton, t2m_skeleton

__all__ = [
    "recover_root_rot_pos",
    "recover_from_ric",
    "recover_from_rot",
    "recover_rot",
    "recover_root_rot_heading_ang",
    "extract_features",
    "process_file",
    "feature_dim",
    "HML_JOINT_NAMES",
    "HML_EE_JOINT_NAMES",
]

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


def _rot_channels(data: torch.Tensor, joints_num: int):
    """(cont6d [..., T, J, 6] with the root's yaw first, r_pos [..., T, 3])."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    start = 1 + 2 + 1 + (joints_num - 1) * 3
    end = start + (joints_num - 1) * 6
    cont6d = data[..., start:end].reshape(data.shape[:-1] + (joints_num - 1, 6))
    root = Q.quaternion_to_cont6d(r_rot_quat)[..., None, :]
    return torch.cat([root, cont6d], dim=-2), r_pos


def recover_from_rot(data: torch.Tensor, joints_num: int, skeleton: Skeleton,
                     offsets: torch.Tensor) -> torch.Tensor:
    """Decode via the rotation channels and forward kinematics instead of
    the ric channels: [..., T, D] -> joints [..., T, J, 3]."""
    cont6d, r_pos = _rot_channels(data, joints_num)
    return skeleton.forward_kinematics_cont6d(cont6d, r_pos, offsets)


def recover_rot(data: torch.Tensor) -> torch.Tensor:
    """Per-joint cont6d and a padded root-translation row: data [..., T,
    263/251] -> [..., T, J+1, 6] (last row: root position, zero-padded)."""
    cont6d, r_pos = _rot_channels(data, 22 if data.shape[-1] == 263 else 21)
    r_pos_pad = torch.cat([r_pos, torch.zeros_like(r_pos)], dim=-1)[..., None, :]
    return torch.cat([cont6d, r_pos_pad], dim=-2)


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


# ---------------------------------------------------------------------------
# Encode path (host: offline preprocessing and round-trip tests)
# ---------------------------------------------------------------------------

def _f32(fn, *arrays) -> np.ndarray:
    """``fn`` of quaternion functions on float32 copies of ``arrays``, back
    to numpy: mdm_tpu's rounding points (it calls the JAX functions on f32)."""
    return fn(*(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                for a in arrays)).numpy()


def _foot_contacts(positions: np.ndarray, fid_l, fid_r, thres: float):
    def contact(fid):
        d = positions[1:, fid] - positions[:-1, fid]
        return ((d ** 2).sum(axis=-1) < thres).astype(np.float32)

    return contact(fid_l), contact(fid_r)


def extract_features(positions: np.ndarray, feet_thre: float, skeleton: Skeleton, face_joints,
                     fid_r, fid_l) -> np.ndarray:
    """Positions [T, J, 3] -> hml features [T-1, D], on the host."""
    positions = positions.astype(np.float64).copy()
    global_positions = positions.copy()

    feet_l, feet_r = _foot_contacts(positions, fid_l, fid_r, feet_thre)

    quat_params = skeleton.inverse_kinematics(positions, face_joints, smooth_forward=True)
    cont6d = _f32(Q.quaternion_to_cont6d, quat_params)
    r_rot = quat_params[:, 0].copy()

    velocity = _f32(Q.qrot, r_rot[1:], positions[1:, 0] - positions[:-1, 0])
    r_velocity = _f32(lambda a, b: Q.qmul(a, Q.qinv(b)), r_rot[1:], r_rot[:-1])

    # Root-relative ("rifke") local positions, all frames rotated to face Z+.
    positions[..., 0] -= positions[:, 0:1, 0]
    positions[..., 2] -= positions[:, 0:1, 2]
    positions = _f32(Q.qrot, np.repeat(r_rot[:, None], positions.shape[1], axis=1), positions)

    root_y = positions[:, 0, 1:2]
    r_vel_ang = np.arcsin(r_velocity[:, 2:3])
    l_vel_xz = velocity[:, [0, 2]]
    root_data = np.concatenate([r_vel_ang, l_vel_xz, root_y[:-1]], axis=-1)

    rot_data = cont6d[:, 1:].reshape(len(cont6d), -1)
    ric_data = positions[:, 1:].reshape(len(positions), -1)

    local_vel = _f32(Q.qrot, np.repeat(r_rot[:-1, None], global_positions.shape[1], axis=1),
                     global_positions[1:] - global_positions[:-1]).reshape(len(positions) - 1, -1)

    return np.concatenate(
        [root_data, ric_data[:-1], rot_data[:-1], local_vel, feet_l, feet_r], axis=-1
    ).astype(np.float32)


def process_file(positions: np.ndarray, feet_thre: float, dataset: str = "t2m",
                 tgt_offsets: Optional[np.ndarray] = None):
    """Full preprocessing: floor, origin and face-Z+ normalization, then
    the features. ``dataset`` is "t2m" (HumanML3D's 22 joints) or "kit";
    ``tgt_offsets`` [J, 3] retargets onto a skeleton's bone lengths first.

    Returns (features [T-1, D], global_positions [T, J, 3])."""
    skeleton = t2m_skeleton() if dataset == "t2m" else kit_skeleton()
    face_joints = T2M_FACE_JOINTS if dataset == "t2m" else KIT_FACE_JOINTS
    fid_r, fid_l = ([8, 11], [7, 10]) if dataset == "t2m" else ([14, 15], [19, 20])

    positions = positions.astype(np.float64).copy()
    if tgt_offsets is not None:
        positions = _uniform_skeleton(positions, skeleton, face_joints, tgt_offsets, dataset)

    positions[:, :, 1] -= positions.min(axis=0).min(axis=0)[1]  # put on floor
    root_init = positions[0]
    positions = positions - root_init[0] * np.array([1, 0, 1])  # XZ to origin

    # Rotate so the initial pose faces Z+.
    r_hip, l_hip, sdr_r, sdr_l = face_joints
    across = (root_init[r_hip] - root_init[l_hip]) + (root_init[sdr_r] - root_init[sdr_l])
    across = across / np.linalg.norm(across)
    forward = np.cross(np.array([0, 1, 0]), across)
    forward = forward / np.linalg.norm(forward)
    init_quat = _f32(Q.qbetween, forward[None], np.array([[0.0, 0.0, 1.0]]))[0]
    quat_full = np.broadcast_to(init_quat, positions.shape[:-1] + (4,))
    positions = _f32(Q.qrot, quat_full, positions).astype(np.float64)

    feats = extract_features(positions, feet_thre, skeleton, face_joints, fid_r, fid_l)
    return feats, positions


def _uniform_skeleton(positions, skeleton, face_joints, tgt_offsets, dataset):
    l_idx1, l_idx2 = (5, 8) if dataset == "t2m" else (17, 18)
    src_offset = skeleton.offsets_from_rest_pose(positions[0])
    src_leg = np.abs(src_offset[l_idx1]).max() + np.abs(src_offset[l_idx2]).max()
    tgt_leg = np.abs(tgt_offsets[l_idx1]).max() + np.abs(tgt_offsets[l_idx2]).max()
    scale = tgt_leg / src_leg
    tgt_root = positions[:, 0] * scale
    quat_params = skeleton.inverse_kinematics(positions, face_joints)
    joints = _f32(skeleton.forward_kinematics, quat_params, tgt_root, tgt_offsets)
    return joints.astype(np.float64)
