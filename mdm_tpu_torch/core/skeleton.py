"""Kinematic skeleton: forward kinematics in torch, inverse kinematics on
the host.

Counterpart of mdm_tpu/core/skeleton.py (reference
``data_loaders/humanml/common/skeleton.py``): the two mocap skeletons'
kinematic chains (which ``visualize/plot_script`` draws), quaternion and
cont6d FK as a static unroll over the chains, and the offline IK. FK keeps
the reference's per-chain quirk: every chain restarts its accumulated
rotation from the root quaternion, and the bone offset of joint j is
rotated by the rotation accumulated through j (skeleton.py:117-126).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import quaternions as Q
from .quaternions import cont6d_to_matrix

# Joint indices root-outward per chain (reference paramUtil.py).
T2M_KINEMATIC_CHAINS: List[List[int]] = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]
KIT_KINEMATIC_CHAINS: List[List[int]] = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]

# Unit bone directions in the rest pose.
T2M_RAW_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0],
     [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1],
     [0, 1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -1, 0],
     [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0]],
    dtype=np.float32,
)
KIT_RAW_OFFSETS = np.array(
    [[0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [1, 0, 0],
     [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
     [0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
     [0, -1, 0], [0, 0, 1], [0, 0, 1]],
    dtype=np.float32,
)

T2M_FACE_JOINTS = [2, 1, 17, 16]  # r_hip, l_hip, sdr_r, sdr_l
KIT_FACE_JOINTS = [11, 16, 5, 8]


def parents_from_chains(chains: Sequence[Sequence[int]], njoints: int) -> np.ndarray:
    parents = np.zeros(njoints, dtype=np.int32)
    parents[0] = -1
    for chain in chains:
        for i in range(1, len(chain)):
            parents[chain[i]] = chain[i - 1]
    return parents


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


@dataclass(frozen=True)
class Skeleton:
    """Static skeleton description; every field is a host constant."""

    raw_offsets: np.ndarray  # [J, 3] unit bone directions
    chains: Tuple[Tuple[int, ...], ...]
    parents: np.ndarray = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "parents", parents_from_chains(self.chains, len(self.raw_offsets)))

    @property
    def njoints(self) -> int:
        return len(self.raw_offsets)

    def offsets_from_rest_pose(self, rest_joints: np.ndarray) -> np.ndarray:
        """Unit directions scaled by the bone lengths of a rest pose [J, 3]."""
        offsets = self.raw_offsets.astype(np.float64).copy()
        for j in range(1, self.njoints):
            bone = rest_joints[j] - rest_joints[self.parents[j]]
            offsets[j] = np.linalg.norm(bone) * offsets[j]
        return offsets.astype(np.float32)

    def forward_kinematics(self, quats: torch.Tensor, root_pos: torch.Tensor,
                           offsets: torch.Tensor, do_root_rotation: bool = True) -> torch.Tensor:
        """Quaternion FK: quats [..., J, 4], root_pos [..., 3], offsets [J, 3]
        (or [..., J, 3]) -> joints [..., J, 3]."""
        pos = [None] * self.njoints
        root_q = quats[..., 0, :]
        if not do_root_rotation:
            root_q = torch.zeros_like(root_q)
            root_q[..., 0] = 1.0
        pos[0] = root_pos
        offsets = torch.broadcast_to(offsets, quats.shape[:-1] + (3,))
        for chain in self.chains:
            acc = root_q
            for i in range(1, len(chain)):
                j = chain[i]
                acc = Q.qmul(acc, quats[..., j, :])
                pos[j] = Q.qrot(acc, offsets[..., j, :]) + pos[chain[i - 1]]
        return torch.stack(pos, dim=-2)

    def forward_kinematics_cont6d(self, cont6d: torch.Tensor, root_pos: torch.Tensor,
                                  offsets: torch.Tensor,
                                  do_root_rotation: bool = True) -> torch.Tensor:
        """cont6d FK (the HumanML column convention): cont6d [..., J, 6],
        with ``forward_kinematics``'s per-chain accumulation."""
        mats = cont6d_to_matrix(cont6d)  # [..., J, 3, 3]
        pos = [None] * self.njoints
        root_m = mats[..., 0, :, :]
        if not do_root_rotation:
            root_m = torch.eye(3, dtype=cont6d.dtype, device=cont6d.device).expand(root_m.shape)
        pos[0] = root_pos
        offsets = torch.broadcast_to(offsets, cont6d.shape[:-1] + (3,))
        for chain in self.chains:
            acc = root_m
            for i in range(1, len(chain)):
                j = chain[i]
                acc = acc @ mats[..., j, :, :]
                pos[j] = torch.einsum("...ij,...j->...i", acc, offsets[..., j, :]) \
                    + pos[chain[i - 1]]
        return torch.stack(pos, dim=-2)

    def inverse_kinematics(self, joints: np.ndarray, face_joints: Sequence[int],
                           smooth_forward: bool = False) -> np.ndarray:
        """Positions [T, J, 3] -> local quaternions [T, J, 4], on the host
        (reference skeleton.py:55-104, its l_hip/r_hip argument order too);
        offline preprocessing only."""
        import scipy.ndimage as ndi

        l_hip, r_hip, sdr_r, sdr_l = face_joints
        across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
        across = across / np.linalg.norm(across, axis=-1, keepdims=True)
        forward = np.cross(np.array([[0.0, 1.0, 0.0]]), across, axis=-1)
        if smooth_forward:
            forward = ndi.gaussian_filter1d(forward, 20, axis=0, mode="nearest")
        forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)

        target = np.tile(np.array([[0.0, 0.0, 1.0]]), (len(forward), 1))
        root_quat = Q.qbetween(_f32(forward), _f32(target)).numpy()

        quat_params = np.zeros(joints.shape[:-1] + (4,), dtype=np.float64)
        quat_params[:, 0] = root_quat
        for chain in self.chains:
            R = root_quat
            for i in range(len(chain) - 1):
                u = np.tile(self.raw_offsets[chain[i + 1]][None], (len(joints), 1))
                v = joints[:, chain[i + 1]] - joints[:, chain[i]]
                v = v / np.linalg.norm(v, axis=-1, keepdims=True)
                rot_u_v = Q.qbetween(_f32(u), _f32(v))
                R_loc = Q.qmul(Q.qinv(_f32(R)), rot_u_v).numpy()
                quat_params[:, chain[i + 1]] = R_loc
                R = Q.qmul(_f32(R), _f32(R_loc)).numpy()
        return quat_params


def t2m_skeleton() -> Skeleton:
    return Skeleton(T2M_RAW_OFFSETS, tuple(tuple(c) for c in T2M_KINEMATIC_CHAINS))


def kit_skeleton() -> Skeleton:
    return Skeleton(KIT_RAW_OFFSETS, tuple(tuple(c) for c in KIT_KINEMATIC_CHAINS))
