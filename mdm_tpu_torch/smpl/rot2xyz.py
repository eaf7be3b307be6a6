"""Rotation features -> joint/vertex xyz through the SMPL layer.

Counterpart of mdm_tpu/smpl/rot2xyz.py (reference model/rotation2xyz.py:
11-92): the input is the canonical [B, T, J, F] rotation tensor (or flat
[B, T, J*F]), computed in its own dtype; masked sequences are computed
densely and zeroed by multiplication, as mdm_tpu's are. Asking for the
``smpl`` joints runs no skinning (``lbs``).

Used by: the a2m geometric training losses, the a2m and unconstrained
protocols' xyz decoding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import rotations as R
from .lbs import JOINTSTYPE_ROOT, SMPLModel, lbs

JOINTSTYPES = ["a2m", "a2mpl", "smpl", "vibe", "vertices"]


@dataclass(frozen=True)
class Rot2XYZConfig:
    pose_rep: str = "rot6d"  # rot6d | rotvec | rotquat | rotmat | xyz
    translation: bool = True
    glob: bool = True
    jointstype: str = "smpl"
    vertstrans: bool = False
    glob_rot: tuple = (np.pi, 0.0, 0.0)
    beta: float = 0.0


def rot2xyz(
    model: SMPLModel,
    x: torch.Tensor,
    config: Rot2XYZConfig = Rot2XYZConfig(),
    mask: Optional[torch.Tensor] = None,  # [B, T] bool
    betas: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x [B, T, J, F] (J includes the translation row if translation) ->
    joints [B, T, J_out, 3] (vertices [B, T, V, 3] for ``vertices``)."""
    cfg = config
    if cfg.pose_rep == "xyz":
        return x

    if x.ndim == 3:  # flat features
        feat = {"rot6d": 6, "rotvec": 3, "rotquat": 4, "rotmat": 9}[cfg.pose_rep]
        x = x.reshape(x.shape[0], x.shape[1], -1, feat)

    B, T = x.shape[:2]
    if cfg.translation:
        transl = x[:, :, -1, :3]  # [B, T, 3]
        rots_in = x[:, :, :-1]
    else:
        transl = None
        rots_in = x

    flat = rots_in.reshape(B * T, rots_in.shape[2], rots_in.shape[3])
    if cfg.pose_rep == "rotvec":
        rotations = R.axis_angle_to_matrix(flat)
    elif cfg.pose_rep == "rotmat":
        rotations = flat.reshape(flat.shape[0], -1, 3, 3)
    elif cfg.pose_rep == "rotquat":
        rotations = R.quaternion_to_matrix(flat)
    elif cfg.pose_rep == "rot6d":
        rotations = R.rotation_6d_to_matrix(flat)
    else:
        raise ValueError(cfg.pose_rep)

    if cfg.glob:
        global_orient = rotations[:, 0]
        body_pose = rotations[:, 1:]
    else:
        go = R.axis_angle_to_matrix(torch.tensor(cfg.glob_rot, dtype=x.dtype, device=x.device))
        global_orient = go.expand(rotations.shape[0], 3, 3)
        body_pose = rotations

    if betas is None:
        betas = torch.zeros((rotations.shape[0], model.num_betas), dtype=x.dtype, device=x.device)
        if cfg.beta != 0.0:
            betas[:, 1] = cfg.beta

    out = lbs(model, betas, global_orient, body_pose, outputs=(cfg.jointstype,))
    joints = out[cfg.jointstype]
    joints = joints.reshape(B, T, joints.shape[1], 3)

    if cfg.jointstype != "vertices":
        root = JOINTSTYPE_ROOT[cfg.jointstype]
        joints = joints - joints[:, :, root: root + 1]

    if cfg.translation and cfg.vertstrans and transl is not None:
        transl = transl - transl[:, :1]
        joints = joints + transl[:, :, None]

    if mask is not None:
        joints = joints * mask[:, :, None, None].to(joints.dtype)
    return joints
