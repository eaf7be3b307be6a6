"""HumanML3D's feature decoding (``recover_from_ric`` of the dataset's
``motion_process.py``): integrate the root's yaw velocity and its planar
velocity, rotate the root-relative joint positions by the inverse yaw,
move them to the root. Features [..., T, 263] -> joints [..., T, 22, 3]."""
from __future__ import annotations

import torch


def _qinv(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _qrot(q, v):
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def recover_from_ric(data: torch.Tensor, joints: int = 22) -> torch.Tensor:
    rot_vel = data[..., 0]
    ang = torch.zeros_like(rot_vel)
    ang[..., 1:] = rot_vel[..., :-1]
    ang = torch.cumsum(ang, dim=-1)
    zero = torch.zeros_like(ang)
    quat = torch.stack([torch.cos(ang), zero, torch.sin(ang), zero], dim=-1)
    vel = torch.zeros(data.shape[:-1] + (3,), dtype=data.dtype, device=data.device)
    vel[..., 1:, 0] = data[..., :-1, 1]
    vel[..., 1:, 2] = data[..., :-1, 2]
    pos = torch.cumsum(_qrot(_qinv(quat), vel), dim=-2)
    pos[..., 1] = data[..., 3]
    ric = data[..., 4:(joints - 1) * 3 + 4].reshape(data.shape[:-1] + (joints - 1, 3))
    ric = _qrot(_qinv(quat)[..., None, :].expand(ric.shape[:-1] + (4,)), ric)
    ric[..., 0] = ric[..., 0] + pos[..., None, 0]
    ric[..., 2] = ric[..., 2] + pos[..., None, 2]
    return torch.cat([pos[..., None, :], ric], dim=-2)
