"""Quaternion algebra (w, x, y, z convention), the part the decode and the
goal targets use.

Counterpart of mdm_tpu/core/quaternions.py (qinv, qrot :41-82, qmul :57,
euler_to_quaternion :147). Pure functions that broadcast over leading dims.
"""
from __future__ import annotations

import math

import torch


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s) ``(..., 4)``."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``(..., 3)`` by quaternion(s) ``(..., 4)``
    (Rodrigues two-cross-product form, reference quaternion.py:56-75)."""
    qw = q[..., :1]
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (qw * uv + uuv)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r for ``(..., 4)`` tensors (broadcasting)."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack([qw * rw - qx * rx - qy * ry - qz * rz,
                        qw * rx + qx * rw + qy * rz - qz * ry,
                        qw * ry - qx * rz + qy * rw + qz * rx,
                        qw * rz + qx * ry - qy * rx + qz * rw], dim=-1)


def euler_to_quaternion(e: torch.Tensor, order: str, deg: bool = True) -> torch.Tensor:
    """Euler angles ``(..., 3)`` -> quaternion ``(..., 4)``, with the
    reference's antipodal flip for the orders xyz, yzx and zxy."""
    if deg:
        e = e * (math.pi / 180.0)
    zero = torch.zeros_like(e[..., 0])
    half_c, half_s = torch.cos(e / 2), torch.sin(e / 2)
    axis = {"x": torch.stack([half_c[..., 0], half_s[..., 0], zero, zero], dim=-1),
            "y": torch.stack([half_c[..., 1], zero, half_s[..., 1], zero], dim=-1),
            "z": torch.stack([half_c[..., 2], zero, zero, half_s[..., 2]], dim=-1)}
    result = axis[order[0]]
    for a in order[1:]:
        result = qmul(result, axis[a])
    return -result if order in ("xyz", "yzx", "zxy") else result
