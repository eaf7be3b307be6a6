"""Quaternion algebra (w, x, y, z convention), the part the decode and the
goal targets use.

Counterpart of mdm_tpu/core/quaternions.py (qinv, qnormalize, qmul, qrot,
qbetween :41-91, euler_to_quaternion :147, quaternion_to_matrix :169,
cont6d_to_matrix :244). Pure functions that broadcast over leading dims.
"""
from __future__ import annotations

import math

import torch


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s) ``(..., 4)``."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    """Unit length, after the reference's 1e-4 bias of the z component
    (quaternion.py:28-31), which keeps a zero quaternion finite."""
    q = torch.cat([q[..., :-1], q[..., -1:] + 1e-4], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


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


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating v0 onto v1 (both ``(..., 3)``)."""
    v = torch.linalg.cross(v0, v1, dim=-1)
    w = torch.sqrt((v0 ** 2).sum(dim=-1, keepdim=True) * (v1 ** 2).sum(dim=-1, keepdim=True)) \
        + (v0 * v1).sum(dim=-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``(..., 4)`` -> rotation matrix ``(..., 3, 3)``."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(dim=-1)
    m = torch.stack([1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
                     two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
                     two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j)],
                    dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def cont6d_to_matrix(c: torch.Tensor) -> torch.Tensor:
    """Continuous 6D (the HumanML codec's column convention) -> rotation
    matrix ``(..., 3, 3)``."""
    x = c[..., 0:3] / torch.linalg.vector_norm(c[..., 0:3], dim=-1, keepdim=True)
    z = torch.linalg.cross(x, c[..., 3:6], dim=-1)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)
