"""Quaternion algebra (w, x, y, z convention).

Counterpart of mdm_tpu/core/quaternions.py: qinv, qnormalize, qmul, qrot,
qbetween, qfix (host numpy), qeuler, euler_to_quaternion,
quaternion_to_matrix, matrix_to_quaternion, quaternion_to_cont6d,
cont6d_to_matrix,
expmap_to_quaternion, qpow, qslerp and lerp. Pure functions that broadcast
over leading dims (reference data_loaders/humanml/common/quaternion.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "qinv",
    "qnormalize",
    "qmul",
    "qrot",
    "qbetween",
    "qfix",
    "qeuler",
    "euler_to_quaternion",
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "quaternion_to_cont6d",
    "cont6d_to_matrix",
    "expmap_to_quaternion",
    "qpow",
    "qslerp",
    "lerp",
]


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


def qfix(q: np.ndarray) -> np.ndarray:
    """Sign continuity along axis 0 of ``(L, J, 4)``, on the host: q or -q
    per frame so consecutive frames have a non-negative dot product (a
    cumulative parity of the sign changes)."""
    dots = np.sum(q[1:] * q[:-1], axis=-1)
    flip = (np.cumsum(dots < 0, axis=0) % 2).astype(bool)
    out = q.copy()
    out[1:][flip] *= -1
    return out


def qeuler(q: torch.Tensor, order: str, epsilon: float = 0.0, deg: bool = False) -> torch.Tensor:
    """Quaternion -> Euler angles for the axis order; radians unless
    ``deg`` (the reference's default unit, quaternion.py:78-127)."""
    q0, q1, q2, q3 = q.unbind(-1)
    clip = lambda x: torch.clamp(x, -1.0 + epsilon, 1.0 - epsilon)  # noqa: E731
    if order == "xyz":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = torch.asin(clip(2 * (q1 * q3 + q0 * q2)))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == "yzx":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = torch.asin(clip(2 * (q1 * q2 + q0 * q3)))
    elif order == "zxy":
        x = torch.asin(clip(2 * (q0 * q1 + q2 * q3)))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "xzy":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = torch.asin(clip(2 * (q0 * q3 - q1 * q2)))
    elif order == "yxz":
        x = torch.asin(clip(2 * (q0 * q1 - q2 * q3)))
        y = torch.atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "zyx":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = torch.asin(clip(2 * (q0 * q2 - q1 * q3)))
        z = torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise ValueError(f"unknown euler order {order!r}")
    out = torch.stack([x, y, z], dim=-1)
    return out * (180.0 / math.pi) if deg else out


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``(..., 4)`` -> rotation matrix ``(..., 3, 3)``."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(dim=-1)
    m = torch.stack([1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
                     two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
                     two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j)],
                    dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` -> quaternion ``(..., 4)``: four
    candidate quaternions, the one of the largest |component| taken
    (robust near w = 0; ``rotations.matrix_to_quaternion`` is the
    reference's copysign form)."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp_min(torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                                                    1.0 - m00 + m11 - m22,
                                                    1.0 - m00 - m11 + m22], dim=-1), 0.0))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * torch.clamp_min(q_abs[..., None], 0.1))
    best = torch.argmax(q_abs, dim=-1)
    return torch.take_along_dim(candidates, best[..., None, None].expand(
        best.shape + (1, 4)), dim=-2)[..., 0, :]


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> continuous 6D, the first two matrix *columns* (the
    HumanML codec's convention, reference quaternion.py:316-319; a2m
    training uses the PyTorch3D rows, ``rotations.matrix_to_rotation_6d``)."""
    mat = quaternion_to_matrix(q)
    return torch.cat([mat[..., 0], mat[..., 1]], dim=-1)


def cont6d_to_matrix(c: torch.Tensor) -> torch.Tensor:
    """Continuous 6D (the HumanML codec's column convention) -> rotation
    matrix ``(..., 3, 3)``."""
    x = c[..., 0:3] / torch.linalg.vector_norm(c[..., 0:3], dim=-1, keepdim=True)
    z = torch.linalg.cross(x, c[..., 3:6], dim=-1)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle / exponential map ``(..., 3)`` -> quaternion ``(..., 4)``
    (the half-angle sinc form, reference quaternion.py:216-232)."""
    theta = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    xyz = 0.5 * torch.sinc(0.5 * theta / math.pi) * e
    return torch.cat([torch.cos(0.5 * theta), xyz], dim=-1)


def qpow(q0: torch.Tensor, t) -> torch.Tensor:
    """Quaternion power ``q0 ** t`` (reference quaternion.py:346-369):
    scalar ``t`` -> ``q0.shape``; a tensor ``t`` -> ``t.shape + q0.shape``
    (each power applied to every quaternion)."""
    q0 = qnormalize(q0)
    theta0 = torch.acos(torch.clamp(q0[..., 0], -1.0, 1.0))
    theta0 = torch.where(theta0.abs() <= 1e-9, torch.full_like(theta0, 1e-9), theta0)
    v0 = q0[..., 1:] / torch.sin(theta0)[..., None]
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.ndim:
        theta = t.reshape(t.shape + (1,) * theta0.ndim) * theta0
        v0 = v0.expand(t.shape + v0.shape)
    else:
        theta = t * theta0
    return torch.cat([torch.cos(theta)[..., None], v0 * torch.sin(theta)[..., None]], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation q0 -> q1 at point(s) ``t`` (reference
    quaternion.py:371-385); a tensor ``t`` -> ``t.shape + q0.shape``."""
    q0 = qnormalize(q0)
    q1 = qnormalize(q1)
    q_ = qpow(qmul(q1, qinv(q0)), t)
    t = torch.as_tensor(t)
    if t.ndim:
        q0 = q0.expand(t.shape + q0.shape)
    return qmul(q_, q0)


def lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    """Linear interpolation, result ``t.shape + p0.shape`` with ``t``
    promoted to at least rank 1 (reference quaternion.py:414-425)."""
    t = torch.atleast_1d(torch.as_tensor(t, dtype=p0.dtype, device=p0.device))
    tb = t.reshape(t.shape + (1,) * p0.ndim)
    return p0 * (1.0 - tb) + p1 * tb
