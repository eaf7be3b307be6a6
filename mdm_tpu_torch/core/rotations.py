"""Rotation representation conversions.

Counterpart of mdm_tpu/core/rotations.py: quaternion <-> matrix,
axis-angle <-> matrix/quaternion, euler <-> matrix and rotation_6d <->
matrix with the conventions of the reference's PyTorch3D-derived
``utils/rotation_conversions.py``, so that the a2m (rot6d) family and its
geometric losses read the same features.

rotation_6d here is the PyTorch3D *row* convention (the first two rows of
the matrix, Zhou et al. 2019), distinct from the HumanML codec's column
convention in ``quaternions.cont6d_to_matrix``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .quaternions import quaternion_to_matrix

__all__ = [
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "rotation_6d_to_matrix",
    "matrix_to_rotation_6d",
    "standardize_quaternion",
    "quaternion_multiply",
    "quaternion_invert",
    "quaternion_apply",
    "random_quaternions",
    "random_rotations",
    "random_rotation",
]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion with non-negative real part
    (copysign form, reference rotation_conversions.py:98-120)."""
    m00, m11, m22 = matrix[..., 0, 0], matrix[..., 1, 1], matrix[..., 2, 2]
    sqrt_pos = lambda x: torch.sqrt(torch.clamp_min(x, 0.0))
    w = 0.5 * sqrt_pos(1.0 + m00 + m11 + m22)
    x = 0.5 * sqrt_pos(1.0 + m00 - m11 - m22)
    y = 0.5 * sqrt_pos(1.0 - m00 + m11 - m22)
    z = 0.5 * sqrt_pos(1.0 - m00 - m11 + m22)
    x = torch.copysign(x, matrix[..., 2, 1] - matrix[..., 1, 2])
    y = torch.copysign(y, matrix[..., 0, 2] - matrix[..., 2, 0])
    z = torch.copysign(z, matrix[..., 1, 0] - matrix[..., 0, 1])
    return torch.stack([w, x, y, z], dim=-1)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so the real part is non-negative."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = (a[..., i:i + 1] for i in range(4))
    bw, bx, by, bz = (b[..., i:i + 1] for i in range(4))
    return torch.cat([aw * bw - ax * bx - ay * by - az * bz,
                      aw * bx + ax * bw + ay * bz - az * by,
                      aw * by - ax * bz + ay * bw + az * bx,
                      aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """PyTorch3D's cross-product form (not quaternions.qrot, whose float
    operation order is the reference quaternion.py's)."""
    uv = torch.linalg.cross(q[..., 1:], point, dim=-1)
    uuv = torch.linalg.cross(q[..., 1:], uv, dim=-1)
    return point + 2.0 * (q[..., :1] * uv + uuv)


def sin_half_over_angle(angles: torch.Tensor, sin_half: torch.Tensor) -> torch.Tensor:
    """sin(angle / 2) / angle, by its Taylor series below 1e-6 so that it
    stays differentiable at 0."""
    small = angles.abs() < 1e-6
    return torch.where(small, 0.5 - (angles * angles) / 48.0,
                       sin_half / torch.where(small, torch.ones_like(angles), angles))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``(..., 3)`` -> quaternion ``(..., 4)``."""
    angles = _norm(axis_angle)
    half = angles * 0.5
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle(angles, torch.sin(half))],
                     dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    half_angles = torch.atan2(_norm(q[..., 1:]), q[..., :1])
    return q[..., 1:] / sin_half_over_angle(2.0 * half_angles, torch.sin(half_angles))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis!r}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Euler angles (radians, intrinsic, e.g. 'XYZ') -> rotation matrix."""
    mats = [_axis_rotation(axis, euler_angles[..., i]) for i, axis in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(
            matrix[..., i0, i2] * (-1.0 if i0 - i2 in [-1, 2] else 1.0), -1, 1))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1, 1))
    o = (_angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
         central,
         _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan))
    return torch.stack(o, dim=-1)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rep (the first two *rows*, Zhou et al.) -> rotation matrix."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / _norm(a1)
    b2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = b2 / _norm(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """``n`` uniform random unit quaternions with non-negative real part
    (reference rotation_conversions.py random_quaternions), drawn from
    ``generator``."""
    q = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    return standardize_quaternion(q / _norm(q))


def random_rotations(n: int, generator: Optional[torch.Generator] = None,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """``n`` uniform random rotation matrices ``[n, 3, 3]``."""
    return quaternion_to_matrix(random_quaternions(n, generator, dtype, device))


def random_rotation(generator: Optional[torch.Generator] = None, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """One uniform random rotation matrix ``[3, 3]``."""
    return random_rotations(1, generator, dtype, device)[0]
