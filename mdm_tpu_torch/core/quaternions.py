"""Quaternion algebra (w, x, y, z convention), the part the decode uses.

Counterpart of mdm_tpu/core/quaternions.py (qinv, qrot :41-82). Pure
functions that broadcast over leading dims.
"""
from __future__ import annotations

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
