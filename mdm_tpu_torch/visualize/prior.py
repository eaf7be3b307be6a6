"""Pose priors for SMPLify fitting (reference joints2smpl/src/prior.py).

Counterpart of mdm_tpu/visualize/prior.py: the max-of-mixture Gaussian
prior over the 69-d axis-angle body pose (``MaxMixturePrior``, weights from
``gmm_08.pkl``), the elbow/knee bending-direction prior (``angle_prior``)
and the Geman-McClure robust error (``gmof``), as plain differentiable
torch functions. The GMM tables are loaded once from the pickled sklearn
dump; ``fit_smpl`` falls back to its L2 stand-in when the asset is absent.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

# elbow/knee axis-angle components of the body pose (without the global
# orient, hence the -3 of reference customloss.py:19-21): left elbow 52,
# right elbow 55, left knee 9, right knee 12; the signs penalise bending
# backwards.
_ANGLE_IDX = (55 - 3, 58 - 3, 12 - 3, 15 - 3)
_ANGLE_SIGN = (1.0, -1.0, -1.0, -1.0)

_SEARCH_PATHS = (
    "body_models/joints2smpl/gmm_08.pkl",
    "visualize/joints2smpl/smpl_models/gmm_08.pkl",
)


def find_gmm_asset() -> Optional[str]:
    """Locate gmm_08.pkl: $MDM_TPU_GMM_PRIOR, then the standard layouts."""
    env = os.environ.get("MDM_TPU_GMM_PRIOR")
    if env:
        return env if os.path.exists(env) else None
    for p in _SEARCH_PATHS:
        if os.path.exists(p):
            return p
    return None


@dataclass(frozen=True)
class MaxMixturePrior:
    """Min-over-components negative log likelihood of the SMPL pose GMM:
    per component 0.5 (x - mu)^T P (x - mu) - log(nll_weight), the
    reference's merged_log_likelihood (prior.py:181-197)."""

    means: np.ndarray  # [M, 69]
    precisions: np.ndarray  # [M, 69, 69]
    log_nll_weights: np.ndarray  # [M]
    _tensors: Dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_tables(cls, means: np.ndarray, covs: np.ndarray,
                    weights: np.ndarray) -> "MaxMixturePrior":
        """The prior from the GMM's tables, as mdm_tpu builds it: precisions
        inverted in float32 (the reference's, prior.py:145), and the
        normalised weights stored in float32 before their log, so components
        whose (2 pi)^(d/2) x det-ratio denominator underflows get -inf and
        never win the min (prior.py:152-158)."""
        precisions = np.stack([np.linalg.inv(c) for c in covs.astype(np.float32)])
        sqrdets = np.sqrt(np.linalg.det(covs.astype(np.float64)))
        const = (2.0 * np.pi) ** (means.shape[1] / 2.0)
        nll_weights = (weights.astype(np.float64)
                       / (const * (sqrdets / sqrdets.min()))).astype(np.float32)
        with np.errstate(divide="ignore"):
            log_nll = np.log(nll_weights)
        return cls(means=means.astype(np.float32), precisions=precisions.astype(np.float32),
                   log_nll_weights=log_nll)

    @classmethod
    def load(cls, path: Optional[str] = None) -> "MaxMixturePrior":
        path = path or find_gmm_asset()
        if path is None:
            raise FileNotFoundError("gmm_08.pkl not found (set $MDM_TPU_GMM_PRIOR or place it "
                                    f"under one of {_SEARCH_PATHS})")
        with open(path, "rb") as f:
            gmm = pickle.load(f, encoding="latin1")
        return cls.from_tables(gmm["means"], gmm["covars"], gmm["weights"])

    def tensors(self, device, dtype):
        """(means, precisions, log weights) as tensors on ``device``, made
        once per device and dtype."""
        key = (str(torch.device(device)), dtype)
        if key not in self._tensors:
            self._tensors[key] = tuple(torch.as_tensor(a).to(device=device, dtype=dtype)
                                       for a in (self.means, self.precisions,
                                                 self.log_nll_weights))
        return self._tensors[key]

    def __call__(self, body_pose: torch.Tensor) -> torch.Tensor:
        """body_pose [..., 69] axis-angle -> NLL [...] (min over modes)."""
        means, precisions, log_w = self.tensors(body_pose.device, body_pose.dtype)
        diff = body_pose[..., None, :] - means  # [..., M, 69]
        prec_diff = torch.einsum("mij,...mj->...mi", precisions, diff)
        quad = (prec_diff * diff).sum(dim=-1)  # [..., M]
        return (0.5 * quad - log_w).min(dim=-1).values


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """Knee/elbow bending-direction penalty (customloss.py:15-21):
    exp(signed component)^2 per joint. body_pose [..., 69] -> [..., 4]."""
    # Four slices, not an index tensor: nothing is copied from the host.
    comps = torch.stack([body_pose[..., i] * s for i, s in zip(_ANGLE_IDX, _ANGLE_SIGN)], dim=-1)
    return torch.exp(comps) ** 2


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robust error (customloss.py:6-12)."""
    x2 = x * x
    s2 = sigma * sigma
    return (s2 * x2) / (s2 + x2)
