"""The numbers that decide ``correct``, each against its limit.

Each compares what the timed path produced with the plain reference:

- ``worst_rel``: the worst example's relative L2 distance,
  ||a - r|| / ||r|| over the axes after the first;
- ``max_rel``: the largest absolute difference over the largest |r|;
- ``leaf_gap``: for training, by the worst parameter leaf (``leaves``), the gap between
  the program's norm and the reference's, |(|a|) - (|r|)|, over the larger
  of the reference's norm of that leaf and of the median leaf; for the
  EMA's change ``median_leaf_gap``, the median leaf's. Leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone and are left out of ``keep``;
- ``leaf_diff``: the worst leaf's difference, where no norm separates a
  fault from rounding.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import torch


def worst_rel(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.double(), r.double()
    num = (a - r).flatten(1).norm(dim=1)
    den = r.flatten(1).norm(dim=1).clamp_min(1e-30)
    return float((num / den).max())


def max_rel(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.double(), r.double()
    return float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))


def leaves(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The model's leaves: a packed attention projection (``in_proj_weight``,
    ``in_proj_bias``, torch's layout) as its three, q, k and v, which the
    published model holds apart (a key's bias among them)."""
    out = {}
    for n, t in tensors.items():
        if n.endswith(("in_proj_weight", "in_proj_bias")):
            out.update({f"{n}.{part}": c for part, c in zip("qkv", t.chunk(3))})
        else:
            out[n] = t
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's L2 norm (``leaves``)."""
    return {n: float(t.double().norm()) for n, t in leaves(tensors).items()}


def moving_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad_norms.values())
    return [n for n, v in ref_grad_norms.items() if v >= 1e-3 * med]


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    names = list(keep) if keep is not None else list(ref)
    med = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap."""
    return max(_gaps(prog, ref, keep))


def leaf_diff(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """By the worst leaf, the norm of the difference over the larger of the
    reference leaf's norm and the median leaf's: where the leaves' norms
    cannot tell two gradients apart (the mean over half of a large batch
    has about the norm of the whole batch's), their directions can."""
    prog, ref = leaves(prog), leaves(ref)
    diff = {n: float((prog[n].double() - ref[n].double()).norm()) for n in ref}
    ref_n = norms(ref)
    med = statistics.median(ref_n.values())
    return max(diff[n] / max(ref_n[n], med, 1e-30) for n in ref)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Optional[Iterable[str]] = None) -> float:
    """The median leaf's gap, for a change made of a few float32 ulps a
    value (the EMA's over the first steps), whose worst leaf is its
    rounding's."""
    return statistics.median(_gaps(prog, ref, keep))


class Checks:
    """Named numbers and their limits, in the order they were taken."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        """Keeps the worst value of a name; NaN stays NaN."""
        old = self.values.get(name)
        if old is None or math.isnan(value) or (not math.isnan(old) and value > old):
            self.values[name] = value

    def correct(self) -> bool:
        return bool(self.values) and all(
            name in self.values and math.isfinite(self.values[name])
            and self.values[name] <= limit for name, limit in self.limits.items())

    def table(self) -> Dict[str, Dict[str, float]]:
        return {n: {"value": self.values.get(n, float("nan")), "limit": lim}
                for n, lim in self.limits.items()}

    def lines(self) -> List[str]:
        return [f"check {n} {v['value']!r} limit {v['limit']!r}" for n, v in self.table().items()]
