"""What the per-layer metrics' readers share: each reads one quantity of a
traced window (``trace.Observed``) for one phase, ``generate`` or
``train``, and returns None where the window is of the other phase or
holds nothing to read."""
from __future__ import annotations

from typing import Optional

from benchmark.counts import flops

PRODUCTS = r"gemm_bf16_wgmma|gemm_f32_tf32x3|sum_splits_(kernel|grouped)"
ATTENTION = r"attn_(fwd|bwd)_"


def _of(obs, phase: str) -> bool:
    return obs.counts.get("phase") == phase and obs.counts.get("units", 0) > 0


def idle_share(obs, phase: str) -> Optional[float]:
    """Per cent of the window in which no operation ran on the device."""
    if not _of(obs, phase) or obs.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.busy_s / obs.window_s)


def mfu(obs, phase: str) -> Optional[float]:
    """The model's operations in the window over the window times the peak
    of the cell's dtype, per cent."""
    if not _of(obs, phase) or obs.window_s <= 0:
        return None
    work = obs.counts["work"]
    return 100.0 * work.total_flops() / (obs.window_s * flops.peak_flops(obs.counts["dtype"]))


def roofline(obs, phase: str, layer: str, pattern: str) -> Optional[float]:
    """The least time of a layer's work over its kernels' device time, per cent."""
    if not _of(obs, phase):
        return None
    least, spent = obs.counts["work"].least_s.get(layer, 0.0), obs.kernel_s(pattern)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent


def launches_per(obs, phase: str, span: Optional[str]) -> Optional[float]:
    """Kernels launched in the window per ``span`` call (per unit without one)."""
    if not _of(obs, phase):
        return None
    per = obs.counts["spans"].get(span, 0) if span else obs.counts["units"]
    return obs.kernel_count() / per if per else None
