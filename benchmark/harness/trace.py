"""The traced run: spans from forward hooks, ``torch.profiler`` over the
traced window, and its reduction to what the per-layer metrics read.

Spans are ``record_function`` ranges that the benchmark opens and closes
in forward hooks it registers on the program's modules (the denoiser, its
layers, the text tower), so that no file of the program changes; the same
hooks count the forwards. The device's busy time is the union of the
intervals in which some operation ran on it (kernels, copies and sets),
not their sum, within the window span; the idle gaps between them are
named by the innermost host range open at their middle.
"""
from __future__ import annotations

import os
import re
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "bench.window"


class Spans:
    """Forward hooks that open a ``record_function`` range per call and
    count the calls, by name."""

    def __init__(self):
        self.counts: Counter = Counter()
        self._open: List = []
        self._handles: List = []

    def attach(self, module: torch.nn.Module, name: str) -> None:
        def pre(mod, args):
            self.counts[name] += 1
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self._open.append(rf)

        def post(mod, args, out):
            self._open.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()


def _short(name: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments: ``gemm_bf16_wgmma``, ``at::native::...``."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


class Observed:
    """What a traced window shows: its length, the device's busy time,
    each device operation's intervals by name, and the host's ranges."""

    def __init__(self, window: Tuple[int, int], device_ops: List[Tuple[str, int, int, bool]],
                 host: List[Tuple[str, int, int]], counts: Dict):
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) / 1e9
        self.counts = counts
        self.ops = [(n, max(s, self.t0), min(e, self.t1), k) for n, s, e, k in device_ops
                    if e > self.t0 and s < self.t1]
        self.intervals = _union([(s, e) for _, s, e, _ in self.ops])
        self.busy_s = sum(e - s for s, e in self.intervals) / 1e9
        self.host = host

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e, k in self.ops if k and rx.search(n)) / 1e9

    def kernel_count(self) -> int:
        return sum(1 for _, _, _, k in self.ops if k)

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for n, s, e, _ in self.ops:
            by_name[_short(n)] += (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": self._idle_gaps(top)}

    def _idle_gaps(self, top: int, longest: int = 2000) -> list:
        edges = [self.t0] + [x for iv in self.intervals for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        if not self.host:
            return []
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host], dtype=np.int64)
        ends = np.array([h[2] for h in self.host], dtype=np.int64)
        by_name: Dict[str, float] = defaultdict(float)
        for a, b in gaps[:longest]:
            mid = (a + b) // 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = "host: none open"
            if len(inside):
                label = names[inside[np.argmin(ends[inside] - starts[inside])]]
            by_name[label] += (b - a) / 1e9
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _events(prof, span_names=()):
    """(device operations, host ranges, the window's [start, end]) in ns.
    The device's copies of host ranges (user annotations) are no operations."""
    device, host, window = [], [], None
    events = list(prof.profiler.kineto_results.events())
    annotation = lambda e: getattr(e, "is_user_annotation", lambda: False)()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {WINDOW, *span_names} | {e.name() for e in events
                                      if e.device_type() != cuda and annotation(e)}
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if annotation(e) or name in ranges:
                continue
            kernel = not re.match(r"(?i)mem(cpy|set)", name)
            device.append((name, start, start + dur, kernel))
        else:
            host.append((name, start, start + dur))
            if name == WINDOW:
                window = (start, start + dur)
    return device, host, window


def profile(run: Callable[[], object], export: Optional[str] = None, span_names=()
            ) -> Tuple[object, Observed]:
    """Run ``run()`` under ``torch.profiler`` inside the window span, ended by
    a synchronise; returns its result and what the trace shows. ``export``:
    a path for the chrome trace (gzip when it ends with .gz)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.autograd.profiler.record_function(WINDOW):
            out = run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    device, host, window = _events(prof, span_names)
    if window is None:
        raise RuntimeError(f"the profiler's trace holds no {WINDOW!r} range")
    extra = {}
    if export:
        os.makedirs(os.path.dirname(export), exist_ok=True)
        t = time.perf_counter()
        prof.export_chrome_trace(export)
        extra["export_s"] = time.perf_counter() - t
    return out, Observed(window, device, host, extra)
