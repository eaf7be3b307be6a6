"""The program's own spans in a traced window, and the device operations
launched under them, read from the chrome trace that the traced run exports.

While torch.profiler records, mdm_tpu_torch opens a profiler range of each
of its spans (``mdm_tpu_torch/utils/tracing.py``: ``sample.step``,
``denoiser.forward``, ``text.encode``, ``train.update``, ...). The traced
run exports the window's chrome trace into ``.bench_cache/traces/``
(``run.py``). ``window_of(obs)`` reads the newest trace there, and takes it
only when its window range is the one of the ``trace.Observed`` at hand.
From it come:

- each device operation (kernel, copy, set), cut to the window, and its
  launch: the host start of the runtime or driver call
  (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...) that
  carries its correlation id;
- each program span's intervals, by name, merged over threads.

An operation counts as launched under a span when its launch lies inside
one of the span's intervals, on any thread: autograd launches the backward
from a thread of its own while the main thread sits in ``train.backward``.
A program that opens no such range, or a run that exported no trace, gives
nothing to read, and the readers return None.

    python3 -m benchmark.harness.program_spans .bench_cache/traces/<cell>.<seed>.trace.json.gz

prints one exported window's ``Window.summary()``: by span, device and idle
seconds, and the share of busy time that no launch could be matched to.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.harness.readers import _of
from benchmark.harness.registry import ROOT
from benchmark.harness.trace import WINDOW

TRACES = os.path.join(ROOT, ".bench_cache", "traces")
# the program's span names: sample.*, denoiser.*, text.*, train.*
NAME = re.compile(r"(sample|denoiser|text|train)\.[a-z_]+")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
CALLS = ("cuda_runtime", "cuda_driver")
TOLERANCE_NS = 2000  # the chrome trace's window against the profiler's own


def _union(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Disjoint sorted intervals covering the given ones."""
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    out_s, out_e = [int(starts[order[0]])], [int(ends[order[0]])]
    for s, e in zip(starts[order[1:]].tolist(), ends[order[1:]].tolist()):
        if s <= out_e[-1]:
            out_e[-1] = max(out_e[-1], e)
        else:
            out_s.append(s)
            out_e.append(e)
    return np.array(out_s, dtype=np.int64), np.array(out_e, dtype=np.int64)


class Window:
    """One traced window: device operations with their launches, the
    program's spans by name, and the window's [t0, t1], in unix ns."""

    def __init__(self, window: Tuple[int, int], ops: List[Tuple[str, int, int, int]],
                 spans: List[Tuple[str, int, int]]):
        """``ops``: (name, start, end, launch or -1); ``spans``: (name,
        start, end) on any thread."""
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) / 1e9
        kept = [(n, max(s, self.t0), min(e, self.t1), c) for n, s, e, c in ops
                if e > self.t0 and s < self.t1]
        self.names = [n for n, _, _, _ in kept]
        self.start = np.array([s for _, s, _, _ in kept], dtype=np.int64)
        self.end = np.array([e for _, _, e, _ in kept], dtype=np.int64)
        self.launch = np.array([c for _, _, _, c in kept], dtype=np.int64)
        self.busy = _union(self.start, self.end)
        self.busy_s = float((self.busy[1] - self.busy[0]).sum()) / 1e9
        self.count: Counter = Counter(n for n, _, _ in spans)
        by_name: Dict[str, list] = defaultdict(list)
        for n, s, e in spans:
            by_name[n].append((s, e))
        self.spans = {n: _union(np.array([s for s, _ in iv], dtype=np.int64),
                                np.array([e for _, e in iv], dtype=np.int64))
                      for n, iv in by_name.items()}

    def inside(self, name: str, times: np.ndarray) -> np.ndarray:
        """Which of ``times`` lie inside a ``name`` span."""
        starts, ends = self.spans.get(name, (np.zeros(0, np.int64),) * 2)
        if not len(starts):
            return np.zeros(len(times), dtype=bool)
        i = np.searchsorted(starts, times, side="right") - 1  # the one interval that may hold it
        return (i >= 0) & (times <= ends[np.maximum(i, 0)])

    def launched_under(self, name: str) -> np.ndarray:
        """Which operations were launched inside a ``name`` span."""
        return (self.launch >= 0) & self.inside(name, self.launch)

    def busy_of(self, which: np.ndarray) -> float:
        """Seconds of the union of the intervals of the operations in ``which``."""
        s, e = _union(self.start[which], self.end[which])
        return float((e - s).sum()) / 1e9

    def gaps(self) -> Tuple[np.ndarray, np.ndarray]:
        """(midpoints, lengths) of the window's idle gaps, where no operation ran."""
        edges = np.concatenate([[self.t0], np.stack(self.busy, axis=1).ravel(), [self.t1]])
        a, b = edges[0::2], edges[1::2]
        keep = b > a
        return (a[keep] + b[keep]) // 2, b[keep] - a[keep]

    def summary(self) -> dict:
        """By span name: its count, the device seconds of the operations
        launched under it (children's included) and the idle seconds of the
        gaps whose midpoint it is the innermost span of; then the per cent
        of the busy time whose launch matched no call (unattributed) and
        launched under no span, and the idle seconds outside every span."""
        mids, length = self.gaps()
        best = np.full(len(mids), np.iinfo(np.int64).max)
        label = np.full(len(mids), "", dtype=object)
        under_any = np.zeros(len(self.launch), dtype=bool)
        device = {}
        for name, (starts, ends) in self.spans.items():
            under = self.launched_under(name)
            under_any |= under
            device[name] = self.busy_of(under)
            i = np.maximum(np.searchsorted(starts, mids, side="right") - 1, 0)
            span_len = ends[i] - starts[i]
            inner = self.inside(name, mids) & (span_len < best)
            best[inner], label[inner] = span_len[inner], name
        idle: Dict[str, float] = defaultdict(float)
        for name, n in zip(label.tolist(), length.tolist()):
            idle[name] += n / 1e9
        busy = self.busy_s or float("inf")
        matched = self.launch >= 0
        return {"spans": {n: {"count": self.count[n], "device_s": device[n],
                              "idle_s": idle.get(n, 0.0)} for n in sorted(self.spans)},
                "unattributed_share": 100.0 * self.busy_of(~matched) / busy,
                "outside_spans_share": 100.0 * self.busy_of(matched & ~under_any) / busy,
                "idle_outside_spans_s": idle.get("", 0.0), "busy_s": self.busy_s,
                "window_s": self.window_s}


def parse(trace: dict) -> Optional[Window]:
    """The window of a chrome trace as torch.profiler exports it, or None
    where it holds no window range."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    ns = lambda us: base + int(round(us * 1000.0))
    calls, device, spans, window = {}, [], [], None
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start = ns(e["ts"])
        end = start + int(round(e.get("dur", 0) * 1000.0))
        if cat in DEVICE:
            device.append((name, start, end, e.get("args", {}).get("correlation")))
        elif cat in CALLS:
            calls[e.get("args", {}).get("correlation")] = start
        elif cat.startswith("gpu_"):
            continue  # the device's copies of host ranges
        elif name == WINDOW:
            window = (start, end)
        elif NAME.fullmatch(name):
            spans.append((name, start, end))
    if window is None:
        return None
    calls.pop(None, None)  # calls that carry no correlation id
    ops = [(n, s, e, calls.get(c, -1)) for n, s, e, c in device]
    return Window(window, ops, spans)


def read(path: str) -> Optional[Window]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return parse(json.load(f))


_cache: Dict[Tuple[str, int], Optional[Window]] = {}


def window_of(obs) -> Optional[Window]:
    """The window of ``obs`` (a ``trace.Observed``) as the newest exported
    trace shows it, or None where the run exported none or the newest is of
    another window."""
    if "export_s" not in obs.counts:
        return None
    paths = glob.glob(os.path.join(TRACES, "*.trace.json*"))
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    key = (path, os.stat(path).st_mtime_ns)
    if key not in _cache:
        _cache.clear()
        _cache[key] = read(path)
    w = _cache[key]
    if w is None or abs(w.t0 - obs.t0) > TOLERANCE_NS or abs(w.t1 - obs.t1) > TOLERANCE_NS:
        return None
    return w


def launched_share(obs, phase: str, under: str, outside=()) -> Optional[float]:
    """Per cent of the device's busy time in the union of the intervals of
    the operations launched inside an ``under`` span and inside no
    ``outside`` span."""
    w = window_of(obs) if _of(obs, phase) else None
    if w is None or under not in w.spans or w.busy_s <= 0 or not (w.launch >= 0).any():
        return None
    which = w.launched_under(under)
    for name in outside:
        which &= ~w.launched_under(name)
    return 100.0 * w.busy_of(which) / w.busy_s


def idle_inside(obs, phase: str, name: str) -> Optional[float]:
    """Per cent of the window in the device's idle gaps whose midpoint lies
    inside a ``name`` span."""
    w = window_of(obs) if _of(obs, phase) else None
    if w is None or name not in w.spans or w.busy_s <= 0:
        return None
    mids, length = w.gaps()
    return 100.0 * float(length[w.inside(name, mids)].sum()) / 1e9 / w.window_s


if __name__ == "__main__":
    import sys

    print(json.dumps(read(sys.argv[1]).summary()))
