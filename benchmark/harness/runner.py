"""One run of one cell: set-up, the measured or traced window, the
reading of the metrics, and the comparison with the plain reference.

Order, after set-up (the kernel library, the weights and inputs made on
the device from the seed, a warm-up of the cell's own shapes):

1. the window: ``seconds`` of back-to-back requests or steps, or with
   ``trace`` the cell's ``trace_units`` of them under the profiler;
2. the device's peak memory, read before anything else runs;
3. the end-to-end metrics, or the per-layer metrics from the trace;
4. the program's state freed, then the plain reference on what the window
   produced, and each compared number against its limit.
"""
from __future__ import annotations

import math
import os
import sys
from typing import Callable, Dict, List, Tuple

import torch

from . import trace as T
from .clock import Stopwatch
from .registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "mdm_tpu")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN`` as a whole word (``mdm_tpu_torch`` is not
    ``mdm_tpu``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _json_number(v: float):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def _describe(rec) -> str:
    """The window in one line: its units and seconds, and the quartiles of
    the units' latencies where they were taken."""
    line = f"window: {rec.n} units in {rec.t1 - rec.t0:.3f} s"
    lat = sorted(getattr(rec, "latencies", []))
    if len(lat) >= 4:
        q = [lat[int(f * (len(lat) - 1))] for f in (0.0, 0.25, 0.5, 0.75, 1.0)]
        line += ", latency min/q1/median/q3/max " + " ".join(f"{v:.4f}" for v in q)
    return line


def run(reg: Registry, name: str, seed: int, seconds: float, trace: bool, device: str,
        since_start: Callable[[], float], export_dir: str = "") -> Tuple[Dict, List[str]]:
    """Returns (the result object, the lines naming each compared number
    and its limit)."""
    cell = reg.cell(name)
    traffic = reg.traffic(cell["kind"])
    watch = Stopwatch(since_start)
    state = traffic.setup(cell, seed, device, watch.mark)
    _sync(device)
    setup_s = since_start()
    print(watch.line(), file=sys.stderr)
    units = cell["params"]["trace_units"] if trace else None
    obs = None
    if trace:
        spans = T.Spans()
        for module, span_name in state.spans:
            spans.attach(module, span_name)
        export = os.path.join(export_dir, f"{name}.{seed}.trace.json.gz") if export_dir else None
        records, obs = T.profile(lambda: traffic.window(state, seconds, units), export,
                                 {n for _, n in state.spans})
        spans.detach()
        obs.counts = {**traffic.counts(state, records), "spans": dict(spans.counts),
                      **obs.counts}
    else:
        records = traffic.window(state, seconds, units)
        _sync(device)
        print(_describe(records), file=sys.stderr)
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    metrics = {}
    if trace:
        dev.update(busy_s=obs.busy_s, window_s=obs.window_s)
        for m in reg.per_layer(name):
            value = reg.reader(m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        found = {**traffic.end_to_end(state, records), "setup_s": setup_s}
        for m in reg.end_to_end(name):
            if m["name"] in found:
                metrics[m["name"]] = {"value": found[m["name"]], "unit": m["unit"]}
    traffic.release(state)
    if cuda:
        torch.cuda.empty_cache()
    checks = traffic.check(state, records, cell["limits"])
    result = {"correct": checks.correct(), "attempted": records.n, "failed": records.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = obs.breakdown()
    result["checks"] = {k: {"value": _json_number(v["value"]), "limit": v["limit"]}
                        for k, v in checks.table().items()}
    return result, checks.lines()
