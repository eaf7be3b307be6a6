"""Finds what a cell is made of by name, in files of their own:

- ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
- ``benchmark/workloads/<cell>.json``: the cell's traffic kind, its
  parameters and dtype;
- ``benchmark/configs/<config>.json``: the model's sizes;
- ``benchmark/traffic/<kind>.py``: the generator of that kind of traffic;
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration or metric is new files and new entries, and no
edit of a file that is here.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)


def _module(path: str, name: str) -> ModuleType:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, root: str = ROOT, bench_dir: str = HERE):
        self.root, self.dir = root, bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> Dict:
        """The cell's entry in BENCHMARK.json, its workload file and its
        configuration, merged: {"name", "config", "traffic", "chips",
        "kind", "params", "dtype", "model": <config file>}."""
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        with open(os.path.join(self.dir, "workloads", f"{name}.json")) as f:
            spec = json.load(f)
        for key in ("config", "traffic", "chips"):
            if spec[key] != entry[key]:
                raise ValueError(f"{name}: {key} is {spec[key]!r} in its workload file and "
                                 f"{entry[key]!r} in BENCHMARK.json")
        conf = next(c for c in self.bench["configs"] if c["name"] == entry["config"])
        with open(os.path.join(self.root, conf["file"])) as f:
            model = json.load(f)
        return {**spec, "name": name, "model": model}

    def traffic(self, kind: str) -> ModuleType:
        return _module(os.path.join(self.dir, "traffic", f"{kind}.py"), f"bench_traffic_{kind}")

    def _listed(self, metric: Dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self._listed(m, cell)]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if self._listed(m, cell)]

    def reader(self, metric: str) -> ModuleType:
        return _module(os.path.join(self.dir, "metrics", f"{metric}.py"),
                       "bench_metric_" + metric.replace(".", "_").replace("-", "_"))
