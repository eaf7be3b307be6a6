"""Key-value training logger (capability mirror of diffusion/logger.py).

A copy of mdm_tpu/train/logger.py, which imports nothing of jax.

Running means via `logkv_mean`, human-readable table dump, CSV + JSONL
writers, and wall-time profiling scopes. Kept dependency-free; heavier
backends (wandb/tensorboard/clearml) attach through `platforms`.
"""
from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None, formats=("stdout", "csv", "json")):
        self.log_dir = log_dir
        self.formats = formats
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._csv_keys = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def logkv(self, key: str, value: float):
        self._sums[key] = float(value)
        self._counts[key] = 1

    def logkv_mean(self, key: str, value: float):
        self._sums[key] += float(value)
        self._counts[key] += 1

    def dumpkvs(self) -> Dict[str, float]:
        kvs = {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}
        self._sums.clear()
        self._counts.clear()
        if "stdout" in self.formats and kvs:
            width = max(len(k) for k in kvs)
            print("-" * (width + 18))
            for k in sorted(kvs):
                print(f"| {k:<{width}} | {kvs[k]:<10.5g} |")
            print("-" * (width + 18))
        if self.log_dir and "csv" in self.formats and kvs:
            path = os.path.join(self.log_dir, "progress.csv")
            exists = os.path.exists(path)
            keys = sorted(kvs)
            if self._csv_keys is None:
                self._csv_keys = keys
            with open(path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_keys, extrasaction="ignore")
                if not exists:
                    w.writeheader()
                w.writerow(kvs)
        if self.log_dir and "json" in self.formats and kvs:
            with open(os.path.join(self.log_dir, "progress.jsonl"), "a") as f:
                f.write(json.dumps(kvs) + "\n")
        return kvs

    @contextlib.contextmanager
    def profile_kv(self, scope: str):
        start = time.time()
        try:
            yield
        finally:
            self.logkv_mean(f"wait_{scope}", time.time() - start)
