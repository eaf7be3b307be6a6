"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, with every configuration and cell cut down, in a directory of its
own, so that tests drive whole runs of the harness without a card."""
from __future__ import annotations

import json
import os
import shutil

from benchmark.harness.registry import HERE, ROOT, Registry

DENOISER = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4)
CLIP = dict(width=32, layers=2, heads=2, embed_dim=32)
BERT = dict(dim=32, n_layers=2, n_heads=2, hidden_dim=64, max_position_embeddings=64)
PARAMS = {
    "generate": dict(batch=3, frames=16, lengths=[4, 16], tokens=[4, 9], pool=2, check_among=3,
                     check_requests=2, trace_units=2),
    "generate_ar": dict(batch=3, frames=16, tokens=[4, 9], text_len=12, pool=2, check_among=3,
                        check_requests=2, trace_units=2),
    "train": dict(batch=4, frames=16, lengths=[4, 16], pool=4, checked_steps=3, trace_units=2),
}


def tiny_copy(dest: str) -> Registry:
    """A registry over ``dest``, which holds BENCHMARK.json and benchmark/
    copied from this checkout with every size cut down."""
    bench_dir = os.path.join(dest, "benchmark")
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for path in os.listdir(os.path.join(bench_dir, "configs")):
        p = os.path.join(bench_dir, "configs", path)
        cfg = json.load(open(p))
        cfg["denoiser"].update(DENOISER)
        if cfg["denoiser"]["arch"] == "trans_dec":
            cfg["denoiser"].update(context_len=4, pred_len=6, text_dim=BERT["dim"])
        else:
            cfg["denoiser"]["text_dim"] = CLIP["embed_dim"]
        cfg["text_encoder"].update(CLIP if cfg["text_encoder"]["type"] == "clip" else BERT)
        cfg["diffusion"]["diffusion_steps"] = 4
        json.dump(cfg, open(p, "w"))
    for path in os.listdir(os.path.join(bench_dir, "workloads")):
        p = os.path.join(bench_dir, "workloads", path)
        w = json.load(open(p))
        w["params"].update(PARAMS[w["kind"]])
        json.dump(w, open(p, "w"))
    return Registry(dest, bench_dir)
