#!/usr/bin/env python3
"""Runs one cell of mdm_tpu_torch's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``
with its files under ``benchmark/`` (see ``harness/registry.py``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each compared number beside its limit; the same
numbers are the last lines of standard error. Exits non-zero and prints
no result when no CUDA device is there or fewer than the cell asks for,
when the program cannot be imported, or when JAX, Flax or the JAX package
is loaded once the window has closed.

Caches stay inside the checkout: the port's kernel library in
``mdm_tpu_torch/_build/`` (``MDM_TPU_COMPILE_CACHE`` unset), the toolkit's
and Triton's in ``.bench_cache/``, where the traced run's chrome trace goes.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.clock import clock  # noqa: E402  (the standard library only)

SINCE_START = clock()
CACHE = os.path.join(ROOT, ".bench_cache")


def _environment() -> None:
    os.environ.pop("MDM_TPU_COMPILE_CACHE", None)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import json

    import torch

    from benchmark.harness import runner
    from benchmark.harness.registry import Registry

    reg = Registry()
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        import mdm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program under test cannot be imported: {e}", file=sys.stderr)
        return 2
    result, lines = runner.run(reg, args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda", SINCE_START, os.path.join(CACHE, "traces"))
    loaded = runner.forbidden_modules(sys.modules)
    if loaded:
        print(f"benchmark: {', '.join(loaded)} loaded in the measuring process", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
