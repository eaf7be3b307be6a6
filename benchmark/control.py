#!/usr/bin/env python3
"""The readings that each cell's limits are set from, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--modes ...] [--units N]

For every seed, in one process: set-up as a run makes it, ``units``
requests (or the window's checked first steps) of the timed path, the program's
state freed, then the plain reference; each mode prints one JSON line of
the cell's compared numbers against the float32 reference:

- ``program``: what the timed path produced (the lower reading);
- ``control``: the reference put in the program's place, a step below the
  precision the configuration states: fp8 products for bfloat16, TF32 for
  float32 (a text tower in float32 runs on TF32);
- ``swap`` (generation): the program's answer with two motions of a
  request exchanged, an answer altered where it is produced;
- ``half`` (training): the reference with the loss averaged over the first
  half of the batch;
- ``unchanged`` (training): the state left as it was before the steps.

The benchmark's runs never run this; a test under ``benchmark/tests`` holds
it at a size the CPU runs.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def _generation(traffic, st, modes, units):
    from benchmark.harness import checks as C
    from benchmark.reference.precision import Precision

    st.keep = set(range(min(units, len(st.slots))))
    rec = traffic.window(st, 0.0, units)
    traffic.release(st)
    params = traffic.reference_params(st)
    out = {m: C.Checks(st.cell["limits"]) for m in modes}
    swap = lambda t: t[[1, 0] + list(range(2, t.shape[0]))]
    for i, got in rec.kept:
        tried = {"program": lambda: got,
                 "control": lambda: traffic.reference_request(
                     st, i, Precision(CONTROL[st.cell["dtype"]]), params, Precision("tf32")),
                 "swap": lambda: dict(got, features=swap(got["features"]),
                                      joints=swap(got["joints"]))}
        for mode in modes:
            traffic.check_request(st, out[mode], i, tried[mode](), params)
    return out


def _training(traffic, st, modes):
    from benchmark.harness import checks as C
    from benchmark.reference.precision import Precision

    traffic.window(st, 0.0, st.cell["params"]["checked_steps"])
    traffic.release(st)
    got = traffic.recorded(st)
    want = traffic.reference_steps(st, Precision("f32"))
    limits = st.cell["limits"]
    out = {m: C.Checks(limits) for m in modes}
    if "program" in modes:
        traffic.compare(st, out["program"], got, want)
    B = st.cell["params"]["batch"]
    for mode, prec, rows in (("control", CONTROL[st.cell["dtype"]], None),
                             ("half", "f32", slice(0, B // 2))):
        if mode in modes:
            losses, grads, params, ema, _ = traffic.reference_steps(st, Precision(prec), rows)
            traffic.compare(st, out[mode], {"loss": losses, "grad": grads, "params": params,
                                            "ema": ema}, want)
    if "unchanged" in modes:
        P0 = want[4]
        traffic.compare(st, out["unchanged"], dict(got, params=P0, ema=P0), want)
    return out


def readings(reg, name: str, seed: int, modes, units: int, device: str):
    """{mode: Checks} of one seed."""
    cell = reg.cell(name)
    traffic = reg.traffic(cell["kind"])
    st = traffic.setup(cell, seed, device)
    if cell["kind"] == "train":
        return _training(traffic, st, modes)
    return _generation(traffic, st, modes, units)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--modes", default="")
    ap.add_argument("--units", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness.registry import Registry

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    kind = reg.cell(args.workload)["kind"]
    modes = args.modes.split(",") if args.modes else (
        ["program", "control", "half", "unchanged"] if kind == "train"
        else ["program", "control", "swap"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode, checks in readings(reg, args.workload, seed, modes, args.units, "cuda").items():
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "numbers": checks.values}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
