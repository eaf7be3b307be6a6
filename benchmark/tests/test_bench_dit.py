"""The DiT traffic kind (``traffic/generate_dit.py``) on the CPU at a tiny
size (``tiny.py``'s copy: 2 blocks of width 32 in 4 heads, 4 diffusion
steps, 3 prompts of 16 frames): a whole run through the harness's set-up,
window and check is correct, traced or not; an answer altered where it is
produced (two motions exchanged) fails the check, and so does the fp8
control; the plain reference loads nothing of the program and no JAX."""
import json
import os
import subprocess
import sys

import pytest

import benchmark.control as control
from benchmark.harness import runner
from benchmark.harness.registry import ROOT
from benchmark.tests import tiny  # its table's entry for this kind: benchmark/conftest.py

CELL = "dit_xl_humanml.generate_b128"
SEED = 2 ** 33 + 4321


@pytest.fixture
def f32(tmp_path):
    reg = tiny.tiny_copy(str(tmp_path))
    path = os.path.join(reg.dir, "workloads", f"{CELL}.json")
    w = json.load(open(path))
    w["dtype"] = "float32"
    json.dump(w, open(path, "w"))
    return reg


def _run(reg, trace=False):
    return runner.run(reg, CELL, SEED, 0.2, trace, "cpu", lambda: 1.0)[0]


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_agrees_with_the_reference(f32, trace):
    """In float32 the program's CPU path and the plain reference compute the
    same function from the same weights and draws."""
    result = _run(f32, trace)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    for number, v in result["checks"].items():
        assert v["value"] <= 1e-5, (number, v)
    wanted = f32.per_layer(CELL) if trace else f32.end_to_end(CELL)
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert {"motions_per_s", "setup_s"} <= set(result["metrics"])


def test_two_motions_exchanged_fail_the_check(f32, monkeypatch):
    from mdm_tpu_torch.sampling.pipeline import MotionGenerator

    generate = MotionGenerator.generate

    def altered(self, *args, **kwargs):
        out = generate(self, *args, **kwargs)
        order = [1, 0] + list(range(2, out["features"].shape[0]))
        return {k: v[order] for k, v in out.items()}

    monkeypatch.setattr(MotionGenerator, "generate", altered)
    result = _run(f32)
    assert not result["correct"]
    assert result["checks"]["joints_rel"]["value"] > 0.1


def test_the_fp8_control_fails(tiny):
    out = control.readings(tiny, CELL, 2 ** 31 + 5, ["control", "swap"], 1, "cpu")
    assert not out["control"].correct() and not out["swap"].correct()


def test_the_reference_loads_nothing_forbidden():
    code = ("import benchmark.reference.dit, benchmark.counts.dit, sys\n"
            "print(' '.join(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = out.stdout.split()
    assert runner.forbidden_modules(loaded) == []
    assert not [m for m in loaded if m.split(".")[0] == "mdm_tpu_torch"]


def test_the_counts_at_dit_xl():
    """DiT-XL's products are 31.85 MFLOP a token a layer (qkv, proj, fc1,
    fc2 at 1152 / 4608), the modulation one product of [samples, 1152] by
    [1152, 28 x 6912 + 2304] with an f32 output; a residual row kernel
    moves 8 bytes a bf16 value, the first of a forward 4."""
    from benchmark.counts import dit, flops

    cfg = dict(latent_dim=1152, ff_size=4608, num_layers=28, njoints=263, nfeats=1, text_dim=512)
    lengths = [196] * 256
    work = dit.dit_forward(flops.Work(), cfg, "bfloat16", lengths)
    tokens, n_mod = 256 * 196, 28 * 6912 + 2304
    per_token_layer = 2 * 1152 * (3456 + 1152 + 4608 + 4608)
    assert per_token_layer == 31_850_496
    assert work.flops["products"] == tokens * 28 * per_token_layer + 2 * 256 * 1152 * n_mod
    values, vectors = tokens * 1152, 256 * 1152 * 4
    assert work.bytes["adaln"] == 4 * values + 2 * vectors + 56 * (8 * values + 3 * vectors)
    assert work.least_s["adaln"] == pytest.approx(work.bytes["adaln"] / flops.PEAKS["hbm_bytes_per_s"])
    assert work.flops["attention"] == 4 * 1152 * 256 * 196 ** 2 * 28
