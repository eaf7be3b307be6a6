"""Whole runs of the harness on the CPU at a tiny size: the traffic is
drawn from the seed alone, a new cell and a new metric are found by their
files' names, the reference agrees with the program's CPU path, and the
result line has the contract's keys."""
import json
import os

import pytest
import torch

from benchmark.harness import runner
from benchmark.harness.registry import Registry

CELLS = ["mdm_humanml.generate_b128", "dip_humanml.generate_ar_b512",
         "mdm_humanml.train_f32_b64", "mdm_humanml.train_bf16_b512"]
SEED = 2 ** 33 + 12345  # more than 32 signed bits hold


def _as_float32(reg, name):
    path = os.path.join(reg.dir, "workloads", f"{name}.json")
    w = json.load(open(path))
    w["dtype"] = "float32"
    json.dump(w, open(path, "w"))


@pytest.mark.parametrize("name", CELLS)
def test_traffic_is_a_function_of_the_seed(tiny, name):
    cell = tiny.cell(name)
    traffic = tiny.traffic(cell["kind"])
    draw = (lambda s: traffic.draw_pool(cell, s, "cpu")) if cell["kind"] == "train" else (
        lambda s: traffic.draw_inputs(cell, s, "cpu"))
    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any(not torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_has_the_contract_keys(tiny, name, trace):
    result, lines = runner.run(tiny, name, SEED, 0.2, trace, "cpu", lambda: 1.0)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(tiny.cell(name)["limits"])
    assert len(lines) == len(result["checks"])
    json.dumps(result, allow_nan=False)
    wanted = tiny.per_layer(name) if trace else tiny.end_to_end(name)
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    else:
        assert "breakdown" in result and result["device"]["window_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_program_on_the_cpu(tmp_path, name):
    """In float32 the program's CPU path and the plain reference compute the
    same function from the same weights and draws. The EMA's change over the
    first steps is a ten-thousandth of the parameters', a few float32 ulps
    of their values, so its gap is their rounding's."""
    from benchmark.tests.tiny import tiny_copy

    reg = tiny_copy(str(tmp_path))
    _as_float32(reg, name)
    result, _ = runner.run(reg, name, SEED, 0.2, False, "cpu", lambda: 1.0)
    for number, v in result["checks"].items():
        assert v["value"] <= (1e-3 if number == "ema_gap" else 1e-5), (number, v)


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """Adding a cell and a per-layer metric takes new files and entries only."""
    from benchmark.tests.tiny import tiny_copy

    reg = tiny_copy(str(tmp_path))
    bench = json.load(open(os.path.join(reg.root, "BENCHMARK.json")))
    w = json.load(open(os.path.join(reg.dir, "workloads", "mdm_humanml.generate_b128.json")))
    w["traffic"] = "generate_b4"
    w["params"]["batch"] = 4
    json.dump(w, open(os.path.join(reg.dir, "workloads", "mdm_humanml.generate_b4.json"), "w"))
    with open(os.path.join(reg.dir, "metrics", "forwards_per_request.generate.py"), "w") as f:
        f.write('"""Denoiser forwards a request."""\nLAYER = "sampler loop"\nUNIT = "forwards"\n'
                'SOURCE = "program_span"\nMOVES = "motions_per_s"\nBETTER = "lower"\n\n\n'
                'def read(obs):\n    return obs.counts["spans"]["mdm.forward"] / obs.counts["units"]\n')
    bench["workloads"].append({"name": "mdm_humanml.generate_b4", "config": "mdm_humanml",
                               "traffic": "generate_b4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "forwards_per_request.generate", "unit": "forwards",
                               "better": "lower", "source": "program_span",
                               "layer": "sampler loop", "moves": "motions_per_s",
                               "workloads": ["mdm_humanml.generate_b4"]})
    for m in bench["end_to_end"]:
        if m["name"] == "motions_per_s":
            m["workloads"].append("mdm_humanml.generate_b4")
    json.dump(bench, open(os.path.join(reg.root, "BENCHMARK.json"), "w"))
    reg = Registry(reg.root, reg.dir)
    result, _ = runner.run(reg, "mdm_humanml.generate_b4", SEED, 0.2, True, "cpu", lambda: 1.0)
    steps = reg.cell("mdm_humanml.generate_b4")["model"]["diffusion"]["diffusion_steps"]
    assert result["metrics"]["forwards_per_request.generate"]["value"] == steps
    result, _ = runner.run(reg, "mdm_humanml.generate_b4", SEED, 0.2, False, "cpu", lambda: 1.0)
    assert "motions_per_s" in result["metrics"]
