"""BENCHMARK.json keeps to the benchmark's contract: names, units, keys,
lengths, bounds, the time a full check takes, and every file it names."""
import json
import os
import re

import pytest

from benchmark.harness.registry import HERE, ROOT, Registry

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert all(PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(group):
    entries = BENCH[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - KEYS[group]
        assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer") else set()), e
        assert KEYS[group] <= set(e), e
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end":
                assert _line(e[key]), (e["name"], key)


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.fullmatch(w["traffic"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in BENCH["workloads"]]
    reports = lambda m, cell: "workloads" not in m or cell in m["workloads"]
    for cell in cells:
        assert sum(reports(m, cell) for m in e2e.values() if m["name"] != "setup_s") >= 1
        assert any(reports(m, cell) for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])


def test_run_seconds_fit_the_full_check():
    cells = 24
    runs = 2 + 14 * cells
    assert 1 <= BENCH["run_seconds"] <= 51
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_every_named_file_is_there_and_agrees():
    reg = Registry()
    for w in BENCH["workloads"]:
        cell = reg.cell(w["name"])  # raises where the workload file disagrees
        assert os.path.exists(os.path.join(HERE, "traffic", cell["kind"] + ".py"))
        assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())
    for m in BENCH["per_layer"]:
        r = reg.reader(m["name"])
        assert (r.UNIT, r.LAYER, r.SOURCE, r.MOVES, r.BETTER) == (
            m["unit"], m["layer"], m["source"], m["moves"], m["better"]), m["name"]
    for root, _, files in os.walk(HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), ROOT)
            if "__pycache__" not in rel:
                assert PATH.fullmatch(rel), rel
