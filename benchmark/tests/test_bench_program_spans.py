"""The readers of the program's spans (``harness/program_spans.py``) on
synthetic chrome traces: launches matched across threads, the sampler's
exclusion of the denoiser, the idle gaps' midpoint rule, the unattributed
remainder, the trace taken only for its own window, and the accepted
readers unmoved by the program's ranges among the host events."""
import gzip
import json
import os

import pytest

from benchmark.counts import flops
from benchmark.harness import program_spans as P
from benchmark.harness.registry import Registry
from benchmark.harness.trace import WINDOW, Observed

BASE = 1_790_000_000_000_000_000  # unix ns, as torch.profiler's baseTimeNanoseconds
US = 1000


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(events, window=(0, 1000)):
    """A chrome trace of ``events`` (times in us after BASE) inside the window range."""
    return {"baseTimeNanoseconds": BASE, "traceEvents": [
        _x("user_annotation", WINDOW, window[0], window[1] - window[0]),
        _x("gpu_user_annotation", "train.backward", 0, 1000, tid=7), *events]}


def _kernel(name, ts, dur, corr, launch_ts, launch_tid=1, call="cudaLaunchKernel"):
    """The device operation and the runtime or driver call that launched it."""
    cat = "cuda_runtime" if call.startswith("cuda") else "cuda_driver"
    return [_x(cat, call, launch_ts, 2, tid=launch_tid, corr=corr),
            _x("kernel", name, ts, dur, tid=7, corr=corr)]


def _ms(us):
    return us * US / 1e9


def test_a_launch_from_another_thread_counts_under_the_span_it_lies_in():
    w = P.parse(_trace([_x("cpu_op", "train.step", 0, 900),
                        _x("cpu_op", "train.backward", 100, 200),
                        _x("cpu_op", "train.update", 400, 100),
                        *_kernel("bwd", 350, 50, 7, 150, launch_tid=2),
                        *_kernel("adam", 500, 100, 8, 420, call="cuLaunchKernel")]))
    assert w.busy_s == pytest.approx(_ms(150))
    assert w.launched_under("train.backward").tolist() == [True, False]
    assert w.launched_under("train.update").tolist() == [False, True]
    assert w.launched_under("train.step").tolist() == [True, True]
    assert w.summary()["spans"]["train.backward"]["device_s"] == pytest.approx(_ms(50))


def test_the_sampler_share_leaves_out_the_denoiser(export):
    _, obs = export("generate", [_x("cpu_op", "sample.step", 0, 600),
                                 _x("cpu_op", "denoiser.forward", 100, 300),
                                 *_kernel("mix_a", 600, 40, 1, 50),
                                 *_kernel("layer", 640, 100, 2, 200),
                                 *_kernel("mix_b", 700, 60, 3, 500)])
    # mix_a and mix_b: [600, 640) and [700, 760), over the busy [600, 760)
    assert _read("sampler_share.generate", obs) == pytest.approx(100.0 * 100 / 160)
    assert _read("text_tower_share.generate", obs) is None  # no text.encode span


def test_an_idle_gap_counts_by_its_midpoint(export):
    w, obs = export("generate", [
        _x("cpu_op", "denoiser.forward", 100, 300),
        *_kernel("a", 0, 100, 1, 0),  # gap [100, 200): midpoint 150, inside
        *_kernel("b", 200, 150, 2, 120),  # gap [350, 500): midpoint 425, outside
        *_kernel("c", 500, 500, 3, 300)])
    assert _read("denoiser_idle_share.generate", obs) == pytest.approx(100.0 * 100 / 1000)
    idle = w.summary()
    assert idle["spans"]["denoiser.forward"]["idle_s"] == pytest.approx(_ms(100))
    assert idle["idle_outside_spans_s"] == pytest.approx(_ms(150))


def test_the_unattributed_remainder():
    """A kernel whose launch matched no call, a copy launched under no span."""
    w = P.parse(_trace([_x("cpu_op", "train.update", 0, 100),
                        *_kernel("adam", 100, 100, 1, 10),
                        _x("kernel", "orphan", 300, 100, tid=7, corr=99),
                        *_kernel("Memcpy DtoH", 500, 200, 2, 400, call="cudaMemcpyAsync")]))
    s = w.summary()
    assert s["unattributed_share"] == pytest.approx(100.0 * 100 / 400)
    assert s["outside_spans_share"] == pytest.approx(100.0 * 200 / 400)
    assert s["spans"]["train.update"]["device_s"] == pytest.approx(_ms(100))


def test_the_trace_is_taken_for_its_own_window_only(export):
    w, obs = export("train", [_x("cpu_op", "train.update", 0, 100),
                              *_kernel("adam", 100, 100, 1, 10),
                              *_kernel("fwd", 300, 300, 2, 200)])
    assert _read("update_share.train", obs) == pytest.approx(100.0 * 100 / 400)
    assert _read("denoiser_idle_share.generate", obs) is None  # the other phase
    obs.counts.pop("export_s")
    assert _read("update_share.train", obs) is None  # nothing exported
    obs = _observed(w, "train")
    obs.t0 += 10 * US
    assert _read("update_share.train", obs) is None  # another window's trace


def test_a_program_without_spans_reads_nothing(export):
    """The parent program opens no span: every reader of spans returns None."""
    _, gen = export("generate", [*_kernel("a", 0, 100, 1, 0)])
    assert [_read(m, gen) for m in ("sampler_share.generate", "text_tower_share.generate",
                                    "denoiser_idle_share.generate")] == [None] * 3
    _, train = export("train", [*_kernel("a", 0, 100, 1, 0)])
    assert _read("update_share.train", train) is None


def test_the_accepted_readers_ignore_the_programs_ranges():
    """The program's ranges join the host events of a traced window; the ten
    accepted readers read the device operations and counts, which they leave
    as they were."""
    ops = [("gemm_bf16_wgmma", 0, 400, True), ("attn_fwd_bf16", 400, 500, True),
           ("Memcpy DtoH", 600, 700, False)]
    host = [(WINDOW, 0, 1000), ("mdm.forward", 0, 550), ("aten::mm", 10, 20)]
    spans = [("denoiser.forward", 5, 540), ("sample.step", 0, 560), ("denoiser.layer", 8, 300)]
    reg = Registry()
    names = [m["name"] for m in reg.bench["per_layer"] if m["source"] == "device_trace"]
    assert len(names) == 10
    for phase in ("generate", "train"):
        work = flops.Work()
        work.product("products", 64, 512, 512, "bfloat16", train=phase == "train")
        work.attention("attention", 1e5, 64, 64, 64, "bfloat16", train=phase == "train")
        counts = {"phase": phase, "units": 2, "work": work, "dtype": "bfloat16",
                  "spans": {"mdm.forward": 4}}
        plain = Observed((0, 1000), ops, host, dict(counts))
        ranged = Observed((0, 1000), ops, host + spans, dict(counts))
        for name in names:
            r = reg.reader(name)
            assert r.read(plain) == r.read(ranged), name


@pytest.fixture
def export(tmp_path, monkeypatch):
    """Writes a trace of the given events as the traced run exports it and
    returns (its window, an ``Observed`` of it for ``phase``)."""
    monkeypatch.setattr(P, "TRACES", str(tmp_path))
    n = [0]

    def write(phase, events):
        n[0] += 1
        path = os.path.join(tmp_path, f"cell.{n[0]}.trace.json.gz")
        with gzip.open(path, "wt") as f:
            json.dump(_trace(events), f)
        os.utime(path, ns=(n[0], n[0]))  # the newest is the last written
        w = P.read(path)
        return w, _observed(w, phase)

    return write


def _observed(w, phase):
    """An ``Observed`` of ``w``'s window and device operations, as the traced
    run builds it."""
    ops = [(n, int(s), int(e), True) for n, s, e in zip(w.names, w.start, w.end)]
    return Observed((w.t0, w.t1), ops, [], {"phase": phase, "units": 1, "export_s": 0.1})


def _read(metric, obs):
    return Registry().reader(metric).read(obs)
