"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (the harness's look for a card is
skipped: these run on the CPU at a tiny size, in float32, where a sound
run reads near zero) with one fault planted in the program:

- a step that leaves the state unchanged, in set-up and the window or in
  the window alone;
- half of the batch left out, the mean taken over the rest;
- an answer altered where it is produced: two motions of a request
  exchanged.

The exchange between chips has no fault to plant: every cell runs on one
chip.
"""
import json
import os

import pytest

from benchmark.harness import runner

SEED = 2 ** 32 + 99


@pytest.fixture
def f32(tmp_path):
    from benchmark.tests.tiny import tiny_copy

    reg = tiny_copy(str(tmp_path))
    for name in os.listdir(os.path.join(reg.dir, "workloads")):
        p = os.path.join(reg.dir, "workloads", name)
        w = json.load(open(p))
        w["dtype"] = "float32"
        json.dump(w, open(p, "w"))
    return reg


def _run(reg, name):
    return runner.run(reg, name, SEED, 0.2, False, "cpu", lambda: 1.0)[0]


@pytest.mark.parametrize("name", ["mdm_humanml.train_f32_b64", "mdm_humanml.train_bf16_b512"])
def test_sound_then_unchanged_state(f32, name, monkeypatch):
    assert _run(f32, name)["correct"]
    import mdm_tpu_torch.train.train_step as ts

    monkeypatch.setattr(ts, "apply_gradients", lambda state, config: state)
    result = _run(f32, name)
    assert not result["correct"] and result["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("name", ["mdm_humanml.train_f32_b64", "mdm_humanml.train_bf16_b512"])
def test_a_fault_only_after_set_up(f32, name, monkeypatch):
    """The steps checked are the window's own: a step that goes wrong only
    once set-up has ended, as one captured after a warm-up could, is seen."""
    import mdm_tpu_torch.train.train_step as ts

    traffic = f32.traffic("train")
    setup, apply = traffic.setup, ts.apply_gradients
    in_window = []

    def setup_then_break(*args, **kwargs):
        st = setup(*args, **kwargs)
        in_window.append(True)
        return st

    monkeypatch.setattr(f32, "traffic", lambda kind: traffic)
    monkeypatch.setattr(traffic, "setup", setup_then_break)
    monkeypatch.setattr(ts, "apply_gradients",
                        lambda state, config: state if in_window else apply(state, config))
    result = _run(f32, name)
    assert in_window and not result["correct"]
    assert result["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("name", ["mdm_humanml.train_f32_b64", "mdm_humanml.train_bf16_b512"])
def test_half_the_batch(f32, name, monkeypatch):
    traffic = f32.traffic("train")

    def half_step(st):
        b = traffic.batch(st, st.next_step)
        n = b["x"].shape[0] // 2
        b = {"x": b["x"][:n], "mask": b["mask"][:n],
             "cond": b["cond"].replace(text_embed=b["cond"].text_embed[:n])}
        _, metrics = st.step(st.state, b, traffic._key(st, st.next_step))
        st.losses.append(metrics["loss"])
        st.next_step += 1

    monkeypatch.setattr(f32, "traffic", lambda kind: traffic)
    monkeypatch.setattr(traffic, "train_step", half_step)
    assert not _run(f32, name)["correct"]


@pytest.mark.parametrize("name", ["mdm_humanml.generate_b128", "dip_humanml.generate_ar_b512"])
def test_an_answer_altered(f32, name, monkeypatch):
    assert _run(f32, name)["correct"]
    from mdm_tpu_torch.sampling.pipeline import MotionGenerator

    generate = MotionGenerator.generate

    def altered(self, *args, **kwargs):
        out = generate(self, *args, **kwargs)
        order = [1, 0] + list(range(2, out["features"].shape[0]))
        return {k: v[order] for k, v in out.items()}

    monkeypatch.setattr(MotionGenerator, "generate", altered)
    assert not _run(f32, name)["correct"]
