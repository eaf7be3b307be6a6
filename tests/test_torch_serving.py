"""mdm_tpu_torch.serving.Predictor's sampler settings on the CPU: its
PredictorConfig has mdm_tpu's fields (with the port's device) at mdm_tpu's
defaults, and a request
with ``sampler="dpmpp_2m"`` or ``cfg_cache_interval=2`` reaches
MotionGenerator with those values, makes that sampler's model forwards and
answers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mdm_tpu import serving as jserving  # noqa: E402
from mdm_tpu_torch import serving  # noqa: E402
from mdm_tpu_torch.sampling import pipeline  # noqa: E402


def test_config_fields_are_mdm_tpus():
    ours = {f.name: f.default for f in dataclasses.fields(serving.PredictorConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jserving.PredictorConfig)}
    assert set(ours) == set(theirs) | {"device"}
    assert {k: v for k, v in ours.items() if k != "device"} == theirs
    assert ours["sampler"] == "ddpm" and ours["cfg_cache_interval"] == 1


STEPS = 4


@pytest.mark.parametrize("sampler, interval, forwards", [
    ("ddpm", 1, STEPS),           # one double-batched CFG forward a step
    ("dpmpp_2m", 1, STEPS),       # the second-order solver: one a step too
    ("ddpm", 2, STEPS + STEPS // 2),  # cached CFG: the unconditional half every 2nd step
])
def test_sampler_settings_reach_the_generator(monkeypatch, sampler, interval, forwards):
    configs = []
    init = pipeline.MotionGenerator.__init__

    def spy(self, model, sched, config=pipeline.GenerationConfig(), *a, **k):
        configs.append(config)
        init(self, model, sched, config, *a, **k)

    monkeypatch.setattr(pipeline.MotionGenerator, "__init__", spy)
    p = serving.Predictor(serving.PredictorConfig(
        num_diffusion_steps=20, respacing=str(STEPS), max_frames=24, latent_dim=64, layers=1,
        compute_dtype="float32", device="cpu", sampler=sampler, cfg_cache_interval=interval))
    p.setup()
    assert [(c.sampler, c.cfg_cache_interval, c.guidance_scale) for c in configs] == [
        (sampler, interval, 2.5)]
    calls = []
    p.model.register_forward_hook(lambda m, args, out: calls.append(out.shape[0]))
    out = p.predict("a person walks forward", motion_length_sec=1.0, seed=3)
    joints = np.asarray(out["joints"][0])
    assert joints.shape == (1, 20, 22, 3) and np.isfinite(joints).all()
    assert len(calls) == forwards
    again = np.asarray(p.predict("a person walks forward", motion_length_sec=1.0,
                                 seed=3)["joints"][0])
    np.testing.assert_array_equal(again, joints)
