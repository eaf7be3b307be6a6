"""The sampling slice end to end: mdm_tpu_torch's MotionGenerator.generate
against mdm_tpu's p_sample_loop(cfg_denoiser(...)) + recover_from_ric, with
identical weights, initial noise and per-step noise; plus the port's
Predictor on the CPU.

The JAX side runs its Pallas layer kernel in interpret mode. Each of the 5
steps feeds the previous step's output back in, which amplifies f32
reordering: features are held to 1e-4 and the decoded joints, whose root
trajectory is a cumulative sum over frames, to 1e-3.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import ops  # noqa: E402
from mdm_tpu.core import hml_codec as jcodec  # noqa: E402
from mdm_tpu.diffusion import Schedule as JaxSchedule, p_sample_loop as jax_p_sample_loop  # noqa: E402
from mdm_tpu.models import Conditioning as JaxCond, MDM as JaxMDM, MDMConfig as JaxCfg  # noqa: E402
from mdm_tpu.models import cfg_denoiser as jax_cfg_denoiser  # noqa: E402
from mdm_tpu.sampling import load_norm_stats  # noqa: E402
from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig, state_dict_from_flax  # noqa: E402
from mdm_tpu_torch.sampling import GenerationConfig, MotionGenerator  # noqa: E402
from mdm_tpu_torch.serving import Predictor, PredictorConfig  # noqa: E402

SMALL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
B, T, D, STEPS = 2, 32, 263, 5


@pytest.fixture(autouse=True)
def _kernel_flags():
    ops.enable_pallas_interpret(True)
    ops.enable_pallas_layer_inference(True)
    yield
    ops.enable_pallas_interpret(False)
    ops.enable_pallas_layer_inference(None)
    ops.enable_pallas_sample_block(None)
    ops.enable_pallas_encoder_tail(None)


def test_slice_matches_jax():
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(B, T, D)).astype(np.float32)
    step_noise = rng.normal(size=(STEPS, B, T, D)).astype(np.float32)
    text = rng.normal(size=(B, 512)).astype(np.float32)

    jmodel = JaxMDM(JaxCfg(**SMALL))
    jcond = JaxCond(frames_mask=jnp.ones((B, T), bool), text_embed=jnp.asarray(text))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(noise), jnp.zeros((B,), jnp.int32), jcond)
    fn = jax_cfg_denoiser(lambda p, x, t, c: jmodel.apply(p, x, t, c), params, 2.5)
    feats_ref = jax_p_sample_loop(lambda x, t: fn(x, t, jcond), JaxSchedule.create("cosine", 1000, "5"),
                                  jnp.asarray(noise), jax.random.PRNGKey(1),
                                  step_noise=jnp.asarray(step_noise))
    mean, std = load_norm_stats("humanml")
    joints_ref = jcodec.recover_from_ric(feats_ref * std + mean, 22)

    model = MDM(MDMConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                               model.config), strict=True)
    gen = MotionGenerator(model, Schedule.create("cosine", 1000, "5"), GenerationConfig(guidance_scale=2.5))
    out = gen.generate(Conditioning(frames_mask=torch.ones(B, T, dtype=torch.bool),
                                    text_embed=torch.from_numpy(text)), B, T,
                       noise=torch.from_numpy(noise), step_noise=torch.from_numpy(step_noise))
    assert out["joints"].shape == (B, T, 22, 3)
    np.testing.assert_allclose(out["features"].numpy(), np.asarray(feats_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out["joints"].numpy(), np.asarray(joints_ref), atol=1e-3, rtol=1e-4)


def test_generate_is_reproducible_from_its_generator():
    model = MDM(MDMConfig(**{**SMALL, "num_layers": 1})).init_weights(torch.Generator().manual_seed(0))
    gen = MotionGenerator(model, Schedule.create("cosine", 1000, "3"))
    cond = Conditioning(text_embed=torch.zeros(1, 512))
    run = lambda seed: gen.generate(cond, 1, 8, torch.Generator().manual_seed(seed))["joints"]
    a, b, c = run(1), run(1), run(2)
    assert a.shape == (1, 8, 22, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_predictor_answers_prompts_on_cpu(tmp_path):
    p = Predictor(PredictorConfig(num_diffusion_steps=20, respacing="5", max_frames=24,
                                  latent_dim=128, layers=2, compute_dtype="float32",
                                  device="cpu"))
    p.setup()
    for prompt in ("a person walks forward", "a person jumps"):
        out = p.predict(prompt, motion_length_sec=1.0, seed=3)
        joints = np.asarray(out["joints"][0])
        assert out["prompt"] == prompt
        assert joints.shape == (1, 20, 22, 3) and np.isfinite(joints).all()
    again = np.asarray(p.predict("a person jumps", motion_length_sec=1.0, seed=3)["joints"][0])
    np.testing.assert_array_equal(again, joints)
    # The animation: an .mp4 through ffmpeg, else plot_3d_motion's GIF (the
    # hik format: tests/test_torch_joints2smpl.py).
    anim = p.predict("a person jumps", motion_length_sec=0.5, seed=3, output_format="animation",
                     output_dir=str(tmp_path / "anim"))["animations"]
    assert len(anim) == 1 and os.path.exists(anim[0])
    assert anim[0].endswith(".mp4" if shutil.which("ffmpeg") else ".gif")
    with pytest.raises(ValueError, match="output_format"):
        p.predict("a person jumps", output_format="bvh")
    # A checkpoint written by mdm_tpu (an orbax directory) is refused.
    (tmp_path / "ckpt_000000001").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        Predictor(PredictorConfig(model_path=str(tmp_path / "ckpt_000000001"), device="cpu",
                                  latent_dim=128, layers=2, compute_dtype="float32")).setup()
