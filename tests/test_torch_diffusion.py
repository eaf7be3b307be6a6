"""mdm_tpu_torch.diffusion against mdm_tpu.diffusion on the CPU.

The schedule tables are built in float64 numpy by both packages and
rounded once to float32, so they must be equal exactly. The q/p algebra is
a handful of f32 multiply-adds (agreement to 1e-6). The sampler test feeds
both loops one numpy-defined model function and identical injected noise;
it integrates over the respaced steps, so it is held to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import diffusion as jd  # noqa: E402
from mdm_tpu.diffusion import gaussian as jg  # noqa: E402
from mdm_tpu_torch import diffusion as td  # noqa: E402

TABLES = [f for f in td.Schedule.__dataclass_fields__
          if f not in ("num_timesteps", "original_num_timesteps")]


@pytest.mark.parametrize("respacing", ["50", "5", None])
def test_schedule_tables_equal(respacing):
    ours = td.Schedule.create("cosine", 1000, respacing)
    ref = jd.Schedule.create("cosine", 1000, respacing)
    assert ours.num_timesteps == ref.num_timesteps
    assert ours.original_num_timesteps == ref.original_num_timesteps
    for name in TABLES:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == (np.int64 if name == "timestep_map" else np.float32), name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_beta_schedules_and_spacing_equal():
    for name in ("linear", "cosine"):
        np.testing.assert_array_equal(td.named_beta_schedule(name, 100),
                                      jd.named_beta_schedule(name, 100))
    for counts in ("50", "5", "10,20", "ddim25", [3, 7]):
        assert td.space_timesteps(1000, counts) == jd.space_timesteps(1000, counts)
    with pytest.raises(ValueError):
        td.space_timesteps(10, "ddim7")


def _arrays(seed=0, shape=(3, 6, 5)):
    rng = np.random.default_rng(seed)
    f = lambda: rng.normal(size=shape).astype(np.float32)
    t = np.array([0, 17, 49])
    return f(), f(), f(), t, rng


@pytest.mark.parametrize("var_type", ["FIXED_SMALL", "FIXED_LARGE"])
@pytest.mark.parametrize("mean_type", ["START_X", "EPSILON"])
def test_p_mean_variance_matches_jax(mean_type, var_type):
    ours_s, ref_s = td.Schedule.create("cosine", 1000, "50"), jd.Schedule.create("cosine", 1000, "50")
    out, x, _, t, rng = _arrays()
    kw = {}
    if mean_type == "START_X":  # the inpainting hook needs x0 prediction
        mask = rng.random(out.shape) < 0.3
        kw = dict(inpainting_mask=mask, inpainted_motion=np.zeros_like(out))
    ours = td.p_mean_variance(
        ours_s, torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(t),
        mean_type=td.MeanType[mean_type], var_type=td.VarType[var_type], clip_denoised=True,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    ref = jg.p_mean_variance(
        ref_s, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t),
        mean_type=jd.MeanType[mean_type], var_type=jd.VarType[var_type], clip_denoised=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.broadcast_to(np.asarray(b), a.shape),
                                   atol=1e-6, rtol=1e-6)


def test_q_sample_and_posterior_match_jax():
    ours_s, ref_s = td.Schedule.create("cosine", 1000, "50"), jd.Schedule.create("cosine", 1000, "50")
    x0, xt, n, t, _ = _arrays(1)
    tt = [torch.from_numpy(v) for v in (x0, xt, n, t)]
    jj = [jnp.asarray(v) for v in (x0, xt, n, t)]
    np.testing.assert_allclose(td.q_sample(ours_s, tt[0], tt[3], tt[2]).numpy(),
                               np.asarray(jg.q_sample(ref_s, jj[0], jj[3], jj[2])), atol=1e-6)
    for a, b in zip(td.q_posterior_mean_variance(ours_s, tt[0], tt[1], tt[3]),
                    jg.q_posterior_mean_variance(ref_s, jj[0], jj[1], jj[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# One model function defined by numpy constants, written for each framework.
_W = np.random.default_rng(7).normal(size=(5,)).astype(np.float32)


def _torch_model(x, t):
    return torch.tanh(x * torch.from_numpy(_W) + t[:, None, None].float() / 1000.0)


def _jax_model(x, t):
    return jnp.tanh(x * jnp.asarray(_W) + t[:, None, None].astype(jnp.float32) / 1000.0)


@pytest.mark.parametrize("inpaint", [False, True])
def test_p_sample_loop_matches_jax(inpaint):
    steps = 5
    ours_s, ref_s = td.Schedule.create("cosine", 1000, str(steps)), jd.Schedule.create("cosine", 1000, str(steps))
    noise, motion, _, _, rng = _arrays(2)
    step_noise = rng.normal(size=(steps,) + noise.shape).astype(np.float32)
    mask = rng.random(noise.shape) < 0.5
    kw = dict(inpainting_mask=mask, inpainted_motion=motion) if inpaint else {}
    ours = td.p_sample_loop(_torch_model, ours_s, torch.from_numpy(noise), None,
                            step_noise=torch.from_numpy(step_noise),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    ref = jd.p_sample_loop(_jax_model, ref_s, jnp.asarray(noise), jax.random.PRNGKey(0),
                           step_noise=jnp.asarray(step_noise),
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_p_sample_loop_draws_from_its_generator():
    sched = td.Schedule.create("cosine", 1000, "5")
    noise = torch.zeros(2, 4, 5)
    run = lambda seed: td.p_sample_loop(_torch_model, sched, noise,
                                        torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
