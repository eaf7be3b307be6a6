"""mdm_tpu_torch's samplers against mdm_tpu's, on the CPU.

Each sampler runs on both sides around the same denoiser (the small
trans_enc MDM, weights from mdm_tpu's init through models/bridge.py) under
``cfg_denoiser``, or ``cfg_denoiser_cached`` for cached CFG, with the same
initial noise; the ancestral loop also takes the same per-step noise
(``step_noise``). The JAX side runs its Pallas layer kernel in interpret
mode, the port its plain version. Nothing random is drawn on either side
otherwise: DDIM at eta 0, PLMS and DPM-Solver++ are deterministic.

Tolerances, all f32: the q/p algebra to 1e-6 relative (the same
elementwise formulas on the same float32 tables); the sampled features to
1e-4, test_torch_pipeline.py's bar, where each of the 5 steps feeds the
previous step's output back in and CFG 2.5 amplifies the denoiser's f32
reordering.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import ops as jops  # noqa: E402
from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.diffusion import gaussian as JG  # noqa: E402
from mdm_tpu.diffusion import samplers as JS  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.diffusion import gaussian as G  # noqa: E402
from mdm_tpu_torch.diffusion import samplers as S  # noqa: E402
from mdm_tpu_torch.models import bridge  # noqa: E402
from mdm_tpu_torch.models import mdm as tm  # noqa: E402

SMALL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
B, T, D, STEPS, GUIDANCE = 2, 16, 263, 5, 2.5
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _kernel_flags():
    jops.enable_pallas_interpret(True)
    jops.enable_pallas_layer_inference(True)
    yield
    jops.enable_pallas_interpret(False)
    jops.enable_pallas_layer_inference(None)


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX MDM, params, the port's MDM) with the same weights."""
    jmodel = jm.MDM(jm.MDMConfig(**SMALL))
    cond = jm.Conditioning(text_embed=jnp.zeros((B, 512), jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((B, T, D)), jnp.zeros((B,), jnp.int32),
                         cond)
    tmodel = tm.MDM(tm.MDMConfig(**SMALL))
    tmodel.load_state_dict(bridge.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tmodel.config), strict=True)
    return jmodel, params, tmodel.eval()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(noise=rng.normal(size=(B, T, D)).astype(np.float32),
                step_noise=rng.normal(size=(STEPS, B, T, D)).astype(np.float32),
                text=rng.normal(size=(B, 512)).astype(np.float32),
                image=rng.normal(size=(B, T, D)).astype(np.float32))


def _model_fns(text, cached=0):
    """JAX and port model_fn(x, t) under exact CFG, or (cached > 1) under
    cached CFG with that interval: model_fn(x, t, state) and its first
    state on each side, and the port's count of forwards."""
    jmodel, params, tmodel = _pair()
    jcond = jm.Conditioning(text_embed=jnp.asarray(text))
    tcond = tm.Conditioning(text_embed=torch.from_numpy(text))
    apply = lambda p, x, t, c: jmodel.apply(p, x, t, c)
    forwards = []
    counted = lambda x, t, c: forwards.append(t.shape[0]) or tmodel(x, t, c)
    if cached:
        jfn, jinit = jm.cfg_denoiser_cached(apply, params, GUIDANCE, cached)
        tfn, tstate = tm.cfg_denoiser_cached(counted, GUIDANCE, cached)
        return ((lambda x, t, s: jfn(x, t, jcond, s)), jinit((B, T, D)),
                (lambda x, t, s: tfn(x, t, tcond, s)), tstate, forwards)
    jfn = jm.cfg_denoiser(apply, params, GUIDANCE)
    tfn = tm.cfg_denoiser(counted, GUIDANCE)
    return (lambda x, t: jfn(x, t, jcond)), None, (lambda x, t: tfn(x, t, tcond)), None, forwards


def _scheds():
    return JSchedule.create("cosine", 1000, str(STEPS)), Schedule.create("cosine", 1000, str(STEPS))


def _cond_fn(x, t):
    """A cond_fn gradient that both packages compute alike: the score of
    N(0, 4) in x, scaled by the timestep."""
    scale = (t.float() if torch.is_tensor(t) else t.astype(jnp.float32)) / 1000.0
    return -0.25 * x * scale.reshape((-1, 1, 1))


def test_gaussian_algebra_matches_jax():
    js, ts = _scheds()
    d = _data(1)
    x, x0 = d["noise"], d["image"]
    t = np.array([4, 1], np.int64)
    jx, jx0, jt = jnp.asarray(x), jnp.asarray(x0), jnp.asarray(t.astype(np.int32))
    tx, tx0, tt = torch.from_numpy(x), torch.from_numpy(x0), torch.from_numpy(t)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                                    atol=1e-6)
    for jv, tv in zip(JG.q_mean_variance(js, jx0, jt), G.q_mean_variance(ts, tx0, tt)):
        close(tv, jv)
    close(G.predict_xstart_from_xprev(ts, tx, tt, tx0), JG.predict_xstart_from_xprev(js, jx, jt, jx0))
    close(G.predict_eps_from_xstart(ts, tx, tt, tx0), JG.predict_eps_from_xstart(js, jx, jt, jx0))
    jout = JG.p_mean_variance(js, jx0, jx, jt)
    tout = G.p_mean_variance(ts, tx0, tx, tt)
    grad = 0.1 * x0
    close(G.condition_mean(torch.from_numpy(grad), tout), JG.condition_mean(jnp.asarray(grad), jout))
    for jv, tv in zip(JG.condition_score(js, jnp.asarray(grad), jout, jx, jt),
                      G.condition_score(ts, torch.from_numpy(grad), tout, tx, tt)):
        close(tv, jv)


# name -> (JAX sampler call, port sampler call); each gets (sched, model_fn, data).
SAMPLER_CASES = {
    "ddim": (lambda s, f, d: JS.ddim_sample_loop(f, s, jnp.asarray(d["noise"]),
                                                 jax.random.PRNGKey(1)),
             lambda s, f, d: S.ddim_sample_loop(f, s, torch.from_numpy(d["noise"]))),
    "ddim_cond_fn_skip": (
        lambda s, f, d: JS.ddim_sample_loop(f, s, jnp.asarray(d["noise"]), jax.random.PRNGKey(1),
                                            JS.SamplerConfig(skip_timesteps=2),
                                            init_image=jnp.asarray(d["image"]), cond_fn=_cond_fn),
        lambda s, f, d: S.ddim_sample_loop(f, s, torch.from_numpy(d["noise"]), None,
                                           S.SamplerConfig(skip_timesteps=2),
                                           init_image=torch.from_numpy(d["image"]),
                                           cond_fn=_cond_fn)),
    "ddim_reverse": (lambda s, f, d: JS.ddim_reverse_sample_loop(f, s, jnp.asarray(d["image"])),
                     lambda s, f, d: S.ddim_reverse_sample_loop(f, s, torch.from_numpy(d["image"]))),
    "plms_order1": (
        lambda s, f, d: JS.plms_sample_loop(f, s, jnp.asarray(d["noise"]), jax.random.PRNGKey(1),
                                            JS.SamplerConfig(order=1)),
        lambda s, f, d: S.plms_sample_loop(f, s, torch.from_numpy(d["noise"]), None,
                                           S.SamplerConfig(order=1))),
    "plms_order2": (
        lambda s, f, d: JS.plms_sample_loop(f, s, jnp.asarray(d["noise"]), jax.random.PRNGKey(1)),
        lambda s, f, d: S.plms_sample_loop(f, s, torch.from_numpy(d["noise"]))),
    "dpmpp_2m": (
        lambda s, f, d: JS.dpmpp_2m_sample_loop(f, s, jnp.asarray(d["noise"]),
                                                jax.random.PRNGKey(1)),
        lambda s, f, d: S.dpmpp_2m_sample_loop(f, s, torch.from_numpy(d["noise"]))),
}
# Model evaluations per run at 5 steps: PLMS's first step evaluates twice
# at order 2; DPM-Solver++ evaluates once per step, the last for the clean x0.
EVALS = {"ddim": 5, "ddim_cond_fn_skip": 3, "ddim_reverse": 5, "plms_order1": 5,
         "plms_order2": 6, "dpmpp_2m": 5}


@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(name):
    d = _data()
    jfn, _, tfn, _, forwards = _model_fns(d["text"])
    js, ts = _scheds()
    jrun, trun = SAMPLER_CASES[name]
    ref = np.asarray(jrun(js, jfn, d))
    with torch.no_grad():
        out = trun(ts, tfn, d)
    assert out.shape == (B, T, D)
    tol = TOL
    if name == "ddim_reverse":
        # Its first step divides x - x0_hat by sqrt(1/alpha_bar - 1), about
        # 0.03 at t = 0, so x_T reaches a few hundred with a random model:
        # held to 1e-4 of its largest value.
        tol = dict(TOL, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, **tol)
    assert forwards == [2 * B] * EVALS[name]  # exact CFG: one double-batched forward


def test_samplers_table():
    assert set(S.SAMPLERS) == set(JS.SAMPLERS) == {"ddpm", "ddim", "plms", "dpmpp_2m"}
    with pytest.raises(ValueError, match="order"):
        S.plms_sample_loop(lambda x, t: x, _scheds()[1], torch.zeros(1, 2, 3), None,
                           S.SamplerConfig(order=5))


# name -> (SamplerConfig fields, extra keyword arguments by side).
P_SAMPLE_CASES = {
    "init_image_skip": (dict(skip_timesteps=2), "init_image"),
    "skip_without_image": (dict(skip_timesteps=1), None),
    "cond_fn_mean": (dict(guidance_mode="mean"), "cond_fn"),
    "cond_fn_score": (dict(guidance_mode="score"), "cond_fn"),
    "dump_steps": (dict(), "dump_steps"),
    "clip_denoised": (dict(clip_denoised=True), None),
}


@pytest.mark.parametrize("name", sorted(P_SAMPLE_CASES))
def test_p_sample_loop_options_match_jax(name):
    d = _data(2)
    fields, extra = P_SAMPLE_CASES[name]
    jfn, _, tfn, _, _ = _model_fns(d["text"])
    js, ts = _scheds()
    steps = STEPS - fields.get("skip_timesteps", 0)
    step_noise = d["step_noise"][:steps]
    jkw = dict(step_noise=jnp.asarray(step_noise))
    tkw = dict(step_noise=torch.from_numpy(step_noise))
    if extra == "init_image":
        jkw["init_image"], tkw["init_image"] = jnp.asarray(d["image"]), torch.from_numpy(d["image"])
    elif extra == "cond_fn":
        jkw["cond_fn"] = tkw["cond_fn"] = _cond_fn
    elif extra == "dump_steps":
        jkw["dump_steps"] = tkw["dump_steps"] = (0, 2, 4)
    ref = np.asarray(JS.p_sample_loop(jfn, js, jnp.asarray(d["noise"]), jax.random.PRNGKey(1),
                                      JS.SamplerConfig(**fields), **jkw))
    with torch.no_grad():
        out = S.p_sample_loop(tfn, ts, torch.from_numpy(d["noise"]), None,
                              S.SamplerConfig(**fields), **tkw)
    assert out.shape == ((3, B, T, D) if extra == "dump_steps" else (B, T, D))
    tol = TOL
    if name == "cond_fn_score":
        # The score shift rebuilds x0 as sqrt(1/a) x - sqrt(1/a - 1) eps, at
        # the first step (alpha_bar a = 2.4e-9) a difference of two terms of
        # 2e4 |x|: each package's f32 x0 is off by ~1e-2 from an f64 one
        # (0.0076 JAX, 0.011 the port), and the posterior mean carries a few
        # 1e-4 of it to the output. Held to 5e-4.
        tol = dict(TOL, atol=5e-4)
    np.testing.assert_allclose(out.numpy(), ref, **tol)


def test_const_noise_draws_one_sample_for_the_batch():
    """const_noise: each step draws one [1, T, D] noise from the generator
    and gives it to every sample. JAX fed the same draws as step_noise
    computes the same loop."""
    d = _data(3)
    jfn, _, tfn, _, _ = _model_fns(d["text"])
    js, ts = _scheds()
    config = S.SamplerConfig(const_noise=True)
    with torch.no_grad():
        out = S.p_sample_loop(tfn, ts, torch.from_numpy(d["noise"]),
                              torch.Generator().manual_seed(5), config)
    g = torch.Generator().manual_seed(5)
    draws = torch.stack([torch.randn((1, T, D), generator=g).expand(B, T, D)
                         for _ in range(STEPS)])
    ref = np.asarray(JS.p_sample_loop(jfn, js, jnp.asarray(d["noise"]), jax.random.PRNGKey(1),
                                      JS.SamplerConfig(const_noise=True),
                                      step_noise=jnp.asarray(draws.numpy())))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_cached_cfg_matches_jax(sampler):
    """Interval 2 over 5 steps: 5 conditional forwards and 3 unconditional
    (steps 0, 2, 4), each of the batch alone."""
    d = _data(4)
    jfn, jstate, tfn, tstate, forwards = _model_fns(d["text"], cached=2)
    js, ts = _scheds()
    noise = d["noise"]
    if sampler == "ddpm":
        ref = JS.p_sample_loop(jfn, js, jnp.asarray(noise), jax.random.PRNGKey(1),
                               model_state=jstate, step_noise=jnp.asarray(d["step_noise"]))
        with torch.no_grad():
            out = S.p_sample_loop(tfn, ts, torch.from_numpy(noise), None, model_state=tstate,
                                  step_noise=torch.from_numpy(d["step_noise"]))
    else:
        ref = JS.ddim_sample_loop(jfn, js, jnp.asarray(noise), jax.random.PRNGKey(1),
                                  model_state=jstate)
        with torch.no_grad():
            out = S.ddim_sample_loop(tfn, ts, torch.from_numpy(noise), model_state=tstate)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert forwards == [B] * (STEPS + 3)
