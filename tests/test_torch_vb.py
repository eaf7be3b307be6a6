"""The likelihood terms of mdm_tpu_torch.diffusion and the learned-variance
``vb`` loss, against mdm_tpu's, on the CPU.

Same numpy inputs, drawn from a seed, through both packages: ``normal_kl``,
``discretized_gaussian_log_likelihood`` (both tails and the bins between),
``vb_terms_bpd`` for every mean and variance type with t = 0 rows among the
others, ``prior_bpd``, ``calc_bpd_loop`` with the JAX loop's own noise draws
injected step by step, and ``training_losses`` with a learned variance
(``vb`` with and without ``rescale_vb``, the total loss). f32 on both sides:
1e-5 relative, with an absolute floor of 1e-6 for terms near zero (exp and
log reorder their rounding; the loop's bits sum 10 terms).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.diffusion import gaussian as JG  # noqa: E402
from mdm_tpu.diffusion import losses as JL  # noqa: E402
from mdm_tpu.diffusion.schedule import MeanType as JMean  # noqa: E402
from mdm_tpu.diffusion.schedule import Schedule as JSchedule  # noqa: E402
from mdm_tpu.diffusion.schedule import VarType as JVar  # noqa: E402
from mdm_tpu_torch.diffusion import gaussian as G  # noqa: E402
from mdm_tpu_torch.diffusion import losses as L  # noqa: E402
from mdm_tpu_torch.diffusion.schedule import MeanType, Schedule, VarType  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
B, T, D = 4, 6, 5
STEPS = 10


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _case(seed=0, mean="START_X", learned=False):
    """x0, x_t, a model output, t (t = 0 rows among others). The output's
    mean channels predict x0 to within 0.002, as a trained model's do: the
    decoder NLL at t = 0 (standard deviation ~0.01, bins 2/255 wide) then
    reads the CDFs where they differ by more than their f32 rounding. The
    variance channels lie in [-1, 1]."""
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.normal(size=(B, T, D)) * 0.7, -1.2, 1.2).astype(np.float32)
    x0[0, 0, :2] = (-1.0, 1.0)  # the decoder NLL's two tails
    xt = rng.normal(size=(B, T, D)).astype(np.float32)
    t = np.array([0, 3, STEPS - 1, 0])
    sched = Schedule.create("cosine", STEPS)
    at = lambda table: table.numpy().astype(np.float64)[t][:, None, None]
    x0_hat = x0 + 0.002 * rng.normal(size=x0.shape)
    out = {"START_X": x0_hat,
           "EPSILON": (at(sched.sqrt_recip_alphas_cumprod) * xt - x0_hat)
           / at(sched.sqrt_recipm1_alphas_cumprod),
           "PREVIOUS_X": at(sched.posterior_mean_coef1) * x0_hat
           + at(sched.posterior_mean_coef2) * xt}[mean]
    if learned:
        out = np.concatenate([out, np.tanh(rng.normal(size=out.shape))], axis=-1)
    return x0, xt, out.astype(np.float32), t


def test_normal_kl_and_decoder_likelihood_match_jax():
    rng = np.random.default_rng(1)
    m1, lv1, m2, lv2 = (rng.normal(size=(3, 7)).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(
        _np(G.normal_kl(*map(torch.from_numpy, (m1, lv1, m2, lv2)))),
        _np(JG.normal_kl(*map(jnp.asarray, (m1, lv1, m2, lv2)))), **TOL)
    x = np.concatenate([np.linspace(-1, 1, 41), [-0.9995, 0.9995]]).astype(np.float32)
    # |x - mean| / scale of a few units: away from where both CDFs round to
    # 1 and their difference is all rounding (the bins there clamp to 1e-12)
    means = (x + rng.normal(size=x.shape) * 0.2).astype(np.float32)
    scales = (rng.normal(size=x.shape) * 0.3 - 1.0).astype(np.float32)
    np.testing.assert_allclose(
        _np(G.discretized_gaussian_log_likelihood(torch.from_numpy(x), means=torch.from_numpy(
            means), log_scales=torch.from_numpy(scales))),
        _np(JG.discretized_gaussian_log_likelihood(jnp.asarray(x), means=jnp.asarray(means),
                                                   log_scales=jnp.asarray(scales))), **TOL)


@pytest.mark.parametrize("var", ["FIXED_SMALL", "FIXED_LARGE", "LEARNED", "LEARNED_RANGE"])
@pytest.mark.parametrize("mean", ["START_X", "EPSILON", "PREVIOUS_X"])
def test_vb_terms_bpd_matches_jax(mean, var):
    learned = var.startswith("LEARNED")
    x0, xt, out, t = _case(mean=mean, learned=learned)
    sched, jsched = Schedule.create("cosine", STEPS), JSchedule.create("cosine", STEPS)
    mo, vv = (out[..., :D], out[..., D:]) if learned else (out, None)
    tv = None if vv is None else torch.from_numpy(vv)
    bits, x0_hat = G.vb_terms_bpd(sched, torch.from_numpy(mo), torch.from_numpy(x0),
                                  torch.from_numpy(xt), torch.from_numpy(t), mean_type=MeanType[mean],
                                  var_type=VarType[var], model_var_values=tv)
    jbits, jx0_hat = JG.vb_terms_bpd(jsched, jnp.asarray(mo), jnp.asarray(x0), jnp.asarray(xt),
                                     jnp.asarray(t), mean_type=JMean[mean], var_type=JVar[var],
                                     model_var_values=None if vv is None else jnp.asarray(vv))
    np.testing.assert_allclose(_np(bits), _np(jbits), **TOL)
    np.testing.assert_allclose(_np(x0_hat), _np(jx0_hat), **TOL)
    np.testing.assert_allclose(_np(G.prior_bpd(sched, torch.from_numpy(x0))),
                               _np(JG.prior_bpd(jsched, jnp.asarray(x0))), **TOL)


def _jax_step_noise(key, n, shape):
    """The q_sample noise of each step of mdm_tpu's calc_bpd_loop scan."""
    noise = []
    for _ in range(n):
        key, nk = jax.random.split(key)
        noise.append(np.array(jax.random.normal(nk, shape, jnp.float32)))
    return noise


@pytest.mark.parametrize("mean", ["START_X", "EPSILON"])
def test_calc_bpd_loop_matches_jax_on_its_noise(mean):
    x0, _, _, _ = _case(2, mean)
    sched, jsched = Schedule.create("cosine", STEPS), JSchedule.create("cosine", STEPS)
    key = jax.random.PRNGKey(5)
    noise = _jax_step_noise(key, STEPS, x0.shape)
    kw = dict(mean_type=MeanType[mean], var_type=VarType.FIXED_SMALL)
    got = G.calc_bpd_loop(lambda x, t: 0.8 * x + 1e-3 * t[:, None, None], sched,
                          torch.from_numpy(x0), lambda i: torch.from_numpy(noise[i]), **kw)
    want = JG.calc_bpd_loop(lambda x, t: 0.8 * x + 1e-3 * t[:, None, None], jsched,
                            jnp.asarray(x0), key, mean_type=JMean[mean],
                            var_type=JVar.FIXED_SMALL)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL)


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("var", ["LEARNED", "LEARNED_RANGE"])
def test_learned_variance_loss_matches_jax(var, rescale):
    """The vb term and the total loss; the vb term's gradient reaches only
    the variance channels (the mean is frozen in it)."""
    x0, xt, out, t = _case(3, learned=True)
    noise = np.random.default_rng(4).normal(size=x0.shape).astype(np.float32)
    mask = np.ones((B, T, 1), bool)
    mask[1, 4:] = False
    sched, jsched = Schedule.create("cosine", STEPS), JSchedule.create("cosine", STEPS)
    cfg = L.LossConfig(var_type=VarType[var], rescale_vb=rescale)
    jcfg = JL.LossConfig(var_type=JVar[var], rescale_vb=rescale)
    mo = torch.from_numpy(out).requires_grad_()
    terms = L.training_losses(sched, mo, *map(torch.from_numpy, (x0, xt, t, noise, mask)), cfg)
    jterms = JL.training_losses(jsched, jnp.asarray(out),
                                *map(jnp.asarray, (x0, xt, t, noise, mask)), jcfg)
    assert set(terms) == set(jterms) == {"vb", "rot_mse", "loss"}
    for k in terms:
        np.testing.assert_allclose(_np(terms[k]), _np(jterms[k]), **TOL)
    terms["vb"].sum().backward()
    assert torch.count_nonzero(mo.grad[..., :D]) == 0 and torch.count_nonzero(mo.grad[..., D:]) > 0
    with pytest.raises(ValueError, match="output channels"):
        L.training_losses(sched, torch.from_numpy(out[..., :D]),
                          *map(torch.from_numpy, (x0, xt, t, noise, mask)), cfg)
