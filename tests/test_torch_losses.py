"""mdm_tpu_torch.diffusion.losses and train.resample against mdm_tpu on the CPU.

Same inputs (numpy, seeded) through both; f32 on both sides, so the
tolerance is summation order: 1e-6 relative on per-sample losses.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.diffusion import gaussian as JG  # noqa: E402
from mdm_tpu.diffusion import losses as JL  # noqa: E402
from mdm_tpu.diffusion.schedule import MeanType as JMeanType  # noqa: E402
from mdm_tpu.diffusion.schedule import Schedule as JSchedule  # noqa: E402
from mdm_tpu.train import resample as JR  # noqa: E402
from mdm_tpu_torch.diffusion import gaussian as G  # noqa: E402
from mdm_tpu_torch.diffusion import losses as L  # noqa: E402
from mdm_tpu_torch.diffusion.schedule import MeanType, Schedule  # noqa: E402
from mdm_tpu_torch.train import resample as R  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
B, T, D, J = 3, 10, 12, 4
RNG = np.random.default_rng(0)


def _feats():
    a = RNG.normal(size=(B, T, D)).astype(np.float32)
    b = RNG.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T, 1), bool)
    mask[1, 6:] = False
    mask[2, 3:] = False
    return a, b, mask


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_reductions_and_masked_l2_match_jax():
    a, b, mask = _feats()
    ta, tb, tm = map(torch.from_numpy, (a, b, mask))
    np.testing.assert_allclose(_np(G.mean_flat(ta)), _np(JG.mean_flat(jnp.asarray(a))), **TOL)
    np.testing.assert_allclose(_np(G.sum_flat(ta)), _np(JG.sum_flat(jnp.asarray(a))), rtol=1e-6)
    for kw in ({}, {"entries_norm": False}):
        np.testing.assert_allclose(_np(L.masked_l2(ta, tb, tm, **kw)),
                                   _np(JL.masked_l2(jnp.asarray(a), jnp.asarray(b),
                                                    jnp.asarray(mask), **kw)), **TOL)
    full = np.broadcast_to(mask, a.shape).copy()
    np.testing.assert_allclose(_np(L.masked_l2(ta, tb, torch.from_numpy(full))),
                               _np(JL.masked_l2(jnp.asarray(a), jnp.asarray(b),
                                                jnp.asarray(full))), **TOL)


def test_goal_loss_matches_jax():
    pred = RNG.normal(size=(B, 5, 3)).astype(np.float32) * 3
    ref = RNG.normal(size=(B, 5, 3)).astype(np.float32) * 3
    loc = RNG.random((B, 4, 3)) < 0.6
    heading = np.array([True, False, True])
    got = L.masked_goal_l2(*map(torch.from_numpy, (pred, ref, loc, heading)))
    want = JL.masked_goal_l2(*map(jnp.asarray, (pred, ref, loc, heading)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)


def _get_xyz_pair():
    """A fixed feature -> joints map [B, T, D] -> [B, T, J, 3] for both sides."""
    w = RNG.normal(size=(D, J * 3)).astype(np.float32)
    return (lambda x: (x @ torch.from_numpy(w)).reshape(*x.shape[:2], J, 3),
            lambda x: (x @ jnp.asarray(w)).reshape(*x.shape[:2], J, 3))


@pytest.mark.parametrize("mean_type", ["START_X", "EPSILON"])
def test_training_losses_match_jax(mean_type):
    a, out, mask = _feats()
    noise = RNG.normal(size=(B, T, D)).astype(np.float32)
    t = np.array([0, 5, 9])
    tx, jx = _get_xyz_pair()
    weights = dict(lambda_vel=0.5, lambda_rcxyz=0.3, lambda_vel_rcxyz=0.2, lambda_fc=0.1,
                   fc_joints=(0, 2), fc_threshold=1.5)
    tcfg = L.LossConfig(mean_type=getattr(MeanType, mean_type), **weights)
    jcfg = JL.LossConfig(mean_type=getattr(JMeanType, mean_type), **weights)
    x_t = a * 0.7 + noise * 0.3
    got = L.training_losses(Schedule.create("cosine", 10), torch.from_numpy(out),
                            torch.from_numpy(a), torch.from_numpy(x_t), torch.from_numpy(t),
                            torch.from_numpy(noise), torch.from_numpy(mask), tcfg, get_xyz=tx)
    want = JL.training_losses(JSchedule.create("cosine", 10), jnp.asarray(out), jnp.asarray(a),
                              jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(noise),
                              jnp.asarray(mask), jcfg, get_xyz=jx)
    assert set(got) == set(want) == {"rot_mse", "vel_mse", "rcxyz_mse", "vel_xyz_mse", "fc",
                                     "loss"}
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=2e-6, atol=1e-6, err_msg=k)


def test_uniform_sampler():
    t, w = R.uniform_sample_t(torch.Generator().manual_seed(0), 1000, 50)
    assert t.shape == (1000,) and int(t.min()) >= 0 and int(t.max()) < 50
    assert torch.equal(w, torch.ones(1000))


def test_loss_aware_state_matches_jax():
    """A timestep repeated within a batch lands in order, full rows shift."""
    Tn, H = 6, 3
    jstate = JR.LossAwareState.create(Tn, H)
    tstate = R.LossAwareState.create(Tn, H)
    rng = np.random.default_rng(1)
    for i in range(5):
        t = rng.integers(0, Tn, 8)
        t[:3] = 2  # three in a row for one timestep
        losses = rng.random(8).astype(np.float32) + i
        jstate = JR.loss_aware_update(jstate, jnp.asarray(t), jnp.asarray(losses))
        tstate = R.loss_aware_update(tstate, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(_np(tstate.history), _np(jstate.history))
        np.testing.assert_array_equal(_np(tstate.counts), _np(jstate.counts))
        assert bool(tstate.warmed_up) == bool(jstate.warmed_up)
    np.testing.assert_allclose(_np(R.loss_aware_weights(tstate)),
                               _np(JR.loss_aware_weights(jstate)), rtol=1e-6)
    t, w = R.loss_aware_sample_t(torch.Generator().manual_seed(0), tstate, 4000)
    p = R.loss_aware_weights(tstate) if bool(tstate.warmed_up) else torch.full((Tn,), 1 / Tn)
    np.testing.assert_allclose(_np(w), _np(1.0 / (Tn * p[t])), rtol=1e-6)
    freq = np.bincount(_np(t), minlength=Tn) / 4000
    np.testing.assert_allclose(freq, _np(p), atol=0.03)
