"""mdm_tpu_torch.train against mdm_tpu.train on the CPU.

The JAX step runs ``make_train_step(..., use_shardings=False)`` with the
train-block and encoder-tail kernels (#2-#5) pinned on and run by the
Pallas interpreter at dropout rate 0, as tests/test_shard_map_kernels.py
does; the port's step runs the kernels' plain versions. Both get the same
weights (models/bridge.py) and the same draws (t, noise, condition
dropout), taken from the JAX key by train_step.py:193-203's own calls.

Tolerances, all f32: the loss and metrics agree to summation order (2e-5
relative). The gradients are read back from optax's first moment after
one step (mu = (1 - b1) g exactly up to one rounding) and agree to 2e-5
relative to the largest gradient of their tensor (measured 1.1e-6).

Every update is held, not only the state it leads to. After each step,
AdamW's count and its two moments (exp_avg, exp_avg_sq) match optax's
count, mu and nu, relative to the largest value of their tensor. The
update of each parameter (p_after - p_before) and of its EMA match JAX's,
relative to the tensor's largest update, plus two f32 ulps of its largest
value for the roundings of the update and the subtraction (the EMA of a
LayerNorm weight near 1 moves by 1e-4, some 800 ulps). Both hold to 2e-5
for a step that starts from the same parameters on both sides (measured
1.1e-6 and 7.2e-6). The second of two steps starts from parameters that
differ where the first update was ill-conditioned: there the moments hold
to 1e-4 (measured 2.3e-5) and the updates to 1e-3 (measured 3.8e-4).
Updates are compared at every coordinate whose first moment stood above
100 x 2e-5 of its tensor's largest at every step so far. The others hold
a gradient at rounding level: Adam divides it by its own magnitude, so two
summation orders may move it either way (dbk, a third of in_proj_bias, is
zero in exact arithmetic). At least 80% of the coordinates are compared
(measured 93% after two steps). Weight decay (0.5), the LR anneal (4
steps) and the EMA decay (0.9) are set so that each moves the updates by
far more than the tolerance.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mdm_tpu import ops  # noqa: E402
from mdm_tpu.diffusion import LossConfig as JLossConfig  # noqa: E402
from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.train import state as JS  # noqa: E402
from mdm_tpu.train import train_step as JT  # noqa: E402
from mdm_tpu.train.resample import uniform_sample_t as j_uniform_sample_t  # noqa: E402
from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig, bridge  # noqa: E402
from mdm_tpu_torch.train import (LoopConfig, OptimConfig, TrainLoop,  # noqa: E402
                                 TrainStepConfig, apply_gradients, create_train_state,
                                 make_train_step)
from mdm_tpu_torch.train.platforms import NoPlatform, get_platform  # noqa: E402

SMALL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4, dropout=0.0,
             mask_frames=True)
B, T, NJ = 4, 16, 263
LR = 1e-3
REL = 2e-5
OPTIM = dict(lr=LR, weight_decay=0.5, lr_anneal_steps=4, ema_decay=0.9)
LATER = dict(moment_rel=1e-4, update_rel=1e-3)  # a step after the port's own update
HELD = 100 * REL  # an update is compared where |mu| > HELD x max |mu| of its tensor
ULP = 2.0 ** -23


@pytest.fixture
def jax_kernels():
    ops.enable_pallas_interpret(True)
    ops.enable_pallas_train_block(True)
    ops.enable_pallas_encoder_tail(True)
    yield
    ops.enable_pallas_interpret(False)
    ops.enable_pallas_train_block(None)
    ops.enable_pallas_encoder_tail(None)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, NJ)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 11:] = False
    mask[3, 5:] = False
    text = rng.normal(size=(B, 512)).astype(np.float32)
    jb = {"x": jnp.asarray(x), "mask": jnp.asarray(mask),
          "cond": jm.Conditioning(text_embed=jnp.asarray(text))}
    tb = {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask),
          "cond": Conditioning(text_embed=torch.from_numpy(text))}
    return jb, tb


def _jax_draws(key, x, sched, cond_mask_prob):
    """The draws of JAX train_step.py:193-203, for the port's draws= seam."""
    key_t, key_noise, key_drop, _, _ = jax.random.split(key, 5)
    t, _ = j_uniform_sample_t(key_t, x.shape[0], sched.num_timesteps)
    noise = jax.random.normal(key_noise, x.shape, x.dtype)
    drop = jax.random.bernoulli(key_drop, cond_mask_prob, (x.shape[0],))
    return {"t": torch.from_numpy(np.asarray(t)).long(),
            "noise": torch.from_numpy(np.asarray(noise)),
            "cond_drop": torch.from_numpy(np.asarray(drop))}


def _setup(optim_kw):
    jmodel = jm.MDM(jm.MDMConfig(**SMALL))
    jb, tb = _batch()
    params = jmodel.init(jax.random.PRNGKey(0), jb["x"], jnp.zeros((B,), jnp.int32),
                         jb["cond"])["params"]
    jcfg = JT.TrainStepConfig(loss=JLossConfig(), optim=JS.OptimConfig(**optim_kw))
    tcfg = TrainStepConfig(optim=OptimConfig(**optim_kw))
    jstep = JT.make_train_step(jmodel.apply, JSchedule.create("cosine", 1000), jcfg,
                               use_shardings=False)
    tstep = make_train_step(Schedule.create("cosine", 1000), tcfg)
    return jmodel, params, jb, tb, jcfg, tcfg, jstep, tstep


def _port_state(params_np, optim):
    model = MDM(MDMConfig(**SMALL))
    model.load_state_dict(bridge.state_dict_from_flax(params_np, model.config), strict=True)
    return create_train_state(model, optim)


def _close(got: torch.Tensor, want: np.ndarray, rel: float, name: str, atol: float = 0.0):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * scale + atol, err_msg=name)


def _check_metrics(tm, jmet):
    assert set(tm) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tm[k].item(), float(jmet[k]), rtol=REL, atol=1e-7,
                                   err_msg=k)


def _port_sd(tree, config):
    return bridge.state_dict_from_flax(_np_tree(tree), config)


def _snapshot(tstate, jstate):
    """Parameters and EMA of both sides before a step, as port state_dicts."""
    config = tstate.model.config
    return ({n: p.detach().clone() for n, p in tstate.params().items()},
            {n: t.clone() for n, t in tstate.ema_params.items()},
            _port_sd(jstate.params, config), _port_sd(jstate.ema_params, config))


def _check_update(tstate, jstate, before, held, moment_rel=REL, update_rel=REL):
    """The step just taken on both sides: AdamW's count and moments against
    optax's, then each parameter's and EMA's update against JAX's at the
    coordinates still ``held`` (updated in place: see the module doc)."""
    config = tstate.model.config
    adam = JS_adam(jstate.opt_state)
    mu, nu = _port_sd(adam.mu, config), _port_sd(adam.nu, config)
    jp, je = _port_sd(jstate.params, config), _port_sd(jstate.ema_params, config)
    p0, e0, jp0, je0 = before
    n_held = n_all = 0
    for name, p in tstate.params().items():
        st = tstate.optimizer.state[p]
        assert int(st["step"]) == int(adam.count), name
        _close(st["exp_avg"], mu[name].numpy(), moment_rel, f"exp_avg {name}")
        _close(st["exp_avg_sq"], nu[name].numpy(), moment_rel, f"exp_avg_sq {name}")
        keep = held.setdefault(name, torch.ones(p.shape, dtype=torch.bool))
        keep &= mu[name].abs() > HELD * mu[name].abs().max()
        n_held, n_all = n_held + int(keep.sum()), n_all + keep.numel()
        for what, got, want in (
                ("update", p.detach() - p0[name], jp[name] - jp0[name]),
                ("EMA update", tstate.ema_params[name] - e0[name], je[name] - je0[name])):
            err = ((got - want).abs() * keep).max().item()
            bound = (update_rel * want.abs().max().item()
                     + 2 * ULP * max(p.detach().abs().max().item(), jp[name].abs().max().item()))
            assert err <= bound, f"{what} {name}: max abs err {err} > {bound}"
    assert n_held >= 0.8 * n_all, f"only {n_held} of {n_all} coordinates held"


def test_apply_gradients_matches_optax_adamw_with_anneal_clip_and_decay():
    cfg = dict(lr=1e-2, weight_decay=0.1, lr_anneal_steps=6, grad_clip=0.5, ema_decay=0.9)
    rng = np.random.default_rng(4)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    b0 = rng.normal(size=(4,)).astype(np.float32)
    jconf = JS.OptimConfig(**cfg)
    tx = JS.make_optimizer(jconf)
    jstate = JS.create_train_state({"w": jnp.asarray(w0), "b": jnp.asarray(b0)}, jconf)
    lin = torch.nn.Linear(3, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0))
        lin.bias.copy_(torch.from_numpy(b0))
    tconf = OptimConfig(**cfg)
    tstate = create_train_state(lin, tconf)
    for i in range(5):
        scale = (0.05, 3.0)[i % 2]  # below and above the clip norm
        gw = (rng.normal(size=(4, 3)) * scale).astype(np.float32)
        gb = (rng.normal(size=(4,)) * scale).astype(np.float32)
        jstate = JS.apply_gradients(jstate, {"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                    jconf, tx)
        lin.weight.grad, lin.bias.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        apply_gradients(tstate, tconf)
        for name, jn in (("weight", "w"), ("bias", "b")):
            np.testing.assert_allclose(tstate.params()[name].detach().numpy(),
                                       np.asarray(jstate.params[jn]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tstate.ema_params[name].numpy(),
                                       np.asarray(jstate.ema_params[jn]), rtol=1e-5, atol=1e-6)
    assert tstate.step == int(jstate.step) == 5


def test_one_and_two_steps_match_jax(jax_kernels):
    jmodel, params, jb, tb, jcfg, tcfg, jstep, tstep = _setup(OPTIM)
    params_np = _np_tree(params)
    tstate = _port_state(params_np, tcfg.optim)
    jstate = JS.create_train_state(params, jcfg.optim)
    sched = JSchedule.create("cosine", 1000)
    held = {}
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(7), 2)):
        draws = _jax_draws(key, jb["x"], sched, jcfg.cond_mask_prob)
        before = _snapshot(tstate, jstate)
        jstate, jmet = jstep(jstate, jb, key)
        tstate, tmet = tstep(tstate, tb, i, draws=draws)
        _check_metrics(tmet, jmet)
        if i == 0:  # optax's first moment is (1 - b1) g: the JAX gradients
            mu = JS_adam(jstate.opt_state).mu
            grads = bridge.state_dict_from_flax(_np_tree(mu), tstate.model.config)
            b1 = np.float32(1 - 0.9)
            for name, p in tstate.params().items():
                _close(p.grad, grads[name].numpy() / b1, REL, f"grad {name}")
        _check_update(tstate, jstate, before, held, **({} if i == 0 else LATER))


def JS_adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def test_train_state_from_flax_then_one_port_step_is_jax_step_two(jax_kernels):
    jmodel, params, jb, tb, jcfg, tcfg, jstep, tstep = _setup(OPTIM)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11), 2)
    jstate, _ = jstep(JS.create_train_state(params, jcfg.optim), jb, k1)
    after_one = _np_tree(jstate)
    tstate = bridge.train_state_from_flax(after_one, _port_state(_np_tree(params), tcfg.optim))
    assert tstate.step == 1
    draws = _jax_draws(k2, jb["x"], JSchedule.create("cosine", 1000), jcfg.cond_mask_prob)
    before = _snapshot(tstate, jstate)
    jstate, jmet = jstep(jstate, jb, k2)
    tstate, tmet = tstep(tstate, tb, 0, draws=draws)
    _check_metrics(tmet, jmet)
    _check_update(tstate, jstate, before, {})
    assert tstate.step == int(jstate.step) == 2


class _StepData:
    """Batches as a pure function of the step, with the iter_from contract."""

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start):
        i = start
        while True:
            yield _batch(100 + i)[1]
            i += 1


def test_train_loop_resume_is_bit_exact(tmp_path):
    """6 steps == 3 steps + checkpoint + resume + 3 steps, bit for bit, with
    dropout on (tests/test_training.py::TestBitExactResume on the port)."""
    cfg = MDMConfig(**{**SMALL, "latent_dim": 64, "ff_size": 128, "dropout": 0.1})
    optim = OptimConfig(lr=1e-3)
    step = make_train_step(Schedule.create("cosine", 10), TrainStepConfig(optim=optim))

    def run(save_dir, n):
        model = MDM(cfg).init_weights(torch.Generator().manual_seed(0))
        loop = TrainLoop(step, create_train_state(model, optim), _StepData(),
                         LoopConfig(save_dir=str(save_dir), num_steps=n, log_interval=100,
                                    save_interval=3), args={"dataset": "synthetic"},
                         rng_seed=11)
        loop.run()
        return loop

    straight = run(tmp_path / "a", 6)
    interrupted = run(tmp_path / "b", 3)
    assert interrupted.step == 3 and os.path.exists(tmp_path / "b" / "ckpt_000000003")
    resumed = run(tmp_path / "b", 6)
    assert straight.step == resumed.step == 6
    a, b = straight.state, resumed.state
    for name, p in a.params().items():
        assert torch.equal(p, b.params()[name]), name
        assert torch.equal(a.ema_params[name], b.ema_params[name]), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_unported_options_raise():
    """``remat``, which this test once found refused, now trains: one step
    at rate 0.1 gives finite metrics (tests/test_torch_decoder_train.py
    holds it bitwise against the step without remat). The platforms and
    the schedule sampler refuse what they refused."""
    cfg = MDMConfig(**{**SMALL, "dropout": 0.1, "remat": True})
    state = create_train_state(MDM(cfg).init_weights(torch.Generator().manual_seed(0)),
                               OptimConfig(lr=1e-3))
    _, metrics = make_train_step(Schedule.create("cosine", 10), TrainStepConfig())(
        state, _batch()[1], 0)
    assert state.step == 1 and all(torch.isfinite(v) for v in metrics.values())
    assert isinstance(get_platform("NoPlatform", "unused"), NoPlatform)
    with pytest.raises((ImportError, NotImplementedError)):
        get_platform("WandB", "unused")
    with pytest.raises(ValueError):
        make_train_step(Schedule.create("cosine", 10), TrainStepConfig(schedule_sampler="x"))
