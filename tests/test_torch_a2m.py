"""The action-to-motion family of mdm_tpu_torch against mdm_tpu, on the CPU.

``cond_mode='action'`` (EmbedAction), ``arch='gru'`` (the batch-axis
recurrence of the reference, fed ``[x, the conditioning token]``) and
``data_rep='rot_vel'`` (velEmbedding/velFinal beside the pose ones), at
HumanAct12's feature layout (25 joints x 6, 12 actions) and the test
width: the eval forward to 1e-4 (tests/test_torch_models.py's bar for the
denoiser), one train step (tests/test_torch_decoder_train.py's
``step_matches_jax``: loss and gradients to 2e-5 relative, the AdamW
moments and updates by ``_check_update``) and a 4-step DDPM
``p_sample_loop`` through ``cfg_denoiser`` with the same initial and per-
step noise, to 1e-4 (tests/test_torch_samplers.py's bar). Weights come
from mdm_tpu's init through models/bridge.py. The step holds ``vel_mse``,
which needs no decoder; the geometric losses through SMPL are
tests/test_torch_eval_a2m.py's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.diffusion import samplers as JSa  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.train import state as JS  # noqa: E402
from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.diffusion import samplers as Sa  # noqa: E402
from mdm_tpu_torch.models import bridge  # noqa: E402
from mdm_tpu_torch.models import mdm as tm  # noqa: E402
from mdm_tpu_torch.train import OptimConfig, create_train_state  # noqa: E402
from test_torch_decoder_train import B, T, dip_fields, step_matches_jax  # noqa: E402
from test_torch_train import JS_adam, _np_tree, jax_kernels  # noqa: E402, F401

SMALL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
A2M = dict(njoints=25, nfeats=6, data_rep="rot6d", cond_mode="action", num_actions=12)
CONFIGS = {
    "action": A2M,
    "gru": dict(A2M, arch="gru"),
    "rot_vel": dict(A2M, data_rep="rot_vel"),
    "gru_text": dict(arch="gru", mask_frames=True),  # the GRU on a pooled text, hml_vec
}
FEATS = {name: (263 if "cond_mode" not in cfg else 150) for name, cfg in CONFIGS.items()}
ACTIONS = np.array([0, 11, 5, 5])
TOL = dict(atol=1e-4, rtol=1e-4)


def _fields(name, seed=0):
    """(x, mask, conditioning fields) for a config: its actions, or a text."""
    x, mask, dip = dip_fields(seed, FEATS[name])
    if "cond_mode" in CONFIGS[name]:
        return x, mask, dict(action=ACTIONS, cond_drop=np.array([False, True, False, False]))
    return x, mask, dict(text_embed=dip["text_embed"][:, 0, :512])


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX MDM, params, the port's MDM) with the same weights."""
    kw = {**SMALL, **CONFIGS[name]}
    jmodel = jm.MDM(jm.MDMConfig(**kw))
    x, mask, fields = _fields(name)
    jcond = jm.Conditioning(frames_mask=jnp.asarray(mask),
                            **{k: jnp.asarray(v) for k, v in fields.items()})
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((B,), jnp.int32), jcond)
    tmodel = tm.MDM(tm.MDMConfig(**kw))
    tmodel.load_state_dict(bridge.state_dict_from_flax(_np_tree(params), tmodel.config),
                           strict=True)
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jmodel, params, tmodel = _pair(name)
    x, mask, fields = _fields(name, seed=1)
    t = np.array([0, 421, 999, 17], np.int32)
    fields["frames_mask"] = mask
    jcond = jm.Conditioning(**{k: jnp.asarray(v) for k, v in fields.items()})
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jcond))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(t).long(),
                     tm.Conditioning(**{k: torch.from_numpy(v) for k, v in fields.items()}))
    assert out.shape == (B, T, FEATS[name])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_bridge_carries_the_a2m_layout():
    """The reference torch names: ``embed_action.action_embedding``,
    nn.GRU's ``gru.weight_ih_l{k}`` [3D, in] (JAX's [in, 3D] transposed),
    ``input_process.velEmbedding`` and ``output_process.velFinal``."""
    for name, extra in (("gru", "gru.weight_ih_l1"), ("rot_vel", "output_process.velFinal.weight")):
        _, params, tmodel = _pair(name)
        sd = bridge.state_dict_from_flax(_np_tree(params), tmodel.config)
        assert set(sd) == set(tmodel.state_dict()) and extra in sd
        assert tuple(sd["embed_action.action_embedding"].shape) == (12, 128)
    _, params, tmodel = _pair("gru")
    p = _np_tree(params)["params"]
    w_ih = bridge.state_dict_from_flax(p, tmodel.config)["gru.weight_ih_l0"].numpy()
    np.testing.assert_array_equal(w_ih, p["gru"]["w_ih_l0"].T)
    assert w_ih.shape == (3 * 128, 128)
    # the GRU's input process reads [x, the conditioning token]: 150 + 128 columns
    assert tuple(tmodel.input_process.poseEmbedding.weight.shape) == (128, 150 + 128)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_jax(name, jax_kernels):
    x, mask, fields = _fields(name, seed=2)
    fields.pop("cond_drop", None)  # the step draws it
    loss = dict(lambda_vel=1.0, vel_drop_last_feats=6) if "cond_mode" in CONFIGS[name] else None
    step_matches_jax({**SMALL, **CONFIGS[name], "dropout": 0.0}, x, mask, fields, loss=loss)


@pytest.mark.parametrize("name", ["action", "gru"])
def test_cfg_ddpm_sampling_matches_jax(name):
    """Four respaced DDPM steps at CFG 2.5 from the same noise: the GRU's
    double batch keeps JAX's order (the conditioned half first), which its
    batch-axis recurrence makes visible."""
    jmodel, params, tmodel = _pair(name)
    rng = np.random.default_rng(3)
    steps, feats = 4, FEATS[name]
    noise = rng.normal(size=(B, T, feats)).astype(np.float32)
    step_noise = rng.normal(size=(steps, B, T, feats)).astype(np.float32)
    jcond = jm.Conditioning(action=jnp.asarray(ACTIONS))
    jfn = jm.cfg_denoiser(lambda p, x, t, c: jmodel.apply(p, x, t, c), params, 2.5)
    ref = np.asarray(JSa.p_sample_loop(
        lambda x, t: jfn(x, t, jcond), JSchedule.create("cosine", 1000, str(steps)),
        jnp.asarray(noise), jax.random.PRNGKey(1), JSa.SamplerConfig(),
        step_noise=jnp.asarray(step_noise)))
    tfn = tm.cfg_denoiser(tmodel, 2.5)
    tcond = tm.Conditioning(action=torch.from_numpy(ACTIONS))
    with torch.no_grad():
        out = Sa.p_sample_loop(lambda x, t: tfn(x, t, tcond),
                               Schedule.create("cosine", 1000, str(steps)), torch.from_numpy(noise),
                               None, Sa.SamplerConfig(), step_noise=torch.from_numpy(step_noise))
    assert out.shape == (B, T, feats) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_train_state_from_flax_carries_the_gru_and_action_moments():
    """A JAX TrainState with nonzero AdamW moments and a moved EMA loads
    into the port's: nn.GRU's kernels get JAX's transposed moments, the
    action table its own, and the EMA follows the same map."""
    _, params, tmodel = _pair("gru")
    jcfg = JS.OptimConfig(lr=1e-3, ema_decay=0.9)
    jstate = JS.create_train_state(params["params"], jcfg)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params["params"])
    jstate = _np_tree(JS.apply_gradients(jstate, grads, jcfg, JS.make_optimizer(jcfg)))
    state = bridge.train_state_from_flax(jstate, create_train_state(
        tm.MDM(tmodel.config), OptimConfig(lr=1e-3, ema_decay=0.9)))
    adam = JS_adam(jstate.opt_state)
    params = state.params()
    for name, jmu, jema in (("gru.weight_hh_l1", adam.mu["gru"]["w_hh_l1"].T,
                             jstate.ema_params["gru"]["w_hh_l1"].T),
                            ("embed_action.action_embedding",
                             adam.mu["embed_action"]["action_embedding"],
                             jstate.ema_params["embed_action"]["action_embedding"])):
        np.testing.assert_array_equal(state.optimizer.state[params[name]]["exp_avg"].numpy(), jmu)
        np.testing.assert_array_equal(state.ema_params[name].numpy(), jema)
        assert np.abs(jmu).max() > 0
    assert state.step == 1
