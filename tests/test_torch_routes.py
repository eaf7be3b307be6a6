"""The kernel routes of mdm_tpu_torch's layers against mdm_tpu's, on the CPU.

Each variant of the two kernel shootouts pins the same flags on both
sides: the JAX pins are written out here from scripts/bench_sample_kernels.py
and scripts/bench_train_kernels.py, the port's come from its own scripts'
``VARIANTS``. The JAX side runs its kernels through the Pallas interpreter
with the single-device AUTO signals on, as ``MotionGenerator`` and
``make_train_step`` set them; the port runs its kernels' plain versions.
A spy on each kernel wrapper the layers call shows which route was taken
(the widths are multiples of 128, which the kernels' ``D % 128`` gates
need; ``-k head_dim`` runs the layer and tail routes at head dims 96, 4
and 512).

Tolerances, all f32: an MDM forward to 1e-4 (tests/test_torch_models.py's
bar for the denoiser); a rate-0 train step's loss and metrics to 2e-5
relative and its gradients to 2e-5 of their tensor's largest
(tests/test_torch_train.py's). The ``drop`` route has no JAX oracle at
rate > 0 (the TPU PRNG has no interpret lowering): it is held against the
port's einsum route under the same seed, which draws the same Philox
masks, to 2e-5 relative (the same products in another order).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import ops as jops  # noqa: E402
from mdm_tpu.diffusion import LossConfig as JLossConfig  # noqa: E402
from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.train import state as JS  # noqa: E402
from mdm_tpu.train import train_step as JT  # noqa: E402
from mdm_tpu.train.resample import uniform_sample_t as j_uniform_sample_t  # noqa: E402
from mdm_tpu_torch import ops  # noqa: E402
from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig, bridge  # noqa: E402
from mdm_tpu_torch.models import layers as tl  # noqa: E402
from mdm_tpu_torch.scripts import bench_sample_kernels as BS  # noqa: E402
from mdm_tpu_torch.scripts import bench_train_kernels as BT  # noqa: E402
from mdm_tpu_torch.train import OptimConfig, TrainStepConfig, create_train_state  # noqa: E402
from mdm_tpu_torch.train import make_train_step  # noqa: E402

SMALL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4, mask_frames=True)
# 4 heads of 96: the card runs them in a padded instance of its attention core.
WIDE = dict(latent_dim=384, ff_size=512, num_layers=1)
# Head dims past the tile kernels' multiples of 8 up to 256, as the
# parser's --latent_dim/--num_heads give them: 32 heads of 4 (2-byte row
# copies on the card) and 2 heads of 512 (its wide kernels).
HEAD_DIMS = {"32 heads of 4": dict(latent_dim=128, num_heads=32, ff_size=256, num_layers=1),
             "2 heads of 512": dict(latent_dim=1024, num_heads=2, ff_size=256, num_layers=1)}
B, T = 3, 16
REL = 2e-5

# The JAX scripts' pins (bench_sample_kernels.py:55-79, bench_train_kernels.py:63-75).
JAX_SAMPLE_PINS = {
    "xla": dict(sample_block=False, encoder_tail=False),
    "pallas": dict(sample_block=False, attention=True),
    "block": dict(sample_block=True, encoder_tail=False),
    "tail": dict(sample_block=True, encoder_tail=True, layer_inference=False),
    "layer": dict(sample_block=True, encoder_tail=True, layer_inference=True),
}
JAX_TRAIN_PINS = {
    "xla": dict(train_block=False, encoder_tail=False),
    "drop": dict(train_block=False, train_attention=True, encoder_tail=False),
    "block": dict(train_block=True, encoder_tail=False),
    "tail": dict(train_block=True, encoder_tail=True),
}
# The kernel wrappers each variant's layers call, per layer and forward.
SAMPLE_ROUTES = {
    "xla": set(),
    "pallas": {"fused_attention_v2", "fused_encoder_tail_inference"},
    "block": {"fused_block_attention_inference"},
    "tail": {"fused_block_attention_inference", "fused_encoder_tail_inference"},
    "layer": {"fused_layer_inference"},
}
TRAIN_ROUTES_RATE0 = {  # the dropout kernel's gate needs rate > 0 on both sides
    "xla": set(),
    "drop": set(),
    "block": {"fused_train_attention_block"},
    "tail": {"fused_train_attention_block", "fused_encoder_tail"},
}
WRAPPERS = sorted(set().union(*SAMPLE_ROUTES.values(), *TRAIN_ROUTES_RATE0.values(),
                              {"fused_dropout_attention"}))


@pytest.fixture
def jax_pins():
    """Pins JAX flags for a test and restores them all, AUTO signals too."""
    def pin(**flags):
        jops.enable_pallas_interpret(True)
        jops._set_auto_sample_block(True)
        jops._set_auto_train_block(True)
        for name, value in flags.items():
            getattr(jops, f"enable_pallas_{name}")(value)

    yield pin
    jops.enable_pallas_interpret(False)
    jops._set_auto_sample_block(False)
    jops._set_auto_train_block(False)
    jops.enable_pallas_attention(False)
    jops.enable_pallas_train_attention(False)
    for name in ("train_block", "sample_block", "encoder_tail", "layer_inference"):
        getattr(jops, f"enable_pallas_{name}")(None)


@pytest.fixture
def calls(monkeypatch):
    """Counts the layers' calls of each kernel wrapper."""
    counts = dict.fromkeys(WRAPPERS, 0)

    def spy(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in WRAPPERS:
        monkeypatch.setattr(tl, name, spy(name, getattr(tl, name)))
    return counts


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(**cfg):
    """(JAX MDM, its params, a port MDMConfig) with the same weights."""
    kw = {**SMALL, **cfg}
    jmodel = jm.MDM(jm.MDMConfig(**kw))
    x = jnp.zeros((B, T, 263), jnp.float32)
    cond = jm.Conditioning(frames_mask=jnp.ones((B, T), bool),
                           text_embed=jnp.zeros((B, 512), jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((B,), jnp.int32), cond)
    return jmodel, params, MDMConfig(**kw)


def _port_model(params, config):
    model = MDM(config)
    model.load_state_dict(bridge.state_dict_from_flax(_np_tree(params), config), strict=True)
    return model


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, 263)).astype(np.float32)
    t = np.array([0, 421, 999], np.int32)
    text = rng.normal(size=(B, 512)).astype(np.float32)
    frames = np.ones((B, T), bool)
    frames[1, 11:] = False
    frames[2, 5:] = False
    return x, t, text, frames


def test_pinned_sets_and_restores_every_flag():
    assert ops.pallas_layer_inference_enabled() and ops.pallas_train_block_enabled()
    assert not ops.pallas_attention_enabled() and not ops.pallas_train_attention_enabled()
    with ops.pinned(sample_block=False, attention=True):
        assert ops.pallas_attention_enabled() and not ops.pallas_sample_block_enabled()
        assert not ops.pallas_layer_inference_enabled()  # AUTO follows the sample block
        assert ops.pallas_encoder_tail_enabled(True) and ops.pallas_encoder_tail_enabled(False)
    with pytest.raises(RuntimeError):
        with ops.pinned(train_block=False, encoder_tail=False):
            assert not ops.pallas_train_block_enabled()
            raise RuntimeError("the body failed")
    assert ops.pallas_train_block_enabled() and ops.pallas_encoder_tail_enabled(False)
    assert not ops.pallas_attention_enabled() and ops.pallas_layer_inference_enabled()
    with pytest.raises(ValueError, match="unknown"):
        with ops.pinned(tail=True):
            pass
    ops.enable_pallas_layer_inference(False)  # the enable_* setters pin too
    try:
        assert not ops.pallas_layer_inference_enabled()
    finally:
        ops.enable_pallas_layer_inference(None)


def _check_sampling_variant(variant, jax_pins, calls, **cfg):
    jmodel, params, config = _pair(**cfg)
    x, t, text, frames = _inputs()
    jax_pins(**JAX_SAMPLE_PINS[variant])
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jm.Conditioning(
        frames_mask=jnp.asarray(frames), text_embed=jnp.asarray(text))))
    model = _port_model(params, config).eval()
    with ops.pinned(**BS.VARIANTS[variant]), torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(), Conditioning(
            frames_mask=torch.from_numpy(frames), text_embed=torch.from_numpy(text)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    assert {n for n, c in calls.items() if c} == SAMPLE_ROUTES[variant]
    assert all(c == config.num_layers for c in calls.values() if c)


@pytest.mark.parametrize("variant", sorted(JAX_SAMPLE_PINS))
def test_mdm_forward_matches_jax_per_sampling_variant(variant, jax_pins, calls):
    _check_sampling_variant(variant, jax_pins, calls)


def test_mdm_forward_matches_jax_at_head_dim_96(jax_pins, calls):
    """The layer route (the AUTO sampling route) at 4 heads of 96."""
    _check_sampling_variant("layer", jax_pins, calls, **WIDE)


@pytest.mark.parametrize("heads", sorted(HEAD_DIMS))
def test_mdm_forward_matches_jax_at_head_dims_past_the_tiles(heads, jax_pins, calls):
    """The layer route at head dims 4 and 512."""
    _check_sampling_variant("layer", jax_pins, calls, **HEAD_DIMS[heads])


def _jax_draws(key, x, sched, cond_mask_prob):
    """The draws of JAX train_step.py:193-203, for the port's draws= seam."""
    key_t, key_noise, key_drop, _, _ = jax.random.split(key, 5)
    t, _ = j_uniform_sample_t(key_t, x.shape[0], sched.num_timesteps)
    noise = jax.random.normal(key_noise, x.shape, x.dtype)
    drop = jax.random.bernoulli(key_drop, cond_mask_prob, (x.shape[0],))
    return {"t": torch.from_numpy(np.array(t)).long(), "noise": torch.from_numpy(np.array(noise)),
            "cond_drop": torch.from_numpy(np.array(drop))}


def _adam_mu(opt_state):
    import optax

    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)).mu


def _check_train_variant(variant, jax_pins, calls, **cfg):
    jmodel, params, config = _pair(dropout=0.0, **cfg)
    x, _, text, frames = _inputs(2)
    optim = dict(lr=1e-3)
    jcfg = JT.TrainStepConfig(loss=JLossConfig(), optim=JS.OptimConfig(**optim))
    jstep = JT.make_train_step(jmodel.apply, JSchedule.create("cosine", 1000), jcfg,
                               use_shardings=False)
    key = jax.random.PRNGKey(5)
    draws = _jax_draws(key, jnp.asarray(x), JSchedule.create("cosine", 1000),
                       jcfg.cond_mask_prob)
    jax_pins(**JAX_TRAIN_PINS[variant])
    jstate, jmet = jstep(JS.create_train_state(params["params"], jcfg.optim),
                         {"x": jnp.asarray(x), "mask": jnp.asarray(frames),
                          "cond": jm.Conditioning(text_embed=jnp.asarray(text))}, key)
    state = create_train_state(_port_model(params, config), OptimConfig(**optim))
    step = make_train_step(Schedule.create("cosine", 1000), TrainStepConfig(optim=OptimConfig(
        **optim)))
    with ops.pinned(**BT.VARIANTS[variant]):
        state, met = step(state, {"x": torch.from_numpy(x), "mask": torch.from_numpy(frames),
                                  "cond": Conditioning(text_embed=torch.from_numpy(text))},
                          0, draws=draws)
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=REL, atol=1e-7, err_msg=k)
    mu = bridge.state_dict_from_flax(_np_tree(_adam_mu(jstate.opt_state)), config)
    for name, p in state.params().items():  # optax's first moment is (1 - b1) g
        want = mu[name].numpy() / np.float32(0.1)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=REL * float(np.abs(want).max()), err_msg=name)
    assert {n for n, c in calls.items() if c} == TRAIN_ROUTES_RATE0[variant]


@pytest.mark.parametrize("variant", sorted(JAX_TRAIN_PINS))
def test_rate0_train_step_matches_jax_per_train_variant(variant, jax_pins, calls):
    _check_train_variant(variant, jax_pins, calls)


def test_rate0_train_step_matches_jax_at_head_dim_96(jax_pins, calls):
    """The tail route (the AUTO training route: train block and tail
    kernels) at 4 heads of 96."""
    _check_train_variant("tail", jax_pins, calls, **WIDE)


@pytest.mark.parametrize("heads", sorted(HEAD_DIMS))
def test_rate0_train_step_matches_jax_at_head_dims_past_the_tiles(heads, jax_pins, calls):
    """The tail route at head dims 4 and 512."""
    _check_train_variant("tail", jax_pins, calls, **HEAD_DIMS[heads])


def _training_forward(model, variant, seed):
    """Output and parameter gradients of one training forward and backward."""
    x, t, text, frames = _inputs(3)
    model.zero_grad()
    with ops.pinned(**BT.VARIANTS[variant]):
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    Conditioning(frames_mask=torch.from_numpy(frames),
                                 text_embed=torch.from_numpy(text)),
                    deterministic=False, rng=torch.Generator().manual_seed(seed))
    out.backward(torch.from_numpy(np.random.default_rng(4).normal(size=out.shape)
                                  .astype(np.float32)))
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_drop_route_is_the_einsum_route_under_the_same_seed(calls):
    """At rate 0.25 the dropout kernel (#7/#8) and the einsum route with
    probability dropout draw the same Philox masks from the same seeds."""
    model = MDM(MDMConfig(**{**SMALL, "dropout": 0.25})).init_weights(
        torch.Generator().manual_seed(2))
    out, grads = _training_forward(model, "drop", seed=9)
    assert calls["fused_dropout_attention"] == SMALL["num_layers"]
    ref, ref_grads = _training_forward(model, "xla", seed=9)
    assert calls["fused_dropout_attention"] == SMALL["num_layers"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=REL * ref.abs().max().item())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), rtol=0,
                                   atol=REL * ref_grads[name].abs().max().item(), err_msg=name)
    other, _ = _training_forward(model, "drop", seed=10)
    assert not torch.allclose(other, out, atol=1e-3)  # the seed moves the masks
