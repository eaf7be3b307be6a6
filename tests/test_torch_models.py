"""mdm_tpu_torch.models against mdm_tpu.models on the CPU.

The JAX side runs its AUTO sampling path, the Pallas whole-layer kernel,
in interpret mode; its parameters reach the port through
models/bridge.py::state_dict_from_flax. Both sides compute in f32 unless a
test says otherwise, so they agree to summation order: 2e-5 for one layer
(test_layer_inference.py's bar) and 1e-4 for the whole 2-layer denoiser,
whose input/output projections and timestep MLP add their own reordered
sums. The bf16 denoiser rounds at the same points on both sides, but a
value near a bf16 rounding boundary may round either way, so it is held to
3e-2 absolute on outputs of size ~1.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import ops  # noqa: E402
from mdm_tpu.models import layers as jl  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu_torch.models import bridge  # noqa: E402
from mdm_tpu_torch.models import layers as tl  # noqa: E402
from mdm_tpu_torch.models import mdm as tm  # noqa: E402

SMALL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
B, T = 3, 32


@pytest.fixture(autouse=True)
def _kernel_flags():
    ops.enable_pallas_interpret(True)
    ops.enable_pallas_layer_inference(True)
    yield
    ops.enable_pallas_interpret(False)
    ops.enable_pallas_layer_inference(None)
    ops.enable_pallas_sample_block(None)
    ops.enable_pallas_encoder_tail(None)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def build_pair(seed=0, **cfg):
    """(JAX MDM, its params, the port's MDM carrying the same weights)."""
    kw = {**SMALL, **cfg}
    jmodel = jm.MDM(jm.MDMConfig(**kw))
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(B, T, 263)).astype(np.float32))
    cond = jm.Conditioning(frames_mask=jnp.ones((B, T), bool),
                           text_embed=jnp.zeros((B, 512), jnp.float32))
    ops.enable_pallas_layer_inference(False)  # same tree either way; init is faster
    params = jmodel.init(jax.random.PRNGKey(seed), x, jnp.zeros((B,), jnp.int32), cond)
    ops.enable_pallas_layer_inference(True)
    tmodel = tm.MDM(tm.MDMConfig(**kw))
    tmodel.load_state_dict(bridge.state_dict_from_flax(_tree(params), tmodel.config), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, 263)).astype(np.float32)
    t = np.array([0, 421, 999], np.int32)
    text = rng.normal(size=(B, 512)).astype(np.float32)
    frames = np.ones((B, T), bool)
    frames[1, 20:] = False
    frames[2, 5:] = False
    drop = np.array([False, True, False])
    return x, t, text, frames, drop


def test_gelu_sinusoid_and_padding_bias_match():
    v = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(tl.gelu_exact(torch.from_numpy(v)).numpy(),
                               np.asarray(jl.gelu_exact(jnp.asarray(v))), atol=1e-6)
    np.testing.assert_array_equal(tl.sinusoidal_table(50, 16), jl.sinusoidal_table(50, 16))
    pad = np.array([[False, True, True], [False, False, True]])
    np.testing.assert_array_equal(tl.key_padding_bias(torch.from_numpy(pad)).numpy(),
                                  np.asarray(jl.key_padding_bias(jnp.asarray(pad))))
    assert tl.key_padding_bias(None) is None


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_layer_module_matches_jax(masked):
    D, Hh, Ff, S = 128, 4, 256, T + 1  # the denoiser's layer shape: 1 token + T frames
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[0, 25:] = True
    pad[2, 10:] = True
    jbias = jl.key_padding_bias(jnp.asarray(pad)) if masked else None
    jlayer = jl.TransformerEncoderLayer(D, Hh, Ff, dropout=0.1)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), jbias, True)
    ref = np.asarray(jlayer.apply(params, jnp.asarray(x), jbias, True))

    layer = tl.TransformerEncoderLayer(D, Hh, Ff)
    sd = bridge._encoder_layer(_tree(params)["params"], "layer")
    layer.load_state_dict({k[len("layer."):]: torch.tensor(v)
                           for k, v in sd.items()}, strict=True)
    tbias = tl.key_padding_bias(torch.from_numpy(pad)) if masked else None
    with torch.no_grad():
        out = layer(torch.from_numpy(x), tbias, True)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_timestep_embedder_matches_jax():
    jmodel, params, tmodel = build_pair()
    t = np.array([0, 7, 999], np.int32)
    ref = jl.TimestepEmbedder(128).apply(
        {"params": params["params"]["embed_timestep"]}, jnp.asarray(t))
    with torch.no_grad():
        out = tmodel.embed_timestep(torch.from_numpy(t).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mask_frames", [False, True])
@pytest.mark.parametrize("cond_mode", ["text", "no_cond"])
def test_mdm_forward_matches_jax(cond_mode, mask_frames):
    jmodel, params, tmodel = build_pair(cond_mode=cond_mode, mask_frames=mask_frames)
    x, t, text, frames, drop = _inputs()
    text_mode = cond_mode == "text"
    jcond = jm.Conditioning(frames_mask=jnp.asarray(frames),
                            text_embed=jnp.asarray(text) if text_mode else None,
                            cond_drop=jnp.asarray(drop) if text_mode else None)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jcond))
    tcond = tm.Conditioning(frames_mask=torch.from_numpy(frames),
                            text_embed=torch.from_numpy(text) if text_mode else None,
                            cond_drop=torch.from_numpy(drop) if text_mode else None)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(t).long(), tcond)
    assert out.shape == (B, T, 263)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_mdm_forward_bf16_matches_jax():
    jmodel, params, tmodel = build_pair(compute_dtype="bfloat16")
    x, t, text, frames, _ = _inputs()
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jm.Conditioning(
        frames_mask=jnp.asarray(frames), text_embed=jnp.asarray(text))))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(t).long(), tm.Conditioning(
            frames_mask=torch.from_numpy(frames), text_embed=torch.from_numpy(text)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-2)


def test_cfg_denoiser_matches_jax():
    jmodel, params, tmodel = build_pair()
    x, t, text, frames, _ = _inputs()
    jfn = jm.cfg_denoiser(lambda p, x_, t_, c: jmodel.apply(p, x_, t_, c), params, 2.5)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t), jm.Conditioning(
        frames_mask=jnp.asarray(frames), text_embed=jnp.asarray(text))))
    tfn = tm.cfg_denoiser(tmodel, 2.5)
    with torch.no_grad():
        out = tfn(torch.from_numpy(x), torch.from_numpy(t).long(), tm.Conditioning(
            frames_mask=torch.from_numpy(frames), text_embed=torch.from_numpy(text)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-4)


def test_bridge_gives_the_torch_checkpoint_layout():
    _, params, tmodel = build_pair()
    sd = bridge.state_dict_from_flax(_tree(params)["params"], tmodel.config)  # inner tree too
    assert set(sd) == set(tmodel.state_dict())
    w = sd["seqTransEncoder.layers.0.self_attn.in_proj_weight"]
    assert tuple(w.shape) == (3 * 128, 128)
    q_kernel = np.asarray(params["params"]["seqTransEncoder"]["layers_0"]["self_attn"]
                          ["q_proj"]["kernel"])
    np.testing.assert_array_equal(w[:128].numpy(), q_kernel.T)
    assert tuple(sd["seqTransEncoder.layers.1.linear1.weight"].shape) == (256, 128)
    assert "seqTransEncoder.layers.1.norm2.weight" in sd


def test_unported_options_raise():
    """The options this test once refused (gru, action, remat) now build and
    run: a forward of each gives finite features of the input's shape
    (tests/test_torch_a2m.py holds them against mdm_tpu). What stays
    refused is what mdm_tpu refuses too: a GRU in bf16 (its scan's carry
    changes dtype), an action model without actions, an unknown arch."""
    x, t, *_ = _inputs()
    a2m = dict(njoints=25, nfeats=6, data_rep="rot6d", cond_mode="action", num_actions=12)
    cond = tm.Conditioning(action=torch.tensor([0, 11, 5]))
    for cfg in (dict(arch="gru", **a2m), a2m, dict(remat=True)):
        model = tm.MDM(tm.MDMConfig(**SMALL, **cfg)).init_weights(torch.Generator().manual_seed(0))
        feats = model.config.input_feats
        c = cond if cfg.get("cond_mode") == "action" else tm.Conditioning(
            text_embed=torch.zeros(B, 512))
        with torch.no_grad():
            out = model(torch.from_numpy(x[..., :feats]).contiguous(),
                        torch.from_numpy(t).long(), c)
        assert out.shape == (B, T, feats) and torch.isfinite(out).all(), cfg
    with pytest.raises(ValueError, match="float32"):
        tm.MDM(tm.MDMConfig(**SMALL, arch="gru", compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="Conditioning.action"):
        tm.MDM(tm.MDMConfig(**SMALL, **a2m))(torch.zeros(B, T, 150),
                                             torch.zeros(B, dtype=torch.long), tm.Conditioning())
    with pytest.raises(ValueError, match="arch"):
        tm.MDM(tm.MDMConfig(**SMALL, arch="lstm"))


def test_init_weights_is_seeded():
    cfg = tm.MDMConfig(**SMALL)
    a = tm.MDM(cfg).init_weights(torch.Generator().manual_seed(5)).state_dict()
    b = tm.MDM(cfg).init_weights(torch.Generator().manual_seed(5)).state_dict()
    c = tm.MDM(cfg).init_weights(torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed_text.weight"], c["embed_text.weight"])
    assert torch.equal(a["seqTransEncoder.layers.0.norm1.weight"], torch.ones(128))


def test_sequence_dropout_draws_the_philox_stream():
    """MDM's input-sequence dropout keeps where the Philox bits under one
    seed from the step's CPU generator fall below the kernels' threshold,
    and scales kept values as flax's Dropout: the same mask on any device."""
    from mdm_tpu_torch.ops import dropout_bits as DB

    rate = 0.25
    x = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = tm.sequence_dropout(x, rate, torch.Generator().manual_seed(7))
    seed = tl.draw_seeds(torch.Generator().manual_seed(7), 1)[0]
    keep = DB.philox_bits(seed, torch.arange(2), 0, 9, 16) < DB.keep_threshold(rate)
    assert torch.equal(out, torch.where(keep, x / (1 - rate), torch.zeros((), dtype=x.dtype)))
    assert 0.6 < keep.float().mean().item() < 0.9
