"""The trans_dec denoiser of mdm_tpu_torch against mdm_tpu's, on the CPU.

The decoder layer, the decoder stack and the whole MDM ``trans_dec``
forward (pooled text or DistilBERT-shaped tokens with a ragged token
mask, ``emb_policy`` add or cat, ``emb_trans_dec``, ragged frame masks,
DiP prefix completion, ``no_cond``) run under the same kernel pins on both
sides: AUTO (the rate-0 attention block #2 for the self-attention and the
rate-0 fused tail #4 for the cross-attention -> FFN half), ``pallas`` (v2
attention #11 and the fused tail) and ``xla`` (no kernel). The JAX side
runs its kernels through the Pallas interpreter with the single-device
AUTO signal on, as its MotionGenerator sets it; the port runs the kernels'
plain versions, and a spy on each wrapper shows the route. Weights come
from mdm_tpu's init through models/bridge.py.

Tolerances, all f32: one layer to 2e-5 (tests/test_torch_models.py's bar
for the encoder layer: the same products, summed in another order); the
decoder stack and the denoiser to 1e-4, whose input/output projections,
timestep MLP and text projection add their own reordered sums.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import ops as jops  # noqa: E402
from mdm_tpu.models import layers as jl  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu_torch import ops  # noqa: E402
from mdm_tpu_torch.models import bridge  # noqa: E402
from mdm_tpu_torch.models import layers as tl  # noqa: E402
from mdm_tpu_torch.models import mdm as tm  # noqa: E402

D, H, F = 128, 4, 256  # the kernel gates need D % 128 == 0
B, T, L = 3, 16, 6  # batch, frames, text tokens
SMALL = dict(latent_dim=D, ff_size=F, num_layers=2, num_heads=H, arch="trans_dec")
PINS = {  # pin -> (JAX flags, the port's flags, the wrappers a decoder layer calls)
    "auto": ({}, {}, {"fused_block_attention_inference", "fused_encoder_tail_inference"}),
    "pallas": (dict(sample_block=False, attention=True), dict(sample_block=False, attention=True),
               {"fused_attention_v2", "fused_encoder_tail_inference"}),
    "xla": (dict(sample_block=False, encoder_tail=False),
            dict(sample_block=False, encoder_tail=False), set()),
}
WRAPPERS = ("fused_block_attention_inference", "fused_encoder_tail_inference",
            "fused_attention_v2", "fused_layer_inference")


@pytest.fixture
def pin():
    """pin(name) sets one of PINS on the JAX side (interpret mode, AUTO
    signal on) and returns the port's flags for ops.pinned; every JAX flag
    is restored after the test."""
    def set_pin(name):
        jops.enable_pallas_interpret(True)
        jops._set_auto_sample_block(True)
        for flag, value in PINS[name][0].items():
            getattr(jops, f"enable_pallas_{flag}")(value)
        return PINS[name][1]

    yield set_pin
    jops.enable_pallas_interpret(False)
    jops._set_auto_sample_block(False)
    jops.enable_pallas_attention(False)
    for flag in ("sample_block", "encoder_tail", "layer_inference"):
        getattr(jops, f"enable_pallas_{flag}")(None)


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


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _load(module, sd, prefix):
    module.load_state_dict({k[len(prefix):]: torch.tensor(v) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _layer_inputs(S, seed=3):
    rng = np.random.default_rng(seed)
    tgt = rng.normal(size=(B, S, D)).astype(np.float32)
    memory = rng.normal(size=(B, L, D)).astype(np.float32)
    tgt_pad = np.zeros((B, S), bool)
    tgt_pad[0, S - 5:] = True
    tgt_pad[2, 7:] = True
    mem_pad = np.zeros((B, L), bool)
    mem_pad[1, 2:] = True
    mem_pad[2, 4:] = True
    return tgt, memory, tgt_pad, mem_pad


@pytest.mark.parametrize("name", sorted(PINS))
@pytest.mark.parametrize("S", [T, T + 1])  # + 1: the emb_trans_dec time token
def test_decoder_layer_matches_jax(name, S, pin, calls):
    jflags = pin(name)
    tgt, memory, tgt_pad, mem_pad = _layer_inputs(S)
    jbias = [jl.key_padding_bias(jnp.asarray(p)) for p in (tgt_pad, mem_pad)]
    jlayer = jl.TransformerDecoderLayer(D, H, F, dropout=0.1)
    args = (jnp.asarray(tgt), jnp.asarray(memory), *jbias, True)
    params = jlayer.init(jax.random.PRNGKey(0), *args)
    ref = np.asarray(jlayer.apply(params, *args))

    layer = _load(tl.TransformerDecoderLayer(D, H, F),
                  bridge._decoder_layer(_tree(params)["params"], "layer"), "layer.")
    tbias = [tl.key_padding_bias(torch.from_numpy(p)) for p in (tgt_pad, mem_pad)]
    with ops.pinned(**jflags), torch.no_grad():
        out = layer(torch.from_numpy(tgt), torch.from_numpy(memory), *tbias)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    assert {n for n, c in calls.items() if c} == PINS[name][2]
    assert all(c == 1 for c in calls.values() if c)


@pytest.mark.parametrize("name", sorted(PINS))
def test_decoder_stack_matches_jax(name, pin, calls):
    jflags = pin(name)
    tgt, memory, tgt_pad, mem_pad = _layer_inputs(T, seed=4)
    jdec = jl.TransformerDecoder(D, H, F, num_layers=2)
    args = (jnp.asarray(tgt), jnp.asarray(memory), jnp.asarray(tgt_pad), jnp.asarray(mem_pad),
            True)
    params = jdec.init(jax.random.PRNGKey(1), *args)
    ref = np.asarray(jdec.apply(params, *args))

    p = _tree(params)["params"]
    sd = {k: v for i in range(2) for k, v in bridge._decoder_layer(
        p[f"layers_{i}"], f"layers.{i}").items()}
    dec = _load(tl.TransformerDecoder(D, H, F, 2), sd, "")
    with ops.pinned(**jflags), torch.no_grad():
        out = dec(torch.from_numpy(tgt), torch.from_numpy(memory),
                  torch.from_numpy(tgt_pad), torch.from_numpy(mem_pad))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    assert {n for n, c in calls.items() if c} == PINS[name][2]
    assert all(c == 2 for c in calls.values() if c)


# MDM trans_dec variants: (config over SMALL, conditioning kind).
VARIANTS = {
    "pooled_add": (dict(), "pooled"),
    "tokens_add": (dict(text_dim=768, text_tokens=True), "tokens"),
    "tokens_cat": (dict(text_dim=768, text_tokens=True, emb_policy="cat"), "tokens"),
    "tokens_add_emb_trans_dec": (dict(text_dim=768, text_tokens=True, emb_trans_dec=True),
                                 "tokens"),
    "pooled_cat_emb_trans_dec": (dict(emb_policy="cat", emb_trans_dec=True), "pooled"),
    "mask_frames": (dict(text_dim=768, text_tokens=True, mask_frames=True), "tokens"),
    "prefix": (dict(text_dim=768, text_tokens=True, mask_frames=True, emb_trans_dec=True,
                    context_len=5, pred_len=T), "tokens"),
    "no_cond": (dict(cond_mode="no_cond", mask_frames=True), None),
}
# The DiP flagship's options at the test width: the pinned forwards' config.
DIP = VARIANTS["prefix"][0]


@functools.lru_cache(maxsize=None)
def build_pair(**cfg):
    """(JAX MDM, its params, the port's MDM carrying the same weights)."""
    kw = {**SMALL, **cfg}
    jmodel = jm.MDM(jm.MDMConfig(**kw))
    x, t, jcond, _ = _inputs(kw, "tokens" if kw.get("text_tokens") else "pooled")
    params = jmodel.init(jax.random.PRNGKey(0), x, t, jcond)
    tmodel = tm.MDM(tm.MDMConfig(**kw))
    tmodel.load_state_dict(bridge.state_dict_from_flax(_tree(params), tmodel.config), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(cfg, kind, seed=1):
    """(x, t, JAX Conditioning, port Conditioning) for a config."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, 263)).astype(np.float32)
    t = np.array([0, 421, 999], np.int32)
    frames = np.ones((B, T), bool)
    frames[1, 11:] = False
    frames[2, 5:] = False
    fields = dict(frames_mask=frames, cond_drop=np.array([False, True, False]))
    if kind == "pooled":
        fields["text_embed"] = rng.normal(size=(B, 512)).astype(np.float32)
    elif kind == "tokens":
        fields["text_embed"] = rng.normal(size=(B, L, 768)).astype(np.float32)
        fields["text_tokens_mask"] = np.arange(L)[None] < np.array([[3], [L], [1]])
    else:
        del fields["cond_drop"]
    if cfg.get("context_len"):
        fields["prefix"] = rng.normal(size=(B, cfg["context_len"], 263)).astype(np.float32)
    jcond = jm.Conditioning(**{k: jnp.asarray(v) for k, v in fields.items()})
    tcond = tm.Conditioning(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return jnp.asarray(x), jnp.asarray(t), jcond, (torch.from_numpy(x),
                                                   torch.from_numpy(t).long(), tcond)


def _forward(cfg, kind, jflags):
    jmodel, params, tmodel = build_pair(**cfg)
    x, t, jcond, targs = _inputs({**SMALL, **cfg}, kind)
    ref = np.asarray(jmodel.apply(params, x, t, jcond))
    with ops.pinned(**jflags), torch.no_grad():
        out = tmodel(*targs)
    assert out.shape == (B, T, 263)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mdm_trans_dec_forward_matches_jax(variant, pin, calls):
    cfg, kind = VARIANTS[variant]
    _forward(cfg, kind, pin("auto"))
    assert calls["fused_block_attention_inference"] == calls["fused_encoder_tail_inference"] == 2
    assert calls["fused_layer_inference"] == 0  # the encoder's kernel never takes a decoder layer


@pytest.mark.parametrize("name", ["pallas", "xla"])
def test_mdm_dip_forward_matches_jax_per_pin(name, pin, calls):
    _forward(DIP, "tokens", pin(name))
    assert {n for n, c in calls.items() if c} == PINS[name][2]


def test_cfg_denoiser_duplicates_every_field(pin):
    """CFG's double batch carries the token mask and the prefix too."""
    pin("auto")
    jmodel, params, tmodel = build_pair(**DIP)
    x, t, jcond, (tx, tt, tcond) = _inputs({**SMALL, **DIP}, "tokens")
    jcond, tcond = jcond.replace(cond_drop=None), tcond.replace(cond_drop=None)
    jfn = jm.cfg_denoiser(lambda p, x_, t_, c: jmodel.apply(p, x_, t_, c), params, 7.5)
    ref = np.asarray(jfn(x, t, jcond))
    with torch.no_grad():
        out = tm.cfg_denoiser(tmodel, 7.5)(tx, tt, tcond)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-4)  # 7.5 x the 1e-4 bar


def test_bridge_carries_the_decoder_layout():
    _, params, tmodel = build_pair(**DIP)
    sd = bridge.state_dict_from_flax(_tree(params)["params"], tmodel.config)
    assert set(sd) == set(tmodel.state_dict())
    layer = _tree(params)["params"]["seqTransDecoder"]["layers_1"]
    w = sd["seqTransDecoder.layers.1.multihead_attn.in_proj_weight"]
    assert tuple(w.shape) == (3 * D, D)
    np.testing.assert_array_equal(w[D:2 * D].numpy(), layer["multihead_attn"]["k_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["seqTransDecoder.layers.1.norm3.weight"].numpy(),
                                  layer["norm3"]["scale"])
    assert tuple(sd["embed_text.weight"].shape) == (D, 768)


def test_decoder_training_forward_raises():
    """A training forward of the decoder, which this test once found
    refused, now runs: finite features of x's shape, other than the eval
    forward's (dropout 0.1), and the same again under the same generator
    seed (tests/test_torch_decoder_train.py holds it against mdm_tpu). What
    still raises: a forward without its prefix, and a training forward with
    dropout but no generator."""
    _, _, tmodel = build_pair(**DIP)
    _, _, _, (x, t, cond) = _inputs({**SMALL, **DIP}, "tokens")
    train = lambda seed: tmodel(x, t, cond, deterministic=False,
                                rng=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        out, again, ref = train(0), train(0), tmodel(x, t, cond)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    assert not torch.allclose(out, ref, atol=1e-3)
    with pytest.raises(ValueError, match="prefix"):
        tmodel(x, t, cond.replace(prefix=None))
    with pytest.raises(ValueError, match="generator"):
        tmodel(x, t, cond, deterministic=False)


@pytest.mark.parametrize("name", sorted(PINS))
def test_eval_forward_casts_the_weights_once(name):
    """Without autograd a bf16 decoder layer casts its weights once (both
    attentions' and the tail's) and reuses the casts on every later call;
    an in-place update of a weight recasts it. With autograd on, the
    parameters themselves take their gradients (shown on the ``xla`` pin:
    the rate-0 kernel entries are inference-only)."""
    tgt, memory, tgt_pad, mem_pad = (torch.from_numpy(a) for a in _layer_inputs(T))
    biases = (tl.key_padding_bias(tgt_pad), tl.key_padding_bias(mem_pad))
    layer = tl.TransformerDecoderLayer(D, H, F, compute_dtype=torch.bfloat16)
    tl.init_weights_(layer, torch.Generator().manual_seed(0))
    layer.eval()
    owners = (layer.self_attn, layer.multihead_attn, layer)
    with ops.pinned(**PINS[name][1]), torch.no_grad():
        out = layer(tgt, memory, *biases)
        casts = [m._cast[1] for m in owners if m._cast is not None]
        assert len(casts) == (3 if name != "xla" else 2)
        assert all(w.dtype == torch.bfloat16 for c in casts for w in c)
        assert torch.equal(layer(tgt, memory, *biases), out)
        assert [m._cast[1] for m in owners if m._cast is not None] == casts
        layer.multihead_attn.out_proj.weight.mul_(2)
        assert not torch.equal(layer(tgt, memory, *biases), out)
        assert layer.multihead_attn._cast[1] is not casts[1]
        assert layer.self_attn._cast[1] is casts[0]
    if name == "xla":
        with ops.pinned(**PINS[name][1]):
            layer(tgt, memory, *biases).float().square().sum().backward()
        for attn in owners[:2]:
            assert attn.in_proj_weight.grad.abs().sum() > 0
