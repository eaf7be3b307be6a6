"""Training the trans_dec denoiser and ``remat`` in mdm_tpu_torch, on the CPU.

Against mdm_tpu: a rate-0 DiP train step (DistilBERT-shaped token memory
with a ragged token mask, ragged frame masks, the prefix in
``cond.prefix``) and a ``remat=True`` step of trans_enc and of trans_dec,
each through ``make_train_step(use_shardings=False)`` with the train block
and the tail pinned and run by the Pallas interpreter at rate 0
(tests/test_torch_train.py's ``jax_kernels``). Weights cross through
models/bridge.py, draws come from the JAX key. Tolerances are
tests/test_torch_train.py's: 2e-5 relative on the loss, the metrics and
the gradients (optax's first moment over 1 - b1), and ``_check_update`` on
AdamW's moments and the parameter and EMA updates.

Inside the port at rate 0.1, where the JAX stream has no CPU lowering:
the AUTO, ``drop`` and ``xla`` routes of a decoder step drop the same
elements under one seed (the same loss and gradients to 2e-5 relative,
tests/test_torch_routes.py's bar); a ``remat`` step is bitwise the step
without it, generator included; and the rectangular attention dump is
the square one's corner.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.diffusion import LossConfig as JLossConfig  # noqa: E402
from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.train import state as JS  # noqa: E402
from mdm_tpu.train import train_step as JT  # noqa: E402
from mdm_tpu_torch import ops  # noqa: E402
from mdm_tpu_torch.diffusion import LossConfig, Schedule  # noqa: E402
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig, bridge  # noqa: E402
from mdm_tpu_torch.models import layers as tl  # noqa: E402
from mdm_tpu_torch.ops import dropout_bits as DB  # noqa: E402
from mdm_tpu_torch.scripts import bench_train_kernels as BT  # noqa: E402
from mdm_tpu_torch.train import (OptimConfig, TrainStepConfig, create_train_state,  # noqa: E402
                                 make_train_step, step_key)
from mdm_tpu_torch.train.train_step import step_generators  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402
from test_torch_train import (OPTIM, REL, JS_adam, _check_metrics, _check_update,  # noqa: E402
                              _close, _jax_draws, _np_tree, _snapshot, jax_kernels)

SMALL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
# scripts/dip_probe.py's DIP at the test width: token memory, frame masks,
# a 5-frame prefix before the T predicted frames.
B, T, L, CTX = 4, 16, 6, 5
DIP = dict(arch="trans_dec", text_dim=768, text_tokens=True, mask_frames=True, context_len=CTX,
           pred_len=T)


def dip_fields(seed=0, njoints=263):
    """(x, mask, conditioning fields) of a DiP batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, njoints)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 11:] = False
    mask[3, 5:] = False
    fields = dict(text_embed=rng.normal(size=(B, L, 768)).astype(np.float32),
                  text_tokens_mask=np.arange(L)[None] < np.array([[3], [L], [1], [4]]),
                  prefix=rng.normal(size=(B, CTX, njoints)).astype(np.float32))
    return x, mask, fields


def step_matches_jax(kw, x, mask, fields, *, init_fields=None, loss=None, jax_kw=None,
                     port_kw=None, extra_draws=None, key=7):
    """One train step of the config ``kw`` on both sides from the same
    weights and draws, held at the module doc's tolerances. ``fields``:
    the batch's conditioning (numpy); ``init_fields`` the conditioning the
    JAX init sees (default: ``fields``); ``loss``: LossConfig fields;
    ``jax_kw``/``port_kw``: make_train_step keywords by side;
    ``extra_draws(key)``: port draws beyond t, noise and cond_drop;
    ``key``: the JAX step key's seed. Returns the port's state after the
    step."""
    jmodel = jm.MDM(jm.MDMConfig(**kw))
    jfield = lambda f: jm.Conditioning(**{k: jnp.asarray(v) for k, v in f.items()})
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((B,), jnp.int32),
                         jfield({"frames_mask": mask, **(init_fields or fields)}))["params"]
    jcfg = JT.TrainStepConfig(loss=JLossConfig(**(loss or {})), optim=JS.OptimConfig(**OPTIM))
    tcfg = TrainStepConfig(loss=LossConfig(**(loss or {})), optim=OptimConfig(**OPTIM))
    jsched = JSchedule.create("cosine", 1000)
    jstep = JT.make_train_step(jmodel.apply, jsched, jcfg, use_shardings=False, **(jax_kw or {}))
    tstep = make_train_step(Schedule.create("cosine", 1000), tcfg, **(port_kw or {}))
    model = MDM(MDMConfig(**kw))
    model.load_state_dict(bridge.state_dict_from_flax(_np_tree(params), model.config), strict=True)
    tstate = create_train_state(model, tcfg.optim)
    jstate = JS.create_train_state(params, jcfg.optim)
    key = jax.random.PRNGKey(key)
    draws = _jax_draws(key, jnp.asarray(x), jsched, jcfg.cond_mask_prob)
    draws.update(extra_draws(key) if extra_draws else {})
    before = _snapshot(tstate, jstate)
    jstate, jmet = jstep(jstate, {"x": jnp.asarray(x), "mask": jnp.asarray(mask),
                                  "cond": jfield(fields)}, key)
    tcond = Conditioning(**{k: torch.from_numpy(v) for k, v in fields.items()})
    tstate, tmet = tstep(tstate, {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask),
                                  "cond": tcond}, 0, draws=draws)
    _check_metrics(tmet, jmet)
    mu = bridge.state_dict_from_flax(_np_tree(JS_adam(jstate.opt_state).mu), model.config)
    for name, p in tstate.params().items():  # optax's first moment is (1 - b1) g
        _close(p.grad, mu[name].numpy() / np.float32(0.1), REL, f"grad {name}")
    _check_update(tstate, jstate, before, {})
    return tstate


def test_dip_rate0_train_step_matches_jax(jax_kernels):
    x, mask, fields = dip_fields()
    step_matches_jax({**SMALL, **DIP, "dropout": 0.0}, x, mask, fields)


@pytest.mark.parametrize("arch", ["trans_enc", "trans_dec"])
def test_remat_train_step_matches_jax(arch, jax_kernels):
    x, mask, fields = dip_fields(1)
    if arch == "trans_enc":  # the flagship's conditioning: a pooled text embedding
        kw, fields = dict(mask_frames=True), dict(text_embed=fields["text_embed"][:, 0, :512])
    else:
        kw = DIP
    step_matches_jax({**SMALL, **kw, "dropout": 0.0, "remat": True}, x, mask, fields)


# -- inside the port, at rate 0.1 --------------------------------------------

RATE = 0.1
# The wrappers a DiP decoder layer calls in training, per route.
ROUTES = {"tail": {"fused_train_attention_block", "fused_encoder_tail"},
          "drop": {"fused_dropout_attention"}, "xla": set()}
WRAPPERS = ("fused_train_attention_block", "fused_encoder_tail", "fused_dropout_attention",
            "dropout_bits", "sequence_dropout_bits", "tail_dropout_bits")


@pytest.fixture
def calls(monkeypatch):
    """Each wrapper's calls from the layers: their shapes and keywords."""
    seen = {n: [] for n in WRAPPERS}

    def spy(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            seen[name].append((args[1:4], kwargs.get("key_len")))
            return fn(*args, **kwargs)
        return wrapped

    for name in WRAPPERS:
        monkeypatch.setattr(tl, name, spy(name, getattr(tl, name)))
    return seen


def _port_batch(cfg, seed=2):
    """A DiP batch, or for trans_enc the same frames with a pooled text."""
    x, mask, fields = dip_fields(seed)
    if not cfg.text_tokens:
        fields = dict(text_embed=fields["text_embed"][:, 0, :512])
    cond = Conditioning(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask), "cond": cond}


def _train_step(cfg, variant="tail", key=3, seed=4):
    """One port step at rate 0.1 from seeded weights under a training
    route: (the state after it, its metrics, the parameters' gradients)."""
    model = MDM(cfg).init_weights(torch.Generator().manual_seed(seed))
    state = create_train_state(model, OptimConfig(lr=1e-3))
    step = make_train_step(Schedule.create("cosine", 1000), TrainStepConfig())
    with ops.pinned(**BT.VARIANTS[variant]):
        state, metrics = step(state, _port_batch(cfg), key)
    return state, metrics, {n: p.grad.clone() for n, p in state.model.named_parameters()}


def test_decoder_routes_drop_the_same_elements_under_one_seed(calls):
    """The AUTO route (train block + fused tail), ``drop`` (dropout kernel
    + plain tail) and ``xla`` (einsum + plain tail) of a DiP step at rate
    0.1 give the same loss and gradients: every site draws its mask from
    the same seed whatever its route. Each layer draws the cross-attention's
    [B, H, Sq, Sk] bits once and the self-attention output's [B, S, D]
    ones once."""
    cfg = MDMConfig(**{**SMALL, **DIP, "dropout": RATE})
    S, layers = CTX + T, cfg.num_layers
    ref = None
    for variant in ("tail", "drop", "xla"):
        for seen in calls.values():
            seen.clear()
        _, metrics, grads = _train_step(cfg, variant)
        routed = {n for n in ROUTES["tail"] | ROUTES["drop"] if calls[n]}
        assert routed == ROUTES[variant], variant
        assert all(len(calls[n]) == layers for n in routed)
        # The cross-attention's [B, H, S, L] bits; under xla also the
        # self-attention's [B, H, S, S], drawn first.
        cross = [((B, cfg.num_heads, S), L)]
        per_layer = [((B, cfg.num_heads, S), S)] + cross if variant == "xla" else cross
        assert calls["dropout_bits"] == per_layer * layers
        assert calls["sequence_dropout_bits"] == [((B, S, cfg.latent_dim), None)] * layers
        assert len(calls["tail_dropout_bits"]) == (0 if variant == "tail" else layers)
        if ref is None:
            ref = metrics, grads
            continue
        for k, v in ref[0].items():
            np.testing.assert_allclose(metrics[k].item(), v.item(), rtol=REL, err_msg=k)
        for name, g in grads.items():
            want = ref[1][name]
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                       atol=REL * want.abs().max().item(), err_msg=name)
    _, other, _ = _train_step(cfg, "tail", key=5)
    assert abs(other["loss"].item() - ref[0]["loss"].item()) > 1e-4  # the key moves the masks


@pytest.mark.parametrize("arch", ["trans_enc", "trans_dec"])
def test_remat_step_is_bitwise_the_step_without_it(arch, monkeypatch):
    """At rate 0.1 a ``remat`` step equals the step without it bit for bit:
    the gradients, the parameters and EMA after it, and the training
    forward's generator where it leaves it (the seeds are drawn before the
    checkpointed call and replayed by the recompute). Each layer call of
    the remat step goes through ``torch.utils.checkpoint``."""
    checkpoints = []
    monkeypatch.setattr(tl, "checkpoint",
                        lambda *a, **k: checkpoints.append(k) or checkpoint(*a, **k))
    kw = {**SMALL, "dropout": RATE, **(DIP if arch == "trans_dec" else {"mask_frames": True})}
    results = [_train_step(MDMConfig(**kw, remat=remat)) for remat in (False, True)]
    assert len(checkpoints) == SMALL["num_layers"]
    assert all(k["use_reentrant"] is False for k in checkpoints)
    (s0, m0, g0), (s1, m1, g1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
        assert torch.equal(s0.params()[name], s1.params()[name]), name
        assert torch.equal(s0.ema_params[name], s1.ema_params[name]), name

    states = []
    for remat in (False, True):
        model = MDM(MDMConfig(**kw, remat=remat)).init_weights(torch.Generator().manual_seed(4))
        batch = _port_batch(model.config)
        cond = batch["cond"].replace(frames_mask=batch["mask"])
        rng, _ = step_generators(step_key(0, 3), "cpu")
        out = model(batch["x"], torch.tensor([0, 10, 500, 999]), cond, deterministic=False,
                    rng=rng)
        out.square().sum().backward()
        states.append((out.detach(), rng.get_state(), [p.grad for p in model.parameters()]))
    (o0, r0, q0), (o1, r1, q1) = states
    assert torch.equal(o0, o1) and torch.equal(r0, r1)
    assert all(torch.equal(a, b) for a, b in zip(q0, q1))


def test_rectangular_dump_is_the_square_dumps_corner(monkeypatch):
    """``dropout_bits(.., key_len=Sk)`` gives [B, H, S, Sk]: the [:S, :Sk]
    corner of the square dump of their larger side, so the square case's
    words are today's; on the card it is one ``mdm_philox_dump`` with R = S
    and C = Sk (a stand-in library records the call)."""
    seed, Bq, H = 1234, 2, 3
    for S, Sk in ((21, 6), (6, 21), (21, 21), (1, 64), (60, 64)):
        n = max(S, Sk)
        rect = DB.dropout_bits(seed, Bq, H, S, device="cpu", key_len=Sk)
        assert rect.shape == (Bq, H, S, Sk) and rect.dtype == torch.uint32
        square = DB.dropout_bits(seed, Bq, H, n, device="cpu")
        assert torch.equal(rect, square[:, :, :S, :Sk])
    assert torch.equal(DB.dropout_bits(seed, Bq, H, 21, device="cpu", key_len=21),
                       DB.dropout_bits(seed, Bq, H, 21, device="cpu"))

    calls = []

    class Lib:
        def mdm_philox_dump(self, *args):
            calls.append(args[1:8])
            return 0

    monkeypatch.setattr(DB._build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(DB, "LAUNCHES", dict.fromkeys(DB.LAUNCHES, 0))
    out = DB.dropout_bits(seed, Bq, H, 60, device="meta", key_len=64)
    assert out.shape == (Bq, H, 60, 64)
    assert calls == [(seed, 0, Bq, H, -1, 60, 64)]  # seed, batch offset, B, H, site, R, C
    assert DB.LAUNCHES["dropout_bits"] == 1
