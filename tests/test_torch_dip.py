"""DiP end to end on the CPU: mdm_tpu_torch's autoregressive sampling and
edit masks against mdm_tpu's.

A small DiP denoiser (trans_dec, DistilBERT-shaped token memory with a
ragged token mask, frame masking, a 4-frame prefix and 8-frame chunks,
weights from mdm_tpu's init through models/bridge.py) generates 20 frames
in 3 chunks, a length no multiple of the chunk, with a different text each
chunk:

- under DDIM with pinned per-chunk noise, against mdm_tpu's
  ``MotionGenerator.sample_autoregressive`` (its one-scan chunk loop), with
  and without the initial prefix in the output;
- under DDPM with pinned per-chunk and per-step noise
  (``chunk_step_noise``), against a host loop of mdm_tpu's
  ``p_sample_loop(step_noise=...)`` over the chunks, which mirrors its
  pipeline.py:458-481.

The JAX side runs its kernels in interpret mode with the single-device
AUTO signal on (its MotionGenerator sets it), the port their plain
versions. Features are held to 1e-4 in f32, test_torch_pipeline.py's bar
for a sampling loop: each chunk's prefix is the last one's output, and 5
steps feed each step's output to the next.

DDIM with a new text each chunk runs at CFG 2.5: at DiP's 7.5 this
random-weight denoiser's deterministic chunk loop is ill-conditioned (the
port alone turns a 1e-5 change of the first chunk's noise into 3e-4, 4e-3
and 9e-3 in chunks 1-3), so f32 summation order alone moves the third
chunk by ~1e-3 on either side. DiP's 7.5 is held with one text for all
chunks (the same change then stays below 1.3e-4) and under DDPM, whose
pinned step noise keeps the loop well-conditioned.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import ops as jops  # noqa: E402
from mdm_tpu.core import hml_masks as jmasks  # noqa: E402
from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.diffusion import samplers as JS  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.sampling import pipeline as JP  # noqa: E402
from mdm_tpu_torch.core import hml_masks as tmasks  # noqa: E402
from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.models import bridge  # noqa: E402
from mdm_tpu_torch.models import mdm as tm  # noqa: E402
from mdm_tpu_torch.sampling import pipeline as TP  # noqa: E402
from mdm_tpu_torch.scripts import dip_probe as DP  # noqa: E402

CTX, PRED, STEPS, FRAMES = 4, 8, 5, 20
CHUNKS = -(-FRAMES // PRED)  # 3, the last one cut
B, L, D = 2, 6, 263
DIP = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4, arch="trans_dec",
           text_dim=768, text_tokens=True, mask_frames=True, context_len=CTX, pred_len=PRED)


@pytest.fixture(autouse=True)
def _kernel_flags():
    jops.enable_pallas_interpret(True)
    yield
    jops.enable_pallas_interpret(False)


@functools.lru_cache(maxsize=None)
def _pair():
    jmodel = jm.MDM(jm.MDMConfig(**DIP))
    jcond, _, _ = _conds()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((B, PRED, D)),
                         jnp.zeros((B,), jnp.int32), jcond)
    tmodel = tm.MDM(tm.MDMConfig(**DIP))
    tmodel.load_state_dict(bridge.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tmodel.config), strict=True)
    return jmodel, params, tmodel


def _conds(seed=0):
    """(JAX Conditioning, the port's, each chunk's text [CHUNKS, B, L, 768])."""
    rng = np.random.default_rng(seed)
    frames = np.ones((B, PRED), bool)
    frames[1, 6:] = False
    fields = dict(frames_mask=frames,
                  text_embed=rng.normal(size=(B, L, 768)).astype(np.float32),
                  text_tokens_mask=np.arange(L)[None] < np.array([[3], [L]]),
                  prefix=rng.normal(size=(B, CTX, D)).astype(np.float32))
    texts = rng.normal(size=(CHUNKS, B, L, 768)).astype(np.float32)
    return (jm.Conditioning(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tm.Conditioning(**{k: torch.from_numpy(v) for k, v in fields.items()}), texts)


def _noise(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(CHUNKS, B, PRED, D)).astype(np.float32),
            rng.normal(size=(CHUNKS, STEPS, B, PRED, D)).astype(np.float32))


def _gen_config(guidance=7.5, **kw):
    """The port's GenerationConfig fields; mdm_tpu's also takes the model's
    prefix and chunk lengths (``JP.GenerationConfig(**JAX_AR, **kw)``)."""
    return dict(guidance_scale=guidance, autoregressive=True, **kw)


JAX_AR = dict(context_len=CTX, pred_len=PRED)


@pytest.mark.parametrize("include_prefix, texts_per_chunk, guidance",
                         [(False, True, 2.5), (True, True, 2.5), (False, False, 7.5)])
def test_ddim_autoregressive_matches_jax(include_prefix, texts_per_chunk, guidance):
    jmodel, params, tmodel = _pair()
    jcond, tcond, texts = _conds()
    chunk_noise, _ = _noise()
    kw = _gen_config(guidance, sampler="ddim", autoregressive_include_prefix=include_prefix)
    jchunk = tchunk = None
    if texts_per_chunk:
        jchunk = lambda i, c: c.replace(text_embed=jnp.asarray(texts[i]))
        tchunk = lambda i, c: c.replace(text_embed=torch.from_numpy(texts[i]))
    jgen = JP.MotionGenerator(jmodel, params, JSchedule.create("cosine", 1000, str(STEPS)),
                              JP.GenerationConfig(**JAX_AR, **kw))
    ref = np.asarray(jgen.sample_autoregressive(
        jcond, B, jax.random.PRNGKey(0), required_frames=FRAMES, per_chunk_cond=jchunk,
        chunk_noise=jnp.asarray(chunk_noise)))
    tgen = TP.MotionGenerator(tmodel, Schedule.create("cosine", 1000, str(STEPS)),
                              TP.GenerationConfig(**kw))
    out = tgen.generate(tcond, B, FRAMES, per_chunk_cond=tchunk,
                        chunk_noise=torch.from_numpy(chunk_noise))
    assert ref.shape == out["features"].shape == (B, FRAMES, D)
    assert out["joints"].shape == (B, FRAMES, 22, 3)
    np.testing.assert_allclose(out["features"].numpy(), ref, atol=1e-4, rtol=1e-4)
    if include_prefix:
        np.testing.assert_array_equal(out["features"][:, :CTX].numpy(),
                                      tcond.prefix.numpy())


def test_ddpm_autoregressive_matches_a_jax_host_loop():
    jmodel, params, tmodel = _pair()
    jcond, tcond, texts = _conds(2)
    chunk_noise, chunk_step_noise = _noise(3)
    sched = JSchedule.create("cosine", 1000, str(STEPS))
    guided = jm.cfg_denoiser(lambda p, x, t, c: jmodel.apply(p, x, t, c), params, 7.5)
    jops._set_auto_sample_block(True)  # as mdm_tpu's MotionGenerator sets it for one device
    try:
        prefix, chunks = jcond.prefix, []
        for i in range(CHUNKS):
            cond_i = jcond.replace(prefix=prefix, text_embed=jnp.asarray(texts[i]))
            sample = JS.p_sample_loop(lambda x, t: guided(x, t, cond_i), sched,
                                      jnp.asarray(chunk_noise[i]), jax.random.PRNGKey(i),
                                      step_noise=jnp.asarray(chunk_step_noise[i]))
            chunks.append(sample)
            prefix = jnp.concatenate([prefix, sample], axis=1)[:, -CTX:]
    finally:
        jops._set_auto_sample_block(False)
    ref = np.asarray(jnp.concatenate(chunks, axis=1)[:, :FRAMES])

    tgen = TP.MotionGenerator(tmodel, Schedule.create("cosine", 1000, str(STEPS)),
                              TP.GenerationConfig(**_gen_config(sampler="ddpm")))
    out = tgen.sample_autoregressive(
        tcond, B, required_frames=FRAMES,
        per_chunk_cond=lambda i, c: c.replace(text_embed=torch.from_numpy(texts[i])),
        chunk_noise=torch.from_numpy(chunk_noise),
        chunk_step_noise=torch.from_numpy(chunk_step_noise))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_autoregressive_generate_draws_from_its_generator():
    """Without pinned noise every draw comes from the generator: the same
    seed gives the same motion, another seed another; cached CFG runs the
    chunk loop too."""
    _, _, tmodel = _pair()
    _, tcond, _ = _conds()
    for kw in (dict(sampler="ddpm"), dict(sampler="ddim", cfg_cache_interval=2)):
        gen = TP.MotionGenerator(tmodel, Schedule.create("cosine", 1000, "3"),
                                 TP.GenerationConfig(**_gen_config(**kw)))
        run = lambda seed: gen.generate(tcond, B, FRAMES, torch.Generator().manual_seed(seed))
        a, b, c = run(1), run(1), run(2)
        assert a["joints"].shape == (B, FRAMES, 22, 3) and torch.isfinite(a["joints"]).all()
        assert torch.equal(a["features"], b["features"])
        assert not torch.equal(a["features"], c["features"])
    with pytest.raises(ValueError, match="prefix"):
        gen.sample_autoregressive(tcond.replace(prefix=None), B)


def test_autoregressive_needs_a_prefix_model():
    """The chunk loop reads its prefix and chunk lengths from the model's
    config, so a model without prefix completion is refused up front."""
    model = tm.MDM(tm.MDMConfig(latent_dim=128, ff_size=256, num_layers=1, num_heads=4,
                                arch="trans_dec", text_dim=768, text_tokens=True))
    sched = Schedule.create("cosine", 1000, "3")
    with pytest.raises(ValueError, match="context_len=0 and pred_len=0"):
        TP.MotionGenerator(model, sched, TP.GenerationConfig(autoregressive=True))
    TP.MotionGenerator(model, sched, TP.GenerationConfig())


@pytest.mark.parametrize("sampler", ["plms", "dpmpp_2m"])
def test_cached_cfg_refuses_the_multistep_solvers(sampler):
    _, _, tmodel = _pair()
    sched = Schedule.create("cosine", 1000, "3")
    with pytest.raises(ValueError, match="only supported for the ddpm/ddim"):
        TP.MotionGenerator(tmodel, sched, TP.GenerationConfig(sampler=sampler,
                                                              cfg_cache_interval=2))
    TP.MotionGenerator(tmodel, sched, TP.GenerationConfig(sampler=sampler))
    with pytest.raises(ValueError, match="unknown sampler"):
        TP.MotionGenerator(tmodel, sched, TP.GenerationConfig(sampler="euler"))


def test_edit_masks_match_jax():
    lengths = np.array([196, 120, 37, 1])
    np.testing.assert_array_equal(TP.in_between_mask(lengths, 196, 263),
                                  JP.in_between_mask(lengths, 196, 263))
    np.testing.assert_array_equal(TP.in_between_mask(lengths, 60, 12, 0.1, 0.9),
                                  JP.in_between_mask(lengths, 60, 12, 0.1, 0.9))
    np.testing.assert_array_equal(TP.upper_body_mask(196, 3), JP.upper_body_mask(196, 3))
    names = [n for n in dir(jmasks) if n.isupper()]
    assert names and names == [n for n in dir(tmasks) if n.isupper()]
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(tmasks, name)),
                                      np.asarray(getattr(jmasks, name)))


def test_dip_probe_drives_the_flagship_dip_config():
    """The card's DiP configuration (scripts/dip_probe.py, chip_smoke.py
    phase 13) is the flagship width with DiP's options, and its
    conditioning has the shapes and ragged masks the decoder expects."""
    cfg = DP.DIP
    assert (cfg.arch, cfg.latent_dim, cfg.num_layers, cfg.num_heads, cfg.ff_size) == (
        "trans_dec", 512, 8, 4, 1024)
    assert (cfg.text_dim, cfg.text_tokens, cfg.mask_frames, cfg.context_len, cfg.pred_len,
            cfg.compute_dtype) == (768, True, True, 20, 40, "bfloat16")
    assert (DP.TOKENS, DP.STEPS, DP.GUIDANCE, DP.FRAMES) == (64, 10, 7.5, 196)
    cond = DP.make_cond(5, device="cpu", seed=1)
    assert cond.text_embed.shape == (5, 64, 768) and cond.prefix.shape == (5, 20, 263)
    assert cond.text_tokens_mask.sum(1).tolist() == [1, 14, 27, 40, 53]
    assert cond.frames_mask.sum(1).tolist() == [33, 40, 40, 33, 40]
