"""The CLIP and DistilBERT text towers of mdm_tpu_torch against mdm_tpu's,
on the CPU, with their converters, bridges, embedders and assets.

One random state dict in the published layout (OpenAI ``clip`` keys for
CLIP, HuggingFace DistilBertModel keys for DistilBERT), drawn with numpy
from a seed, goes through each package's converter; both towers then embed
the same tokens. DistilBERT is 128 wide with 2 heads, so its self-attention
passes the sample-block gate (D % 128 == 0): under AUTO the JAX side runs
its Pallas kernel (#2's rate-0 entry) through the interpreter and the port
the kernel's plain version, which a spy on the wrapper shows; pinned off,
both run the einsum route. CLIP's causal bias is a full [1, 1, 77, 77] and
takes the einsum route either way.

Tolerance: f32 at matmul precision ``highest`` (tests/conftest.py), the
largest difference within 1e-5 of the largest output value (the same
products and LayerNorms summed in another order). The comparisons with
HuggingFace's torch models run only where ``transformers`` imports.
"""
import functools
import gzip
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_cli import synthetic_humanml  # noqa: E402,F401

from mdm_tpu import ops as jops  # noqa: E402
from mdm_tpu.models import text_encoders as J  # noqa: E402
from mdm_tpu.sampling import text as jtext  # noqa: E402
from mdm_tpu_torch import ops  # noqa: E402
from mdm_tpu_torch.cli import convert_text_encoders as ct_cli  # noqa: E402
from mdm_tpu_torch.models import bridge  # noqa: E402
from mdm_tpu_torch.models import layers as tl  # noqa: E402
from mdm_tpu_torch.models import text_encoders as T  # noqa: E402
from mdm_tpu_torch.sampling import text  # noqa: E402

REL = 1e-5
CLIP = dict(vocab_size=600, width=64, layers=3, heads=1, embed_dim=32)  # heads: width // 64
BERT = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2, hidden_dim=256,
            max_position_embeddings=64)
MERGES = ["#version tiny", "h e", "l l", "he ll", "hell o</w>", "w a", "wa l", "wal k</w>",
          "p e", "pe r", "per s", "pers o", "perso n</w>"]
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "walk", "##s", "run", "##ning",
         "forward", "jump", "."]


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, f"max |diff| / max |want| = {err:.3g} > {rel}"


def _draw(rng, shape, scale):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def openai_clip_sd(seed=0, vocab_size=600, width=64, layers=3, embed_dim=32, ctx=77):
    """A random OpenAI ``clip`` state dict (text keys, plus a visual key
    and logit_scale, which the converters drop)."""
    rng = np.random.default_rng(seed)
    w = width
    sd = {"token_embedding.weight": _draw(rng, (vocab_size, w), 0.02),
          "positional_embedding": _draw(rng, (ctx, w), 0.01),
          "text_projection": _draw(rng, (w, embed_dim), w ** -0.5),
          "ln_final.weight": 1 + _draw(rng, (w,), 0.1), "ln_final.bias": _draw(rng, (w,), 0.1),
          "logit_scale": np.float32(4.6), "visual.proj": _draw(rng, (8, embed_dim), 1.0)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        for name, shape in (("attn.in_proj_weight", (3 * w, w)), ("attn.out_proj.weight", (w, w)),
                            ("mlp.c_fc.weight", (4 * w, w)), ("mlp.c_proj.weight", (w, 4 * w))):
            sd[f"{p}.{name}"] = _draw(rng, shape, shape[1] ** -0.5)
        for name, n in (("attn.in_proj_bias", 3 * w), ("attn.out_proj.bias", w),
                        ("mlp.c_fc.bias", 4 * w), ("mlp.c_proj.bias", w)):
            sd[f"{p}.{name}"] = _draw(rng, (n,), 0.1)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = 1 + _draw(rng, (w,), 0.1)
            sd[f"{p}.{ln}.bias"] = _draw(rng, (w,), 0.1)
    return sd


def hf_distilbert_sd(seed=1, vocab_size=300, dim=128, n_layers=2, hidden_dim=256, max_pos=64,
                     prefix=""):
    """A random HuggingFace DistilBertModel state dict."""
    rng = np.random.default_rng(seed)
    sd = {"embeddings.word_embeddings.weight": _draw(rng, (vocab_size, dim), 0.5),
          "embeddings.position_embeddings.weight": _draw(rng, (max_pos, dim), 0.5),
          "embeddings.LayerNorm.weight": 1 + _draw(rng, (dim,), 0.1),
          "embeddings.LayerNorm.bias": _draw(rng, (dim,), 0.1)}
    for i in range(n_layers):
        p = f"transformer.layer.{i}"
        for name, shape in (("attention.q_lin", (dim, dim)), ("attention.k_lin", (dim, dim)),
                            ("attention.v_lin", (dim, dim)), ("attention.out_lin", (dim, dim)),
                            ("ffn.lin1", (hidden_dim, dim)), ("ffn.lin2", (dim, hidden_dim))):
            sd[f"{p}.{name}.weight"] = _draw(rng, shape, shape[1] ** -0.5)
            sd[f"{p}.{name}.bias"] = _draw(rng, shape[:1], 0.1)
        for ln in ("sa_layer_norm", "output_layer_norm"):
            sd[f"{p}.{ln}.weight"] = 1 + _draw(rng, (dim,), 0.1)
            sd[f"{p}.{ln}.bias"] = _draw(rng, (dim,), 0.1)
    return {prefix + k: v for k, v in sd.items()}


def _clip_tokens(rng, B=4, eot=599):
    """MDM's CLIP tokens: SOT, words, the EOT (the highest id), zeros to 77."""
    tokens = np.zeros((B, 77), np.int32)
    for b, n in enumerate((3, 7, 22, 1)[:B]):
        tokens[b, 0] = eot - 1
        tokens[b, 1:n + 1] = rng.integers(1, eot - 1, n)
        tokens[b, n + 1] = eot
    return tokens


def _bert_batch(rng, B=4, L=12):
    tokens = rng.integers(0, 300, (B, L)).astype(np.int32)
    lengths = np.array([L, 6, 2, 9])[:B]
    mask = np.arange(L)[None] < lengths[:, None]  # ragged rows, most of row 2 padding
    return tokens, mask


@pytest.fixture
def jax_pins():
    """set(sample_block) runs mdm_tpu's kernels through the Pallas
    interpreter with its single-device AUTO signal on, the sample block
    as given (None = AUTO); every JAX flag is restored after the test."""
    def set_pins(sample_block):
        jops.enable_pallas_interpret(True)
        jops._set_auto_sample_block(True)
        jops.enable_pallas_sample_block(sample_block)

    yield set_pins
    jops.enable_pallas_interpret(False)
    jops._set_auto_sample_block(False)
    jops.enable_pallas_sample_block(None)


@pytest.fixture
def block_calls(monkeypatch):
    """Counts the attention's calls of #2's rate-0 entry."""
    calls = []
    fn = tl.fused_block_attention_inference

    @functools.wraps(fn)
    def spy(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return fn(x, *args, **kwargs)

    monkeypatch.setattr(tl, "fused_block_attention_inference", spy)
    return calls


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jnp(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("sample_block", [None, False], ids=["auto", "sample_block_off"])
def test_clip_tower_matches_jax(jax_pins, block_calls, sample_block):
    """ClipTextEncoder on the OpenAI state dict through each converter; the
    bridge from mdm_tpu's params gives the same state dict."""
    sd = openai_clip_sd()
    jparams = J.convert_openai_clip_text(sd)
    jax_pins(sample_block)
    want = J.ClipTextEncoder(J.ClipTextConfig(**CLIP)).apply(
        jparams, jnp.asarray(_clip_tokens(np.random.default_rng(2))))
    ours = T.convert_openai_clip_text(sd)
    assert not any(k.startswith("visual.") or k == "logit_scale" for k in ours)
    for k, v in bridge.clip_text_from_flax(_tree(jparams)).items():
        torch.testing.assert_close(v, ours[k], rtol=0, atol=0)
    tower = T.ClipTextEncoder(T.ClipTextConfig(**CLIP))
    tower.load_state_dict(ours, strict=True)
    assert T.ClipTextConfig.from_state_dict(ours) == T.ClipTextConfig(**CLIP)
    with torch.no_grad(), ops.pinned(sample_block=sample_block):
        got = tower(torch.from_numpy(_clip_tokens(np.random.default_rng(2))))
    _close(got.numpy(), want)
    assert block_calls == []  # the causal bias is no key-padding row: the einsum route


@pytest.mark.parametrize("sample_block", [None, False], ids=["auto", "sample_block_off"])
def test_distilbert_tower_matches_jax(jax_pins, block_calls, sample_block):
    """DistilBertEncoder on the HF state dict through each converter, with a
    ragged padding mask: on #2's rate-0 entry under AUTO (once a layer), on
    the einsum route pinned off. Every row is compared, padded ones too
    (both packages compute them)."""
    sd = hf_distilbert_sd(prefix="distilbert.")
    jparams = J.convert_hf_distilbert(sd)
    tokens, mask = _bert_batch(np.random.default_rng(3))
    jax_pins(sample_block)
    want = J.DistilBertEncoder(J.DistilBertConfig(**BERT)).apply(
        jparams, jnp.asarray(tokens), jnp.asarray(mask))
    ours = T.convert_hf_distilbert(sd)
    for k, v in bridge.distilbert_from_flax(_tree(jparams)).items():
        torch.testing.assert_close(v, ours[k], rtol=0, atol=0)
    tower = T.DistilBertEncoder(T.DistilBertConfig(**BERT))
    tower.load_state_dict(ours, strict=True)
    assert T.DistilBertConfig.from_state_dict(ours) == T.DistilBertConfig(**BERT)
    with torch.no_grad(), ops.pinned(sample_block=sample_block):
        got = tower(torch.from_numpy(tokens), torch.from_numpy(mask))
    _close(got.numpy(), want)
    assert block_calls == ([(4, 12, 128)] * 2 if sample_block is None else [])


def test_quick_gelu_and_infer_layers():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(T.quick_gelu(torch.from_numpy(x)).numpy(), J.quick_gelu(jnp.asarray(x)))
    sd = openai_clip_sd(layers=5)
    assert T._infer_layers(sd, "transformer.resblocks.") == 5
    with pytest.raises(KeyError):
        T._infer_layers(sd, "encoder.layers.")


def _bpe_file(path):
    with gzip.open(path, "wt") as f:
        f.write("\n".join(MERGES))
    return str(path)


def _vocab_file(path):
    path.write_text("\n".join(WORDS))
    return str(path)


PROMPTS = ["a person walks forward.", "hello walk", "", "a person running, then a jump"]


def test_embedders_match_jax(tmp_path, jax_pins):
    """ClipTextEmbedder / BertTextEmbedder against mdm_tpu's on one
    tokenizer file each: the embeddings to REL, the token mask equal."""
    bpe, vocab = _bpe_file(tmp_path / "bpe.txt.gz"), _vocab_file(tmp_path / "vocab.txt")
    clip_sd = openai_clip_sd(vocab_size=530)  # the tiny BPE's 524 ids fit
    cfg = dict(CLIP, vocab_size=530)
    jax_pins(None)
    want = jtext.ClipTextEmbedder(_jnp(J.convert_openai_clip_text(clip_sd)), bpe,
                                  J.ClipTextConfig(**cfg))(PROMPTS)
    got = text.ClipTextEmbedder(T.convert_openai_clip_text(clip_sd), bpe, device="cpu")(PROMPTS)
    assert set(got) == set(want) == {"text_embed"}
    _close(got["text_embed"], want["text_embed"])

    bert_sd = hf_distilbert_sd()
    want = jtext.BertTextEmbedder(_jnp(J.convert_hf_distilbert(bert_sd)), vocab,
                                  J.DistilBertConfig(**BERT))(PROMPTS)
    got = text.BertTextEmbedder(T.convert_hf_distilbert(bert_sd), vocab, device="cpu")(PROMPTS)
    assert set(got) == set(want) == {"text_embed", "text_tokens_mask"}
    assert got["text_embed"].shape == (4, 64, 128)
    np.testing.assert_array_equal(got["text_tokens_mask"], want["text_tokens_mask"])
    _close(got["text_embed"], want["text_embed"])


def test_make_text_embedder_cases(tmp_path):
    """None without the port's assets (as mdm_tpu's), FileNotFoundError
    naming the converter where only mdm_tpu's orbax weights are, and the
    tower from the port's assets, written by cli.convert_text_encoders."""
    for kind in ("clip", "bert"):
        assert text.make_text_embedder(kind, str(tmp_path / "none"), device="cpu") is None
    orbax = tmp_path / "orbax"
    (orbax / "clip_text_flax").mkdir(parents=True)
    (orbax / "distilbert_flax").mkdir()
    _bpe_file(orbax / "bpe_simple_vocab_16e6.txt.gz")
    _vocab_file(orbax / "bert_vocab.txt")
    for kind in ("clip", "bert"):
        with pytest.raises(FileNotFoundError, match="mdm_tpu_torch.cli.convert_text_encoders"):
            text.make_text_embedder(kind, str(orbax), device="cpu")

    assets = tmp_path / "assets"
    assets.mkdir()
    clip_pt, bert_bin = tmp_path / "clip.pt", tmp_path / "bert.bin"
    torch.save({k: torch.as_tensor(v) for k, v in openai_clip_sd(vocab_size=530).items()}, clip_pt)
    torch.save({k: torch.as_tensor(v) for k, v in hf_distilbert_sd().items()}, bert_bin)
    ct_cli.main(["--clip", str(clip_pt), "--bert", str(bert_bin), "--out_dir", str(assets)])
    _bpe_file(assets / "bpe_simple_vocab_16e6.txt.gz")
    _vocab_file(assets / "bert_vocab.txt")
    clip = text.make_text_embedder("clip", str(assets), device="cpu")
    bert = text.make_text_embedder("bert", str(assets), device="cpu")
    assert clip.encoder.config == T.ClipTextConfig(**dict(CLIP, vocab_size=530))
    assert bert.encoder.config == T.DistilBertConfig(**BERT)
    direct = text.BertTextEmbedder(T.convert_hf_distilbert(hf_distilbert_sd()),
                                   str(assets / "bert_vocab.txt"), device="cpu")
    np.testing.assert_array_equal(bert(PROMPTS)["text_embed"], direct(PROMPTS)["text_embed"])
    assert clip(PROMPTS)["text_embed"].shape == (4, 32)


def test_convert_text_encoders_cli_layouts(tmp_path):
    """--clip from an HF directory (.bin; text_model. prefix, separate q/k/v)
    gives the tower mdm_tpu's HF converter gives; --bert from an HF
    directory; a directory of .safetensors alone is refused by name."""
    rng = np.random.default_rng(4)
    oa = openai_clip_sd(seed=5)
    w = CLIP["width"]
    hf = {"text_model.embeddings.token_embedding.weight": oa["token_embedding.weight"],
          "text_model.embeddings.position_embedding.weight": oa["positional_embedding"],
          "text_model.final_layer_norm.weight": oa["ln_final.weight"],
          "text_model.final_layer_norm.bias": oa["ln_final.bias"],
          "text_projection.weight": oa["text_projection"].T.copy()}
    for i in range(CLIP["layers"]):
        p, q = f"text_model.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for j, n in enumerate(("q_proj", "k_proj", "v_proj")):
            hf[f"{p}.self_attn.{n}.weight"] = oa[f"{q}.attn.in_proj_weight"][j * w:(j + 1) * w]
            hf[f"{p}.self_attn.{n}.bias"] = oa[f"{q}.attn.in_proj_bias"][j * w:(j + 1) * w]
        for a, b in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"),
                     ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            hf[f"{p}.{a}.weight"] = oa[f"{q}.{b}.weight"]
            hf[f"{p}.{a}.bias"] = oa[f"{q}.{b}.bias"]
    clip_dir, bert_dir, out = tmp_path / "clip_hf", tmp_path / "bert_hf", tmp_path / "out"
    clip_dir.mkdir()
    bert_dir.mkdir()
    torch.save({k: torch.as_tensor(v) for k, v in hf.items()}, clip_dir / "pytorch_model.bin")
    bert = hf_distilbert_sd(seed=6, prefix="distilbert.")
    torch.save({k: torch.as_tensor(v) for k, v in bert.items()}, bert_dir / "pytorch_model.bin")
    ct_cli.main(["--clip", str(clip_dir), "--bert", str(bert_dir), "--out_dir", str(out)])

    clip_sd = torch.load(out / "clip_text_torch.pt", weights_only=True)
    for k, v in T.convert_openai_clip_text(oa).items():  # the same weights, another layout
        torch.testing.assert_close(clip_sd[k], v, rtol=0, atol=0)
    tokens = _clip_tokens(rng)
    want = J.ClipTextEncoder(J.ClipTextConfig(**CLIP)).apply(J.convert_hf_clip_text(hf),
                                                              jnp.asarray(tokens))
    tower = T.ClipTextEncoder(T.ClipTextConfig(**CLIP))
    tower.load_state_dict(clip_sd, strict=True)
    with torch.no_grad():
        _close(tower(torch.from_numpy(tokens)).numpy(), want)
    bert_sd = torch.load(out / "distilbert_torch.pt", weights_only=True)
    for k, v in T.convert_hf_distilbert(bert).items():
        torch.testing.assert_close(bert_sd[k], v, rtol=0, atol=0)

    st = tmp_path / "st_only"
    st.mkdir()
    (st / "model.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="safetensors"):
        ct_cli.main(["--bert", str(st), "--out_dir", str(out)])


def test_hf_models_match_the_port():
    """HuggingFace's torch CLIPTextModelWithProjection and DistilBertModel,
    random-init, against the port's towers on their converted weights
    (valid positions of DistilBERT only: HF masks scores with the dtype's
    minimum, mdm_tpu and the port add -1e9, and padded rows differ)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_clip = transformers.CLIPTextModelWithProjection(transformers.CLIPTextConfig(
        vocab_size=600, hidden_size=64, intermediate_size=256, num_hidden_layers=3,
        num_attention_heads=1, max_position_embeddings=77, projection_dim=32,
        hidden_act="quick_gelu", eos_token_id=599)).eval()
    tokens = _clip_tokens(np.random.default_rng(7))
    with torch.no_grad():
        want = hf_clip(input_ids=torch.from_numpy(tokens).long()).text_embeds.numpy()
        tower = T.ClipTextEncoder(T.ClipTextConfig(**CLIP))
        tower.load_state_dict(T.convert_hf_clip_text(hf_clip.state_dict()), strict=True)
        _close(tower(torch.from_numpy(tokens)).numpy(), want)

    hf_bert = transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=300, dim=128, n_layers=2, n_heads=2, hidden_dim=256,
        max_position_embeddings=64)).eval()
    tokens, mask = _bert_batch(np.random.default_rng(8))
    with torch.no_grad():
        want = hf_bert(input_ids=torch.from_numpy(tokens).long(),
                       attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
        tower = T.DistilBertEncoder(T.DistilBertConfig(**BERT))
        tower.load_state_dict(T.convert_hf_distilbert(hf_bert.state_dict()), strict=True)
        got = tower(torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()
    _close(got[mask], want[mask])


def _tower_assets(root):
    """The port's assets for both towers, small, at the widths MDM reads:
    CLIP pooled to 512, DistilBERT 768 wide (1 layer, FFN 128)."""
    root.mkdir()
    torch.save({k: torch.as_tensor(v) for k, v in
                openai_clip_sd(vocab_size=530, layers=1, embed_dim=512).items()}, root / "c.pt")
    torch.save({k: torch.as_tensor(v) for k, v in
                hf_distilbert_sd(vocab_size=len(WORDS), dim=768, n_layers=1,
                                 hidden_dim=128).items()}, root / "b.bin")
    ct_cli.main(["--clip", str(root / "c.pt"), "--bert", str(root / "b.bin"),
                 "--out_dir", str(root)])
    _bpe_file(root / "bpe_simple_vocab_16e6.txt.gz")
    _vocab_file(root / "bert_vocab.txt")
    return str(root)


@pytest.mark.parametrize("kind", ["clip", "bert"])
def test_clis_run_on_the_towers(tmp_path, synthetic_humanml, monkeypatch, kind):
    """With the towers' assets present, ``--text_encoder_type clip`` and
    ``bert`` build them on the run's device (here --device cpu) in cli.train
    (the loader's batches), cli.generate, cli.edit and cli.eval_humanml;
    args.json keeps the type; a bert run (DiP, trans_dec with token memory)
    carries ``text_tokens_mask`` into every denoiser forward, training and
    sampling, and generates with --autoregressive."""
    from test_torch_cli import TINY, _eval, _evaluators

    from mdm_tpu_torch.cli import edit as edit_cli
    from mdm_tpu_torch.cli import generate as gen_cli
    from mdm_tpu_torch.cli import train as train_cli
    from mdm_tpu_torch.models import mdm as tm

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(text, "DEFAULT_ASSETS", _tower_assets(tmp_path / "assets"))
    masks = []
    forward = tm.MDM.forward

    def spy(self, x, timesteps, cond=tm.Conditioning(), *args, **kwargs):
        masks.append(cond.text_tokens_mask is not None)
        return forward(self, x, timesteps, cond, *args, **kwargs)

    monkeypatch.setattr(tm.MDM, "forward", spy)
    dip = ["--arch", "trans_dec", "--context_len", "4", "--pred_len", "8"] if kind == "bert" else []
    run = str(tmp_path / "run")
    train_cli.main(["--save_dir", run, "--dataset", "humanml", "--data_dir", synthetic_humanml,
                    *TINY, "--num_steps", "2", "--save_interval", "2", "--text_encoder_type",
                    kind, *dip, "--device", "cpu"])
    with open(os.path.join(run, "args.json")) as f:
        assert json.load(f)["text_encoder_type"] == kind
    ckpt = os.path.join(run, "ckpt_000000002")
    gen_cli.main(["--model_path", ckpt, "--text_prompt", "a person walks", "--num_samples", "2",
                  "--num_repetitions", "1", "--motion_length", "1.0", "--device", "cpu",
                  "--output_dir", str(tmp_path / "gen")]
                 + (["--autoregressive"] if kind == "bert" else []))
    res = np.load(tmp_path / "gen" / "results.npy", allow_pickle=True).item()
    assert np.isfinite(res["motion"]).all() and res["motion"].shape[0] == 2
    if kind == "clip":
        edit_cli.main(["--model_path", ckpt, "--data_dir", synthetic_humanml, "--num_samples",
                       "2", "--use_dataset_captions", "--output_dir", str(tmp_path / "edit"),
                       "--device", "cpu"])
        _evaluators(tmp_path, synthetic_humanml, "humanml")
        summary = _eval(ckpt, synthetic_humanml, str(tmp_path))
        assert np.isfinite(summary["FID"]["vald"]["mean"])
    assert masks and all(masks) == (kind == "bert")
