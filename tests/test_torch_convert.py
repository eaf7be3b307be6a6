"""Reference MDM checkpoints into mdm_tpu_torch, against mdm_tpu, on the CPU.

A state dict keyed as the reference's MDM saves it (the port's own module
names, which follow the reference's, plus the ``clip_model.*`` keys and
the sinusoidal ``pe`` buffers the converters drop), drawn from a seed, goes
through mdm_tpu's ``convert_mdm_state_dict`` and through the port's; both
denoisers then run one forward on the same numpy inputs. Cases: the
flagship ``trans_enc`` on pooled text, the DiP ``trans_dec`` on
DistilBERT-shaped token memory with a ragged token mask, the text ``gru``,
and each goal encoder (``multi``, ``single``, ``split``) on ``trans_enc``.
Tolerance: 1e-4 (absolute and relative) in f32, the bar of the denoiser
forwards in tests/test_torch_decoder.py. Then the command line:
``cli.convert_checkpoint`` on a wrapped ``{'model', 'model_avg'}`` file
and its args.json, then ``cli.generate --text_encoder_type clip`` on the
converted run, with CLIP assets from ``cli.convert_text_encoders``.
"""
import gzip
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.core.hml_codec import HML_EE_JOINT_NAMES  # noqa: E402
from mdm_tpu.models import convert as jconvert  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu_torch.cli import convert_checkpoint as cc_cli  # noqa: E402
from mdm_tpu_torch.cli import convert_text_encoders as ct_cli  # noqa: E402
from mdm_tpu_torch.cli import generate as gen_cli  # noqa: E402
from mdm_tpu_torch.models import convert  # noqa: E402
from mdm_tpu_torch.models import mdm as tm  # noqa: E402
from mdm_tpu_torch.sampling import text  # noqa: E402
from mdm_tpu_torch.train.checkpoints import find_resume_checkpoint  # noqa: E402
from test_torch_text_encoders import MERGES, openai_clip_sd  # noqa: E402

GOALS = ["pelvis"] + HML_EE_JOINT_NAMES
B, T, L = 3, 12, 7
BASE = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=4)
CASES = {
    "trans_enc": {},
    "trans_dec_bert": dict(arch="trans_dec", text_dim=768, text_tokens=True, emb_trans_dec=True),
    "gru": dict(arch="gru"),
    "goal_multi": dict(multi_target_cond=True, multi_encoder_type="multi"),
    "goal_single": dict(multi_target_cond=True, multi_encoder_type="single", target_enc_layers=2),
    "goal_split": dict(multi_target_cond=True, multi_encoder_type="split", target_enc_layers=2),
}


def reference_state_dict(cfg: tm.MDMConfig, seed: int = 0):
    """Seeded weights in the reference's keys and layouts, with the keys a
    reference checkpoint carries beside them."""
    model = tm.MDM(cfg).init_weights(torch.Generator().manual_seed(seed))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if cfg.multi_target_cond and cfg.multi_encoder_type == "multi":
        w = "embed_target_cond.target_all_loc_emb.weights"
        sd[w] = sd[w].abs()  # normal(1) mixing weights may sum near 0 (ROADMAP Queue 3)
    pe = torch.randn(5000, 1, cfg.latent_dim, generator=torch.Generator().manual_seed(seed))
    sd.update({"sequence_pos_encoder.pe": pe, "embed_timestep.sequence_pos_encoder.pe": pe,
               "clip_model.token_embedding.weight": torch.zeros(4, 8)})
    return sd


def _inputs(cfg: tm.MDMConfig, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, cfg.input_feats)).astype(np.float32)
    t = rng.integers(0, 1000, B).astype(np.int32)
    fields = {"frames_mask": np.arange(T)[None] < np.array([T, 9, 5])[:, None]}
    if cfg.text_tokens:
        fields["text_embed"] = rng.normal(size=(B, L, cfg.text_dim)).astype(np.float32)
        fields["text_tokens_mask"] = np.arange(L)[None] < np.array([L, 4, 1])[:, None]
    else:
        fields["text_embed"] = rng.normal(size=(B, cfg.text_dim)).astype(np.float32)
    if cfg.multi_target_cond:
        G = len(cfg.goal_names)
        fields["target_cond"] = rng.normal(size=(B, G, 3)).astype(np.float32)
        fields["target_validity"] = rng.random((B, G)) < 0.6
        fields["target_uncond"] = np.array([False, True, False])
    return x, t, fields


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_state_dict_same_forward_as_jax(case):
    cfg = tm.MDMConfig(**BASE, **CASES[case])
    sd = reference_state_dict(cfg)
    ours = convert.convert_mdm_state_dict(sd, cfg, GOALS)
    assert not any(k.startswith("clip_model.") or k.endswith(".pe") for k in ours)
    model = tm.MDM(cfg)
    model.load_state_dict(ours, strict=True)

    jcfg = jm.MDMConfig(**BASE, **CASES[case])
    jparams = jconvert.convert_mdm_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg, GOALS)
    x, t, fields = _inputs(cfg)
    want = jm.MDM(jcfg).apply(jparams, jnp.asarray(x), jnp.asarray(t),
                              jm.Conditioning(**{k: jnp.asarray(v) for k, v in fields.items()}))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    tm.Conditioning(**{k: torch.from_numpy(v) for k, v in fields.items()}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_goal_rows_follow_the_checkpoints_order():
    """A checkpoint whose goal rows come in another joint order is renumbered
    to the model's rows: the split encoder's ``mini_mlps.<g>`` and the
    mixing weights move with their names; unknown names are refused."""
    cfg = tm.MDMConfig(**BASE, multi_target_cond=True, multi_encoder_type="split")
    sd = reference_state_dict(cfg)
    theirs = GOALS[::-1]  # rows stored as reversed(GOALS) + traj, heading
    G = len(GOALS)
    their_row = lambda g: G - 1 - g if g < G else g  # of our row g

    def stored_key(k):
        m = re.match(r"(embed_target_cond\.mini_mlps\.)(\d+)(\..*)$", k)
        return k if m is None else f"{m.group(1)}{their_row(int(m.group(2)))}{m.group(3)}"

    stored = {stored_key(k): v for k, v in sd.items()}
    back = convert.convert_mdm_state_dict(stored, cfg, theirs)
    for k, v in convert.convert_mdm_state_dict(sd, cfg, GOALS).items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="goal rows"):
        convert.convert_mdm_state_dict(sd, cfg, ["pelvis", "tail"])


def test_load_torch_checkpoint_formats(tmp_path):
    """The wrapped format prefers ``model_avg`` (EMA), as the reference's
    load_saved_model; a raw state dict loads as it is; both as mdm_tpu's
    loader reads them."""
    raw = {"a": torch.ones(2), "b": torch.zeros(3)}
    avg = {"a": torch.full((2,), 2.0), "b": torch.ones(3)}
    torch.save({"model": raw, "model_avg": avg}, tmp_path / "wrapped.pt")
    torch.save(raw, tmp_path / "raw.pt")
    for path, use_ema, want in (("wrapped.pt", True, avg), ("wrapped.pt", False, raw),
                                ("raw.pt", True, raw)):
        got = convert.load_torch_checkpoint(str(tmp_path / path), use_ema)
        ref = jconvert.load_torch_checkpoint(str(tmp_path / path), use_ema)
        assert set(got) == set(ref) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k])
            np.testing.assert_array_equal(ref[k], want[k].numpy())


def test_convert_checkpoint_cli_then_generate(tmp_path, monkeypatch):
    """cli.convert_checkpoint on a wrapped reference checkpoint at a small
    flagship shape writes ckpt_{step:09d} and args.json in the port's format
    (the parameters the raw state dict's, the EMA the model_avg's, the step
    from the file name); cli.generate then loads the run with CLIP assets
    and writes finite joints."""
    monkeypatch.chdir(tmp_path)
    cfg = tm.MDMConfig(latent_dim=64, ff_size=128, num_layers=2, num_heads=4)
    raw, avg = reference_state_dict(cfg, 0), reference_state_dict(cfg, 1)
    ref_dir = tmp_path / "ref_run"
    ref_dir.mkdir()
    torch.save({"model": raw, "model_avg": avg}, ref_dir / "model000000042.pt")
    with open(ref_dir / "args.json", "w") as f:
        json.dump({"dataset": "humanml", "latent_dim": 64, "ff_size": 128, "layers": 2,
                   "num_heads": 4, "arch": "trans_enc", "text_encoder_type": "clip",
                   "cond_mask_prob": 0.1, "use_ema": True, "diffusion_steps": 8,
                   "lr": 1e-4}, f)
    out = tmp_path / "converted"
    path = cc_cli.main(["--torch_ckpt", str(ref_dir / "model000000042.pt"),
                        "--out_dir", str(out)])
    assert find_resume_checkpoint(str(out)) == (path, 42)
    state = torch.load(path, weights_only=True)
    assert state["step"] == 42
    drop = lambda k: k.startswith("clip_model.") or k.endswith(".pe")
    for k, v in raw.items():
        if not drop(k):
            torch.testing.assert_close(state["model"][k], v, rtol=0, atol=0)
    for k, v in state["ema_params"].items():
        torch.testing.assert_close(v, avg[k], rtol=0, atol=0)
    saved = json.loads((out / "args.json").read_text())
    assert saved["use_ema"] is True and saved["layers"] == 2 and saved["latent_dim"] == 64
    assert "lr" not in saved  # only the model's fields are carried

    assets = tmp_path / "assets"
    assets.mkdir()
    clip_pt = tmp_path / "clip.pt"
    torch.save({k: torch.as_tensor(v)
                for k, v in openai_clip_sd(vocab_size=530, embed_dim=512).items()}, clip_pt)
    ct_cli.main(["--clip", str(clip_pt), "--out_dir", str(assets)])
    with gzip.open(assets / "bpe_simple_vocab_16e6.txt.gz", "wt") as f:
        f.write("\n".join(MERGES))
    monkeypatch.setattr(text, "DEFAULT_ASSETS", str(assets))
    gen_cli.main(["--model_path", path, "--text_prompt", "a person walks", "--num_samples", "2",
                  "--num_repetitions", "1", "--motion_length", "1.0", "--device", "cpu",
                  "--output_dir", str(tmp_path / "gen")])
    res = np.load(tmp_path / "gen" / "results.npy", allow_pickle=True).item()
    assert res["motion"].shape[:2] == (2, 20) and np.isfinite(res["motion"]).all()
    assert list(res["text"]) == ["a person walks"] * 2
