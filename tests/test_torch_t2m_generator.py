"""mdm_tpu_torch.eval.t2m_generator (the T2M baseline) against mdm_tpu's on
the CPU: random weights under the reference's module names go through both
packages' converters (equal trees) into each package's t2m_generate, with
the noise injected (zero and seeded normal): features at 1e-5. The .tar
checkpoints and mdm_tpu's comp_v6 / length-estimator .npy load in the port,
and the baseline loaders draw the same lengths from one default_rng."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.eval import t2m_generator as JG  # noqa: E402
from mdm_tpu.eval import train_evaluators as jtrain  # noqa: E402
from mdm_tpu_torch.eval import t2m_generator as G  # noqa: E402

# A tiny Comp_v6 (the published structure, scaled down; tests/test_t2m_generator.py's)
DIM_WORD, DIM_POS = 30, 15
TEXT_HIDDEN = 16           # text_size = 32
DIM_ATT, DIM_Z = 24, 8
PRI_HIDDEN = DEC_HIDDEN = 20
MOV_LATENT, MOV_HIDDEN = 12, 18
DIM_POSE = 11              # mov enc/dec run on dim_pose - 4 = 7
UNIT, SEQ_LEN, MOV_LEN = 4, 10, 10


def _sd(**mods):
    return {f"{k}.{n}" if k else n: v for k, m in mods.items()
            for n, v in (m.state_dict() if isinstance(m, torch.nn.Module) else {"": m}).items()}


def _cells(n, in_size, hidden):
    return torch.nn.ModuleList([torch.nn.GRUCell(in_size, hidden) for _ in range(n)])


def _emb(in_size, hidden):
    return torch.nn.Sequential(torch.nn.Linear(in_size, hidden), torch.nn.LayerNorm(hidden),
                               torch.nn.LeakyReLU(0.2))


def reference_state(seed=0):
    """CompTrainerV6's checkpoint dict under the reference's module names
    (modules.py:123-310), from torch's own layers."""
    torch.manual_seed(seed)
    text_size = 2 * TEXT_HIDDEN
    pri_in, dec_in = DIM_ATT + MOV_LATENT, DIM_ATT + DIM_Z + MOV_LATENT
    lin = torch.nn.Linear
    return {
        "text_enc": {**_sd(pos_emb=lin(DIM_POS, DIM_WORD), input_emb=lin(DIM_WORD, TEXT_HIDDEN),
                           gru=torch.nn.GRU(TEXT_HIDDEN, TEXT_HIDDEN, batch_first=True,
                                            bidirectional=True)),
                     "hidden": torch.randn(2, 1, TEXT_HIDDEN)},
        "seq_pri": _sd(emb=_emb(pri_in, PRI_HIDDEN), z2init=lin(text_size, PRI_HIDDEN),
                       gru=_cells(1, PRI_HIDDEN, PRI_HIDDEN), mu_net=lin(PRI_HIDDEN, DIM_Z),
                       logvar_net=lin(PRI_HIDDEN, DIM_Z)),
        "seq_dec": _sd(emb=_emb(dec_in, DEC_HIDDEN), z2init=lin(text_size, DEC_HIDDEN),
                       gru=_cells(1, DEC_HIDDEN, DEC_HIDDEN),
                       output=torch.nn.Sequential(lin(DEC_HIDDEN, DEC_HIDDEN),
                                                  torch.nn.LayerNorm(DEC_HIDDEN),
                                                  torch.nn.LeakyReLU(0.2),
                                                  lin(DEC_HIDDEN, MOV_LATENT))),
        "att_layer": _sd(W_q=lin(DEC_HIDDEN, DIM_ATT), W_k=lin(text_size, DIM_ATT, bias=False),
                         W_v=lin(text_size, DIM_ATT)),
        "mov_enc": _sd(main=torch.nn.Sequential(
            torch.nn.Conv1d(DIM_POSE - 4, MOV_HIDDEN, 4, 2, 1), torch.nn.Dropout(0.2),
            torch.nn.LeakyReLU(0.2), torch.nn.Conv1d(MOV_HIDDEN, MOV_LATENT, 4, 2, 1)),
            out_net=lin(MOV_LATENT, MOV_LATENT)),
        "mov_dec": _sd(main=torch.nn.Sequential(
            torch.nn.ConvTranspose1d(MOV_LATENT, MOV_HIDDEN, 4, 2, 1), torch.nn.LeakyReLU(0.2),
            torch.nn.ConvTranspose1d(MOV_HIDDEN, DIM_POSE, 4, 2, 1)),
            out_net=lin(DIM_POSE, DIM_POSE)),
    }


def _numpy_state(state):
    return {k: {kk: vv.detach().numpy() for kk, vv in v.items()} for k, v in state.items()}


def _same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def params():
    state = _numpy_state(reference_state())
    ours = G.convert_comp_v6(state)
    _same_tree(ours, JG.convert_comp_v6(state))
    return ours


@pytest.mark.parametrize("noise", ["zero", "normal"])
def test_t2m_generate_matches_jax(params, noise):
    rng = np.random.default_rng(4)
    B = 4
    w = rng.normal(size=(B, SEQ_LEN, DIM_WORD)).astype(np.float32)
    p = rng.normal(size=(B, SEQ_LEN, DIM_POS)).astype(np.float32)
    cap_lens = np.array([10, 4, 1, 7])
    m_lens = np.array([40, 12, 4, 28])
    eps = (np.zeros if noise == "zero" else lambda s: rng.normal(size=s))(
        (MOV_LEN, B, DIM_Z)).astype(np.float32)
    want = np.asarray(JG.t2m_generate(params, jnp.asarray(w), jnp.asarray(p),
                                      jnp.asarray(cap_lens), jnp.asarray(m_lens), MOV_LEN,
                                      eps=jnp.asarray(eps), unit_length=UNIT, dim_pose=DIM_POSE))
    got = G.t2m_generate(G.CompV6(params, "cpu"), *(torch.from_numpy(a) for a in (
        w, p, cap_lens, m_lens)), MOV_LEN, eps=torch.from_numpy(eps), unit_length=UNIT,
        dim_pose=DIM_POSE).numpy()
    assert got.shape == (B, MOV_LEN * UNIT, DIM_POSE)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[1, 12:].any() and got[1, :12].any()


def _len_estimator_state(seed=1):
    torch.manual_seed(seed)
    H, nd, out = 16, 32, MOV_LEN
    gru = torch.nn.GRU(H, H, batch_first=True, bidirectional=True)
    output = torch.nn.Sequential(
        torch.nn.Linear(2 * H, nd), torch.nn.LayerNorm(nd), torch.nn.LeakyReLU(0.2),
        torch.nn.Linear(nd, nd // 2), torch.nn.LayerNorm(nd // 2), torch.nn.LeakyReLU(0.2),
        torch.nn.Linear(nd // 2, nd // 4), torch.nn.LayerNorm(nd // 4), torch.nn.LeakyReLU(0.2),
        torch.nn.Linear(nd // 4, out))
    return {**_sd(pos_emb=torch.nn.Linear(DIM_POS, DIM_WORD),
                  input_emb=torch.nn.Linear(DIM_WORD, H), gru=gru, output=output),
            "hidden": torch.randn(2, 1, H)}, dict(word_size=DIM_WORD, hidden_size=H,
                                                  output_size=out, nd=nd)


def test_checkpoints_load_from_tar_and_npy(tmp_path, params):
    """The reference's .tar (both packages' loaders agree), mdm_tpu's
    comp_v6 .npy, and the length estimator's .tar and the length stage's
    .npy."""
    tar = str(tmp_path / "latest.tar")
    torch.save({**reference_state(), "ep": 3}, tar)
    _same_tree(G.load_comp_v6(tar), JG.load_comp_v6(tar))
    npy = str(tmp_path / "comp_v6.npy")
    np.save(npy, params)
    _same_tree(G.load_comp_v6(npy), params)
    sd, _ = _len_estimator_state()
    est_tar = str(tmp_path / "length_est.tar")
    torch.save({"estimator": sd}, est_tar)
    est = G.load_len_estimator(est_tar)
    _same_tree(est, JG.load_len_estimator(est_tar))
    est_npy = str(tmp_path / "length.npy")
    jtrain.save_evaluator_params(est_npy, {"estimator": est["params"]})
    _same_tree(G.load_len_estimator(est_npy), est)


def _gt_batches(rng, n=3, size=32):
    return [{"word_embeddings": rng.normal(size=(size, SEQ_LEN, DIM_WORD)).astype(np.float32),
             "pos_one_hots": rng.normal(size=(size, SEQ_LEN, DIM_POS)).astype(np.float32),
             "sent_lens": rng.integers(1, SEQ_LEN + 1, size=size).astype(np.int32),
             "lengths": np.full(size, 40, np.int32)} for _ in range(n)]


def test_baseline_loaders_draw_the_same_lengths(tmp_path, params):
    """Both packages' loaders, on the same estimator weights and prompts,
    draw the same lengths from one default_rng (the noise streams differ:
    a PRNGKey there, a torch.Generator here), with finite features of the
    loader's shape; the multimodality loaders pick the same prompts."""
    sd, kwargs = _len_estimator_state()
    tar = str(tmp_path / "length_est.tar")
    torch.save({"estimator": sd}, tar)
    gt = _gt_batches(np.random.default_rng(6))
    common = dict(unit_length=UNIT, dim_pose=DIM_POSE, max_motion_length=MOV_LEN * UNIT,
                  min_mov_length=3)
    ours = G.T2MBaselineGenerator(params, G.load_len_estimator(tar), device="cpu", **common)
    ref = JG.T2MBaselineGenerator(params, JG.load_len_estimator(tar), len_est_kwargs=kwargs,
                                  **common)
    for loader in ("T2MBaselineLoader", "T2MBaselineMMLoader"):
        kw = dict(mm_num_samples=4, mm_num_repeats=3) if "MM" in loader else {}
        a = list(getattr(G, loader)(ours, gt, seed=2, **kw))
        b = list(getattr(JG, loader)(ref, gt, seed=2, **kw))
        assert len(a) == len(b) == (4 if kw else 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["lengths"], y["lengths"])
            assert tuple(x["x"].shape) == np.shape(y["x"]) and torch.isfinite(x["x"]).all()
            frames = np.arange(MOV_LEN * UNIT)[None, :] < x["lengths"][:, None]
            assert not x["x"].numpy()[~frames].any()
