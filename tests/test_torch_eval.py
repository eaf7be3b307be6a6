"""mdm_tpu_torch.eval against mdm_tpu.eval on the CPU: the evaluator
networks (each module at f32, B=5, T=24 and 25, ragged lengths 1..T,
widths 16-64, 1e-5), the flax-layout bridge both ways, the reference's
torch names against torch's own packed bidirectional GRU, EvaluatorWrapper
on one finest.npy (either package's) and on a reference finest.tar, the
metrics (1e-6), and the harness: every summary entry of `evaluation` on the
same batches and generated features (1e-4), its stamps, the ground-truth
rows on the synthetic tree, the multimodality loader's prompts and the
DiP branch's lengths."""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_cli import synthetic_humanml  # noqa: E402,F401

from mdm_tpu.eval import evaluator as jevaluator  # noqa: E402
from mdm_tpu.eval import harness as jharness  # noqa: E402
from mdm_tpu.eval import metrics as JM  # noqa: E402
from mdm_tpu.eval import networks as J  # noqa: E402
from mdm_tpu.eval import train_evaluators as jtrain  # noqa: E402
from mdm_tpu_torch.eval import evaluator, harness  # noqa: E402
from mdm_tpu_torch.eval import metrics as PM  # noqa: E402
from mdm_tpu_torch.eval import networks as P  # noqa: E402
from mdm_tpu_torch.eval import train_evaluators as ptrain  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B = 5
WORD, POS, DIM_POSE = 32, 15, 27  # small GloVe width; the movement encoder sees 23 features


def _lengths(T):
    return np.array([1, T, 7, T - 3, 13])


def _text_inputs(rng, T, word=WORD):
    return (rng.normal(size=(B, T, word)).astype(np.float32),
            rng.normal(size=(B, T, POS)).astype(np.float32), _lengths(T))


# (jax module, port module, inputs) at widths 16-64
CASES = {
    "movement_encoder": lambda rng, T: (J.MovementConvEncoder(48, 32), P.MovementConvEncoder(
        23, 48, 32), (rng.normal(size=(B, T, 23)).astype(np.float32),)),
    "movement_decoder": lambda rng, T: (J.MovementConvDecoder(48, 27), P.MovementConvDecoder(
        32, 48, 27), (rng.normal(size=(B, T, 32)).astype(np.float32),)),
    "text_encoder": lambda rng, T: (J.TextEncoderBiGRUCo(WORD, POS, 40, 16), P.TextEncoderBiGRUCo(
        WORD, POS, 40, 16), _text_inputs(rng, T)),
    "motion_encoder": lambda rng, T: (J.MotionEncoderBiGRUCo(24, 64, 16), P.MotionEncoderBiGRUCo(
        24, 64, 16), (rng.normal(size=(B, T, 24)).astype(np.float32), _lengths(T))),
    "length_estimator": lambda rng, T: (J.MotionLenEstimatorBiGRU(WORD, POS, 32, 12, 64),
                                        P.MotionLenEstimatorBiGRU(WORD, POS, 32, 12, 64),
                                        _text_inputs(rng, T)),
}


def _port(module, *inputs):
    with torch.no_grad():
        return module(*(torch.from_numpy(np.asarray(a)) for a in inputs)).numpy()


@pytest.mark.parametrize("T", [24, 25])
@pytest.mark.parametrize("name", sorted(CASES))
def test_network_matches_jax(name, T):
    rng = np.random.default_rng(T)
    jmod, pmod, inputs = CASES[name](rng, T)
    params = jmod.init(jax.random.PRNGKey(T), *(jnp.asarray(a) for a in inputs))
    P.load_flax_params(pmod, params)
    np.testing.assert_allclose(_port(pmod, *inputs), np.asarray(jmod.apply(params, *inputs)),
                               **TOL)
    # the bridge back gives mdm_tpu's tree bitwise
    back = P.flax_params(pmod)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params["params"])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def _reference_text_state_dict(H, out, word=WORD, seed=0):
    """A state dict under the reference TextEncoderBiGRUCo's names, from
    torch's own modules: nn.GRU(bidirectional=True) and its Sequential."""
    torch.manual_seed(seed)
    mods = {"pos_emb": torch.nn.Linear(POS, word), "input_emb": torch.nn.Linear(word, H),
            "gru": torch.nn.GRU(H, H, batch_first=True, bidirectional=True),
            "output_net": torch.nn.Sequential(torch.nn.Linear(2 * H, H), torch.nn.LayerNorm(H),
                                              torch.nn.LeakyReLU(0.2), torch.nn.Linear(H, out))}
    sd = {f"{k}.{n}": v for k, m in mods.items() for n, v in m.state_dict().items()}
    sd["hidden"] = torch.randn(2, 1, H)
    return sd, mods


def test_reference_names_load_and_match_a_packed_gru():
    """A state dict with the reference's names loads with load_state_dict;
    the masked two-call GRU equals torch's bidirectional GRU over a packed
    sequence (the reference's pack_padded_sequence path), and mdm_tpu's
    converter of the same dict."""
    H, out, T = 24, 16, 11
    sd, mods = _reference_text_state_dict(H, out)
    ours = P.TextEncoderBiGRUCo(WORD, POS, H, out)
    ours.load_state_dict(sd)
    rng = np.random.default_rng(3)
    w, p, lens = _text_inputs(rng, T)
    lens = np.array([1, T, 7, 8, 3])
    got = _port(ours, w, p, lens)
    with torch.no_grad():
        x = mods["input_emb"](torch.from_numpy(w) + mods["pos_emb"](torch.from_numpy(p)))
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, torch.from_numpy(lens),
                                                         batch_first=True, enforce_sorted=False)
        _, h_n = mods["gru"](packed, sd["hidden"].repeat(1, B, 1))
        want = mods["output_net"](torch.cat([h_n[0], h_n[1]], dim=-1)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jparams = J.convert_text_encoder({k: v.numpy() for k, v in sd.items()})
    np.testing.assert_allclose(got, np.asarray(J.TextEncoderBiGRUCo(WORD, POS, H, out).apply(
        jparams, w, p, lens)), **TOL)


def _jax_evaluator_params(seed=0, mov=32, text_hidden=24, coemb=16, mot_hidden=48,
                          dim_pose=DIM_POSE):
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "movement": J.MovementConvEncoder(mov, mov).init(k[0], jnp.zeros((1, 8, dim_pose - 4))),
        "text": J.TextEncoderBiGRUCo(300, 15, text_hidden, coemb).init(
            k[1], jnp.zeros((1, 4, 300)), jnp.zeros((1, 4, 15)), jnp.array([4])),
        "motion": J.MotionEncoderBiGRUCo(mov, mot_hidden, coemb).init(
            k[2], jnp.zeros((1, 4, mov)), jnp.array([4])),
    }


def _eval_batch(rng, n=B, T=24, L=10):
    return dict(word_embs=rng.normal(size=(n, L, 300)).astype(np.float32),
                pos_ohot=rng.normal(size=(n, L, 15)).astype(np.float32),
                cap_lens=rng.integers(1, L + 1, size=n),
                motions=rng.normal(size=(n, T, DIM_POSE)).astype(np.float32),
                m_lens=rng.integers(4, T + 1, size=n))


def _finest(root, name="t2m"):
    d = os.path.join(root, name, "text_mot_match", "model")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "finest.npy")


def _both_embed(jw, pw, batch):
    a = jw.get_co_embeddings(*batch.values())
    b = pw.get_co_embeddings(*batch.values())
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, **TOL)
    np.testing.assert_allclose(pw.get_motion_embeddings(batch["motions"], batch["m_lens"]),
                               jw.get_motion_embeddings(batch["motions"], batch["m_lens"]), **TOL)


@pytest.mark.parametrize("writer", ["mdm_tpu", "mdm_tpu_torch"])
def test_wrapper_loads_either_packages_finest_npy(tmp_path, writer):
    """One finest.npy, written by either package, sizes and loads both
    wrappers (the port's on device="cpu") and they embed the same."""
    params = _jax_evaluator_params()
    path = _finest(str(tmp_path))
    if writer == "mdm_tpu":
        jtrain.save_evaluator_params(path, params)
    else:
        mods = evaluator.EvaluatorWrapper._modules_from_params(params)
        for m in mods:
            P.reset_seeded(m, 5)  # weights of its own, not the file mdm_tpu wrote
        ptrain.save_evaluator_params(path, {k: {"params": m} for k, m in
                                            zip(("movement", "text", "motion"), mods)})
    pw = evaluator.EvaluatorWrapper("humanml", str(tmp_path), device="cpu")
    jw = jevaluator.EvaluatorWrapper("humanml", str(tmp_path))
    assert pw.degraded is None and jw.degraded is None
    assert pw.motion_enc.input_size == 32 and pw.text_enc.gru.hidden_size == 24
    _both_embed(jw, pw, _eval_batch(np.random.default_rng(1)))


def test_wrapper_loads_a_reference_finest_tar(tmp_path):
    """finest.tar with the reference's names (torch.save of the three state
    dicts) loads in the port by load_state_dict and in mdm_tpu by its
    converters, and both embed the same."""
    H, coemb, mov, mot_hidden = 24, 16, 32, 48
    text_sd, _ = _reference_text_state_dict(H, coemb, word=300, seed=1)
    torch.manual_seed(2)
    movement = torch.nn.Sequential(torch.nn.Conv1d(DIM_POSE - 4, mov, 4, 2, 1), torch.nn.Dropout(0.2),
                                   torch.nn.LeakyReLU(0.2), torch.nn.Conv1d(mov, mov, 4, 2, 1))
    mov_sd = {f"main.{k}": v for k, v in movement.state_dict().items()}
    mov_sd.update({f"out_net.{k}": v for k, v in torch.nn.Linear(mov, mov).state_dict().items()})
    gru = torch.nn.GRU(mot_hidden, mot_hidden, batch_first=True, bidirectional=True)
    mot_sd = {f"gru.{k}": v for k, v in gru.state_dict().items()}
    mot_sd.update({f"input_emb.{k}": v for k, v in torch.nn.Linear(mov, mot_hidden).state_dict().items()})
    out_net = torch.nn.Sequential(torch.nn.Linear(2 * mot_hidden, mot_hidden),
                                  torch.nn.LayerNorm(mot_hidden), torch.nn.LeakyReLU(0.2),
                                  torch.nn.Linear(mot_hidden, coemb))
    mot_sd.update({f"output_net.{k}": v for k, v in out_net.state_dict().items()})
    mot_sd["hidden"] = torch.randn(2, 1, mot_hidden)
    path = _finest(str(tmp_path)).replace(".npy", ".tar")
    torch.save({"movement_encoder": mov_sd, "text_encoder": text_sd, "motion_encoder": mot_sd},
               path)
    pw = evaluator.EvaluatorWrapper("humanml", str(tmp_path), device="cpu")
    jw = jevaluator.EvaluatorWrapper("humanml", str(tmp_path))
    _both_embed(jw, pw, _eval_batch(np.random.default_rng(2)))


def test_random_init_is_stamped_degraded(tmp_path):
    pw = evaluator.EvaluatorWrapper("kit", str(tmp_path), device="cpu")
    assert pw.degraded == "random-init-evaluator-encoders" == jevaluator.EvaluatorWrapper(
        "kit", str(tmp_path)).degraded
    assert pw.movement_enc.main[0].in_channels == 247


@pytest.mark.parametrize("path", ["wrapper", "train_step"])
def test_evaluators_run_without_tf32(tmp_path, path):
    """The evaluators and their training steps compute in float32 with TF32
    off inside (cuDNN allows it by default) and leave the process's
    settings as they found them."""
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    saved = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    try:
        if path == "wrapper":
            jtrain.save_evaluator_params(_finest(str(tmp_path)), _jax_evaluator_params())
            pw = evaluator.EvaluatorWrapper("humanml", str(tmp_path), device="cpu")
            mods = (pw.movement_enc, pw.text_enc, pw.motion_enc)
            run = lambda: pw.get_co_embeddings(*_eval_batch(np.random.default_rng(3)).values())
        else:
            mods = (P.MovementConvEncoder(DIM_POSE - 4, 16, 16), P.MovementConvDecoder(16, 16, DIM_POSE))
            init, step = ptrain.make_decomp_step(*mods)
            motions = torch.from_numpy(np.random.default_rng(3).normal(
                size=(2, 8, DIM_POSE)).astype(np.float32))
            run = lambda: step(*init(0), motions)
        for m in mods:
            m.register_forward_pre_hook(lambda *_: seen.append(flags()))
        run()
        assert len(seen) == len(mods) and set(seen) == {(False, False)}
        assert flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(64, 16)), rng.normal(size=(48, 16)) + 0.3
    close = dict(rtol=1e-6, atol=1e-6)
    for name in ("euclidean_distance_matrix", "calculate_matching_score",
                 "calculate_R_precision", "precision_and_recall"):
        np.testing.assert_allclose(getattr(PM, name)(a[:48], b), getattr(JM, name)(a[:48], b),
                                   **close)
    stats = [m.calculate_activation_statistics(x) for m in (PM, JM) for x in (a, b)]
    np.testing.assert_allclose(PM.calculate_frechet_distance(*stats[0], *stats[1]),
                               JM.calculate_frechet_distance(*stats[2], *stats[3]), **close)
    np.testing.assert_allclose(PM.calculate_kid(a, b, n_subsets=5, subset_size=20),
                               JM.calculate_kid(a, b, n_subsets=5, subset_size=20), **close)
    mm = rng.normal(size=(6, 10, 16))
    for name, x, times in (("calculate_diversity", a, 30), ("calculate_multimodality", mm, 5)):
        np.testing.assert_allclose(
            getattr(PM, name)(x, times, rng=np.random.default_rng(11)),
            getattr(JM, name)(x, times, rng=np.random.default_rng(11)), **close)


class _Stub:
    """A generator stub for both packages: each sample_features call returns
    the next of a fixed list of feature batches (numpy for mdm_tpu, CPU
    tensors for the port) and records its prompts' conditioning."""

    def __init__(self, feats, torch_out, autoregressive=False):
        from types import SimpleNamespace

        self.feats, self.torch_out, self.calls = list(feats), torch_out, []
        self.config = SimpleNamespace(autoregressive=autoregressive)
        self.device = torch.device("cpu")

    def _next(self, cond, B, T):
        self.calls.append((B, T, np.asarray(cond.frames_mask).copy()))
        f = self.feats.pop(0)
        assert f.shape[:2] == (B, T)
        return torch.from_numpy(f) if self.torch_out else f

    def sample_features(self, cond, B, T, key):
        return self._next(cond, B, T)

    def sample_autoregressive(self, cond, B, key, required_frames):
        return self._next(cond, B, required_frames)


def _gt_batches(rng, n_batches=3, T=24, glove=True):
    out = []
    for _ in range(n_batches):
        lengths = rng.integers(8, T + 1, size=32).astype(np.int32)
        b = {"x": rng.normal(size=(32, T, DIM_POSE)).astype(np.float32), "lengths": lengths,
             "mask": np.arange(T)[None] < lengths[:, None],
             "text": [f"prompt {i}" for i in rng.integers(0, 100, size=32)],
             "sent_lens": rng.integers(1, 11, size=32).astype(np.int32)}
        if glove:
            b["word_embeddings"] = rng.normal(size=(32, 10, 300)).astype(np.float32)
            b["pos_one_hots"] = rng.normal(size=(32, 10, 15)).astype(np.float32)
        out.append(b)
    return out


def _embed(texts):
    return {"text_embed": np.zeros((len(texts), 8), np.float32)}


@pytest.mark.parametrize("glove", [True, False])
def test_evaluation_matches_jax(tmp_path, glove):
    """Both packages' `evaluation` on the same ground-truth batches, the
    same generated features through each GeneratedMotionLoader (with the
    model -> evaluator renormalization) and one finest.npy: every summary
    entry at 1e-4 relative, the stamps identical."""
    rng = np.random.default_rng(5)
    jtrain.save_evaluator_params(_finest(str(tmp_path)), _jax_evaluator_params(seed=3))
    gt = _gt_batches(rng, glove=glove)
    reps = 2
    feats = [rng.normal(size=(32, 24, DIM_POSE)).astype(np.float32) for _ in range(3 * reps)]
    stats = dict(model_mean=rng.normal(size=DIM_POSE).astype(np.float32),
                 model_std=rng.uniform(0.5, 2, DIM_POSE).astype(np.float32),
                 eval_mean=rng.normal(size=DIM_POSE).astype(np.float32),
                 eval_std=rng.uniform(0.5, 2, DIM_POSE).astype(np.float32))
    summaries = []
    for pkg, wrapper, stub in (
            (harness, evaluator.EvaluatorWrapper("humanml", str(tmp_path), device="cpu"),
             _Stub(feats, True)),
            (jharness, jevaluator.EvaluatorWrapper("humanml", str(tmp_path)), _Stub(feats, False))):
        summaries.append(pkg.evaluation(
            wrapper, lambda: iter(gt),
            {"vald": lambda rep, pkg=pkg, stub=stub: pkg.GeneratedMotionLoader(
                stub, gt, _embed, seed=rep, **stats)},
            pkg.EvalConfig(replication_times=reps, log_file=str(tmp_path / f"{pkg.__name__}.log"))))
    ours, ref = summaries
    assert ours.keys() == ref.keys()
    assert ours["comparable"] == ref["comparable"] == glove
    assert ours.get("degraded_reasons") == ref.get("degraded_reasons")
    for metric in ("Matching Score", "R_precision", "FID", "Diversity", "MultiModality"):
        assert ours[metric].keys() == ref[metric].keys()
        for name in ref[metric]:
            for k in ("mean", "ci"):
                np.testing.assert_allclose(ours[metric][name][k], ref[metric][name][k],
                                           rtol=1e-4, atol=1e-6)
    assert os.path.exists(tmp_path / "mdm_tpu_torch.eval.harness.log")


def _write_glove(root):
    words = ["sos", "eos", "unk", "a", "person", "walk"]
    vecs = np.random.default_rng(7).normal(size=(len(words), 300)).astype(np.float32)
    np.save(os.path.join(root, "our_vab_data.npy"), vecs)
    with open(os.path.join(root, "our_vab_words.pkl"), "wb") as f:
        pickle.dump(words, f)
    with open(os.path.join(root, "our_vab_idx.pkl"), "wb") as f:
        pickle.dump({w: i for i, w in enumerate(words)}, f)


def test_ground_truth_rows_on_the_synthetic_tree(tmp_path, synthetic_humanml, monkeypatch):
    """Real batches of tests/test_cli.py's HumanML3D tree with a GloVe
    vocabulary, through each package's loader and evaluator: the ground
    truth's rows agree (R-precision exactly)."""
    from mdm_tpu.data import BatchIterator as JBatches
    from mdm_tpu.data import WordVectorizer as JWords
    from mdm_tpu.data import get_dataset as jget
    from mdm_tpu_torch.data import BatchIterator, WordVectorizer, get_dataset

    monkeypatch.chdir(tmp_path)
    glove = tmp_path / "glove"
    glove.mkdir()
    _write_glove(str(glove))
    jtrain.save_evaluator_params(_finest(str(tmp_path)), _jax_evaluator_params(seed=4, dim_pose=263))
    summaries = []
    for pkg, wrapper, batches, words, dataset in (
            (harness, evaluator.EvaluatorWrapper("humanml", str(tmp_path), device="cpu"),
             BatchIterator, WordVectorizer, get_dataset),
            (jharness, jevaluator.EvaluatorWrapper("humanml", str(tmp_path)), JBatches, JWords,
             jget)):
        ds = dataset("humanml", split="test", hml_mode="eval", data_root=synthetic_humanml)
        ds.w_vectorizer = words(str(glove), "our_vab")
        gt = list(batches(ds, 32, shuffle=True, seed=0, infinite=False))
        assert "word_embeddings" in gt[0]
        summaries.append(pkg.evaluation(wrapper, lambda gt=gt: iter(gt), {},
                                        pkg.EvalConfig(replication_times=2)))
    ours, ref = summaries
    assert ours["comparable"] and ref["comparable"]
    np.testing.assert_array_equal(ours["R_precision"]["ground truth"]["mean"],
                                  ref["R_precision"]["ground truth"]["mean"])
    for metric in ("Matching Score", "FID", "Diversity"):
        np.testing.assert_allclose(ours[metric]["ground truth"]["mean"],
                                   ref[metric]["ground truth"]["mean"], rtol=1e-4, atol=1e-6)


def test_mm_loader_draws_the_same_prompts(tmp_path):
    rng = np.random.default_rng(9)
    gt = _gt_batches(rng, n_batches=4)
    feats = [rng.normal(size=(3, 24, DIM_POSE)).astype(np.float32) for _ in range(3)]
    seen = []
    for pkg, torch_out in ((harness, True), (jharness, False)):
        stub = _Stub(feats, torch_out)
        prompts = []
        embed = lambda texts: prompts.append(list(texts)) or _embed(texts)
        out = list(pkg.MMGeneratedLoader(stub, gt, embed, mm_num_samples=3, mm_num_repeats=3,
                                         seed=2))
        seen.append((prompts, [np.asarray(b["lengths"]) for b in out],
                     [c[2] for c in stub.calls], [np.asarray(b["x"]) for b in out]))
    (p_ours, l_ours, m_ours, x_ours), (p_ref, l_ref, m_ref, x_ref) = seen
    assert p_ours == p_ref and len(p_ours) == 3
    for a, b in zip(l_ours + m_ours + x_ours, l_ref + m_ref + x_ref):
        np.testing.assert_array_equal(a, b)


def test_dip_branch_generates_to_orig_lengths():
    """Autoregressive (DiP) eval: each batch generates to its longest
    original length and scores with orig_lengths, as mdm_tpu's loader."""
    rng = np.random.default_rng(10)
    batches = []
    for _ in range(2):
        b = _gt_batches(rng, n_batches=1, T=8)[0]
        b["prefix"] = rng.normal(size=(32, 4, DIM_POSE)).astype(np.float32)
        b["orig_lengths"] = rng.integers(20, 41, size=32).astype(np.int32)
        batches.append(b)
    feats = [rng.normal(size=(32, int(b["orig_lengths"].max()), DIM_POSE)).astype(np.float32)
             for b in batches]
    outs = []
    for pkg, torch_out in ((harness, True), (jharness, False)):
        stub = _Stub(feats, torch_out, autoregressive=True)
        outs.append((list(pkg.GeneratedMotionLoader(stub, batches, _embed)), stub.calls))
    (ours, calls), (ref, jcalls) = outs
    assert [c[:2] for c in calls] == [c[:2] for c in jcalls]
    for o, r, b in zip(ours, ref, batches):
        np.testing.assert_array_equal(o["lengths"], b["orig_lengths"])
        np.testing.assert_array_equal(o["lengths"], r["lengths"])
        np.testing.assert_array_equal(o["x"].numpy(), np.asarray(r["x"]))
