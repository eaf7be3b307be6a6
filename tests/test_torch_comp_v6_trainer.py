"""mdm_tpu_torch.eval.train_t2m_generator (the T2M baseline's training)
against mdm_tpu's on the CPU, at tests/test_comp_v6_trainer.py's small
widths. The parameters cross as mdm_tpu's comp_v6 npy tree (drawn by
mdm_tpu's init_comp_v6_params, held by the port's comp_v6_modules) and the
reparameterisation noise is injected on both sides, since jax.random cannot
be replayed in torch (a step's noise is JAX's own split_eps of its key).

Tolerances (float32 on both sides, the sums and GRU recurrences in other
orders): the forward's outputs and the four losses at 1e-5 absolute plus
1e-4 relative; each TRAINABLE network's gradient at 1e-5 absolute plus 1e-3
relative; after one Adam step (lr 1e-3), the clipped gradient Adam took
(recovered from its first moment) at the same, and the parameters at 1e-6
absolute where that gradient stands above HELD of its tensor's largest
(elsewhere Adam divides rounding noise by its own size and moves it by up to
lr either way: tests/test_torch_train_evaluators.py's rule). The curriculum
batches are bitwise equal. The generators trained by each package's
curriculum are compared through both packages' t2m_generate at 1e-5.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.eval import t2m_generator as JG  # noqa: E402
from mdm_tpu.eval import train_t2m_generator as JT  # noqa: E402
from mdm_tpu_torch.eval import t2m_generator as G  # noqa: E402
from mdm_tpu_torch.eval import train_t2m_generator as T  # noqa: E402
from test_cli import synthetic_humanml  # noqa: E402,F401

DIM_WORD, DIM_POS = 30, 15
TEXT_HIDDEN = 16
DIM_ATT, DIM_Z = 24, 8
PRI_HIDDEN = DEC_HIDDEN = 20
MOV_LATENT = 12
DIM_POSE = 11
UNIT = 4
SEQ_LEN = 10
MOV_LEN = 4                      # schedule_len: motions are MOV_LEN*UNIT frames
WIDTHS = dict(lr=1e-3, unit_length=UNIT, dim_pose=DIM_POSE, dim_word=DIM_WORD,
              dim_pos_ohot=DIM_POS, dim_text_hidden=TEXT_HIDDEN, dim_att_vec=DIM_ATT,
              dim_z=DIM_Z, dim_pri_hidden=PRI_HIDDEN, dim_dec_hidden=DEC_HIDDEN,
              dim_movement_latent=MOV_LATENT, dim_movement_hidden=18,
              lambda_rec_mov=0.7, lambda_rec_mot=1.3)  # unequal: the swapped names show
JCFG, CFG = JT.CompV6TrainConfig(**WIDTHS), T.CompV6TrainConfig(**WIDTHS)
FWD = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=1e-5, rtol=1e-3)
HELD = 2e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _close(a, b, **tol):
    ta, tb = jax.tree_util.tree_structure(a), jax.tree_util.tree_structure(b)
    assert ta == tb, (ta, tb)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), err_msg=str(path), **tol)


@pytest.fixture(scope="module")
def tree():
    """mdm_tpu's scratch parameters, as its npy tree."""
    return _np_tree(JT.init_comp_v6_params(jax.random.PRNGKey(0), JCFG))


def _batch(seed=3, B=3):
    rng = np.random.default_rng(seed)
    return {"word_embs": rng.normal(size=(B, SEQ_LEN, DIM_WORD)).astype(np.float32),
            "pos_onehot": rng.normal(size=(B, SEQ_LEN, DIM_POS)).astype(np.float32),
            # ragged captions below the padded length: the batch-max mask matters
            "cap_lens": np.asarray([8, 6, 4][:B], np.int32),
            "motions": rng.normal(size=(B, MOV_LEN * UNIT, DIM_POSE)).astype(np.float32),
            # curriculum semantics: true lengths >= the cropped length
            "m_lens": np.asarray([24, 20, 16][:B], np.int32)}


def _eps(key, B=3):
    """JAX's split_eps (make_comp_v6_step) of ``key``."""
    k1, k2 = jax.random.split(key)
    shape = (MOV_LEN, B, DIM_Z)
    return tuple(np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in (k1, k2))


def _jax_forward(params, batch, tf, eps, use_prior_z=False):
    return JT.comp_v6_forward(params, *(jnp.asarray(batch[k]) for k in (
        "word_embs", "pos_onehot", "cap_lens", "motions", "m_lens")), jnp.asarray(tf),
        *(jnp.asarray(e) for e in eps), UNIT, use_prior_z=use_prior_z)


def _port_forward(mods, batch, tf, eps, use_prior_z=False):
    return T.comp_v6_forward(mods, *(torch.as_tensor(batch[k]) for k in (
        "word_embs", "pos_onehot", "cap_lens", "motions", "m_lens")), tf,
        *(torch.from_numpy(e) for e in eps), UNIT, use_prior_z=use_prior_z)


def _as_numpy(out):
    fm, fmov, mov, stats = out
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in (fm, fmov, mov, *stats)]


@pytest.mark.parametrize("tf, use_prior_z", [(0.0, False), (1.0, False), (0.0, True)])
def test_forward_and_losses_match_jax(tree, tf, use_prior_z):
    batch, eps = _batch(), _eps(jax.random.PRNGKey(5))
    want = _jax_forward(tree, batch, tf, eps, use_prior_z)
    got = _port_forward(T.comp_v6_modules(tree, "cpu"), batch, tf, eps, use_prior_z)
    assert got[0].shape == (3, MOV_LEN * UNIT, DIM_POSE) and got[3][0].shape == (MOV_LEN, 3, DIM_Z)
    for x, y in zip(_as_numpy(got), _as_numpy(want)):
        np.testing.assert_allclose(x, y, **FWD)
    _, jlogs = JT.comp_v6_losses(*want[:2], jnp.asarray(batch["motions"]), want[2], want[3], JCFG)
    _, logs = T.comp_v6_losses(*got[:2], torch.from_numpy(batch["motions"]), got[2], got[3], CFG)
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), **FWD)


def _grad_tree(mods):
    """The networks' gradients in the comp_v6 tree layout (zero where None)."""
    g = copy.deepcopy(mods)
    with torch.no_grad():
        for p, q in zip(mods.parameters(), g.parameters()):
            q.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return T.comp_v6_tree(g)


def test_gradients_match_jax_grad(tree):
    """loss_gen.backward() against jax.grad of comp_v6_forward +
    comp_v6_losses, per TRAINABLE network, at teacher forcing 0 (the
    movement chain detached) and 1; no gradient reaches mov_enc."""
    batch, eps = _batch(4), _eps(jax.random.PRNGKey(6))
    for tf in (0.0, 1.0):
        def loss_fn(trainable):
            out = _jax_forward({**trainable, "mov_enc": tree["mov_enc"]}, batch, tf, eps)
            return JT.comp_v6_losses(*out[:2], jnp.asarray(batch["motions"]), out[2], out[3],
                                     JCFG)[0]

        want = jax.grad(loss_fn)({k: tree[k] for k in JT.TRAINABLE})
        mods = T.comp_v6_modules(tree, "cpu")
        out = _port_forward(mods, batch, tf, eps)
        T.comp_v6_losses(*out[:2], torch.from_numpy(batch["motions"]), out[2], out[3],
                         CFG)[0].backward()
        got = _grad_tree(mods)
        for k in T.TRAINABLE:
            _close(got[k], _np_tree(want[k]), **GRAD)
        assert all(p.grad is None and not p.requires_grad for p in mods["mov_enc"].parameters())


def _held(grads, held):
    """Per leaf: where |grad| stood above HELD of the leaf's largest."""
    now = jax.tree_util.tree_map(lambda g: np.abs(g) > HELD * np.abs(g).max(), grads)
    return now if held is None else jax.tree_util.tree_map(np.logical_and, held, now)


def _moments(mods, opt):
    """Adam's first moments in the comp_v6 tree layout."""
    g = copy.deepcopy(mods)
    with torch.no_grad():
        for p, q in zip(mods.parameters(), g.parameters()):
            st = opt.state.get(p, {})
            q.copy_(st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p))
    return T.comp_v6_tree(g)


def test_two_steps_and_val_match_jax(tree):
    """make_comp_v6_step twice from mdm_tpu's parameters with JAX's noise
    replayed (teacher forcing 1, then 0): the logs, the clipped gradients
    Adam took (mov_dec in its lr * 0.1 group: the check holds both groups'
    updates) and the parameters after each step; then val_step with
    mdm_tpu's PRNGKey(0) noise injected."""
    jinit, jstep, jval = JT.make_comp_v6_step(JCFG)
    init_opt, step, val_step = T.make_comp_v6_step(CFG)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = jinit(jparams)
    mods = T.comp_v6_modules(tree, "cpu")
    opt = init_opt(mods)
    assert [g["lr"] for g in opt.param_groups] == [1e-3, 1e-4]
    prev_j = prev_p = held = None
    for i, tf in enumerate((1.0, 0.0)):
        batch, key = _batch(10 + i), jax.random.PRNGKey(20 + i)
        jparams, jopt, jlogs = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()},
                                     key, jnp.asarray(tf))
        mods, opt, logs = step(mods, opt, batch, None, tf, eps=tuple(
            torch.from_numpy(e) for e in _eps(key)))
        for k in jlogs:
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), **FWD)
        mu_j = _np_tree({k: jopt.inner_states["mov_dec" if k == "mov_dec" else "main"]
                         .inner_state[0].mu[k] for k in JT.TRAINABLE})
        mu_p = {k: v for k, v in _moments(mods, opt).items() if k in T.TRAINABLE}
        g_j = jax.tree_util.tree_map(lambda m, p: (m - 0.9 * p) / 0.1, mu_j,
                                     prev_j if prev_j is not None else
                                     jax.tree_util.tree_map(np.zeros_like, mu_j))
        g_p = jax.tree_util.tree_map(lambda m, p: (m - 0.9 * p) / 0.1, mu_p,
                                     prev_p if prev_p is not None else
                                     jax.tree_util.tree_map(np.zeros_like, mu_p))
        _close(g_p, g_j, **GRAD)
        held = _held(g_j, held)
        after = T.comp_v6_tree(mods)
        for (path, x), y, h in zip(
                jax.tree_util.tree_leaves_with_path({k: after[k] for k in T.TRAINABLE}),
                jax.tree_util.tree_leaves(_np_tree({k: jparams[k] for k in JT.TRAINABLE})),
                jax.tree_util.tree_leaves(held)):
            np.testing.assert_allclose(x[h], y[h], atol=1e-6, err_msg=str(path))
        _close(after["mov_enc"], tree["mov_enc"], atol=0, rtol=0)  # frozen
        prev_j, prev_p = mu_j, mu_p
    batch = _batch(30)
    jlogs = jval(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    logs = val_step(mods, batch, eps=tuple(torch.from_numpy(e)
                                           for e in _eps(jax.random.PRNGKey(0))))
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), **FWD)
    assert torch.isfinite(val_step(mods, batch)["loss_gen"])  # its own seeded noise


def test_init_tree_matches_jax_layout():
    """init_comp_v6_params: mdm_tpu's keys, shapes and dtypes; the laws'
    constants (zero biases, unit LayerNorm scales) exactly, the uniform
    GRU draws inside +-1/sqrt(H), the xavier draws' scale; the same tree
    at one seed twice, and a different one at another."""
    want = _np_tree(JT.init_comp_v6_params(jax.random.PRNGKey(1), JCFG))
    got = T.init_comp_v6_params(torch.Generator().manual_seed(1), CFG)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        name = jax.tree_util.keystr(path)
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32, name
        if name.endswith("['bias']") or name.endswith("['scale']"):
            np.testing.assert_array_equal(x, y, err_msg=name)
    for cell in ("seq_post", "seq_dec"):
        assert np.abs(got[cell]["gru_0"]["w_hh"]).max() <= 1 / np.sqrt(PRI_HIDDEN)
    k = got["seq_dec"]["emb"]["fc"]["kernel"]  # xavier: std sqrt(2 / (fan_in + fan_out))
    assert abs(k.std() / np.sqrt(2.0 / sum(k.shape)) - 1) < 0.1
    _close(T.init_comp_v6_params(torch.Generator().manual_seed(1), CFG), got, atol=0, rtol=0)
    other = T.init_comp_v6_params(torch.Generator().manual_seed(2), CFG)
    assert not np.array_equal(other["att_layer"]["w_q"]["kernel"],
                              got["att_layer"]["w_q"]["kernel"])


def test_movement_params_from_flax_equal():
    """The decomp stage's flax tree -> mov_enc / mov_dec, equal to
    mdm_tpu's; the port's generator decodes with them as mdm_tpu's."""
    from mdm_tpu.eval.networks import MovementConvDecoder, MovementConvEncoder

    x = jax.random.normal(jax.random.PRNGKey(3), (2, 8, DIM_POSE - 4))
    enc_p = MovementConvEncoder(hidden_size=18, output_size=MOV_LATENT).init(
        jax.random.PRNGKey(4), x)["params"]
    lat = jnp.zeros((2, 2, MOV_LATENT))
    dec_p = MovementConvDecoder(hidden_size=18, output_size=DIM_POSE).init(
        jax.random.PRNGKey(5), lat)["params"]
    got = T.movement_params_from_flax(_np_tree(enc_p), _np_tree(dec_p))
    want = JT.movement_params_from_flax(enc_p, dec_p)
    for a, b in zip(got, want):
        _close(a, _np_tree(b), atol=0, rtol=0)
    tree = T.init_comp_v6_params(torch.Generator().manual_seed(0), CFG, *got)
    _close(tree["mov_dec"], _np_tree(want[1]), atol=0, rtol=0)


def _synthetic_batches(schedule_len, split):
    """test_comp_v6_trainer.py's make_batches, as numpy."""
    n = 2 if split == "train" else 1
    local = np.random.default_rng(schedule_len * 100 + (split == "val"))
    for _ in range(n):
        yield {"word_embs": local.normal(size=(2, SEQ_LEN, DIM_WORD)).astype(np.float32),
               "pos_onehot": local.normal(size=(2, SEQ_LEN, DIM_POS)).astype(np.float32),
               "cap_lens": np.asarray([6, 4], np.int32),
               "motions": local.normal(size=(2, schedule_len * UNIT, DIM_POSE)).astype(
                   np.float32),
               "m_lens": np.asarray([schedule_len * UNIT + 4, schedule_len * UNIT], np.int32)}


def test_curriculum_save_and_both_loaders(tmp_path, tree):
    """Two schedule lengths of train_comp_v6 (callbacks after each), then
    save_comp_v6_params; the port's load_comp_v6 and mdm_tpu's reader of
    its own .npy (``np.load(...).item()``, save_comp_v6_params' docstring:
    mdm_tpu's load_comp_v6 reads the reference's .tar only) give the same
    tree, and both packages' t2m_generate on it agree at 1e-5 with one
    noise."""
    cfg = T.CompV6TrainConfig(**{**WIDTHS, "schedule_start": 2, "schedule_end": 3,
                                 "max_sub_epoch": 2, "early_stop_count": 1})
    seen, lines = [], []
    params = T.train_comp_v6(T.comp_v6_modules(tree, "cpu"), _synthetic_batches, cfg,
                             generator=torch.Generator().manual_seed(1),
                             rng=np.random.default_rng(1), log=lines.append,
                             on_length_done=lambda sl, p: seen.append(sl))
    assert seen == [2, 3] and lines and all("val=" in line for line in lines)
    path = T.save_comp_v6_params(str(tmp_path / "comp_v6.npy"), params)
    ours, theirs = G.load_comp_v6(path), np.load(path, allow_pickle=True).item()
    _close(ours, theirs, atol=0, rtol=0)
    assert not np.array_equal(ours["seq_dec"]["out_fc2"]["kernel"],
                              tree["seq_dec"]["out_fc2"]["kernel"])  # it trained
    _close(ours["mov_enc"], tree["mov_enc"], atol=0, rtol=0)
    rng = np.random.default_rng(8)
    w = rng.normal(size=(2, SEQ_LEN, DIM_WORD)).astype(np.float32)
    p = rng.normal(size=(2, SEQ_LEN, DIM_POS)).astype(np.float32)
    eps = rng.normal(size=(4, 2, DIM_Z)).astype(np.float32)
    cl, ml = np.asarray([4, 7]), np.asarray([16, 12])
    want = JG.t2m_generate(theirs, jnp.asarray(w), jnp.asarray(p), jnp.asarray(cl),
                           jnp.asarray(ml), mov_len=4, eps=jnp.asarray(eps), unit_length=UNIT,
                           dim_pose=DIM_POSE)
    got = G.t2m_generate(G.CompV6(ours, "cpu"), *(torch.from_numpy(a) for a in (w, p, cl, ml)),
                         4, eps=torch.from_numpy(eps), unit_length=UNIT, dim_pose=DIM_POSE)
    assert got.shape == (2, 16, DIM_POSE) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_curriculum_batches_bitwise(tmp_path, synthetic_humanml):
    """make_curriculum_batches on test_cli.py's tree (train and its test
    split for validation, a GloVe vocabulary): the same batches as
    mdm_tpu's, call for call over two lengths and both splits (one rng
    across the calls), and max_batches."""
    from mdm_tpu.data import WordVectorizer as JW
    from mdm_tpu.data.loader import get_dataset as jget
    from mdm_tpu_torch.data import WordVectorizer
    from mdm_tpu_torch.data.loader import get_dataset
    from mdm_tpu_torch.scripts.quality_rehearsal import write_glove

    glove = write_glove(str(tmp_path), ["a", "person", "walk"])
    sources = []
    for get, wv, tag in ((get_dataset, WordVectorizer, "port"), (jget, JW, "jax")):
        dss = [get("humanml", split=s, hml_mode="eval", data_root=synthetic_humanml,
                   cache_dir=str(tmp_path / tag)) for s in ("train", "test")]
        for ds in dss:
            ds.w_vectorizer = wv(glove, "our_vab")
        sources.append(dss)
    cfg = dict(unit_length=UNIT)
    ours = T.make_curriculum_batches(*sources[0], 2, T.CompV6TrainConfig(**cfg), seed=3)
    ref = JT.make_curriculum_batches(*sources[1], 2, JT.CompV6TrainConfig(**cfg), seed=3)
    n = 0
    for sl, split in ((10, "train"), (10, "val"), (11, "train"), (30, "train"), (10, "train")):
        a, b = list(ours(sl, split)), list(ref(sl, split))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            n += 1
            assert x.keys() == y.keys()
            for k in y:
                v = np.asarray(y[k])
                assert x[k].numpy().tobytes() == v.astype(x[k].numpy().dtype).tobytes(), k
                assert x[k].shape == v.shape
            assert x["motions"].shape[1] == sl * UNIT and x["word_embs"].abs().sum() > 0
    assert n >= 4
    capped = T.make_curriculum_batches(*sources[0], 1, T.CompV6TrainConfig(**cfg), seed=3,
                                       max_batches=1)
    assert len(list(capped(10, "train"))) == 1


def test_comp_v6_stage_end_to_end(tmp_path, synthetic_humanml, monkeypatch):
    """python -m mdm_tpu_torch.cli.train_evaluators --stage comp_v6
    --device cpu on the decomp stage's movement autoencoder: the .npy the
    port's load_comp_v6 and mdm_tpu's np.load read alike, its movement
    networks the decomp stage's, driving both packages' t2m_generate at the
    published widths."""
    from mdm_tpu_torch.cli import train_evaluators as cli
    from mdm_tpu_torch.eval.train_evaluators import load_evaluator_params

    monkeypatch.chdir(tmp_path)
    decomp, path = str(tmp_path / "decomp.npy"), str(tmp_path / "comp_v6.npy")
    common = ["--data_dir", synthetic_humanml, "--batch_size", "2", "--device", "cpu"]
    cli.main(["--stage", "decomp", "--save_path", decomp, "--num_steps", "1", *common])
    cli.main(["--stage", "comp_v6", "--save_path", path, "--decomp_path", decomp,
              "--schedule_start", "2", "--schedule_end", "2", "--max_sub_epoch", "1",
              "--max_batches", "1", *common])
    ours, theirs = G.load_comp_v6(path), np.load(path, allow_pickle=True).item()
    _close(ours, theirs, atol=0, rtol=0)
    assert set(ours) == set(T.TRAINABLE) | {"mov_enc"}
    stage = load_evaluator_params(decomp)
    enc, _ = T.movement_params_from_flax(stage["enc"], stage["dec"])
    _close(ours["mov_enc"], enc, atol=0, rtol=0)
    assert ours["seq_dec"]["gru_0"]["w_hh"].shape == (1024, 3 * 1024)
    out = G.t2m_generate(G.CompV6(ours, "cpu"), torch.zeros(2, 22, 300), torch.zeros(2, 22, 15),
                         torch.tensor([4, 4]), torch.tensor([8, 8]), 2)
    want = JG.t2m_generate(theirs, jnp.zeros((2, 22, 300)), jnp.zeros((2, 22, 15)),
                           jnp.asarray([4, 4]), jnp.asarray([8, 8]), mov_len=2)
    assert out.shape == (2, 8, 263) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
