"""mdm_tpu_torch.eval.train_evaluators against mdm_tpu's on the CPU: one
and two steps of the decomposition, match (fixed shift, ragged lengths) and
length-estimation trainers from the same (bridged) parameters — the logged
losses at 1e-5, the clipped gradients Adam took at 1e-5 (recovered on both
sides from Adam's first moment, (m_t - 0.9 m_{t-1}) / 0.1), the parameters
after Adam at 1e-6 absolute (lr 1e-4) — and the npy layout both ways.
Parameters are compared where Adam's first moment stood above HELD of its
tensor's largest at every step so far (chip_smoke.py phase 7's rule):
elsewhere the gradient is at rounding level (1e-10 against 1e-2), and Adam,
which divides it by its own size, moves it by anything up to lr on either
side; those gradients are still held to 1e-5 above."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.eval import networks as J  # noqa: E402
from mdm_tpu.eval import train_evaluators as jtrain  # noqa: E402
from mdm_tpu_torch.eval import networks as P  # noqa: E402
from mdm_tpu_torch.eval import train_evaluators as ptrain  # noqa: E402

B, T, L, WORD, D = 6, 24, 9, 32, 27
CFG = dict(lr=1e-4)
HELD = 2e-3


def _batch(rng):
    m_lens = np.array([24, 8, 24, 13, 4, 17], np.int32)  # ties: the sort must be stable
    return {"word_embs": rng.normal(size=(B, L, WORD)).astype(np.float32),
            "pos_onehot": rng.normal(size=(B, L, 15)).astype(np.float32),
            "cap_lens": np.array([9, 1, 4, 9, 6, 2]), "m_lens": m_lens,
            "motions": rng.normal(size=(B, T, D)).astype(np.float32), "shift": 2}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flax_moments(modules, opt):
    """{name: tree of Adam's first moment} in mdm_tpu's layout."""
    out = {}
    for name, m in modules.items():
        tree = {}
        for path, t, kind in m.flax_layout():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = P._to_torch_layout(opt.state[t]["exp_avg"].numpy().copy(), kind)
        out[name] = tree
    return out


def _close(a, b, **tol):
    ta, tb = jax.tree_util.tree_structure(a), jax.tree_util.tree_structure(b)
    assert ta == tb, (ta, tb)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


def _grads(mu, prev):
    """The step's gradient from Adam's first moments (b1 = 0.9)."""
    if prev is None:
        return jax.tree_util.tree_map(lambda m: m / 0.1, mu)
    return jax.tree_util.tree_map(lambda m, p: (m - 0.9 * p) / 0.1, mu, prev)


def _run_two(jinit, jstep, jargs, pmods, pinit, pstep, pargs):
    """Two steps on both sides from mdm_tpu's initial parameters; checks
    logs, clipped gradients and parameters after each. ``pmods`` names the
    port's networks as mdm_tpu's parameter tree does ("est": the whole tree)."""
    tree = lambda t: {"est": t} if list(pmods) == ["est"] else t
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    params, opt = pinit(0)
    for name, m in pmods.items():
        P.load_flax_params(m, tree(jparams)[name])
    prev_j = prev_p = held = None
    for _ in range(2):
        jparams, jopt, jlogs = jstep(jparams, jopt, *jargs)
        params, opt, logs = pstep(params, opt, *pargs)
        assert logs.keys() == jlogs.keys()
        for k in jlogs:
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-5, atol=1e-6)
        mu_j, mu_p = tree(jopt[0].mu), _flax_moments(pmods, opt)
        _close(_grads(mu_p, prev_p), _grads(mu_j, prev_j), rtol=1e-5, atol=1e-5)
        above = jax.tree_util.tree_map(
            lambda m: np.abs(np.asarray(m)) > HELD * np.abs(np.asarray(m)).max(), mu_j)
        held = above if held is None else jax.tree_util.tree_map(np.logical_and, held, above)
        _close(*(jax.tree_util.tree_map(lambda p, h: np.asarray(p)[h], t, held)
                 for t in ({k: P.flax_params(m) for k, m in pmods.items()}, tree(jparams))),
               rtol=0, atol=1e-6)
        prev_j, prev_p = mu_j, mu_p


def test_decomp_steps_match_jax():
    rng = np.random.default_rng(0)
    motions = rng.normal(size=(B, T, D)).astype(np.float32)
    cfg = jtrain.EvalTrainConfig(**CFG)
    jinit, jstep = jtrain.make_decomp_step(J.MovementConvEncoder(32, 32),
                                           J.MovementConvDecoder(32, D), cfg)
    enc, dec = P.MovementConvEncoder(D - 4, 32, 32), P.MovementConvDecoder(32, 32, D)
    pinit, pstep = ptrain.make_decomp_step(enc, dec, ptrain.EvalTrainConfig(**CFG))
    _run_two(jinit, jstep, (jnp.asarray(motions),), {"enc": enc, "dec": dec}, pinit, pstep,
             (torch.from_numpy(motions),))


def test_match_steps_match_jax():
    rng = np.random.default_rng(1)
    batch = _batch(rng)
    cfg = jtrain.EvalTrainConfig(**CFG)
    jmov = J.MovementConvEncoder(32, 32)
    mov_params = jmov.init(jax.random.PRNGKey(9), jnp.zeros((1, 8, D - 4)))["params"]
    jinit, jstep = jtrain.make_match_step(J.TextEncoderBiGRUCo(WORD, 15, 24, 16),
                                          J.MotionEncoderBiGRUCo(32, 40, 16), jmov, cfg)
    text, motion = P.TextEncoderBiGRUCo(WORD, 15, 24, 16), P.MotionEncoderBiGRUCo(32, 40, 16)
    mov = P.load_flax_params(P.MovementConvEncoder(D - 4, 32, 32), mov_params)
    pinit, pstep = ptrain.make_match_step(text, motion, mov, ptrain.EvalTrainConfig(**CFG))
    _run_two(lambda k: jinit(k, dim_word=WORD), jstep,
             (mov_params, {k: jnp.asarray(v) for k, v in batch.items()}),
             {"text": text, "motion": motion}, pinit, pstep, (_torch_batch(batch),))


def test_length_est_steps_match_jax():
    rng = np.random.default_rng(2)
    batch = _batch(rng)
    del batch["motions"], batch["shift"]
    cfg = jtrain.EvalTrainConfig(**CFG)
    jinit, jstep = jtrain.make_length_est_step(J.MotionLenEstimatorBiGRU(WORD, 15, 24, 7, 32), cfg)
    est = P.MotionLenEstimatorBiGRU(WORD, 15, 24, 7, 32)
    pinit, pstep = ptrain.make_length_est_step(est, ptrain.EvalTrainConfig(**CFG))
    _run_two(lambda k: jinit(k, dim_word=WORD), jstep,
             ({k: jnp.asarray(v) for k, v in batch.items()},), {"est": est}, pinit, pstep,
             (_torch_batch(batch),))


def test_clip_is_per_network():
    """Each network's gradient is scaled by min(1, 0.5 / max(norm, 1e-6))
    on its own (mdm_tpu's _clip_per_network)."""
    nets = {"a": torch.nn.Linear(3, 2), "b": torch.nn.Linear(2, 1)}
    for scale, net in zip((10.0, 1e-3), nets.values()):
        for p in net.parameters():
            p.grad = torch.full_like(p, scale)
    grads = {k: {n: p.grad.numpy().copy() for n, p in net.named_parameters()}
             for k, net in nets.items()}
    ptrain._clip_per_network(nets, 0.5)
    want = jtrain._clip_per_network(grads, 0.5)
    for k, net in nets.items():
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k][n]), rtol=1e-6)


def test_npy_layout_round_trips(tmp_path):
    """A file the port saves loads with mdm_tpu's loader into the same tree
    that the port's modules hold, and mdm_tpu's file loads into them."""
    est = P.reset_seeded(P.MotionLenEstimatorBiGRU(WORD, 15, 24, 7, 32), 3)
    path = str(tmp_path / "len.npy")
    ptrain.save_evaluator_params(path, {"estimator": est, "note": "x"})
    loaded = jtrain.load_evaluator_params(path)
    assert loaded["note"] == "x"
    _close(loaded["estimator"], P.flax_params(est), rtol=0, atol=0)
    jparams = J.MotionLenEstimatorBiGRU(WORD, 15, 24, 7, 32).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, WORD)), jnp.zeros((1, 4, 15)), jnp.array([4]))
    jtrain.save_evaluator_params(path, {"estimator": jparams["params"]})
    P.load_flax_params(est, ptrain.load_evaluator_params(path)["estimator"])
    _close(P.flax_params(est), jparams["params"], rtol=0, atol=0)


def test_init_draws_mdm_tpus_distributions():
    """init(seed) draws each tensor from mdm_tpu's initialiser (flax's
    lecun-normal kernels over the flax fan-in, zero biases, LayerNorm ones,
    N(0, 1) GRU states): each tensor's spread agrees with flax's draw within
    five standard errors of a sample spread (1 / sqrt(2 n) relative)."""
    cases = [(J.MovementConvDecoder(64, D), P.MovementConvDecoder(48, 64, D), (1, 4, 48)),
             (J.MovementConvEncoder(64, 48), P.MovementConvEncoder(D - 4, 64, 48), (1, 8, D - 4)),
             (J.MotionEncoderBiGRUCo(48, 96, 32), P.MotionEncoderBiGRUCo(48, 96, 32), None)]
    for jmod, pmod, shape in cases:
        args = ((jnp.zeros(shape),) if shape else (jnp.zeros((1, 4, 48)), jnp.array([4])))
        want = jmod.init(jax.random.PRNGKey(0), *args)["params"]
        got = P.flax_params(P.reset_seeded(pmod, 0))
        for a, b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)):
            path, a = a
            b = np.asarray(b)
            assert a.shape == b.shape, path
            if b.std() == 0:
                np.testing.assert_array_equal(a, b, err_msg=str(path))
            else:
                np.testing.assert_allclose(a.std(), b.std(), rtol=5 / np.sqrt(2 * a.size),
                                           err_msg=str(path))
