"""mdm_tpu_torch's action-to-motion evaluation against mdm_tpu's, on the CPU:

- the GRU MotionDiscriminator at ragged lengths 1..T and the STGCN in both
  layouts (UESTC's ``smpl`` on rot6d, the unconstrained protocol's
  ``openpose_modi15`` on xyz), each within TOL of the largest |output|,
  from mdm_tpu's parameters through the flax bridge, which also carries
  them back bitwise; reference-named state dicts through each package's
  ``convert_*`` give the same outputs;
- ``A2MEvaluation`` + ``evaluate_multi_seed`` on the same loaders (every
  summary entry at 1e-4 relative; accuracies equal) and
  ``evaluate_unconstrained_metrics`` on the same features;
- ``make_a2m_loaders_factory`` on tests/test_cli.py's synthetic HumanAct12
  tree: the host epochs bitwise (lengths, labels, the rot6d passes, the
  generator's masks and actions), the SMPL decode within DECODE_TOL, generation
  pinned by a stub that returns the same features to both;
- one and two ``make_a2m_classifier_step``s of the GRU and of the STGCN
  (tests/test_torch_train_evaluators.py's ``_run_two``: logs at 1e-5, the
  clipped gradients at 1e-5, the parameters after Adam at 1e-6 absolute;
  the STGCN's batch-norm statistics are trained as mdm_tpu's params are);
- a rate-0 a2m train step with the rcxyz, velocity and foot-contact losses
  through SMPL against mdm_tpu's ``make_train_step(get_xyz=...)``
  (tests/test_torch_decoder_train.py's ``step_matches_jax``), on valid
  rot6d features as HumanAct12's are.

The SMPL model is tests/test_torch_smpl.py's small synthetic one."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_cli import synthetic_humanact12  # noqa: E402,F401
from test_torch_a2m import SMALL, _fields  # noqa: E402
from test_torch_a2m import CONFIGS as A2M_CONFIGS  # noqa: E402
from test_torch_decoder_train import step_matches_jax  # noqa: E402
from test_torch_smpl import _arrays  # noqa: E402
from test_torch_train import jax_kernels  # noqa: E402,F401
from test_torch_train_evaluators import _run_two  # noqa: E402

from mdm_tpu import smpl as JSMPL  # noqa: E402
from mdm_tpu.core import rotations as JR  # noqa: E402
from mdm_tpu.eval import a2m_setup as ja2m  # noqa: E402
from mdm_tpu.eval import classifiers as JC  # noqa: E402
from mdm_tpu.eval import harness_a2m as jharness  # noqa: E402
from mdm_tpu.eval import stgcn as JS  # noqa: E402
from mdm_tpu.eval import train_evaluators as jtrain  # noqa: E402
from mdm_tpu_torch import smpl as PSMPL  # noqa: E402
from mdm_tpu_torch.eval import a2m_setup as pa2m  # noqa: E402
from mdm_tpu_torch.eval import classifiers as PC  # noqa: E402
from mdm_tpu_torch.eval import harness_a2m as pharness  # noqa: E402
from mdm_tpu_torch.eval import networks as N  # noqa: E402
from mdm_tpu_torch.eval import stgcn as PS  # noqa: E402
from mdm_tpu_torch.eval import train_evaluators as ptrain  # noqa: E402

TOL = 1e-5  # of the largest |value|: f32 sums in another order
# The loaders' SMPL decode of random features: mdm_tpu's jitted decode (XLA's
# CPU fusions) lands 2e-5 of the largest |joint| off the float64 answer, the
# port and mdm_tpu's eager decode 2.3e-6.
DECODE_TOL = 5e-5
B, T, CLASSES = 6, 24, 5
LENGTHS = np.array([1, T, 7, T - 3, 13, 2])
# Small STGCN widths with each residual kind: none (block 0), identity, a
# strided conv.
STG = dict(channels=((8, 1), (8, 1), (16, 2)))
LAYOUTS = {"smpl": dict(in_channels=6, layout="smpl"),
           "openpose_modi15": dict(in_channels=3, layout="openpose_modi15")}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _leaves_equal(a, b):
    ta, tb = jax.tree_util.tree_structure(a), jax.tree_util.tree_structure(b)
    assert ta == tb, (ta, tb)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@functools.lru_cache(maxsize=None)
def _gru_pair():
    """(mdm_tpu's GRU, its params, the port's GRU with them)."""
    j = JC.MotionDiscriminator(12, 16, 2, CLASSES)
    params = jax.jit(j.init)(jax.random.PRNGKey(0), jnp.zeros((1, T, 12)), jnp.array([T]))
    return j, params, N.load_flax_params(PC.MotionDiscriminator(12, 16, 2, CLASSES), params)


@functools.lru_cache(maxsize=None)
def _stgcn_pair(layout):
    """(mdm_tpu's STGCN, its params, the port's STGCN with them)."""
    cfg = dict(LAYOUTS[layout], num_class=CLASSES, **STG)
    j = JS.STGCN(JS.STGCNConfig(**cfg))
    V = 24 if layout == "smpl" else 15
    params = jax.jit(j.init)(jax.random.PRNGKey(0), jnp.zeros((1, T, V, cfg["in_channels"])))
    # batch-norm statistics off their init, so they are read
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(rng.uniform(0.1, 0.5, a.shape), a.dtype)
        if p[-1].key in ("mean", "var") else a, params)
    return j, params, N.load_flax_params(PS.STGCN(PS.STGCNConfig(**cfg)), params)


def _stgcn_input(rng, layout, n=B):
    V, C = (24, 6) if layout == "smpl" else (15, 3)
    return rng.normal(size=(n, T, V, C)).astype(np.float32)


@pytest.mark.parametrize("case", ["gru", "smpl", "openpose_modi15"])
def test_classifier_matches_jax_and_bridges_both_ways(case):
    rng = np.random.default_rng(len(case))
    if case == "gru":
        j, params, ours = _gru_pair()
        x = rng.normal(size=(B, T, 12)).astype(np.float32)
        ref = jax.jit(j.apply)(params, jnp.asarray(x), jnp.asarray(LENGTHS))
        with torch.no_grad():
            out = ours(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    else:
        j, params, ours = _stgcn_pair(case)
        x = _stgcn_input(rng, case)
        ref = jax.jit(j.apply)(params, jnp.asarray(x))
        with torch.no_grad():
            out = ours(torch.from_numpy(x))
    assert set(out) == set(ref) == {"features", "yhat"}
    for k in ref:
        _close(out[k], ref[k])
    _leaves_equal(N.flax_params(ours), params["params"])


def _reference_state_dict(module):
    """A state dict with the reference's names and shapes: the STGCN's 1x1
    ``fcn`` conv, its graph buffer ``A`` and the batch norms' counters."""
    sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    if isinstance(module, PS.STGCN):
        sd["fcn.weight"] = sd["fcn.weight"][..., None, None]
        sd["A"] = module.A.numpy()
        for k in [k for k in sd if k.endswith("running_mean")]:
            sd[k.replace("running_mean", "num_batches_tracked")] = np.array(7)
    return sd


@pytest.mark.parametrize("case", ["gru", "smpl", "openpose_modi15"])
def test_reference_names_convert_in_both_packages(case):
    rng = np.random.default_rng(3)
    if case == "gru":
        _, _, src = _gru_pair()
        sd = _reference_state_dict(src)
        j, params = JC.MotionDiscriminator(12, 16, 2, CLASSES), \
            JC.convert_motion_discriminator(sd)
        ours = PC.MotionDiscriminator(12, 16, 2, CLASSES)
        ours.load_state_dict(PC.convert_motion_discriminator(sd))
        x = rng.normal(size=(B, T, 12)).astype(np.float32)
        args_j, args_p = (jnp.asarray(x), jnp.asarray(LENGTHS)), (torch.from_numpy(x), LENGTHS)
    else:
        _, _, src = _stgcn_pair(case)
        sd = _reference_state_dict(src)
        cfg = dict(LAYOUTS[case], num_class=CLASSES, **STG)
        j, params = JS.STGCN(JS.STGCNConfig(**cfg)), JS.convert_stgcn(sd, JS.STGCNConfig(**cfg))
        ours = PS.STGCN(PS.STGCNConfig(**cfg))
        ours.load_state_dict(PS.convert_stgcn(sd, PS.STGCNConfig(**cfg)))
        x = _stgcn_input(rng, case)
        args_j, args_p = (jnp.asarray(x),), (torch.from_numpy(x),)
    ref = jax.jit(j.apply)(params, *args_j)
    with torch.no_grad():
        out = ours(*args_p)
    for k in ref:
        _close(out[k], ref[k])


def _loaders(rng, n_batches=2, size=16, dim=12, shift=0.0):
    out = []
    for _ in range(n_batches):
        out.append({"output_xyz": (rng.normal(size=(size, T, dim)) + shift).astype(np.float32),
                    "lengths": rng.integers(1, T + 1, size).astype(np.int32),
                    "y": rng.integers(0, CLASSES, size)})
    return out


@pytest.mark.parametrize("arch", ["gru", "stgcn"])
def test_a2m_evaluation_matches_jax(arch):
    """Both packages' A2MEvaluation over evaluate_multi_seed on the same
    gt / gt2 / gen loaders and the same classifier weights."""
    if arch == "gru":
        j, params, ours = _gru_pair()
        dim = 12
    else:
        j, params, stg = _stgcn_pair("smpl")
        j, ours, dim = ja2m.StgcnAdapter(j), pa2m.StgcnAdapter(stg), 24 * 6
    loaders = {seed: {"gt": _loaders(np.random.default_rng(7), dim=dim),
                      "gt2": _loaders(np.random.default_rng(8), dim=dim),
                      "gen": _loaders(np.random.default_rng(9 + seed), dim=dim, shift=0.5)}
               for seed in range(2)}
    if arch == "stgcn":
        for passes in loaders.values():
            for batches in passes.values():
                for b in batches:
                    b["output_xyz"] = b["output_xyz"].reshape(16, T, 24, 6)
    cfg = dict(num_classes=CLASSES, diversity_times=10, multimodality_times=3)
    ref = jharness.evaluate_multi_seed(
        loaders.__getitem__, jharness.A2MEvaluation(j, params, config=jharness.A2MEvalConfig(**cfg)),
        num_seeds=2)
    got = pharness.evaluate_multi_seed(
        loaders.__getitem__, pharness.A2MEvaluation(ours, config=pharness.A2MEvalConfig(**cfg)),
        num_seeds=2)
    assert got.keys() == ref.keys()
    for k in ref:
        for s in ("mean", "ci"):
            if k.startswith("accuracy"):
                assert got[k][s] == ref[k][s], k
            else:
                np.testing.assert_allclose(got[k][s], ref[k][s], rtol=1e-4, atol=1e-6,
                                           err_msg=k)


def test_unconstrained_metrics_match_jax():
    rng = np.random.default_rng(11)
    gt = rng.normal(size=(40, 16)).astype(np.float32)
    gen = (gt[:30] + 0.3 * rng.normal(size=(30, 16))).astype(np.float32)
    ref = jharness.evaluate_unconstrained_metrics(gen, gt, fast=True)
    got = pharness.evaluate_unconstrained_metrics(gen, gt, fast=True)
    assert got.keys() == ref.keys()
    for k in ("fid", "kid", "kid_std", "precision", "recall"):  # diversity draws unseeded
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-9, err_msg=k)
    assert np.isfinite(got["diversity"])
    assert pharness.UNCONSTRAINED_JOINT_SUBSET == jharness.UNCONSTRAINED_JOINT_SUBSET


class _Stub:
    """A generator for both packages: each sample_features call returns the
    next fixed feature megabatch (numpy for mdm_tpu, a tensor for the port)
    and records the conditioning."""

    def __init__(self, feats, torch_out):
        self.feats, self.torch_out, self.calls = list(feats), torch_out, []
        self.device = torch.device("cpu")

    def sample_features(self, cond, n, frames, key):
        self.calls.append((np.asarray(cond.frames_mask), np.asarray(cond.action), n, frames))
        f = self.feats.pop(0)
        return torch.from_numpy(f) if self.torch_out else f


@pytest.mark.parametrize("dataset", ["uestc", "humanact12"])
def test_a2m_loaders_match_jax(dataset, synthetic_humanact12, tmp_path, monkeypatch):
    """The gt / gt2 / gen megabatches of two seeds: uestc's rot6d input
    (bitwise), humanact12's xyz through each package's SMPL (DECODE_TOL)."""
    from mdm_tpu.data import get_dataset as jget
    from mdm_tpu_torch.data import get_dataset as pget

    monkeypatch.chdir(tmp_path)
    a = _arrays()
    monkeypatch.setattr(JSMPL.SMPLModel, "load", lambda *_, **__: JSMPL.SMPLModel(**a))
    monkeypatch.setattr(PSMPL.SMPLModel, "load", lambda *_, **__: PSMPL.SMPLModel(**a))
    frames, bs = 60, 2
    feats = [np.random.default_rng(s).normal(size=(4, frames, 150)).astype(np.float32)
             for s in range(2)]
    sides = []
    for pkg, get, torch_out in ((ja2m, jget, False), (pa2m, pget, True)):
        ds = get("humanact12", num_frames=frames, data_root=synthetic_humanact12)
        stub = _Stub(feats, torch_out)
        make = pkg.make_a2m_loaders_factory(ds, stub, bs, frames,
                                            pkg.make_a2m_feature_input(dataset), max_batches=2)
        sides.append(([make(seed) for seed in range(2)], stub.calls))
    (ours, ours_calls), (ref, ref_calls) = sides[1], sides[0]
    for o, r in zip(ours, ref):
        assert o.keys() == r.keys() == {"gt", "gt2", "gen"}
        for k in r:
            (ob,), (rb,) = o[k], r[k]
            np.testing.assert_array_equal(ob["lengths"], rb["lengths"])
            np.testing.assert_array_equal(ob["y"], rb["y"])
            if dataset == "uestc":
                np.testing.assert_array_equal(ob["output_xyz"].numpy(), np.asarray(rb["output_xyz"]))
            else:
                assert ob["output_xyz"].shape == (4, frames, 72)
                _close(ob["output_xyz"], rb["output_xyz"], DECODE_TOL)
    for oc, rc in zip(ours_calls, ref_calls):
        for x, y in zip(oc, rc):
            np.testing.assert_array_equal(x, y)


def _classifier_batch(rng, x):
    return {"x": x, "lengths": LENGTHS.astype(np.int32),
            "y": rng.integers(0, CLASSES, B).astype(np.int32)}


@pytest.mark.parametrize("arch", ["gru", "stgcn"])
def test_a2m_classifier_steps_match_jax(arch):
    """Two steps of each package's make_a2m_classifier_step from mdm_tpu's
    initial parameters (lr 1e-4, the per-network clip at 0.5)."""
    rng = np.random.default_rng(12)
    if arch == "gru":
        jclf, pclf, size = JC.MotionDiscriminator(12, 16, 2, CLASSES), \
            PC.MotionDiscriminator(12, 16, 2, CLASSES), 12
        x, ex_j, ex_p = rng.normal(size=(B, T, 12)).astype(np.float32), None, None
    else:
        cfg = dict(LAYOUTS["smpl"], num_class=CLASSES, **STG)
        jclf = ja2m.StgcnAdapter(JS.STGCN(JS.STGCNConfig(**cfg)))
        pclf = pa2m.StgcnAdapter(PS.STGCN(PS.STGCNConfig(**cfg)))
        size, x = 6, _stgcn_input(rng, "smpl")
        ex_j, ex_p = jnp.zeros((1, T, 24, 6)), torch.zeros((1, T, 24, 6))
    batch = _classifier_batch(rng, x)
    jinit, jstep = jtrain.make_a2m_classifier_step(jclf, size, T, jtrain.EvalTrainConfig(lr=1e-4),
                                                   example_x=ex_j)
    pinit, pstep = ptrain.make_a2m_classifier_step(pclf, size, T, ptrain.EvalTrainConfig(lr=1e-4),
                                                   example_x=ex_p)
    _run_two(jinit, jstep, ({k: jnp.asarray(v) for k, v in batch.items()},), {"params": pclf},
             pinit, pstep, ({k: torch.from_numpy(v) for k, v in batch.items()},))


def test_a2m_step_with_geometric_losses_matches_jax(jax_kernels):
    """One rate-0 step of the action-conditioned trans_enc with
    lambda_rcxyz, lambda_vel and lambda_fc at 1, the joints from each
    package's rot2xyz (smpl joints, no translation) on one SMPL model."""
    a = _arrays()
    jm, pm = JSMPL.SMPLModel(**a), PSMPL.SMPLModel(**a)
    jcfg, pcfg = (pkg.Rot2XYZConfig(jointstype="smpl", vertstrans=False) for pkg in (JSMPL, PSMPL))
    jget = lambda f: JSMPL.rot2xyz(jm, f.reshape(f.shape[0], f.shape[1], 25, 6), jcfg)  # noqa
    pget = lambda f: PSMPL.rot2xyz(pm, f.reshape(f.shape[0], f.shape[1], 25, 6), pcfg)  # noqa
    x, mask, fields = _fields("action", seed=3)
    fields.pop("cond_drop")  # the step draws it
    # HumanAct12's features: 24 rotations in rot6d and a translation row
    rng = np.random.default_rng(3)
    q = rng.normal(size=x.shape[:2] + (24, 4))
    rot = np.asarray(JR.quaternion_to_matrix(jnp.asarray(q / np.linalg.norm(q, axis=-1,
                                                                        keepdims=True))))
    x = x.reshape(x.shape[:2] + (25, 6))
    x[:, :, :24] = rot[..., :2, :].reshape(x.shape[:2] + (24, 6))
    x = np.ascontiguousarray(x.reshape(x.shape[:2] + (150,)), np.float32)
    state = step_matches_jax({**SMALL, **A2M_CONFIGS["action"], "dropout": 0.0}, x, mask, fields,
                             loss=dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0,
                                       vel_drop_last_feats=6),
                             jax_kw=dict(get_xyz=jget), port_kw=dict(get_xyz=pget))
    assert state.step == 1
