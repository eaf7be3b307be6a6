"""mdm_tpu_torch.smpl against mdm_tpu.smpl on the CPU, at f32 on a small
synthetic model (tests/test_smpl.py's recipe: 40 vertices, SMPL's 24-joint
kinematic tree, its own 21 keypoint vertex ids and a 9-row extra
regressor): ``lbs`` for every output, ``rot2xyz`` for every joint set and
pose representation and for its mask, ``vertstrans``, ``glob=False``,
``beta`` and flat-input options, each within TOL of the largest |value|;
gradients against ``jax.grad`` (GRAD_TOL); ``SMPLModel.load`` on a pickle
the test writes, array for array; the ``smpl`` joint set runs no skinning,
and the computation keeps the input's dtype."""
import dataclasses
import importlib
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import smpl as J  # noqa: E402
from mdm_tpu.core import rotations as JR  # noqa: E402
from mdm_tpu_torch import smpl as P  # noqa: E402

plbs = importlib.import_module("mdm_tpu_torch.smpl.lbs")  # the package exports the function lbs

V, NJ, NB = 40, 24, 10
TOL = 1e-5  # of the largest |value|: f32 sums in another order
GRAD_TOL = 1e-4  # of the largest |gradient|
PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                    20, 21])


def _arrays(seed=21):
    rng = np.random.default_rng(seed)
    jr = rng.random((NJ, V)) ** 4
    w = rng.random((V, NJ)) ** 4
    return dict(
        v_template=rng.normal(size=(V, 3)).astype(np.float32),
        shapedirs=(rng.normal(size=(V, 3, NB)) * 0.01).astype(np.float32),
        posedirs=(rng.normal(size=((NJ - 1) * 9, V * 3)) * 0.01).astype(np.float32),
        j_regressor=(jr / jr.sum(axis=1, keepdims=True)).astype(np.float32),
        parents=PARENTS,
        lbs_weights=(w / w.sum(axis=1, keepdims=True)).astype(np.float32),
        extra_vertex_ids=np.arange(3, 24, dtype=np.int32),  # the synthetic mesh is small
        j_regressor_extra=rng.random((9, V)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def models():
    a = _arrays()
    return J.SMPLModel(**a), P.SMPLModel(**a)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _rotmats(rng, *shape):
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(JR.quaternion_to_matrix(jnp.asarray(q.astype(np.float32))))


def test_lbs_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(0)
    B = 3
    betas = rng.normal(size=(B, NB)).astype(np.float32)
    go, bp = _rotmats(rng, B), _rotmats(rng, B, NJ - 1)
    transl = rng.normal(size=(B, 3)).astype(np.float32)
    ref = J.lbs(jm, *(jnp.asarray(a) for a in (betas, go, bp, transl)))
    ours = P.lbs(pm, *(torch.from_numpy(a) for a in (betas, go, bp, transl)))
    assert set(ours) == set(ref) == {"vertices", "joints", "smpl", "a2m", "a2mpl", "vibe"}
    for k in ref:
        _close(ours[k], ref[k])
    for name in ref:  # each output alone is the same tensor
        alone = P.lbs(pm, *(torch.from_numpy(a) for a in (betas, go, bp, transl)), outputs=[name])
        assert set(alone) == {name}
        _close(alone[name], ref[name])


def _features(rng, B, T, pose_rep, translation=True, joints=NJ):
    rots = _rotmats(rng, B * T, joints)
    conv = {"rot6d": lambda m: JR.matrix_to_rotation_6d(m), "rotvec": JR.matrix_to_axis_angle,
            "rotquat": JR.matrix_to_quaternion, "rotmat": lambda m: m.reshape(m.shape[:-2] + (9,))}
    x = np.asarray(conv[pose_rep](jnp.asarray(rots))).reshape(B, T, joints, -1)
    if translation:
        row = np.zeros((B, T, 1, x.shape[-1]), np.float32)
        row[..., :3] = rng.normal(size=(B, T, 1, 3))
        x = np.concatenate([x, row], axis=2)
    return x.astype(np.float32)


# Every joint set on rot6d, every other pose representation on the smpl set
# and on a set read from the mesh, and the options.
CASES = {f"{jt}-rot6d": (dict(jointstype=jt), {}) for jt in P.JOINTSTYPES}
CASES.update({f"{jt}-{rep}": (dict(jointstype=jt, pose_rep=rep), {})
              for jt, rep in (("smpl", "rotvec"), ("smpl", "rotquat"), ("smpl", "rotmat"),
                              ("vibe", "rotquat"), ("a2mpl", "rotmat"))})
CASES.update({
    "smpl-mask-vertstrans": (dict(vertstrans=True), {"mask": True}),
    "a2m-mask": (dict(jointstype="a2m"), {"mask": True}),
    "vibe-vertstrans": (dict(jointstype="vibe", vertstrans=True), {}),
    "smpl-no-glob": (dict(glob=False), {}),
    "vertices-no-glob-rotvec": (dict(jointstype="vertices", glob=False, pose_rep="rotvec",
                                     translation=False), {}),
    "smpl-beta": (dict(beta=0.7), {}),
    "a2mpl-betas": (dict(jointstype="a2mpl"), {"betas": True}),
    "smpl-flat": (dict(vertstrans=True), {"flat": True}),
    "xyz": (dict(pose_rep="xyz"), {}),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_rot2xyz_matches_jax(models, case):
    jm, pm = models
    fields, opts = CASES[case]
    rng = np.random.default_rng(len(case))
    B, T = 2, 5
    rep = fields.get("pose_rep", "rot6d")
    x = (rng.normal(size=(B, T, NJ, 3)).astype(np.float32) if rep == "xyz"
         else _features(rng, B, T, rep, fields.get("translation", True),
                        NJ if fields.get("glob", True) else NJ - 1))
    if opts.get("flat"):
        x = x.reshape(B, T, -1)
    kw_j, kw_p = {}, {}
    if opts.get("mask"):
        mask = np.array([[True] * T, [True, True, False, False, False]])
        kw_j["mask"], kw_p["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if opts.get("betas"):
        betas = rng.normal(size=(B * T, NB)).astype(np.float32)
        kw_j["betas"], kw_p["betas"] = jnp.asarray(betas), torch.from_numpy(betas)
    ref = J.rot2xyz(jm, jnp.asarray(x), J.Rot2XYZConfig(**fields), **kw_j)
    ours = P.rot2xyz(pm, torch.from_numpy(x), P.Rot2XYZConfig(**fields), **kw_p)
    _close(ours, ref)
    if opts.get("mask"):
        assert not ours[1, 2:].any()


@pytest.mark.parametrize("jointstype", ["smpl", "vertices", "a2m"])
def test_rot2xyz_gradients_match_jax(models, jointstype):
    """d(sum(w * rot2xyz(x))) / dx, the geometric losses' path, vs jax.grad."""
    jm, pm = models
    rng = np.random.default_rng(3)
    x = _features(rng, 2, 4, "rot6d")
    cfg = dict(jointstype=jointstype, vertstrans=jointstype == "smpl")
    out_shape = jax.eval_shape(lambda a: J.rot2xyz(jm, a, J.Rot2XYZConfig(**cfg)), x).shape
    w = rng.normal(size=out_shape).astype(np.float32)
    ref = jax.jit(jax.grad(lambda a: jnp.sum(J.rot2xyz(jm, a, J.Rot2XYZConfig(**cfg)) * w)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (P.rot2xyz(pm, xt, P.Rot2XYZConfig(**cfg)) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, ref, GRAD_TOL)


def test_smpl_runs_no_skinning(models, monkeypatch):
    """The smpl joint set reads only the kinematic chain: no _skin call (no
    [N, V, ...] tensor); the mesh-keypoint sets and the vertices skin once."""
    _, pm = models
    calls = []
    skin = plbs._skin
    monkeypatch.setattr(plbs, "_skin", lambda *a: calls.append(a[1].shape[0]) or skin(*a))
    x = torch.from_numpy(_features(np.random.default_rng(4), 2, 3, "rot6d"))
    P.rot2xyz(pm, x, P.Rot2XYZConfig(jointstype="smpl"))
    assert calls == []
    for jt in ("a2m", "vertices"):
        P.rot2xyz(pm, x, P.Rot2XYZConfig(jointstype=jt))
    assert calls == [6, 6]


def test_computes_in_the_inputs_dtype(models):
    _, pm = models
    x = torch.from_numpy(_features(np.random.default_rng(5), 1, 2, "rot6d"))
    for dtype in (torch.float64, torch.bfloat16):
        assert P.rot2xyz(pm, x.to(dtype)).dtype == dtype
    _close(P.rot2xyz(pm, x.double()), P.rot2xyz(pm, x))


def test_load_matches_jax(tmp_path):
    """The same pickle (sparse regressor, uint32 kintree with its root
    sentinel, 300 shape directions cut to 10, faces) and extra regressor
    through both packages' load, array for array."""
    import scipy.sparse

    a = _arrays(seed=8)
    kintree = np.stack([PARENTS, np.arange(NJ)]).astype(np.uint32)
    kintree[0, 0] = 2 ** 32 - 1
    data = {"v_template": a["v_template"].astype(np.float64),
            "shapedirs": np.random.default_rng(9).normal(size=(V, 3, 300)),
            "posedirs": a["posedirs"].T.reshape(V, 3, -1).astype(np.float64),
            "J_regressor": scipy.sparse.csc_matrix(a["j_regressor"].astype(np.float64)),
            "kintree_table": kintree, "weights": a["lbs_weights"].astype(np.float64),
            "f": np.arange(30).reshape(10, 3).astype(np.uint32)}
    path, extra = tmp_path / "SMPL_NEUTRAL.pkl", tmp_path / "J_regressor_extra.npy"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    np.save(extra, a["j_regressor_extra"])
    ref = J.SMPLModel.load(str(path), str(extra))
    ours = P.SMPLModel.load(str(path), str(extra))
    assert ours.parents[0] == -1 and ours.num_betas == NB
    for f in dataclasses.fields(J.SMPLModel):
        want, got = getattr(ref, f.name), getattr(ours, f.name)
        if want is None:
            assert got is None, f.name
            continue
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    with pytest.raises(FileNotFoundError):
        P.SMPLModel.load(str(tmp_path / "absent.pkl"))
