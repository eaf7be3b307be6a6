"""mdm_tpu_torch.core's HumanML3D encoder, rotation decode and quaternion
helpers against mdm_tpu's on the CPU.

The joints are seeded: a random-walk of local rotations and root through
each skeleton's forward kinematics (tests/test_geometry.py's motion), T = 40
frames. Tolerances: the quaternion helpers at 1e-6 (float32, the same
formulas; qfix exactly); the encoder's features at 1e-5 and its
normalized positions at 1e-6 of their metres (numpy float64 between the
same float32 rounding points on both sides, the IK's gaussian smoothing
included); the rotation decodes at 1e-5 (40-frame cumulative sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.core import hml_codec as jcodec  # noqa: E402
from mdm_tpu.core import quaternions as jq  # noqa: E402
from mdm_tpu.core import skeleton as jskel  # noqa: E402
from mdm_tpu_torch.core import hml_codec, quaternions as Q, skeleton  # noqa: E402

QTOL = dict(atol=1e-6, rtol=1e-6)
T = 40
DATASETS = {"t2m": (skeleton.t2m_skeleton, jskel.t2m_skeleton, 22),
            "kit": (skeleton.kit_skeleton, jskel.kit_skeleton, 21)}


def _quats(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q, r = _quats(rng, 6, 5), _quats(rng, 6, 5)
    for order in ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx"):
        for eps, deg in ((0.0, False), (1e-6, True)):
            np.testing.assert_allclose(Q.qeuler(_t(q), order, eps, deg).numpy(),
                                       np.asarray(jq.qeuler(jnp.asarray(q), order, eps, deg)),
                                       atol=1e-6 * (180 / np.pi if deg else 1), rtol=1e-6)
    with pytest.raises(ValueError, match="euler order"):
        Q.qeuler(_t(q), "xxy")
    m = Q.quaternion_to_matrix(_t(q)).numpy()
    m[0, :3] = np.diag([1.0, -1.0, -1.0])  # w = 0: the best-trace branch's reason
    np.testing.assert_allclose(Q.matrix_to_quaternion(_t(m)).numpy(),
                               np.asarray(jq.matrix_to_quaternion(jnp.asarray(m))), **QTOL)
    np.testing.assert_allclose(Q.quaternion_to_cont6d(_t(q)).numpy(),
                               np.asarray(jq.quaternion_to_cont6d(jnp.asarray(q))), **QTOL)
    e = (rng.normal(size=(11, 3)) * 1.5).astype(np.float32)
    e[0] = 0.0  # the zero rotation
    np.testing.assert_allclose(Q.expmap_to_quaternion(_t(e)).numpy(),
                               np.asarray(jq.expmap_to_quaternion(jnp.asarray(e))), **QTOL)
    t = np.linspace(0.0, 1.0, 4).astype(np.float32)
    for tt in (t, 0.3):  # a tensor of powers, and a scalar
        np.testing.assert_allclose(Q.qpow(_t(q), _t(t) if tt is t else tt).numpy(),
                                   np.asarray(jq.qpow(jnp.asarray(q), tt)), **QTOL)
        np.testing.assert_allclose(Q.qslerp(_t(q), _t(r), _t(t) if tt is t else tt).numpy(),
                                   np.asarray(jq.qslerp(jnp.asarray(q), jnp.asarray(r), tt)),
                                   **QTOL)
        np.testing.assert_allclose(Q.lerp(_t(q[..., :3]), _t(r[..., :3]),
                                          _t(t) if tt is t else tt).numpy(),
                                   np.asarray(jq.lerp(jnp.asarray(q[..., :3]),
                                                      jnp.asarray(r[..., :3]), tt)), **QTOL)
    assert tuple(Q.qslerp(_t(q), _t(r), _t(t)).shape) == (4, 6, 5, 4)
    seq = _quats(rng, 30, 4)
    seq[5:9] *= -1  # sign flips to undo
    fixed = Q.qfix(seq)
    np.testing.assert_array_equal(fixed, jq.qfix(seq))
    assert (np.sum(fixed[1:] * fixed[:-1], axis=-1) >= 0).all()
    assert set(Q.__all__) == set(jq.__all__)


def _joints(dataset, seed):
    """A seeded motion [T, J, 3] in metres through the skeleton's FK."""
    rng = np.random.default_rng(seed)
    skel = DATASETS[dataset][0]()
    J = skel.njoints
    offsets = skel.offsets_from_rest_pose(np.abs(rng.normal(size=(J, 3))) * 0.3 + 0.1)
    quats = np.zeros((T, J, 4), np.float32)
    quats[..., 0] = 1.0
    quats += np.cumsum(rng.normal(scale=0.01, size=(T, J, 4)), axis=0).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    root = np.cumsum(rng.normal(scale=0.02, size=(T, 3)), axis=0).astype(np.float32)
    root[:, 1] += 1.0
    joints = skel.forward_kinematics(_t(quats), _t(root), _t(offsets)).numpy()
    return joints.astype(np.float64), offsets


@pytest.mark.parametrize("dataset", ["t2m", "kit"])
@pytest.mark.parametrize("retarget", [False, True])
def test_process_file_matches_jax(dataset, retarget):
    """process_file (and through it extract_features and, with
    tgt_offsets, _uniform_skeleton) against mdm_tpu's; then the encode ->
    recover_from_ric round trip, whose error is mdm_tpu's own."""
    joints, offsets = _joints(dataset, 1 if dataset == "t2m" else 2)
    tgt = offsets * 1.1 if retarget else None
    feats, pos = hml_codec.process_file(joints.copy(), 0.002, dataset, tgt_offsets=tgt)
    jfeats, jpos = jcodec.process_file(joints.copy(), 0.002, dataset, tgt_offsets=tgt)
    J = DATASETS[dataset][2]
    assert feats.shape == (T - 1, hml_codec.feature_dim(J)) and feats.dtype == np.float32
    assert pos.shape == (T, J, 3) and pos.dtype == np.float64
    np.testing.assert_allclose(feats, jfeats, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pos, jpos, atol=1e-6, rtol=0)
    assert set(np.unique(feats[:, -4:])) <= {0.0, 1.0}  # foot contacts
    rec = hml_codec.recover_from_ric(_t(feats), J).numpy()
    jrec = np.asarray(jcodec.recover_from_ric(jnp.asarray(jfeats), J))
    err, jerr = np.abs(rec - pos[:-1]).max(), np.abs(jrec - jpos[:-1]).max()
    assert abs(err - jerr) < 1e-5, (err, jerr)
    if dataset == "t2m":  # metres; on KIT's skeleton this random motion loses as much in both
        assert err < 0.05


@pytest.mark.parametrize("dataset", ["t2m", "kit"])
def test_extract_features_and_rotation_decodes_match_jax(dataset):
    """extract_features on unnormalized joints; recover_rot and
    recover_from_rot (cont6d FK from the features' rotation channels)."""
    joints, offsets = _joints(dataset, 3)
    make, jmake, J = DATASETS[dataset]
    face = skeleton.T2M_FACE_JOINTS if dataset == "t2m" else skeleton.KIT_FACE_JOINTS
    fid_r, fid_l = ([8, 11], [7, 10]) if dataset == "t2m" else ([14, 15], [19, 20])
    feats = hml_codec.extract_features(joints.copy(), 0.002, make(), face, fid_r, fid_l)
    jfeats = jcodec.extract_features(joints.copy(), 0.002, jmake(), face, fid_r, fid_l)
    np.testing.assert_allclose(feats, jfeats, atol=1e-5, rtol=1e-5)
    x = np.stack([feats, feats * 0.5])  # a batch
    rot = hml_codec.recover_rot(_t(x)).numpy()
    np.testing.assert_allclose(rot, np.asarray(jcodec.recover_rot(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    assert rot.shape == (2, T - 1, J + 1, 6)
    got = hml_codec.recover_from_rot(_t(x), J, make(), _t(offsets)).numpy()
    want = np.asarray(jcodec.recover_from_rot(jnp.asarray(x), J, jmake(), jnp.asarray(offsets)))
    assert got.shape == (2, T - 1, J, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert set(hml_codec.__all__) == set(jcodec.__all__)
    assert hml_codec.HML_EE_JOINT_NAMES == jcodec.HML_EE_JOINT_NAMES
