"""mdm_tpu_torch's host-side modules against mdm_tpu's: the dataset loader
yields bitwise equal batches on the synthetic HumanML3D, KIT and
HumanAct12 trees of tests/test_cli.py (the first positions, iter_from,
DiP prefix batches, shards), the a2m representations are bitwise equal,
and core/rotations and core/skeleton match to 1e-6 in f32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from test_cli import synthetic_humanact12, synthetic_humanml, synthetic_kit  # noqa: E402,F401

from mdm_tpu.core import rotations as JR  # noqa: E402
from mdm_tpu.core import skeleton as JS  # noqa: E402
from mdm_tpu.data import a2m as ja2m  # noqa: E402
from mdm_tpu.data import get_dataset_loader as jax_loader  # noqa: E402
from mdm_tpu_torch.core import rotations as R  # noqa: E402
from mdm_tpu_torch.core import skeleton as S  # noqa: E402
from mdm_tpu_torch.data import a2m  # noqa: E402
from mdm_tpu_torch.data import get_dataset_loader as port_loader  # noqa: E402
from mdm_tpu_torch.data.loader import cache_device_batches, pin_batch, pinned_put  # noqa: E402

TOL = 1e-6  # f32: a few ulps of the O(1) values these functions return


def assert_batches_equal(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            assert ours[k].tobytes() == v.tobytes(), k
        else:
            assert ours[k] == v, k


def _take(it, n):
    return [next(it) for _ in range(n)]


def _loaders(tmp_path, name, root, batch_size, **kw):
    if name in ("humanml", "kit"):  # each package parses into its own cache
        return [make(name, batch_size, data_root=root, cache_dir=str(tmp_path / tag), **kw)
                for make, tag in ((port_loader, "port"), (jax_loader, "jax"))]
    return [make(name, batch_size, data_root=root, **kw) for make in (port_loader, jax_loader)]


@pytest.mark.parametrize("name", ["humanml", "kit", "humanact12"])
def test_loader_batches_bitwise(tmp_path, request, name):
    root = request.getfixturevalue({"humanml": "synthetic_humanml", "kit": "synthetic_kit",
                                    "humanact12": "synthetic_humanact12"}[name])
    frames = {"humanml": 196, "kit": 196, "humanact12": 60}[name]
    ours, ref = _loaders(tmp_path, name, root, 4, num_frames=frames)
    # The first 6 positions (past an epoch: 5-6 clips at batch 4), then iter_from(k).
    for a, b in zip(_take(iter(ours), 6), _take(iter(ref), 6)):
        assert_batches_equal(a, b)
    for a, b in zip(_take(ours.iter_from(4), 3), _take(ref.iter_from(4), 3)):
        assert_batches_equal(a, b)
    # shard=(i, n): each rank's rows of the global batch.
    for rank in range(2):
        ours, ref = _loaders(tmp_path, name, root, 4, num_frames=frames, shard=(rank, 2))
        for a, b in zip(_take(ours.iter_from(1), 3), _take(ref.iter_from(1), 3)):
            assert a["x"].shape[0] == 2
            assert_batches_equal(a, b)


def test_loader_prefix_batches_bitwise(tmp_path, synthetic_humanml):
    """DiP: fixed_len = context + prediction crops, collated into prefix
    and prediction windows."""
    ours, ref = _loaders(tmp_path, "humanml", synthetic_humanml, 4, fixed_len=30, pred_len=20)
    for a, b in zip(_take(ours.iter_from(2), 4), _take(ref.iter_from(2), 4)):
        assert a["prefix"].shape == (4, 10, 263) and a["x"].shape == (4, 20, 263)
        assert_batches_equal(a, b)


def test_parallel_workers_and_cached_batches(tmp_path, synthetic_humanml):
    """The thread-pool build and the pinned prefetch transform change
    nothing; cache_device_batches cycles its first n batches on the device."""
    ours, ref = _loaders(tmp_path, "humanml", synthetic_humanml, 4)
    ours.workers = 2
    for a, b in zip(_take(ours.iter_from(0), 4), _take(ref.iter_from(0), 4)):
        assert_batches_equal(a, b)
    if torch.cuda.is_available():
        ours.host_transform = pin_batch
    first = next(ours.iter_from(0))
    assert torch.equal(torch.as_tensor(first["x"]), torch.from_numpy(next(iter(ref))["x"]))
    cached = cache_device_batches(iter(ours), 2, device="cpu")
    got = _take(cached, 4)
    assert isinstance(got[0]["x"], torch.Tensor) and got[0]["x"] is got[2]["x"]
    assert torch.equal(got[0]["x"], torch.as_tensor(first["x"]))
    assert pinned_put("cpu")({"text": ["a"]}) == {"text": ["a"]}


@pytest.mark.parametrize("rep", ["rotvec", "rotmat", "rotquat", "rot6d"])
def test_a2m_representations_bitwise(rep):
    aa = (np.random.default_rng(3).normal(size=(40, 24, 3)) * 0.7).astype(np.float32)
    aa[0, :3] = 0.0  # the small-angle branch
    ours, ref = a2m._to_rep(aa, rep), ja2m._to_rep(aa, rep)
    assert ours.dtype == ref.dtype == np.float32 and ours.tobytes() == ref.tobytes()
    mats = np.asarray(JR.axis_angle_to_matrix(jnp.asarray(aa)))
    np.testing.assert_array_equal(a2m._axis_angle_to_matrix(aa), mats)
    np.testing.assert_allclose(a2m._matrix_to_axis_angle(mats),
                               np.asarray(JR.matrix_to_axis_angle(jnp.asarray(mats))),
                               atol=TOL, rtol=TOL)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[:2] *= 1e-7  # the Taylor branch
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    mats = np.asarray(JR.quaternion_to_matrix(jnp.asarray(q)))
    d6 = rng.normal(size=(64, 6)).astype(np.float32)
    j = lambda f, *a: getattr(JR, f)(*(jnp.asarray(x) for x in a))
    p = lambda f, *a: getattr(R, f)(*(_t(x) for x in a))
    for name, args in (("quaternion_to_matrix", (q,)), ("matrix_to_quaternion", (mats,)),
                       ("standardize_quaternion", (q,)), ("quaternion_multiply", (q, q[::-1])),
                       ("quaternion_invert", (q,)), ("quaternion_apply", (q, pts)),
                       ("axis_angle_to_quaternion", (aa,)), ("quaternion_to_axis_angle", (q,)),
                       ("axis_angle_to_matrix", (aa,)), ("matrix_to_axis_angle", (mats,)),
                       ("rotation_6d_to_matrix", (d6,)), ("matrix_to_rotation_6d", (mats,))):
        _close(p(name, *args), j(name, *args))
    euler = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    for conv in ("XYZ", "ZYX", "YXZ", "XZX", "ZYZ"):
        _close(R.euler_angles_to_matrix(_t(euler), conv),
               JR.euler_angles_to_matrix(jnp.asarray(euler), conv))
        _close(R.matrix_to_euler_angles(_t(mats), conv),
               JR.matrix_to_euler_angles(jnp.asarray(mats), conv))
    rots = R.random_rotations(16, torch.Generator().manual_seed(0))
    eye = torch.eye(3).expand(16, 3, 3)
    assert torch.allclose(rots @ rots.transpose(-1, -2), eye, atol=1e-5)
    assert R.random_rotation(torch.Generator().manual_seed(1)).shape == (3, 3)


@pytest.mark.parametrize("which", ["t2m", "kit"])
def test_skeleton_matches_jax(which):
    ours, ref = getattr(S, f"{which}_skeleton")(), getattr(JS, f"{which}_skeleton")()
    np.testing.assert_array_equal(ours.parents, ref.parents)
    assert ours.chains == ref.chains
    J = ours.njoints
    rng = np.random.default_rng(1)
    rest = rng.normal(size=(J, 3)).astype(np.float32)
    offsets = ours.offsets_from_rest_pose(rest)
    np.testing.assert_array_equal(offsets, ref.offsets_from_rest_pose(rest))
    q = rng.normal(size=(2, 5, J, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    root = rng.normal(size=(2, 5, 3)).astype(np.float32)
    c6 = rng.normal(size=(2, 5, J, 6)).astype(np.float32)
    for do_root in (True, False):
        _close(ours.forward_kinematics(_t(q), _t(root), _t(offsets), do_root),
               ref.forward_kinematics(jnp.asarray(q), jnp.asarray(root), jnp.asarray(offsets),
                                      do_root))
        _close(ours.forward_kinematics_cont6d(_t(c6), _t(root), _t(offsets), do_root),
               ref.forward_kinematics_cont6d(jnp.asarray(c6), jnp.asarray(root),
                                             jnp.asarray(offsets), do_root))
    joints = rng.normal(size=(6, J, 3))
    face = S.T2M_FACE_JOINTS if which == "t2m" else S.KIT_FACE_JOINTS
    for smooth in (False, True):
        np.testing.assert_allclose(ours.inverse_kinematics(joints, face, smooth),
                                   ref.inverse_kinematics(joints, face, smooth),
                                   atol=TOL, rtol=TOL)


def test_quaternion_helpers_match_jax():
    """The quaternion functions core/rotations and core/skeleton reach."""
    from mdm_tpu.core import quaternions as JQ
    from mdm_tpu_torch.core import quaternions as Q

    rng = np.random.default_rng(2)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    v0, v1 = rng.normal(size=(2, 32, 3)).astype(np.float32)
    c6 = rng.normal(size=(32, 6)).astype(np.float32)
    _close(Q.qnormalize(_t(q)), JQ.qnormalize(jnp.asarray(q)))
    _close(Q.qnormalize(torch.zeros(2, 4)), JQ.qnormalize(jnp.zeros((2, 4))))
    _close(Q.qbetween(_t(v0), _t(v1)), JQ.qbetween(jnp.asarray(v0), jnp.asarray(v1)))
    _close(Q.quaternion_to_matrix(_t(q)), JQ.quaternion_to_matrix(jnp.asarray(q)))
    _close(Q.cont6d_to_matrix(_t(c6)), JQ.cont6d_to_matrix(jnp.asarray(c6)))
