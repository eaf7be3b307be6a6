"""SMPLify mesh export of mdm_tpu_torch against mdm_tpu's, on the CPU.

The pose priors (``MaxMixturePrior`` from tables and from a pickled GMM,
``angle_prior``, ``gmof``) on the same numpy inputs to 1e-5 of the largest
value (f32, another summation order); ``fit_smpl`` for 5 iterations on
tests/test_torch_smpl.py's 40-vertex synthetic model, with the L2 fallback
and with the GMM prior, each package's Adam and cosine schedule, compared
on what the fit determines: the rotation matrices of the fitted pose, the
translation, the vertices, the joints and each iteration's loss, to
FIT_TOL of the largest value (Adam divides each gradient by its own size,
so rounding-level gradients, such as those along the 6d vectors' lengths,
which no rotation depends on, move their components by up to a step);
``motions_to_euler`` and ``motions2hik`` on rot6d thetas and on fitted xyz
joints; ``NpyToObj``'s .obj and smpl_params.npy; then ``cli.render_mesh``
and ``Predictor(output_format="hik")`` on a synthetic SMPL at its published
sizes in the working directory.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu import smpl as JS  # noqa: E402
from mdm_tpu.visualize import joints2smpl as JF  # noqa: E402
from mdm_tpu.visualize import prior as JP  # noqa: E402
from mdm_tpu_torch import smpl as PS  # noqa: E402
from mdm_tpu_torch.cli import render_mesh  # noqa: E402
from mdm_tpu_torch.core import rotations as PR  # noqa: E402
from mdm_tpu_torch.scripts.a2m_rehearsal import write_synthetic_smpl  # noqa: E402
from mdm_tpu_torch.visualize import joints2smpl as PF  # noqa: E402
from mdm_tpu_torch.visualize import prior as PP  # noqa: E402
from test_torch_smpl import V, _arrays  # noqa: E402

TOL = 1e-5
FIT_TOL = 1e-4
T = 6


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max |diff| / max |want| = {err:.3g} > {tol}"


def _gmm_tables(seed=0, M=4, d=69):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, d, d)) * 0.1
    covs = a @ a.transpose(0, 2, 1) / d + 0.05 * np.eye(d)
    return {"means": rng.normal(size=(M, d)) * 0.2, "covars": covs,
            "weights": rng.dirichlet(np.ones(M))}


@pytest.fixture
def models():
    a = dict(_arrays(), faces=np.random.default_rng(1).integers(0, V, (30, 3)).astype(np.int32))
    return JS.SMPLModel(**a), PS.SMPLModel(**a)


@pytest.fixture
def gmm_path(tmp_path):
    path = tmp_path / "gmm_08.pkl"
    with open(path, "wb") as f:
        pickle.dump(_gmm_tables(), f)
    return str(path)


def test_priors_match_jax(gmm_path, monkeypatch):
    rng = np.random.default_rng(2)
    pose = (rng.normal(size=(5, 69)) * 0.3).astype(np.float32)
    t = _gmm_tables()
    tables = (t["means"], t["covars"], t["weights"])
    ours, ref = PP.MaxMixturePrior.from_tables(*tables), JP.MaxMixturePrior.from_tables(*tables)
    for k in ("means", "precisions", "log_nll_weights"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    _close(ours(torch.from_numpy(pose)).numpy(), ref(jnp.asarray(pose)))
    monkeypatch.setenv("MDM_TPU_GMM_PRIOR", gmm_path)
    assert PP.find_gmm_asset() == JP.find_gmm_asset() == gmm_path
    loaded = PP.MaxMixturePrior.load()
    _close(loaded(torch.from_numpy(pose)).numpy(), ref(jnp.asarray(pose)))
    _close(PP.angle_prior(torch.from_numpy(pose)).numpy(), JP.angle_prior(jnp.asarray(pose)))
    x = np.linspace(-300, 300, 61).astype(np.float32)
    _close(PP.gmof(torch.from_numpy(x), 100.0).numpy(), JP.gmof(jnp.asarray(x), 100.0))
    monkeypatch.setenv("MDM_TPU_GMM_PRIOR", gmm_path + ".missing")
    assert PP.find_gmm_asset() is None
    with pytest.raises(FileNotFoundError):
        PP.MaxMixturePrior.load()


def test_safe_axis_angle_and_schedule_match_jax():
    rng = np.random.default_rng(3)
    mats = PR.axis_angle_to_matrix(torch.from_numpy(
        (rng.normal(size=(7, 3)) * 0.8).astype(np.float32)))
    mats = torch.cat([mats, torch.eye(3)[None]])  # the identity, the fit's start
    _close(PF._safe_matrix_to_axis_angle(mats).numpy(),
           JF._safe_matrix_to_axis_angle(jnp.asarray(mats.numpy())))
    import optax

    sched = optax.cosine_decay_schedule(0.02, 150, alpha=0.02)
    for n in (0, 1, 75, 149, 150, 200):
        assert abs(PF.cosine_decay(0.02, 150, 0.02, n) - float(sched(n))) <= 1e-9


def _target(seed=4):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, 22, 3)) * 0.3
    return (base + 0.02 * rng.normal(size=(T, 22, 3))).astype(np.float32)


def _fitted_matrices(thetas):
    return PR.rotation_6d_to_matrix(torch.from_numpy(np.asarray(thetas)[:, :24])).numpy()


@pytest.mark.parametrize("gmm", [False, True], ids=["l2", "gmm"])
def test_fit_smpl_matches_jax(models, gmm, gmm_path, monkeypatch):
    monkeypatch.setenv("MDM_TPU_GMM_PRIOR", gmm_path)
    jmodel, pmodel = models
    target = _target()
    cfg = dict(iterations=5, use_gmm_prior=gmm)
    ours = PF.fit_smpl(pmodel, target, PF.FitConfig(**cfg), device="cpu")
    ref = JF.fit_smpl(jmodel, target, JF.FitConfig(**cfg))
    assert set(ours) == set(ref)
    assert ours["thetas"].shape == (T, 25, 6) and ours["losses"].shape == (5,)
    _close(_fitted_matrices(ours["thetas"]), _fitted_matrices(ref["thetas"]), FIT_TOL)
    for k in ("transl", "betas", "vertices", "joints", "losses"):
        _close(ours[k], ref[k], FIT_TOL)
    _close(ours["thetas"][:, 24, :3], ref["thetas"][:, 24, :3], FIT_TOL)
    assert ours["losses"][-1] < ours["losses"][0]


def test_fit_options_match_jax(models):
    """Per-frame betas, no lr decay and a given initial pose, for 2
    iterations: off the identity the rounding-level gradients along the 6d
    vectors' lengths are larger, and each Adam step carries their noise on
    (6.4e-5 of the vertices after 2 steps, 1.6e-4 after 4, on this CPU)."""
    jmodel, pmodel = models
    target = _target(5)
    init = np.tile(np.array([1.0, 0, 0, 0, 1.0, 0], np.float32), (T, 24, 1))
    init[:, 1:, 1] = 0.1
    cfg = dict(iterations=2, use_gmm_prior=False, per_frame_betas=True, lr_decay=False)
    ours = PF.fit_smpl(pmodel, target, PF.FitConfig(**cfg), init_thetas=init, device="cpu")
    ref = JF.fit_smpl(jmodel, target, JF.FitConfig(**cfg), init_thetas=init)
    assert ours["betas"].shape == (T, 10)
    for k in ("betas", "vertices", "losses"):
        _close(ours[k], ref[k], FIT_TOL)


def test_motions2hik_and_euler_match_jax(models):
    jmodel, pmodel = models
    rng = np.random.default_rng(6)
    thetas = rng.normal(size=(2, T, 25, 6)).astype(np.float32)
    _close(PF.motions_to_euler(thetas[0, :, :-1]), JF.motions_to_euler(thetas[0, :, :-1]))
    ours, ref = PF.motions2hik(thetas, device="cpu"), JF.motions2hik(thetas)
    assert ours["joint_map"] == ref["joint_map"]
    _close(ours["thetas"], ref["thetas"])
    np.testing.assert_array_equal(ours["root_translation"], ref["root_translation"])
    xyz = _target()[None]
    cfg = dict(iterations=3, use_gmm_prior=False)
    ours = PF.motions2hik(xyz, pmodel, PF.FitConfig(**cfg), device="cpu")
    ref = JF.motions2hik(xyz, jmodel, JF.FitConfig(**cfg))
    assert np.asarray(ours["thetas"]).shape == (1, T, 24, 3)
    _close(ours["root_translation"], ref["root_translation"], FIT_TOL)


def _results_npy(path, seed=7, n=2, reps=2):
    motion = np.stack([_target(seed + i) for i in range(n * reps)])
    np.save(path, {"motion": motion, "text": ["a"] * (n * reps), "lengths": np.full(n * reps, T),
                   "num_samples": n, "num_repetitions": reps})
    return motion


def test_npy_to_obj_matches_jax(models, tmp_path):
    jmodel, pmodel = models
    motion = _results_npy(tmp_path / "results.npy")
    cfg = dict(iterations=3, use_gmm_prior=False)
    ours = PF.NpyToObj(str(tmp_path / "results.npy"), 1, 1, pmodel, PF.FitConfig(**cfg),
                       device="cpu")
    ref = JF.NpyToObj(str(tmp_path / "results.npy"), 1, 1, jmodel, JF.FitConfig(**cfg))
    assert ours.num_frames == ref.num_frames == T
    _close(ours.vertices, ref.vertices, FIT_TOL)
    fit_direct = PF.fit_smpl(pmodel, motion[3], PF.FitConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(ours.vertices, fit_direct["vertices"])  # sample 1 of rep 1
    ours.save_obj(str(tmp_path / "ours.obj"), 2)
    ref.save_obj(str(tmp_path / "ref.obj"), 2)
    a, b = ((tmp_path / n).read_text().splitlines() for n in ("ours.obj", "ref.obj"))
    assert len(a) == len(b) == V + 30
    assert a[V:] == b[V:]  # the faces, 1-based
    _close([[float(v) for v in line.split()[1:]] for line in a[:V]],
           [[float(v) for v in line.split()[1:]] for line in b[:V]], FIT_TOL)
    saved = np.load(ours.save_npy(str(tmp_path / "p.npy")), allow_pickle=True).item()
    assert set(saved) == {"thetas", "betas", "transl"}


def test_render_mesh_cli_and_predictor_hik(tmp_path, monkeypatch):
    """cli.render_mesh and Predictor(output_format="hik") with SMPL at its
    published sizes (the seeded synthetic model) under the working
    directory, as the card runs them."""
    monkeypatch.chdir(tmp_path)
    write_synthetic_smpl(str(tmp_path))
    _results_npy(tmp_path / "results.npy")
    conv = render_mesh.main(["--input_path", str(tmp_path / "results.npy"), "--iterations", "4",
                             "--device", "cpu", "--out_dir", str(tmp_path / "obj")])
    objs = sorted(p.name for p in (tmp_path / "obj").iterdir())
    assert objs == [f"frame{i:03d}.obj" for i in range(T)] + ["smpl_params.npy"]
    assert conv.vertices.shape == (T, 6890, 3) and np.isfinite(conv.vertices).all()
    assert conv.fit["losses"][-1] < conv.fit["losses"][0]

    from mdm_tpu_torch.serving import Predictor, PredictorConfig

    p = Predictor(PredictorConfig(num_diffusion_steps=20, respacing="3", max_frames=8,
                                  latent_dim=128, layers=1, compute_dtype="float32",
                                  device="cpu"))
    p.setup()
    hik = p.predict("a person walks", num_repetitions=2, motion_length_sec=0.3, seed=1,
                    output_format="hik")
    assert hik["joint_map"] == JF.HIK_JOINT_MAP
    assert np.asarray(hik["thetas"]).shape == (2, 6, 24, 3)
    assert np.isfinite(np.asarray(hik["root_translation"])).all()
