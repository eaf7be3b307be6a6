"""Goal conditioning in mdm_tpu_torch against mdm_tpu, on the CPU.

``EmbedTargetLoc`` in its three encoder types (weights from mdm_tpu's init
through models/bridge.py into the reference torch layout) to 2e-5, one
layer's bar; core/goals.py's target extraction, loss mask and trajectory
velocities on HumanML3D's normalisation statistics to 1e-5; the goal
sampling of core/goals.py and train/goal_cond.py from the same numpy
generator, bitwise; and a goal-conditioned DiP train step with the
targets extracted in the step, ``lambda_target_loc`` on and the target's
condition dropout injected from the JAX key
(tests/test_torch_decoder_train.py's ``step_matches_jax`` and tolerances).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.core import goals as JG  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.train import goal_cond as JGC  # noqa: E402
from mdm_tpu_torch.core import goals as G  # noqa: E402
from mdm_tpu_torch.models import bridge  # noqa: E402
from mdm_tpu_torch.models import mdm as tm  # noqa: E402
from mdm_tpu_torch.sampling.pipeline import load_norm_stats  # noqa: E402
from mdm_tpu_torch.train import goal_cond as GC  # noqa: E402
from test_torch_decoder_train import DIP, SMALL, B, dip_fields, step_matches_jax  # noqa: E402
from test_torch_train import _np_tree, jax_kernels  # noqa: E402, F401

NG = len(G.extended_goal_names())  # 6 goal joints + traj + heading
MEAN, STD = load_norm_stats("humanml")
ENCODERS = {"multi": 1, "single": 2, "split": 2}  # type -> target_enc_layers


def _goal_inputs(seed=0):
    rng = np.random.default_rng(seed)
    validity, _ = JG.sample_goal(B, np.random.default_rng(seed))
    validity[0] = True  # every row of one sample
    target = rng.normal(size=(B, NG, 3)).astype(np.float32)
    return target, validity


@pytest.mark.parametrize("kind", sorted(ENCODERS))
def test_embed_target_loc_matches_jax(kind):
    target, validity = _goal_inputs()
    jmod = jm.EmbedTargetLoc(128, NG, kind, ENCODERS[kind])
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(target), jnp.asarray(validity))
    if kind == "multi":  # normal(1) mixing weights may sum near 0: keep the test conditioned
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.abs(v) if "mix_weights" in str(path) else v, params)
    ref = np.asarray(jmod.apply(params, jnp.asarray(target), jnp.asarray(validity)))
    cfg = tm.MDMConfig(latent_dim=128, multi_target_cond=True, multi_encoder_type=kind,
                       target_enc_layers=ENCODERS[kind])
    sd = bridge._target_loc(_np_tree(params)["params"], cfg)
    module = tm.EmbedTargetLoc(128, cfg.goal_names, kind, ENCODERS[kind])
    module.load_state_dict({k[len("embed_target_cond."):]: torch.tensor(v)
                            for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = module(torch.from_numpy(target), torch.from_numpy(validity))
    assert out.shape == (B, 128)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    if kind == "multi":
        assert "target_loc_emb.left_wrist.2.weight" in module.state_dict()


def test_goal_rows_named_and_tables_drawn_normal():
    """The reference layout keys each goal row's parameters by humanml's
    joint names, so another number of goal joints raises. init_weights
    draws the mixing weights and the action table as flax's normal(1.0):
    seeded, and neither the ones nor the zeros their modules start from."""
    with pytest.raises(ValueError, match="num_goal_joints"):
        tm.MDM(tm.MDMConfig(**SMALL, multi_target_cond=True, num_goal_joints=5))
    for extra, name, n in ((dict(multi_target_cond=True), "embed_target_cond."
                            "target_all_loc_emb.weights", NG),
                           (dict(cond_mode="action", num_actions=12),
                            "embed_action.action_embedding", 12 * 128)):
        cfg = tm.MDMConfig(**SMALL, **extra)
        a, b, c = (tm.MDM(cfg).init_weights(torch.Generator().manual_seed(s)).state_dict()[name]
                   for s in (5, 5, 6))
        assert torch.equal(a, b) and not torch.equal(a, c) and a.numel() == n
        assert 0.3 < a.std().item() < 2.0 and a.abs().min() > 0


def test_target_location_mask_and_trajectory_match_jax():
    rng = np.random.default_rng(1)
    motion = rng.normal(size=(B, 12, 263)).astype(np.float32) * 0.5
    _, validity = _goal_inputs(2)
    ref = np.asarray(JG.get_target_location(jnp.asarray(motion), jnp.asarray(MEAN),
                                            jnp.asarray(STD), validity=jnp.asarray(validity)))
    out = G.get_target_location(torch.from_numpy(motion), torch.from_numpy(MEAN),
                                torch.from_numpy(STD), validity=torch.from_numpy(validity))
    assert out.shape == (B, NG, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(G.goal_loss_mask(torch.from_numpy(validity)).numpy(),
                                  np.asarray(JG.goal_loss_mask(jnp.asarray(validity))))
    pos = np.cumsum(rng.normal(size=(B, 9, 2)), axis=1).astype(np.float32)
    yaw = np.cumsum(rng.normal(size=(B, 9)) * 0.3, axis=1).astype(np.float32)
    ref = np.asarray(JG.traj_global2vel(jnp.asarray(pos), jnp.asarray(yaw)))
    out = G.traj_global2vel(torch.from_numpy(pos), torch.from_numpy(yaw))
    assert out.shape == (B, 8, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("force", [None, "DIMP_FULL", "DIMP_FINAL", "PURE_T2M", "pelvis,head"])
def test_goal_sampling_is_bitwise_jax_from_one_generator(force):
    """The same numpy generator gives the same goals on both sides, and
    leaves the generator in the same state; the targets agree to 1e-5."""
    out = G.sample_goal(16, np.random.default_rng(4), force_joints=force)
    ref = JG.sample_goal(16, np.random.default_rng(4), force_joints=force)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert G.get_allowed_joint_options(force or "DIMP_BENCH") == JG.get_allowed_joint_options(
        force or "DIMP_BENCH")
    x = np.random.default_rng(5).normal(size=(B, 12, 263)).astype(np.float32) * 0.5
    for compute in (True, False):
        r1, r2 = np.random.default_rng(6), np.random.default_rng(6)
        got = GC.goal_cond_modifier({"x": torch.from_numpy(x)}, r1, MEAN, STD,
                                    force_joints=force, compute_target=compute)
        want = JGC.goal_cond_modifier({"x": x}, r2, MEAN, STD, force_joints=force,
                                      compute_target=compute)
        assert set(got) == set(want)
        for k in ("target_validity", "is_heading"):
            np.testing.assert_array_equal(got[k], want[k])
        assert r1.random() == r2.random()
        if compute:
            np.testing.assert_allclose(got["target_cond"].numpy(), want["target_cond"],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(ENCODERS))
def test_goal_conditioned_dip_step_matches_jax(kind, jax_kernels):
    """Targets extracted inside the step from ``target_validity``
    (``target_cond_fn``), the goal loss at ``lambda_target_loc`` 1, the
    target's condition dropout injected from the JAX key's fourth split
    (key 2 drops a sample's condition and another's target)."""
    x, mask, fields = dip_fields(3)
    validity, _ = JG.sample_goal(B, np.random.default_rng(7))
    fields["target_validity"] = validity
    init = dict(fields, target_cond=np.asarray(JG.get_target_location(
        jnp.asarray(x), jnp.asarray(MEAN), jnp.asarray(STD), validity=jnp.asarray(validity))))

    def target_uncond(key):
        key_tdrop = jax.random.split(key, 5)[3]
        return {"target_uncond": torch.from_numpy(np.array(
            jax.random.bernoulli(key_tdrop, 0.1, (B,))))}

    kw = dict(SMALL, **DIP, dropout=0.0, multi_target_cond=True, multi_encoder_type=kind,
              target_enc_layers=ENCODERS[kind])
    state = step_matches_jax(
        kw, x, mask, fields, init_fields=init, loss=dict(lambda_target_loc=1.0),
        jax_kw=dict(target_loss_builder=JGC.make_target_loss_builder(MEAN, STD),
                    target_cond_fn=JGC.make_target_cond_fn(MEAN, STD)),
        port_kw=dict(target_loss_builder=GC.make_target_loss_builder(MEAN, STD),
                     target_cond_fn=GC.make_target_cond_fn(MEAN, STD)),
        extra_draws=target_uncond, key=2)
    assert any(n.startswith("embed_target_cond.") for n in state.params())
