"""Data-parallel training in a two-rank gloo world on the CPU.

Each world is spawned by ``launch_local_multihost`` under a time limit of
its own and runs ``mdm_tpu_torch.scripts.parallel_check train``: the
data-parallel steps of ``make_train_step(mesh=)`` on a global batch and,
on rank 0, the one-process steps on the same batch, weights and keys.

- At rate 0.1 (2 layers, 64 wide, 8 x 16 frames, 2 steps): every rank
  draws its rows of the one-process masks, so the only difference left is
  the order of the gradient sum. Stated tolerances, f32: each step's loss
  to 1e-6 relative (measured 0 and 6e-8), AdamW's first moments after two
  steps to 1e-5 of each tensor's largest (measured 7e-7), and the
  parameters' updates, all tensors together, to 1e-5 in relative L2
  (measured 8e-7) at the held coordinates, at least 80% of them (measured
  96%): those whose first moment stood above 2e-3 of its tensor's largest
  at every step. The others hold a gradient at rounding level (the key
  bias, which softmax cancels), and Adam steps it either way in either
  run. The control pins every rank's batch offset at 0, so rank 1 draws
  rows 0..3's masks: its moments and updates miss by more than 100 times
  the tolerances (measured 0.75 and 0.78).
- ``loss-second-moment`` and goal conditioning (DiP, split encoder) run in
  the world and meet the same tolerances.
- At rate 0 with the JAX key's draws injected (tests/test_torch_train.py's
  seam and sizes: 128 wide, 4 x 16 frames), the two-rank steps against
  mdm_tpu's ``make_train_step(shard_map_kernels=True)`` on a 2-device
  virtual mesh, its kernels under the Pallas interpreter: the metrics to
  2e-5 relative and ``_check_update``'s bars on AdamW's moments and the
  parameter and EMA updates, as test_torch_train.py states them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.parallel import mesh as jmesh  # noqa: E402
from mdm_tpu.train import state as JS  # noqa: E402
from mdm_tpu.train import train_step as JT  # noqa: E402
from mdm_tpu_torch.models import MDM, MDMConfig, bridge  # noqa: E402
from mdm_tpu_torch.parallel.multihost import launch_local_multihost  # noqa: E402
from mdm_tpu_torch.train import OptimConfig, create_train_state  # noqa: E402
from test_torch_train import (LATER, OPTIM, SMALL, _check_metrics, _check_update,  # noqa: E402
                              _jax_draws, _np_tree, _setup, _snapshot, jax_kernels)

LOSS_REL, MOMENT_REL, UPDATE_REL = 1e-6, 1e-5, 1e-5
TIMEOUT = 120  # seconds for a whole world
ENV = {"OMP_NUM_THREADS": "2"}


def _world(out, *argv):
    launch_local_multihost(2, module="mdm_tpu_torch.scripts.parallel_check",
                           extra_argv=["train", "--out", str(out), "--device", "cpu", *argv],
                           extra_env=ENV,
                           timeout=TIMEOUT)
    return torch.load(out / "train.pt", weights_only=False)


@pytest.fixture(scope="module")
def rate_01(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("rate01"), "--control")


def _within(summary):
    assert max(summary["loss_rel"]) <= LOSS_REL, summary
    assert summary["moment_err"] <= MOMENT_REL, summary
    assert summary["update_err"] <= UPDATE_REL, summary
    assert summary["held"] >= 0.8, summary


def test_dp_step_at_rate_01_is_the_one_process_step(rate_01):
    _within(rate_01["summary"]["dp"])
    dp, ref = rate_01["metrics"]["dp"], rate_01["metrics"]["reference"]
    assert len(dp) == len(ref) == 2 and dp[1]["loss"] != dp[0]["loss"]
    for a, b in zip(dp, ref):  # every metric is the global one
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_offset_pinned_at_zero_misses_the_masks(rate_01):
    control = rate_01["summary"]["control"]
    assert control["moment_err"] > 100 * MOMENT_REL, control
    assert control["update_err"] > 100 * UPDATE_REL, control


def test_loss_second_moment_and_goal_conditioning_in_the_world(tmp_path):
    out = _world(tmp_path, "--arch", "trans_dec", "--goal", "--schedule_sampler",
                 "loss-second-moment")
    _within(out["summary"]["dp"])
    assert "target_loc" in out["metrics"]["dp"][0]  # the goal loss ran


def test_dp_step_at_rate_0_matches_jax_shard_map_step(tmp_path, jax_kernels):
    jmodel, params, jb, tb, jcfg, _, _, _ = _setup(OPTIM)
    sched = JSchedule.create("cosine", 1000)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    draws = [{k: v.numpy() for k, v in _jax_draws(key, jb["x"], sched, 0.1).items()}
             for key in keys]
    config = MDMConfig(**SMALL)
    init = bridge.state_dict_from_flax(_np_tree(params), config)
    batch = {"x": tb["x"].numpy(), "mask": tb["mask"].numpy(),
             "cond": {"text_embed": tb["cond"].text_embed.numpy()}}
    torch.save({"state_dict": init, "batch": batch, "draws": draws}, tmp_path / "inputs.pt")
    B, T = tb["x"].shape[:2]
    out = _world(tmp_path, "--inputs", str(tmp_path / "inputs.pt"), "--keep", "--dropout", "0",
                 "--latent_dim", "128", "--ff_size", "256", "--batch", str(B), "--frames",
                 str(T), "--steps", "2", "--lr", str(OPTIM["lr"]))
    assert OPTIM == dict(lr=1e-3, weight_decay=0.5, lr_anneal_steps=4, ema_decay=0.9)

    prev = jmesh._active_mesh
    try:
        jmesh.make_mesh(n_devices=2)
        jstep = JT.make_train_step(jmodel.apply, sched, jcfg, shard_map_kernels=True)
        jstate = JS.create_train_state(params, jcfg.optim)
        held = {}
        for i, key in enumerate(keys):
            tstate = _port_state(out["states"]["dp"][i], config)
            before = _snapshot(tstate, jstate)
            jstate, jmet = jstep(jstate, jb, key)
            after = _port_state(out["states"]["dp"][i + 1], config)
            _check_metrics({k: torch.tensor(v) for k, v in out["metrics"]["dp"][i].items()},
                           jmet)
            _check_update(after, jstate, before, held,
                          **({} if i == 0 else LATER))
    finally:
        jmesh._active_mesh = prev


def _port_state(sd, config):
    state = create_train_state(MDM(config), OptimConfig(**OPTIM))
    state.load_state_dict(sd)
    return state
