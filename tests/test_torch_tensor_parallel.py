"""Tensor-parallel training in gloo worlds on the CPU.

Each world is spawned by ``launch_local_multihost`` under a time limit of
its own and runs ``mdm_tpu_torch.scripts.parallel_check train
--model_parallel 2 --device cpu``: the tensor-parallel steps of
``make_train_step(mesh=)`` on a state split by ``tp_rules.shard_state_``
and, on rank 0, the one-process steps on TP's route (the einsum attention
and the plain tail) on the same global batch, weights and keys. Sizes: 2
layers, latent 32, ff 64, 4 heads, B = 8, T = 16, f32, 2 steps.

- At rate 0.1 each rank draws its heads' and FFN columns' slices of the
  one-process masks (the model offsets), so only the order of the
  row-parallel sums and of the input gradients' sum differs. The
  tolerances are test_torch_multihost.py's: each step's loss to 1e-6
  relative (measured 0: bitwise), AdamW's first moments after two steps to
  1e-5 of each tensor's largest (measured 1.1e-6), the held updates to 1e-5
  relative L2 (measured 1.0e-6) at 80% of the coordinates or more
  (measured 97%). The control pins the model offsets at 0, so rank 1 draws
  heads 0..1 and columns 0..31: its moments and updates miss by more than
  100 times the tolerances (measured 0.53-0.78).
- ``data 2 x model 2`` on four ranks, a DiP (``trans_dec``) step, whose
  cross-attention's rectangular dump takes the head offset, and ``remat``
  (bitwise the step without it) meet the same tolerances.
- A gathered checkpoint holds the one-process file's names and shapes, and
  save after step 1 -> restore onto the TP mesh -> step 2 is bitwise the
  uninterrupted TP run.
- At rate 0 with the JAX key's draws injected (tests/test_torch_train.py's
  seam and sizes: 128 wide, 4 x 16 frames), the two-rank TP steps against
  mdm_tpu's ``make_train_step(state_shardings=...)`` on a 1 x 2 virtual CPU
  mesh (``shard_state``, as tests/test_tensor_parallel.py builds it): the
  metrics to 2e-5 relative and ``_check_update``'s bars on AdamW's moments
  and the parameter and EMA updates, as test_torch_train.py states them.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.parallel import mesh as jmesh  # noqa: E402
from mdm_tpu.parallel import tp_rules as jtp  # noqa: E402
from mdm_tpu.train import state as JS  # noqa: E402
from mdm_tpu.train import train_step as JT  # noqa: E402
from mdm_tpu_torch import ops  # noqa: E402
from mdm_tpu_torch.diffusion import Schedule  # noqa: E402
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig, bridge  # noqa: E402
from mdm_tpu_torch.parallel import mesh as M  # noqa: E402
from mdm_tpu_torch.parallel import tp_rules as TP  # noqa: E402
from mdm_tpu_torch.parallel.multihost import launch_local_multihost  # noqa: E402
from mdm_tpu_torch.scripts.parallel_check import _leaves  # noqa: E402
from mdm_tpu_torch.train import (OptimConfig, TrainStepConfig, apply_gradients,  # noqa: E402
                                 create_train_state, make_train_step)
from mdm_tpu_torch.train.state import global_norm, tree_norm  # noqa: E402
from test_torch_multihost import _port_state  # noqa: E402
from test_torch_train import (LATER, OPTIM, SMALL, _check_metrics, _check_update,  # noqa: E402
                              _jax_draws, _np_tree, _setup, _snapshot)

LOSS_REL, MOMENT_REL, UPDATE_REL = 1e-6, 1e-5, 1e-5
TIMEOUT = 120  # seconds for a whole world
ENV = {"OMP_NUM_THREADS": "2"}
WIDTHS = ["--latent_dim", "32", "--ff_size", "64", "--layers", "2", "--heads", "4"]
LAYERS = 2


def _world(out, *argv, ranks=2):
    launch_local_multihost(ranks, module="mdm_tpu_torch.scripts.parallel_check",
                           extra_argv=["train", "--out", str(out), "--device", "cpu",
                                       "--model_parallel", "2", *WIDTHS, *argv],
                           extra_env=ENV, timeout=TIMEOUT)
    return torch.load(out / "train.pt", weights_only=False)


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    return _world(out, "--control", "--save_resume", "--keep"), out


def _within(summary):
    assert max(summary["loss_rel"]) <= LOSS_REL, summary
    assert summary["moment_err"] <= MOMENT_REL, summary
    assert summary["update_err"] <= UPDATE_REL, summary
    assert summary["held"] >= 0.8, summary


def _misses(control):
    assert control["moment_err"] > 100 * MOMENT_REL, control
    assert control["update_err"] > 100 * UPDATE_REL, control


def test_tp_step_at_rate_01_is_the_one_process_step(tp_world):
    out, _ = tp_world
    _within(out["summary"]["tp"])
    assert out["mesh"] == {"model_parallel": 2, "data_parallel": 1}
    tp, ref = out["metrics"]["tp"], out["metrics"]["reference"]
    assert len(tp) == len(ref) == 2 and tp[1]["loss"] != tp[0]["loss"]
    for a, b in zip(tp, ref):  # every metric is the global one, the norms too
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # shard_state_ then gather_state is the identity on the initial state
    assert all(torch.equal(a, b) for a, b in zip(_leaves(out["states"]["tp"][0]),
                                                 _leaves(out["states"]["reference"][0])))


def test_model_offsets_pinned_at_zero_miss_the_masks(tp_world):
    _misses(tp_world[0]["summary"]["control"])


def test_every_rank_runs_the_global_step_through_megatrons_collectives(tp_world):
    """Each rank's metrics are the same global ones; per step and rank the
    model group runs 4 all-reduces a layer (*g* after out_proj and
    linear2, *f* before in_proj and linear1) of a [B, S, D] f32 (S = T + 1
    with the text token) and the two norms' scalars, the batch group (one
    rank here) the step's one flat sum."""
    out, _ = tp_world
    ranks = out["ranks"]
    assert len(ranks) == 2
    one = 8 * 17 * 32 * 4
    for r in ranks:
        assert r["tp"]["metrics"] == ranks[0]["tp"]["metrics"]
        model = r["tp"]["all_reduces"]["model"]
        assert model["count"] == 2 * (4 * LAYERS + 2), model
        assert model["bytes"] == 2 * (4 * LAYERS * one + 2 * 4), model
        assert r["tp"]["all_reduces"]["batch"]["count"] == 2


def test_gathered_checkpoint_is_the_one_process_file_and_resumes(tp_world):
    out, root = tp_world
    assert out["save_resume"] == {"same_layout_as_one_process": True,
                                  "resumed_equals_uninterrupted": True}
    _within(out["summary"]["resumed"])
    mesh_sd, one_sd = (torch.load(root / d / "ckpt_000000001", weights_only=True)
                       for d in ("resume_mesh", "resume_one"))
    for part in ("model", "ema_params"):
        assert {k: v.shape for k, v in mesh_sd[part].items()} == {
            k: v.shape for k, v in one_sd[part].items()}
    # the gathered file restores into a one-process model as it is
    model = MDM(MDMConfig(njoints=263, latent_dim=32, ff_size=64, num_layers=2, num_heads=4))
    model.load_state_dict(mesh_sd["model"])


def test_remat_under_tp_is_plain_tp_bitwise(tp_world, tmp_path):
    """The rematerialised backward reruns each layer's forward, its two *g*
    all-reduces included, on every rank in the same order: the step is the
    plain TP step bitwise, with 2 more model-group all-reduces a layer."""
    out = _world(tmp_path, "--remat", "--keep")
    for a, b in zip(out["states"]["tp"], tp_world[0]["states"]["tp"]):
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    for r in out["ranks"]:
        assert r["tp"]["all_reduces"]["model"]["count"] == 2 * (6 * LAYERS + 2)


def test_data_2_x_model_2_on_four_ranks(tmp_path):
    out = _world(tmp_path, "--steps", "1", "--control", ranks=4)
    assert out["mesh"] == {"model_parallel": 2, "data_parallel": 2}
    _within(out["summary"]["tp"])
    _misses(out["summary"]["control"])


def test_dip_tp_step_with_the_cross_attention_at_the_head_offset(tmp_path):
    out = _world(tmp_path, "--arch", "trans_dec", "--control")
    _within(out["summary"]["tp"])
    _misses(out["summary"]["control"])


def test_tp_step_at_rate_0_matches_jax_state_shardings_step(tmp_path):
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
    launch_local_multihost(2, module="mdm_tpu_torch.scripts.parallel_check", extra_argv=[
        "train", "--out", str(tmp_path), "--device", "cpu", "--model_parallel", "2",
        "--inputs", str(tmp_path / "inputs.pt"), "--keep", "--dropout", "0", "--latent_dim",
        "128", "--ff_size", "256", "--batch", str(B), "--frames", str(T), "--steps", "2",
        "--lr", str(OPTIM["lr"])], extra_env=ENV, timeout=TIMEOUT)
    out = torch.load(tmp_path / "train.pt", weights_only=False)
    assert OPTIM == dict(lr=1e-3, weight_decay=0.5, lr_anneal_steps=4, ema_decay=0.9)

    prev = jmesh._active_mesh
    try:
        mesh = jmesh.make_mesh(n_devices=2, model_parallel=2)
        jstate = jtp.shard_state(JS.create_train_state(params, jcfg.optim), mesh)
        jstep = JT.make_train_step(jmodel.apply, sched, jcfg,
                                   state_shardings=jtp.state_shardings(jstate, mesh))
        held = {}
        for i, key in enumerate(keys):
            tstate = _port_state(out["states"]["tp"][i], config)
            before = _snapshot(tstate, jstate)
            jstate, jmet = jstep(jstate, jb, key)
            after = _port_state(out["states"]["tp"][i + 1], config)
            _check_metrics({k: torch.tensor(v) for k, v in out["metrics"]["tp"][i].items()},
                           jmet)
            _check_update(after, jstate, before, held, **({} if i == 0 else LATER))
    finally:
        jmesh._active_mesh = prev


def _mesh(index):
    """Rank ``index``'s place on a 1 x 2 mesh, with no process group: what
    the in-process tests split with (no collective runs)."""
    return M.Mesh(*M.mesh_grid(2, 2), rank=index)


def _trained_state(seed=0):
    """A one-process state after one AdamW step: moments and EMA set."""
    cfg = MDMConfig(njoints=12, latent_dim=32, ff_size=64, num_layers=1, num_heads=4,
                    arch="trans_dec", text_dim=16, text_tokens=True, dropout=0.0)
    model = MDM(cfg).init_weights(torch.Generator().manual_seed(seed))
    state = create_train_state(model, OptimConfig(lr=1e-2, ema_decay=0.5))
    g = torch.Generator().manual_seed(seed + 1)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    apply_gradients(state, OptimConfig(lr=1e-2, ema_decay=0.5))
    with torch.no_grad():
        model.seqTransDecoder.layers[0].self_attn.in_proj_weight[0, 0] = -0.0
    return state


def test_shard_state_splits_moments_and_ema_like_their_parameters_and_places_back():
    """Each rank's part of every parameter, moment and EMA is its slice
    under the parameter's split (the packed q/k/v blocks each split alike,
    the cross-attention's too); the parts written into -0.0 tensors and
    summed (gather_tensors' exact gather, here without a group) give back
    the whole state bitwise, signed zeros included; ``local_state_dict`` of
    the whole state is each rank's own state dict."""
    whole = _trained_state()
    sd = whole.state_dict()
    names = [n for n, _ in whole.model.named_parameters()]
    parts = []
    for index in range(2):
        state = TP.shard_state_(copy.deepcopy(whole), _mesh(index))
        local = state.state_dict()
        mine = TP.local_state_dict(sd, state)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(mine), _leaves(local)))
        parts.append(local)
        attn = state.model.seqTransDecoder.layers[0].multihead_attn
        layer = state.model.seqTransDecoder.layers[0]
        assert (attn.num_heads, attn.head_offset, layer.ffn_offset) == (2, 2 * index, 32 * index)
        assert attn.in_proj_weight.shape == (48, 32)
    splits = TP.state_splits(whole)
    assert splits["seqTransDecoder.layers.0.multihead_attn.in_proj_weight"] == (0, 3)
    assert splits["seqTransDecoder.layers.0.norm1.weight"] is None

    def back(get):  # the two ranks' places added: -0.0 + x is x
        if splits[name] is None:
            return get(parts[0])
        return torch.add(*(TP._place(get(p), splits[name], 2, i) for i, p in enumerate(parts)))

    for i, name in enumerate(names):
        for what, get in (("model", lambda s: s["model"][name]),
                          ("ema", lambda s: s["ema_params"][name]),
                          ("exp_avg", lambda s: s["optimizer"]["state"][i]["exp_avg"]),
                          ("exp_avg_sq", lambda s: s["optimizer"]["state"][i]["exp_avg_sq"])):
            got = back(get)
            want = get(sd)
            assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit()), \
                (what, name)


def test_tp_norms_sum_split_leaves_once_and_replicated_leaves_once(monkeypatch):
    """global_norm with a model group: the split leaves' squares go through
    one all-reduce over the group, the replicated ones are added once;
    tree_norm reads the state's layout. A stand-in all-reduce doubles the
    split sum, as two ranks holding equal parts would."""
    import torch.distributed as dist

    calls = []

    def fake_all_reduce(t, group=None):
        calls.append((t.clone(), group))
        t.mul_(2)

    monkeypatch.setattr(dist, "all_reduce", fake_all_reduce)
    a, b, c = torch.full((3,), 2.0), torch.full((2, 2), 1.0), torch.full((5,), 3.0)
    norm = global_norm([a, b, c], [True, False, True], group="model")
    assert len(calls) == 1 and calls[0][1] == "model" and float(calls[0][0]) == 12 + 45
    assert float(norm) == pytest.approx(float(torch.sqrt(torch.tensor(2 * 57.0 + 4.0))))
    assert float(global_norm([a, b, c])) == pytest.approx(float(torch.sqrt(torch.tensor(61.0))))
    mesh = _mesh(0)
    mesh.model_group = "model"
    state = TP.shard_state_(_trained_state(), mesh)
    named = dict(state.model.named_parameters())
    calls.clear()
    tree = tree_norm(state, named)
    split = sum(float(p.detach().pow(2).sum()) for n, p in named.items()
                if state.tp.splits[n] is not None)
    repl = sum(float(p.detach().pow(2).sum()) for n, p in named.items()
               if state.tp.splits[n] is None)
    assert len(calls) == 1 and float(tree) == pytest.approx((2 * split + repl) ** 0.5, rel=1e-6)


def test_tp_step_refuses_a_state_split_for_another_mesh_and_pinned_kernels():
    """A split state on a step without a model axis raises, and a pinned
    fused kernel raises before any forward (ops.mesh_kernels, shared with
    the generator); AUTO resolves to off under TP and is restored."""
    state = TP.shard_state_(_trained_state(), _mesh(0))
    cfg = TrainStepConfig()
    batch = {"x": torch.zeros(2, 4, 12), "mask": torch.ones(2, 4, dtype=torch.bool),
             "cond": Conditioning(text_embed=torch.zeros(2, 3, 16))}
    with pytest.raises(ValueError, match="shard_state_"):
        make_train_step(Schedule.create("cosine", 10), cfg)(state, batch, 0)
    with pytest.raises(ValueError, match="split already"):
        TP.shard_state_(state, _mesh(0))
    step = make_train_step(Schedule.create("cosine", 10), cfg, mesh=_mesh(0))
    for flag in ("train_block", "train_attention", "encoder_tail", "layer_inference"):
        with ops.pinned(**{flag: True}), pytest.raises(ValueError, match="pinned on"):
            step(state, batch, 0)
    with ops.mesh_kernels(True):
        assert not ops.pallas_train_block_enabled() and not ops.pallas_encoder_tail_enabled(False)
    assert ops.pallas_train_block_enabled()
