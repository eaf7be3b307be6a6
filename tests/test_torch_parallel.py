"""mdm_tpu_torch.parallel and the kernels' batch offset, in one process on
the CPU.

- The rank grid against mdm_tpu.parallel.make_mesh's device grid on the
  8-device virtual mesh (worlds 1, 2, 4, 8 x model_parallel and num_slices
  1, 2, 4), its batch axes, make_mesh_for_batch's data-parallel size, and
  the indivisible cases raising in both with JAX's wording.
- The batch offset against ``shard_seed_offset``'s contract
  (tests/test_shard_map_kernels.py:74-104): rows [k n, (k + 1) n) of a
  whole-batch call equal a call on those rows with ``batch_offset`` k n,
  bitwise, for every dump and every kernel wrapper's plain version, and a
  training layer forward inside ``ops.sharded_rows`` the same way. A row
  count of 16 or more keeps every product at or above the 16 rows below
  which torch's CPU GEMM takes another kernel (a row's result then depends
  on the row count, with no offset involved).
- ``tp_rules`` against ``mdm_tpu.parallel.tp_rules.spec_for_param`` on
  every leaf of a bridged MDM (trans_enc, trans_dec, gru): each element's
  model-axis part, carried through models/bridge.py's names and
  transposes, is the part ``shard_tensor`` gives it.
- A mesh of one rank through the data-parallel step and sampler, bitwise
  the mesh-less ones.
- AUTO bound per call (restored after a raise), ``shard_batch``,
  ``restore_pytree_numpy``, and the launcher's failure and timeout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.parallel import mesh as jmesh  # noqa: E402
from mdm_tpu.parallel import tp_rules as jtp  # noqa: E402
from mdm_tpu_torch import ops  # noqa: E402
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig, bridge  # noqa: E402
from mdm_tpu_torch.models import layers as tl  # noqa: E402
from mdm_tpu_torch.ops import dropout_bits as DB  # noqa: E402
from mdm_tpu_torch.ops.attention_dropout import fused_dropout_attention  # noqa: E402
from mdm_tpu_torch.ops.attention_train_block import fused_train_attention_block  # noqa: E402
from mdm_tpu_torch.ops.encoder_tail import fused_encoder_tail  # noqa: E402
from mdm_tpu_torch.parallel import mesh as M  # noqa: E402
from mdm_tpu_torch.parallel import multihost as MH  # noqa: E402
from mdm_tpu_torch.parallel import tp_rules as TP  # noqa: E402

SEED, RATE = 123, 0.1


@pytest.fixture
def restore_jax_mesh():
    prev = jmesh._active_mesh
    yield
    jmesh._active_mesh = prev


# -- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("mp", [1, 2, 4])
@pytest.mark.parametrize("slices", [1, 2, 4])
def test_rank_grid_is_jax_device_grid(world, mp, slices, restore_jax_mesh):
    if world % (mp * slices):
        with pytest.raises(ValueError, match="not divisible") as ours:
            M.mesh_grid(world, mp, slices)
        with pytest.raises(ValueError, match="not divisible") as theirs:
            jmesh.make_mesh(n_devices=world, model_parallel=mp, num_slices=slices)
        assert str(ours.value) == str(theirs.value)
        return
    grid, names = M.mesh_grid(world, mp, slices)
    jmesh_ = jmesh.make_mesh(n_devices=world, model_parallel=mp, num_slices=slices)
    np.testing.assert_array_equal(grid, np.vectorize(lambda d: d.id)(jmesh_.devices))
    assert names == tuple(jmesh_.axis_names)
    mesh = M.Mesh(grid, names)
    assert M.batch_axes(mesh) == jmesh.batch_axes(jmesh_)
    assert mesh.shape == dict(jmesh_.shape)
    assert mesh.data_parallel * mesh.model_parallel == world
    # a rank's batch index is its row of the grid over the batch axes, as
    # shard_map's linear shard index; its model index the column
    rows = grid.reshape(-1, mp)
    for r in range(world):
        here = M.Mesh(grid, names, rank=r)
        (row, col), = np.argwhere(rows == r)
        assert (here.batch_index, here.model_index) == (row, col)


@pytest.mark.parametrize("batch", [1, 3, 6, 8, 12, 16])
@pytest.mark.parametrize("mp", [1, 2])
def test_data_parallel_size_is_make_mesh_for_batch(batch, mp, restore_jax_mesh):
    want = jmesh.make_mesh_for_batch(batch, model_parallel=mp)
    assert M.data_parallel_size(8, batch, mp) == dict(want.shape)["data"]


def test_make_mesh_refuses_what_the_world_cannot_hold():
    assert MH.world_size() == 1 and M.make_mesh().size == 1
    with pytest.raises(ValueError, match="world holds 1"):
        M.make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="not divisible"):
        M.make_mesh(model_parallel=2)
    assert M.make_mesh_for_batch(3).size == 1


def test_shard_batch_keeps_the_ranks_rows_of_a_global_batch():
    grid, names = M.mesh_grid(2)
    mesh = M.Mesh(grid, names, rank=1)
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    batch = {"x": x, "mask": torch.ones(4, 6, dtype=torch.bool), "text": ["a", "b", "c", "d"],
             "cond": Conditioning(text_embed=torch.arange(8.0).reshape(4, 2),
                                  prefix=torch.zeros(1, 3))}
    out = M.shard_batch(batch, mesh, global_batch=True)
    assert torch.equal(out["x"], torch.from_numpy(x[2:]))
    assert out["mask"].shape == (2, 6) and out["text"] == batch["text"]
    assert torch.equal(out["cond"].text_embed, torch.arange(4.0, 8.0).reshape(2, 2))
    assert out["cond"].prefix.shape == (1, 3)  # not the batch
    local = M.shard_batch(batch, mesh)  # a loader's shard=: already local
    assert torch.equal(local["x"], torch.from_numpy(x))
    assert mesh.rows(4) == slice(2, 4) and M.batch_sharding(mesh)(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(5)


# -- the batch offset --------------------------------------------------------

B, N = 4, 2  # the whole batch and a shard's rows


def _shards(fn, full):
    """fn(first_row, rows) for each shard, against rows of the full call."""
    for k in range(B // N):
        part = fn(k * N, slice(k * N, (k + 1) * N))
        if isinstance(full, tuple):
            for a, b in zip(full, part):
                assert torch.equal(a[k * N:(k + 1) * N], b), k
        else:
            assert torch.equal(full[k * N:(k + 1) * N], part), k


def test_dumps_take_the_batch_offset():
    H, S, Sk, D, F = 3, 5, 7, 8, 16
    _shards(lambda b0, _: DB.dropout_bits(SEED, N, H, S, "cpu", batch_offset=b0),
            DB.dropout_bits(SEED, B, H, S, "cpu"))
    _shards(lambda b0, _: DB.dropout_bits(SEED, N, H, S, "cpu", key_len=Sk, batch_offset=b0),
            DB.dropout_bits(SEED, B, H, S, "cpu", key_len=Sk))
    _shards(lambda b0, _: DB.tail_dropout_bits(SEED, N, S, D, F, "cpu", batch_offset=b0),
            DB.tail_dropout_bits(SEED, B, S, D, F, "cpu"))
    _shards(lambda b0, _: DB.sequence_dropout_bits(SEED, N, S, D, "cpu", batch_offset=b0),
            DB.sequence_dropout_bits(SEED, B, S, D, "cpu"))
    # the counter's batch word wraps at 2^32, as the kernels' uint32 add
    top = DB.philox_bits(SEED, torch.arange(2), 0, 2, 3, batch_offset=2 ** 32 - 1)
    assert torch.equal(top[1], DB.philox_bits(SEED, torch.arange(1), 0, 2, 3)[0])
    assert not torch.equal(DB.sequence_dropout_bits(SEED, N, S, D, "cpu", batch_offset=N),
                           DB.sequence_dropout_bits(SEED, N, S, D, "cpu"))


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_kernel_plain_versions_take_the_batch_offset():
    """The three wrappers' forwards, and dx through the train block, on a
    shard equal the rows of the whole batch (S 12: 24 rows a shard)."""
    S, D, H, F = 12, 16, 2, 32
    x = _rand(B, S, D)
    w = [_rand(*s, seed=i + 1) * 0.3 for i, s in enumerate([(3 * D, D), (3 * D,), (D, D), (D,)])]

    def block(b0, rows):
        xr = x[rows].clone().requires_grad_()
        out = fused_train_attention_block(xr, *w, H, RATE, SEED, batch_offset=b0)
        out.sum().backward()
        return out.detach(), xr.grad

    xf = x.clone().requires_grad_()
    full = fused_train_attention_block(xf, *w, H, RATE, SEED)
    full.sum().backward()
    _shards(block, (full.detach(), xf.grad))
    q, k, v = _rand(B, S, D, seed=5), _rand(B, S, D, seed=6), _rand(B, S, D, seed=7)
    _shards(lambda b0, r: fused_dropout_attention(q[r], k[r], v[r], H, RATE, SEED,
                                                  batch_offset=b0).detach(),
            fused_dropout_attention(q, k, v, H, RATE, SEED).detach())
    attn = _rand(B, S, D, seed=8)
    p = [torch.ones(D), torch.zeros(D), _rand(F, D, seed=9) * 0.3, torch.zeros(F),
         _rand(D, F, seed=10) * 0.3, torch.zeros(D), torch.ones(D), torch.zeros(D)]
    _shards(lambda b0, r: fused_encoder_tail(x[r], attn[r], *p, RATE, SEED,
                                             batch_offset=b0).detach(),
            fused_encoder_tail(x, attn, *p, RATE, SEED).detach())
    # offset 0 outside a shard: the stream the port drew before the offset
    zero = fused_encoder_tail(x, attn, *p, RATE, SEED, batch_offset=0)
    assert torch.equal(zero, fused_encoder_tail(x, attn, *p, RATE, SEED))


ROUTES = {"auto": {}, "drop": dict(train_block=False, train_attention=True, encoder_tail=False),
          "xla": dict(train_block=False, encoder_tail=False)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("arch", ["encoder", "decoder"])
def test_training_layer_inside_sharded_rows(route, arch):
    """A training layer on a shard, inside ``ops.sharded_rows(first row)``,
    is the whole batch's layer on those rows: every dropout site moved."""
    D, S = 128, 12
    torch.manual_seed(0)
    if arch == "encoder":
        layer = tl.TransformerEncoderLayer(D, 4, 256, dropout=RATE)
        args = lambda r: ()
    else:
        layer = tl.TransformerDecoderLayer(D, 4, 256, dropout=RATE)
        memory = _rand(B, 5, D, seed=3)
        args = lambda r: (memory[r],)
    x = _rand(B, S, D)
    seeds = [11, 12, 13, 14][:layer.N_SEEDS]
    with ops.pinned(**ROUTES[route]):
        full = layer(x, *args(slice(None)), deterministic=False, seeds=seeds).detach()
        with ops.sharded_rows(N):
            assert ops.shard_seed_offset() == N
            part = layer(x[N:], *args(slice(N, None)), deterministic=False, seeds=seeds)
        assert ops.shard_seed_offset() == 0
        moved = layer(x[N:], *args(slice(N, None)), deterministic=False, seeds=seeds)
    assert torch.equal(part.detach(), full[N:])
    assert not torch.equal(moved.detach(), full[N:])  # without it: rows 0..N's masks


def test_mdm_sequence_dropout_inside_sharded_rows():
    """MDM's input-sequence dropout draws its rows of the whole batch's mask
    (16 rows a shard, as the module doc says)."""
    from mdm_tpu_torch.models.mdm import sequence_dropout

    x = _rand(32, 8, 16)
    full = sequence_dropout(x, RATE, torch.Generator().manual_seed(4))
    with ops.sharded_rows(16):
        part = sequence_dropout(x[16:], RATE, torch.Generator().manual_seed(4))
    assert torch.equal(part, full[16:])


def test_auto_kernels_bind_per_call_and_restore_after_a_raise():
    assert ops.pallas_train_block_enabled() and ops.pallas_layer_inference_enabled()

    def boom():
        assert not ops.pallas_sample_block_enabled()
        assert not ops.pallas_layer_inference_enabled()
        assert not ops.pallas_encoder_tail_enabled(True)
        raise KeyError("inside")

    with pytest.raises(KeyError, match="inside"), ops.auto_kernels(False):
        boom()
    assert ops.pallas_sample_block_enabled() and ops.pallas_layer_inference_enabled()
    with ops.pinned(train_block=True), ops.auto_kernels(False):
        assert ops.pallas_train_block_enabled()  # a pinned flag wins over AUTO
        assert not ops.pallas_encoder_tail_enabled(False)
    with pytest.raises(RuntimeError), ops.sharded_rows(5):
        raise RuntimeError
    assert ops.shard_seed_offset() == 0


def test_a_mesh_of_one_runs_the_data_parallel_body_bitwise(monkeypatch):
    """A mesh of one rank takes the data-parallel body of make_train_step
    and MotionGenerator (its rows, the packed gradient, loss and terms, the
    gathered sample; with no world up the sum over one rank is skipped):
    two steps at rate 0.1 and a DDPM sample equal the mesh-less ones
    bitwise, and the spy sees each step's one flat sum and the sample's
    one gather."""
    from mdm_tpu_torch.diffusion.schedule import Schedule
    from mdm_tpu_torch.sampling import GenerationConfig, MotionGenerator
    from mdm_tpu_torch.train import (OptimConfig, TrainStepConfig, create_train_state,
                                     make_train_step, step_key)

    sums = []
    real = M.Mesh.sum_over_batch
    monkeypatch.setattr(M.Mesh, "sum_over_batch",
                        lambda self, t: sums.append(tuple(t.shape)) or real(self, t))
    cfg = MDMConfig(latent_dim=64, ff_size=128, num_layers=2, num_heads=4, dropout=RATE,
                    mask_frames=True)
    mesh = M.Mesh(*M.mesh_grid(1))
    sched = Schedule.create("cosine", 8)
    b, t = 4, 16
    batch = {"x": _rand(b, t, 263), "mask": torch.ones((b, t), dtype=torch.bool),
             "cond": Conditioning(text_embed=_rand(b, 512, seed=1))}
    states, metrics = [], []
    for m in (None, mesh):
        model = MDM(cfg).init_weights(torch.Generator().manual_seed(0))
        state = create_train_state(model, OptimConfig(lr=1e-3))
        step = make_train_step(sched, TrainStepConfig(), mesh=m)
        metrics.append([step(state, batch, step_key(0, i))[1] for i in range(2)])
        states.append(state)
    assert len(sums) == 2 and len(sums[0]) == 1
    for k, v in states[0].model.state_dict().items():
        assert torch.equal(v, states[1].model.state_dict()[k]), k
    for a, c in zip(*metrics):
        assert set(a) == set(c) and all(torch.equal(a[k], c[k]) for k in a)
    samples = [MotionGenerator(states[0].model, sched, GenerationConfig(), mesh=m).sample_features(
        batch["cond"], b, t, torch.Generator().manual_seed(3)) for m in (None, mesh)]
    assert len(sums) == 3 and sums[2] == (b, t, 263)
    assert torch.equal(samples[0], samples[1])


# -- tensor-parallel rules ---------------------------------------------------

PARTS = 2
ARCHS = {
    "trans_enc": dict(),
    "trans_dec": dict(arch="trans_dec", text_dim=768, text_tokens=True),
    "gru": dict(arch="gru"),
}


def _jax_parts(path: str, leaf: np.ndarray) -> np.ndarray:
    """Each element's part of the model axis under JAX's spec, -1 where
    the leaf is replicated."""
    spec = jtp.spec_for_param(path, leaf.ndim)
    dims = [i for i, a in enumerate(spec) if a is not None]
    if not dims:
        return np.full(leaf.shape, -1.0, np.float32)
    d, n = dims[0], leaf.shape[dims[0]]
    idx = (np.arange(n) * PARTS // n).reshape([-1 if i == d else 1 for i in range(leaf.ndim)])
    return np.broadcast_to(idx, leaf.shape).astype(np.float32)


def _port_parts(name: str, shape) -> torch.Tensor:
    split = TP.spec_for_param(name, len(shape))
    out = torch.full(shape, -1.0)
    if split is None:
        return out
    flat = torch.arange(out.numel(), dtype=torch.float64).reshape(shape)
    for part in range(PARTS):
        mine = TP.shard_tensor(flat, split, PARTS, part).long().flatten()
        out.view(-1)[mine] = float(part)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tp_split_of_every_leaf_is_jax_spec(arch):
    kw = dict(njoints=263, nfeats=1, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
              **ARCHS[arch])
    jmodel = jm.MDM(jm.MDMConfig(**kw))
    B, T = 2, 6
    text = jnp.zeros((B, 3, 768)) if arch == "trans_dec" else jnp.zeros((B, 512))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((B, T, 263)), jnp.zeros((B,), jnp.int32),
                         jm.Conditioning(frames_mask=jnp.ones((B, T), bool),
                                         text_embed=text))["params"]
    parts = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _jax_parts(jtp._path_str(path), np.asarray(leaf)), params)
    config = MDMConfig(**kw)
    want = bridge.state_dict_from_flax(parts, config)
    model = MDM(config)
    assert set(want) == {n for n, _ in model.named_parameters()}
    split = 0
    for name, p in model.named_parameters():
        got = _port_parts(name, tuple(p.shape))
        assert torch.equal(got, want[name]), name
        split += TP.spec_for_param(name, p.dim()) is not None
    assert (split == 0) == (arch == "gru")


def test_tp_rules_match_jax_rule_order_and_too_few_dims():
    assert TP.spec_for_param("seqTransEncoder.layers.0.self_attn.in_proj_weight", 2) == (0, 3)
    assert TP.spec_for_param("seqTransEncoder.layers.0.self_attn.out_proj.weight", 2) == (1, 1)
    assert TP.spec_for_param("seqTransEncoder.layers.0.self_attn.out_proj.bias", 1) is None
    assert TP.spec_for_param("seqTransEncoder.layers.0.linear2.weight", 1) is None
    assert TP.spec_for_param("transformer.resblocks.0.mlp.c_fc.bias", 1) == (0, 1)
    assert TP.spec_for_param("input_process.poseEmbedding.weight", 2) is None
    with pytest.raises(ValueError, match="does not split"):
        TP.shard_tensor(torch.zeros(9, 4), TP.Split(0, 3), 2, 0)


# -- checkpoints and the launcher -------------------------------------------

def test_restore_pytree_numpy_reads_any_port_checkpoint(tmp_path):
    from mdm_tpu_torch.train import (OptimConfig, create_train_state, restore_pytree_numpy,
                                     save_checkpoint)

    model = MDM(MDMConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=2))
    state = create_train_state(model, OptimConfig())
    state.step = 3
    path = save_checkpoint(str(tmp_path), 3, state)
    tree = restore_pytree_numpy(path)
    assert tree["step"] == 3
    for name, t in model.state_dict().items():
        assert isinstance(tree["model"][name], np.ndarray)
        np.testing.assert_array_equal(tree["model"][name], t.numpy())
    np.testing.assert_array_equal(tree["ema_params"]["embed_text.weight"],
                                  state.ema_params["embed_text.weight"].numpy())
    with pytest.raises(ValueError, match="orbax"):
        restore_pytree_numpy(str(tmp_path))


def test_launcher_raises_with_every_output_and_kills_on_timeout(monkeypatch):
    with pytest.raises(RuntimeError, match="process 1") as err:
        MH.launch_local_multihost(2, module="this_module_does_not_exist", timeout=60)
    assert "No module named" in str(err.value)
    import subprocess

    with pytest.raises(subprocess.TimeoutExpired):
        MH.launch_local_multihost(2, module="timeit",
                                  extra_argv=["-n", "1", "-r", "1", "import time; time.sleep(60)"],
                                  timeout=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        MH.launch_local_multihost(1, device="tpu")


def test_no_world_unless_asked_and_nccl_needs_a_card(monkeypatch):
    for var in ("MDM_TPU_COORDINATOR", "MDM_TPU_MULTIHOST"):
        monkeypatch.delenv(var, raising=False)
    assert MH.maybe_initialize_distributed() == 0 and MH.world_size() == 1
    assert MH.is_primary() and MH.replicate("anything") == "anything"
    monkeypatch.setenv("MDM_TPU_COORDINATOR", f"localhost:{MH.find_free_port()}")
    monkeypatch.setenv("MDM_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("MDM_TPU_PROCESS_ID", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl world needs a CUDA device"):
        MH.maybe_initialize_distributed(backend="nccl")


def test_tensor_parallel_training_and_pinned_kernels_under_tp_raise():
    """A mesh with a model axis above 1 builds a train step, which takes a
    state split over that axis (tp_rules.shard_state_) and refuses a whole
    one; a fused training kernel pinned on raises before any forward. TP
    sampling runs the einsum attention and the plain tail, so a kernel flag
    pinned on raises there too."""
    from mdm_tpu_torch.diffusion import Schedule
    from mdm_tpu_torch.parallel import tp_rules as TP
    from mdm_tpu_torch.sampling import MotionGenerator
    from mdm_tpu_torch.train import OptimConfig, TrainStepConfig, create_train_state, make_train_step

    tp = M.Mesh(*M.mesh_grid(2, 2))
    step = make_train_step(Schedule.create("cosine", 10), TrainStepConfig(), mesh=tp)
    cfg = MDMConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=4)
    state = create_train_state(MDM(cfg), OptimConfig())
    batch = {"x": torch.zeros(2, 4, cfg.njoints), "mask": torch.ones(2, 4, dtype=torch.bool),
             "cond": Conditioning(text_embed=torch.zeros(2, 512))}
    with pytest.raises(ValueError, match="shard_state_"):
        step(state, batch, 0)
    TP.shard_state_(state, tp)
    assert state.tp is not None and state.model.seqTransEncoder.layers[0].linear1.out_features == 32
    for flag in ("train_block", "train_attention", "encoder_tail"):
        with ops.pinned(**{flag: True}), pytest.raises(ValueError, match="pinned on"):
            step(state, batch, 0)
    model = MDM(MDMConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=4))
    gen = MotionGenerator(model, Schedule.create("cosine", 10, "2"), mesh=tp)
    assert gen.tensor_parallel and gen.model.seqTransEncoder.layers[0].self_attn.num_heads == 2
    assert model.seqTransEncoder.layers[0].self_attn.num_heads == 4  # the caller's stays whole
    assert gen.model.seqTransEncoder.layers[0].linear1.weight.shape == (32, 32)
    with ops.pinned(layer_inference=True), pytest.raises(ValueError, match="pinned on"):
        gen.sample_features(Conditioning(text_embed=torch.zeros(1, 512)), 1, 4)
