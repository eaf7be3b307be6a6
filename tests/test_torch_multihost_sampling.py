"""Data- and tensor-parallel sampling in a two-rank gloo world on the CPU.

One world (``launch_local_multihost`` under a time limit of its own) runs
``mdm_tpu_torch.scripts.parallel_check sample`` on a 2-layer, 32-wide
trans_enc MDM whose weights come from mdm_tpu's init through
models/bridge.py, at a batch of 16 x 16 frames, 4 DDIM steps, guidance 2.5:

- data parallel: the DDIM sample from the global initial noise, and DiP's
  autoregressive path with the chunk noise given, equal the one-process
  samples bitwise (8 rows a rank, 16 with CFG's double batch: torch's CPU
  GEMM takes another kernel below 16 rows, where a row's result depends on
  the row count); a DDPM sample of a batch whose halves are the same
  inputs is finite, and its halves differ: each rank draws from its own
  stream;
- tensor parallel (the model axis over both ranks, 2 heads and 32 FFN
  columns a rank): the DDIM sample against the one-process sample and
  against mdm_tpu's sample over its data x model mesh (4 x 2 virtual
  devices) from the same noise, each to 2e-4 absolute, the bar of
  tests/test_tensor_parallel.py (measured 8e-6 and 1e-5);
- ``Predictor`` with ``tensor_parallel=2`` answers one request on each
  rank, the same joints on both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.diffusion import Schedule as JSchedule  # noqa: E402
from mdm_tpu.models import mdm as jm  # noqa: E402
from mdm_tpu.parallel import mesh as jmesh  # noqa: E402
from mdm_tpu.sampling import GenerationConfig as JGenerationConfig  # noqa: E402
from mdm_tpu.sampling import MotionGenerator as JMotionGenerator  # noqa: E402
from mdm_tpu_torch.models import MDMConfig, bridge  # noqa: E402
from mdm_tpu_torch.parallel.multihost import launch_local_multihost  # noqa: E402

B, T, STEPS = 16, 16, 4
WIDTHS = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4)
TP_ATOL = 2e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's results, mdm_tpu's tensor-parallel sample)."""
    tmp = tmp_path_factory.mktemp("sampling")
    cfg = dict(njoints=263, nfeats=1, mask_frames=True, **WIDTHS)
    jmodel = jm.MDM(jm.MDMConfig(**cfg))
    text = np.random.default_rng(3).normal(size=(B, 512)).astype(np.float32)
    cond = jm.Conditioning(frames_mask=jnp.ones((B, T), bool), text_embed=jnp.asarray(text))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((B, T, 263)),
                         jnp.zeros((B,), jnp.int32), cond)
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (B, T, 263), jnp.float32))
    sd = bridge.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                     MDMConfig(**cfg))
    torch.save({"state_dict": sd, "text_embed": text, "noise": noise}, tmp / "inputs.pt")
    launch_local_multihost(
        2, module="mdm_tpu_torch.scripts.parallel_check",
        extra_argv=["sample", "--out", str(tmp), "--device", "cpu", "--inputs",
                    str(tmp / "inputs.pt"), "--keep",
                    "--batch", str(B), "--frames", str(T), "--steps", str(STEPS),
                    "--latent_dim", "32", "--ff_size", "64", "--layers", "2", "--heads", "4"],
        extra_env={"OMP_NUM_THREADS": "2"}, timeout=120)
    out = torch.load(tmp / "sample.pt", weights_only=False)
    prev = jmesh._active_mesh
    try:
        mesh = jmesh.make_mesh(model_parallel=2)  # 4 data x 2 model
        gen = JMotionGenerator(jmodel, params, JSchedule.create("cosine", 1000, str(STEPS)),
                               JGenerationConfig(guidance_scale=2.5, sampler="ddim"),
                               "humanml", mesh=mesh)
        jax_tp = np.asarray(gen.sample_features(cond, B, T, key))
    finally:
        jmesh._active_mesh = prev
    return out, jax_tp


def test_dp_ddim_is_the_one_process_sample_bitwise(world):
    out, _ = world
    assert out["dp_ddim"]["equal"], out["dp_ddim"]
    assert torch.equal(out["samples"]["dp_ddim"], out["samples"]["one_ddim"])
    assert out["samples"]["dp_ddim"].shape == (B, T, 263)


def test_dp_autoregressive_is_the_one_process_sample_bitwise(world):
    assert world[0]["dp_ar"]["equal"], world[0]["dp_ar"]


def test_dp_ddpm_is_finite_and_the_rank_streams_differ(world):
    ddpm = world[0]["dp_ddpm"]
    assert ddpm["finite"] and ddpm["halves_differ"], ddpm


def test_tp_ddim_matches_the_one_process_sample(world):
    tp = world[0]["tp_ddim"]
    assert tp["max_abs"] <= TP_ATOL, tp


def test_tp_ddim_matches_jax_tensor_parallel_sample(world):
    out, jax_tp = world
    np.testing.assert_allclose(out["samples"]["tp_ddim"].numpy(), jax_tp, rtol=0, atol=TP_ATOL)


def test_predictor_serves_a_request_on_every_rank(world):
    serve = world[0]["serve_tp"]
    assert serve["ranks"] == 2 and serve["model_parallel"] == 2, serve
    assert serve["heads_per_rank"] == 2 and serve["finite"], serve
    assert serve["same_on_every_rank"] and serve["shape"] == [1, T, 22, 3], serve
