"""``mdm_tpu_torch.cli.train`` as a two-process gloo world on the CPU.

A one-process run (in this process) and a two-process run (spawned by
``launch_local_multihost`` under a time limit of its own; each rank loads
its half of every batch of 4 through the loader's ``shard=``) train 4
steps on tests/test_cli.py's synthetic HumanML3D tree from the same seed.
The two-process checkpoint, read with ``restore_pytree_numpy``, is the
one-process one within tests/test_multihost.py:139-146's own tolerance
(rtol 1e-4, atol 1e-5): the gradient is summed in another order. args.json
and the progress log exist once, written by rank 0 alone (a log row per
step, not two), and only rank 0 saves. A second two-process world that
resumes from the first one's step-2 checkpoint writes its step-4
checkpoint bitwise.

``cli.eval_humanml --eval_mode debug`` of a model trained with one
diffusion step (whose DDPM step at t = 0 adds no noise, so the sample is a
function of the initial noise alone, which every rank draws whole and
slices) runs in a two-process world: each rank samples its 16 rows of
every batch of 32 and the metrics come from the gathered samples. The
summary rank 0 writes equals the one-process run's, bitwise, and the log
holds one line a replication (rank 0 alone appends to it).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import test_cli  # noqa: E402

from mdm_tpu_torch.cli import train as train_cli  # noqa: E402
from mdm_tpu_torch.parallel.multihost import launch_local_multihost  # noqa: E402
from mdm_tpu_torch.train import restore_pytree_numpy  # noqa: E402

ARGS = ["--dataset", "humanml", "--batch_size", "4", "--latent_dim", "32", "--layers", "2",
        "--diffusion_steps", "8", "--log_interval", "1", "--num_steps", "4",
        "--save_interval", "2", "--use_ema", "true", "--device", "cpu"]


def _two_processes(cwd, save_dir, data_dir, *extra):
    return launch_local_multihost(
        2, module="mdm_tpu_torch.cli.train",
        extra_argv=["--save_dir", str(save_dir), "--data_dir", data_dir, *ARGS, *extra],
        extra_env={"OMP_NUM_THREADS": "2"}, timeout=120, cwd=str(cwd))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, np.ndarray):
        yield prefix, tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work dir, outputs of the two ranks, data dir): the one-process and
    the two-process runs on test_cli.py's synthetic tree, built once."""
    tmp = tmp_path_factory.mktemp("multihost_cli")
    synthetic_humanml = test_cli.synthetic_humanml.__wrapped__(tmp)
    cwd = os.getcwd()
    os.chdir(tmp)  # the dataset's parse cache goes under ./save
    try:
        train_cli.main(["--save_dir", str(tmp / "one"), "--data_dir", synthetic_humanml, *ARGS])
    finally:
        os.chdir(cwd)
    return tmp, _two_processes(tmp, tmp / "two", synthetic_humanml), synthetic_humanml


def test_two_process_train_reproduces_the_one_process_checkpoint(runs):
    tmp = runs[0]
    a = restore_pytree_numpy(str(tmp / "one" / "ckpt_000000004"))
    b = restore_pytree_numpy(str(tmp / "two" / "ckpt_000000004"))
    assert a["step"] == b["step"] == 4
    leaves = dict(_leaves(b))
    assert {k for k, _ in _leaves(a)} == set(leaves)
    for name, want in _leaves(a):
        np.testing.assert_allclose(leaves[name], want, rtol=1e-4, atol=1e-5, err_msg=name)


def test_rank_0_alone_writes_args_logs_and_checkpoints(runs):
    tmp, outs, _ = runs
    two = tmp / "two"
    assert outs[0].count("saved checkpoint") == 2 and "saved checkpoint" not in outs[1]
    assert sorted(f for f in os.listdir(two) if f.startswith("ckpt_")) == [
        "ckpt_000000002", "ckpt_000000004"]
    with open(two / "args.json") as f:
        assert json.load(f)["batch_size"] == 4
    with open(two / "progress.csv") as f:
        assert len(f.read().splitlines()) == 1 + 4  # the header and rank 0's row a step


def test_resume_inside_the_two_process_world_is_bitwise(runs):
    tmp, _, data = runs
    _two_processes(tmp, tmp / "resumed", data, "--resume_checkpoint",
                   str(tmp / "two" / "ckpt_000000002"))
    want = dict(_leaves(restore_pytree_numpy(str(tmp / "two" / "ckpt_000000004"))))
    got = dict(_leaves(restore_pytree_numpy(str(tmp / "resumed" / "ckpt_000000004"))))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_two_process_eval_humanml_is_the_one_process_eval(runs):
    from mdm_tpu_torch.cli import eval_humanml, train_evaluators
    from mdm_tpu_torch.scripts.quality_rehearsal import write_glove

    tmp, _, data = runs
    work = tmp / "eval"
    work.mkdir()
    glove = write_glove(os.path.dirname(data), ["a", "person", "walk"])
    ev = ["--data_dir", data, "--glove_dir", glove, "--num_steps", "1", "--batch_size", "2",
          "--movement_dim", "8", "--coemb_dim", "8", "--device", "cpu"]
    finest = work / "t2m" / "text_mot_match" / "model" / "finest.npy"
    finest.parent.mkdir(parents=True)
    train_evaluators.main(["--stage", "decomp", "--save_path", str(work / "decomp.npy"), *ev])
    train_evaluators.main(["--stage", "match", "--save_path", str(finest), "--decomp_path",
                           str(work / "decomp.npy"), *ev])
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        train_cli.main(["--save_dir", str(work / "run"), "--data_dir", data, *ARGS[:8],
                        "--diffusion_steps", "1", "--num_steps", "1", "--save_interval", "1",
                        "--device", "cpu"])
    finally:
        os.chdir(cwd)
    argv = ["--model_path", str(work / "run"), "--data_dir", data, "--eval_mode", "debug",
            "--replications", "2", "--evaluator_dir", str(work), "--device", "cpu"]
    stem = work / "run" / "eval_ckpt_000000001_debug_gscale2.5"
    eval_humanml.main(argv)
    with open(f"{stem}.json") as f:
        one = json.load(f)
    for ext in (".json", ".log"):
        os.remove(f"{stem}{ext}")
    launch_local_multihost(2, module="mdm_tpu_torch.cli.eval_humanml", extra_argv=argv,
                           extra_env={"OMP_NUM_THREADS": "2"}, timeout=120, cwd=str(tmp))
    with open(f"{stem}.json") as f:
        assert json.load(f) == one
    with open(f"{stem}.log") as f:
        assert f.read().count("Replication") == 2
