"""Multi-process bootstrap over torch.distributed, and replication helpers.

Counterpart of mdm_tpu/parallel/multihost.py. One process per device; each
process feeds only its row range of every global batch (data/loader.py
``shard=``). Activation is launcher-driven through the same environment
variables, so one ``mdm_tpu_torch.cli.train`` invocation runs in one
process, under torchrun, or under an explicit coordinator:

  MDM_TPU_COORDINATOR   host:port of rank 0 (presence turns this on)
  MDM_TPU_NUM_PROCESSES world size
  MDM_TPU_PROCESS_ID    this process's rank
  MDM_TPU_MULTIHOST=auto  read torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
                          MASTER_PORT instead (``init_method="env://"``)
  MDM_TPU_DIST_BACKEND  ``nccl`` or ``gloo``; by default nccl where a CUDA
                          device is visible, else gloo

NCCL takes one device a rank. Gloo also runs CUDA tensors (all_reduce and
broadcast), so two gloo ranks can share one card. ``launch_local_multihost``
spawns an N-process world on localhost, on the CPU or on the card; it backs
the tests and the chip smoke's two-rank phase.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import torch

TIMEOUT = datetime.timedelta(seconds=600)  # a collective that waits longer raises


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK (torchrun and
    ``launch_local_multihost`` set it), else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device() -> torch.device:
    """The device of this rank: ``cuda:{local_rank % device_count}`` where a
    CUDA device is visible, else the CPU. Two gloo ranks on a one-card host
    share ``cuda:0``."""
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def maybe_initialize_distributed(backend: Optional[str] = None) -> int:
    """Initialise torch.distributed from the environment and return the
    rank; 0, with nothing initialised, when the environment asks for no
    world. A second call returns the rank. A requested nccl world without
    a CUDA device raises."""
    import torch.distributed as dist

    mode = os.environ.get("MDM_TPU_MULTIHOST", "")
    coord = os.environ.get("MDM_TPU_COORDINATOR", "")
    if not coord and mode != "auto":
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    if mode == "auto":
        init, r, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        init = f"tcp://{coord}"
        r, world = int(os.environ["MDM_TPU_PROCESS_ID"]), int(os.environ["MDM_TPU_NUM_PROCESSES"])
    backend = backend or os.environ.get("MDM_TPU_DIST_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("an nccl world needs a CUDA device a rank, and none is visible; "
                               "set MDM_TPU_DIST_BACKEND=gloo for a CPU world")
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init, world_size=world, rank=r,
                            timeout=TIMEOUT)
    return r


def is_primary() -> bool:
    """True on the process that owns file-side effects (logs, args.json,
    checkpoints)."""
    return rank() == 0


def barrier() -> None:
    dist = _dist()
    if dist and dist.get_world_size() > 1:
        dist.barrier()


def _broadcast(t: torch.Tensor) -> None:
    """t from rank 0, in place. NCCL moves only CUDA tensors: a CPU one
    (AdamW's step count) goes through the rank's card."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        tmp = t.to(local_device())
        dist.broadcast(tmp, src=0)
        t.copy_(tmp)
    else:
        dist.broadcast(t, src=0)


def _state_tensors(obj):
    """The tensors of a module (parameters, then buffers) or of a train
    state (its model's, the EMA's, then AdamW's per parameter), in an order
    every rank shares."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    out = _state_tensors(obj.model)
    if obj.ema_params is not None:
        out += [obj.ema_params[k] for k in sorted(obj.ema_params)]
    for p in obj.model.parameters():
        state = obj.optimizer.state.get(p, {})
        out += [state[k] for k in sorted(state) if isinstance(state[k], torch.Tensor)]
    return out


@torch.no_grad()
def replicate(obj):
    """Broadcast a module's or a train state's every tensor from rank 0, in
    place, and return it: afterwards every rank holds rank 0's values. A
    world of one returns its input untouched."""
    if world_size() == 1:
        return obj
    for t in _state_tensors(obj):
        _broadcast(t.data)
    return obj


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local_multihost(
    num_processes: int,
    module: str = "mdm_tpu_torch.parallel.multihost",
    extra_argv: Optional[list] = None,
    extra_env: Optional[dict] = None,
    timeout: float = 600.0,
    device: str = "cpu",
    backend: Optional[str] = None,
    cwd: Optional[str] = None,
) -> list:
    """Spawn an N-process world on localhost, one device a process: the CPU
    (CUDA hidden, gloo) or, with ``device="cuda"``, the card of each local
    rank (nccl by default; ``backend="gloo"`` lets ranks share one card).
    ``module`` runs with ``-m`` in ``cwd`` (the repository root by default;
    the repository is on the path either way). Returns each process's
    output; raises on any nonzero exit with every process's output
    attached, and on ``timeout`` kills every process and raises."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"launch_local_multihost runs on cpu or cuda, not {device!r}")
    port = find_free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update(MDM_TPU_COORDINATOR=f"localhost:{port}",
                   MDM_TPU_NUM_PROCESSES=str(num_processes), MDM_TPU_PROCESS_ID=str(pid),
                   LOCAL_RANK=str(pid),
                   MDM_TPU_DIST_BACKEND=backend or ("gloo" if device == "cpu" else "nccl"))
        env.pop("MDM_TPU_MULTIHOST", None)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [repo, env.get("PYTHONPATH")]))
        if device == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-m", module] + (extra_argv or []), env=env, cwd=cwd or repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, rcs = [], []
    deadline = time.monotonic() + timeout  # one limit for the whole world
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.0))
            outs.append(out)
            rcs.append(p.returncode)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        raise
    if any(rcs):
        raise RuntimeError("multihost launch failed (rcs=%s)\n%s" % (
            rcs, "\n".join(f"--- process {i} ---\n{o}" for i, o in enumerate(outs))))
    return outs


def _dryrun_worker() -> None:
    """One process of the multi-process dryrun: a data-parallel mesh over
    the world, this rank's rows of a global batch, one train step of a
    2-layer, 64-wide MDM; the loss is printed (the same on every rank)."""
    maybe_initialize_distributed()
    import numpy as np

    from ..diffusion import Schedule
    from ..models import MDM, Conditioning, MDMConfig
    from ..train import OptimConfig, TrainStepConfig, create_train_state, make_train_step
    from .mesh import make_mesh, shard_batch

    r, world = rank(), world_size()
    mesh = make_mesh()
    B, T = 2 * world, 32
    cfg = MDMConfig(njoints=263, nfeats=1, latent_dim=64, ff_size=128, num_layers=2,
                    num_heads=4)
    model = MDM(cfg).init_weights(torch.Generator().manual_seed(0)).to(mesh.device)
    config = TrainStepConfig(optim=OptimConfig(lr=1e-4))
    state = replicate(create_train_state(model, config.optim))
    step = make_train_step(Schedule.create("cosine", 50).to(mesh.device), config, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = shard_batch({"x": rng.normal(size=(B, T, 263)).astype(np.float32),
                         "mask": np.ones((B, T), bool),
                         "cond": Conditioning(text_embed=torch.zeros(B, 512))},
                        mesh, global_batch=True)
    state, metrics = step(state, batch, 1)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    print(f"multihost dryrun p{r}/{world}: devices={world} loss={loss:.6f} ok", flush=True)


if __name__ == "__main__":
    _dryrun_worker()
