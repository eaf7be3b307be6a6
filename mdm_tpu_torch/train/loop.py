"""Host-side training loop around the train step.

Counterpart of mdm_tpu/train/loop.py (:28-189; reference
train/training_loop.py:37-475): it feeds batches, logs KVs, checkpoints
and runs the eval/generate callbacks. In a multi-process world every rank
runs the loop on its rows (each batch through ``parallel.shard_batch``);
rank 0 alone writes args.json, the progress logs, the platform's reports,
the generated media and each checkpoint, which every rank then waits for
at a barrier. On resume every rank reads the same checkpoint onto its own
device.

Resume is bit exact: the step's randomness is ``step_key(rng_seed, step)``,
a pure function of the step index (JAX's ``fold_in``), a data iterable
with ``iter_from(step)`` is fast-forwarded to the resumed step, and every
kernel reduction runs in a fixed order. Metric sums stay on the device
until a log window closes, so the host reads the card once per window.

With ``profile_trace_dir`` set, steps 2..6 run under torch.profiler
(train/profiling.py) and their trace is written there, the program's spans
in it (utils/tracing.py: ``train.batch`` around each batch from the
loader, and the step's own).

Env hook: MDM_TPU_TRAINING_TEST=1 stops after the first save (the
reference's DIFFUSION_TRAINING_TEST seam, training_loop.py:241).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from ..parallel.mesh import Mesh, mesh_grid, shard_batch
from ..parallel.multihost import barrier, is_primary
from ..utils.tracing import span
from .checkpoints import find_resume_checkpoint, restore_checkpoint, save_args, save_checkpoint
from .logger import KVLogger
from .platforms import NoPlatform, TrainPlatform
from .profiling import start_trace, stop_trace
from .state import TrainState
from .train_step import step_key


@dataclass
class LoopConfig:
    save_dir: str = "save/run"
    num_steps: int = 600_000
    log_interval: int = 1_000
    save_interval: int = 50_000
    eval_during_training: bool = False
    gen_during_training: bool = False
    resume: bool = True
    # explicit checkpoint to resume from; a checkpoint in save_dir wins
    # (reference training_loop.py:131)
    resume_checkpoint: str = ""
    # non-empty: a torch.profiler trace of steps 2..6 (after the first
    # steps' kernel builds and warm-up) into this directory
    profile_trace_dir: str = ""


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,
        state: TrainState,
        data_iter: Iterable,
        config: LoopConfig,
        *,
        args: Optional[Dict[str, Any]] = None,
        platform: Optional[TrainPlatform] = None,
        eval_fn: Optional[Callable[[Any, int], Dict[str, float]]] = None,
        gen_fn: Optional[Callable[[Any, int], Optional[str]]] = None,
        rng_seed: int = 10,
        mesh: Optional[Mesh] = None,
    ):
        self.train_step = train_step
        self.state = state
        self.config = config
        self.is_primary = is_primary()
        self.platform = platform or NoPlatform(config.save_dir)
        self.logger = KVLogger(config.save_dir if self.is_primary else None)
        self.eval_fn = eval_fn
        self.gen_fn = gen_fn
        self.rng_seed = rng_seed
        self.device = next(state.model.parameters()).device
        # One rank on the model's device when no mesh is given.
        self.mesh = mesh if mesh is not None else Mesh(*mesh_grid(1), device=self.device)

        os.makedirs(config.save_dir, exist_ok=True)
        if args is not None and self.is_primary:
            save_args(config.save_dir, args)
            self.platform.report_args(args, "args")

        if config.resume:
            found = find_resume_checkpoint(config.save_dir)
            if not found and config.resume_checkpoint:
                found = (config.resume_checkpoint, -1)
            if found:
                path, step = found
                print(f"resuming from {path}" + (f" (step {step})" if step >= 0 else ""))
                self.state = restore_checkpoint(path, self.state)

        if hasattr(data_iter, "iter_from"):
            self.data_iter = data_iter.iter_from(self.step)
        else:
            self.data_iter = iter(data_iter)

    @property
    def step(self) -> int:
        return self.state.step

    def run(self):
        cfg = self.config
        t_last = time.time()
        acc: Optional[Dict[str, torch.Tensor]] = None  # metric sums of the window, on device
        acc_n = 0
        batch_size = None
        prof = None  # the torch.profiler of steps 2..6, while it records
        try:
            while self.step < cfg.num_steps:
                if cfg.profile_trace_dir and self.step == 2 and prof is None:
                    prof = start_trace(cfg.profile_trace_dir)
                with span("train.batch"):
                    batch = next(self.data_iter)
                batch = shard_batch(batch, self.mesh)
                if batch_size is None:
                    # the global batch: every rank holds its rows
                    batch_size = (int(batch["x"].shape[0]) * self.mesh.data_parallel
                                  if "x" in batch else 0)
                self.state, metrics = self.train_step(self.state, batch,
                                                      step_key(self.rng_seed, self.step))
                if acc is None:
                    acc = {k: v.clone() for k, v in metrics.items()}
                else:
                    for k, v in metrics.items():
                        acc[k] += v
                acc_n += 1

                step = self.step
                if prof is not None and step >= 7:
                    stop_trace(prof, cfg.profile_trace_dir)
                    prof = None
                if step % cfg.log_interval == 0 or step == cfg.num_steps:
                    # One read of the card per window; it also waits for every
                    # step of the window, so steps_per_sec is end to end.
                    for k, v in acc.items():
                        self.logger.logkv(k, v.item() / acc_n)
                    window, acc, acc_n = acc_n, None, 0
                    self.logger.logkv("step", step)
                    sps = window / max(time.time() - t_last, 1e-9)
                    self.logger.logkv("steps_per_sec", sps)
                    if batch_size:
                        self.logger.logkv("samples_per_sec", sps * batch_size)
                    t_last = time.time()
                    for k, v in self.logger.dumpkvs().items():
                        self.platform.report_scalar(k, v, step, group_name="Loss")

                if step % cfg.save_interval == 0 or step == cfg.num_steps:
                    self.save()
                    if self.eval_fn and cfg.eval_during_training:
                        for k, v in (self.eval_fn(self.state, step) or {}).items():
                            self.platform.report_scalar(k, v, step, group_name="Eval")
                    if self.gen_fn and cfg.gen_during_training and self.is_primary:
                        media = self.gen_fn(self.state, step)
                        for m in ([media] if isinstance(media, str) else media or []):
                            self.platform.report_media("Motion", "gen", step, m)
                    if os.environ.get("MDM_TPU_TRAINING_TEST", ""):
                        print("MDM_TPU_TRAINING_TEST set: stopping after first save")
                        return
        finally:
            if prof is not None:
                stop_trace(prof, cfg.profile_trace_dir)

    def save(self):
        """Rank 0 writes the checkpoint; every rank returns once it is whole.
        Every rank of a tensor-parallel state takes part in its gather."""
        path = None
        if self.is_primary or self.state.tp is not None:
            path = save_checkpoint(self.config.save_dir, self.step, self.state)
        if self.is_primary:
            print(f"saved checkpoint {path}")
        barrier()
        return path
