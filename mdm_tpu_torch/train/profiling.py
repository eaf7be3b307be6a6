"""Profiling helpers: wall-clock KV scopes, device traces and named regions.

Counterpart of mdm_tpu/train/profiling.py. ``timed`` is the reference's
wall-clock scope (diffusion/logger.py:293-317); ``trace`` records a
``torch.profiler`` trace (host and, where a card is visible, CUDA kernel
activity) into a directory that TensorBoard's profiler plugin reads, and
``annotate`` names a region in that trace and, on the card, in NVTX.
"""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def timed(name: str, logger=None):
    """Wall-clock scope; logs `wait_<name>` like the reference profile_kv."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if logger is not None:
            logger.logkv_mean(f"wait_{name}", elapsed)
        else:
            print(f"[profile] {name}: {elapsed:.3f}s")


def start_trace(log_dir: str):
    """A started ``torch.profiler.profile`` that writes its trace into
    ``log_dir`` when stopped (``stop_trace``)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> None:
    """Wait for the card's queued work, then stop ``prof`` and write its trace."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    print(f"[profile] trace written to {log_dir}")


@contextlib.contextmanager
def trace(log_dir: str = "save/profile_trace"):
    """Record a torch.profiler trace of the enclosed work into ``log_dir``."""
    prof = start_trace(log_dir)
    try:
        yield log_dir
    finally:
        stop_trace(prof, log_dir)


@contextlib.contextmanager
def annotate(name: str):
    """Named region: a ``record_function`` range in the profiler's trace
    and, when a card is visible, an NVTX range."""
    import torch

    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
