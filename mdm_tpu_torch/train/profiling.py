"""Device traces: counterpart of mdm_tpu/train/profiling.py's ``trace``.

``trace`` records a ``torch.profiler`` trace (host and, where a card is
visible, CUDA kernel activity) into a directory that TensorBoard's
profiler plugin reads. The program's named regions in it are the spans of
``utils/tracing.py``.
"""
from __future__ import annotations

import contextlib


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

