"""The port's spans: named host intervals around the work of a request or a
train step, as ranges in ``torch.profiler``'s trace.

    with span("denoiser.forward"):
        ...

    @traced("text.encode")
    def forward(self, tokens): ...

While no profiler records, ``span`` returns one shared no-op context: no
clock read, no profiler range, no allocation. While ``torch.profiler``
records, each span opens a profiler range of its name, so the trace it
exports, and what reads that trace, shows the span on the profiler's own
clock, beside the operations launched inside it.

The range is ``record_function``'s own C++ path (``_RecordFunctionFast``):
it costs about a microsecond, against about 16 for ``record_function``'s
dispatched ops. A span is a host interval only: opening or closing one
never waits for the device.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

_NOOP = contextlib.nullcontext()
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that marks ``name``'s interval while a profiler records,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _range(name)


def traced(name: str):
    """Decorates a function so that each call runs inside a ``name`` span."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
