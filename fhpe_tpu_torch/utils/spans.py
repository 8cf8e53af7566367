"""Named host spans at the port's layer boundaries, on the profiler's clock.

``with span("fhpe.train.upload"): ...`` records one host event of that
name while a ``torch.profiler`` profile runs on the calling thread (the
benchmark's traced window, ``cli/train.py::StepProfiler``), on the same
clock as the profiler's device events; nothing is kept or written
elsewhere, and the profiler exports what it holds.  A span's parent is
the innermost span open around it on the same thread.  With the profiler
off, ``span`` returns one shared no-op context and builds nothing.

The event is an ordinary host event (``_RecordFunctionFast``), not a user
annotation as ``torch.profiler.record_function`` makes: the CUDA
profiler mirrors a user annotation on the device over the kernels it
encloses, and such a copy would read as device work.  The profiler
records host events only on the thread that started it, so a span opened
on another thread (serving's prefetch) is not recorded.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` (a static ``fhpe.`` string) as a
    host event while the profiler runs on this thread."""
    if not _profiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """A decorator: each call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap
