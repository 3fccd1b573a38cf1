"""Named host spans on the profiler's timeline.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
is running, and one shared ``contextlib.nullcontext()`` otherwise.  The
guard reads ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets when its trace starts and clears when it stops.  With no
profiler running a ``record_function`` still dispatches two operators, 7 to
16 us a span on the hosts measured (an H100 machine's and a CPU-only
one's); the guarded span costs 0.2 to 0.8 us there.

A span goes on the profiler's clock, the clock of the device events of the
same trace.  The port puts spans only on the thread that launches device
work: a span on a reader's worker thread would overlap the launching
thread's and blur which host phase holds the device idle.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span"]

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records a host span ``name`` while a profiler
    runs, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL
