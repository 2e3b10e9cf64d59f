"""Trace annotations for the hot paths.

Port of the reference's ``telemetry/trace.py``. :func:`annotate` stamps a
named range on both timelines a trace of the port has:

- ``torch.profiler.record_function``: the range and every operator and
  kernel launched inside it show under ``name`` in a ``torch.profiler``
  trace (``utils.profiling.Profiler``);
- an NVTX range (``torch.cuda.nvtx``) once CUDA is initialised, for tools
  that read NVTX.

Annotation is metadata: it never changes a computed value. The
``enabled`` switch lets a test run a step annotated and not and compare,
and strips the ranges wholesale from a microbenchmark; disabled, each call
is a no-op.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Iterator

import torch

_ENABLED = True


def set_enabled(flag: bool) -> bool:
    """Globally enable or disable annotation; returns the old value."""
    global _ENABLED
    old = _ENABLED
    _ENABLED = bool(flag)
    return old


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Context manager: a profiler range (and an NVTX range on CUDA) named ``name``."""
    if not _ENABLED:
        yield
        return
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate_fn(name: str) -> Callable[[Callable], Callable]:
    """Decorator form of :func:`annotate` for whole entry points."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any):
            with annotate(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
