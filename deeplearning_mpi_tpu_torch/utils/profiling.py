"""Profiling and step-level timing.

Port of the reference's ``utils/profiling.py``:

- :class:`Profiler` wraps ``torch.profiler``: a trace of a few hot steps
  (host operators and, on the card, every CUDA kernel under its C++ name),
  written into ``trace_dir`` as a Chrome trace (Perfetto or
  ``chrome://tracing`` open it). The reference's ``start_server`` (a live
  capture port for TensorBoard) has no counterpart: ``torch.profiler`` has
  no server to attach to, and a trace is taken from inside the process.
- :class:`StepTimer` measures per-step wall time under asynchronous CUDA
  launches (a ``time.perf_counter`` round a step measures the launches,
  not the card's work) by a sync on a sampling cadence: one every
  ``sync_every`` steps, the elapsed time shared evenly over the window.
- :func:`measure_collective_latency` times a gradient-sized all-reduce
  over a process group.
- :func:`nan_debug_mode`: PyTorch has no ``jax_debug_nans``; forward hooks
  on every module raise at the first non-finite output and name the module,
  and ``torch.autograd.set_detect_anomaly`` names the backward op. Each
  hook reads its output on the host (a sync a module): a debug mode, never
  on by default.
"""

from __future__ import annotations

import os
import statistics
import time
from pathlib import Path
from typing import Any, Iterable

import torch

from deeplearning_mpi_tpu_torch.runtime.collectives import world_size


def _tensors(x: Any) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def host_sync(x: Any) -> None:
    """Wait for the card(s) holding the tensors of ``x`` (a tensor, or a
    dict / list / tuple of them) to finish their queued work; nothing for
    CPU tensors."""
    for device in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(device)


class Profiler:
    """``torch.profiler`` over a window of steps, written as a Chrome trace
    into ``trace_dir`` (``trace-<pid>-<n>.json``, one a window)."""

    def __init__(self, trace_dir: str | Path | None = None) -> None:
        self.trace_dir = str(trace_dir) if trace_dir else None
        self._prof: Any = None
        self.traces: list[Path] = []

    def start_server(self, port: int = 9999) -> None:
        """No counterpart: ``torch.profiler`` has no live capture server."""
        raise NotImplementedError(
            "Profiler.start_server has no PyTorch counterpart: torch.profiler takes traces "
            "from inside the process (start / stop, or --profile_dir); there is no live "
            "capture port to attach TensorBoard to")

    def start(self) -> None:
        if not self.trace_dir or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
            # The window starts from an idle card: no kernel of an earlier
            # step lands in it.
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # every kernel of the window finishes inside it
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        out = Path(self.trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace-{os.getpid()}-{len(self.traces)}.json"
        prof.export_chrome_trace(str(path))
        self.traces.append(path)

    def trace_steps(self, step_fn, *args, num_steps: int = 3):
        """Trace ``num_steps`` calls of ``step_fn``; returns the last result."""
        self.start()
        try:
            out = None
            for _ in range(num_steps):
                out = step_fn(*args)
            host_sync(out)
            return out
        finally:
            self.stop()

    def __enter__(self) -> "Profiler":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


class StepTimer:
    """Per-step timing under asynchronous launches, with percentiles.

    :meth:`tick` once a step with the step's output (any tensor or tree of
    them). Every ``sync_every`` steps it waits for the output and shares
    the elapsed wall time evenly over the window's steps: one sync a
    window."""

    def __init__(self, sync_every: int = 10) -> None:
        self.sync_every = sync_every
        self.durations_s: list[float] = []
        self._window_start: float | None = None
        self._pending = 0
        self._last_output: Any = None

    def _close_window(self) -> None:
        host_sync(self._last_output)
        now = time.perf_counter()
        per_step = (now - self._window_start) / self._pending
        self.durations_s.extend([per_step] * self._pending)
        self._window_start = now
        self._pending = 0

    def tick(self, step_output: Any) -> None:
        if self._window_start is None:
            # First call: sync so the window starts from an idle device.
            host_sync(step_output)
            self._window_start = time.perf_counter()
            return
        self._pending += 1
        self._last_output = step_output
        if self._pending >= self.sync_every:
            self._close_window()

    def summary(self, items_per_step: int | None = None) -> dict[str, float]:
        """Latency percentiles (and throughput with ``items_per_step``, the
        global items of a step). Closes the trailing partial window first
        (one more sync), so an epoch shorter than ``sync_every`` reports."""
        if self._pending:
            self._close_window()
        if not self.durations_s:
            return {}
        d = sorted(self.durations_s)
        out = {
            "steps_timed": float(len(d)),
            "step_ms_p50": statistics.median(d) * 1e3,
            "step_ms_p90": d[int(0.9 * (len(d) - 1))] * 1e3,
            "step_ms_p95": d[int(0.95 * (len(d) - 1))] * 1e3,
            "step_ms_max": d[-1] * 1e3,
        }
        if items_per_step:
            mean = sum(d) / len(d)
            out["items_per_s"] = items_per_step / mean
            out["items_per_s_per_device"] = out["items_per_s"] / world_size()
        return out


def measure_collective_latency(group: Any = None, *, num_floats: int = 1 << 20,
                               trials: int = 10,
                               device: str | torch.device | None = None) -> dict[str, float]:
    """Time an all-reduce of ``num_floats`` float32 a rank over ``group``
    (default: the world): mean and min milliseconds and the implied
    algorithmic bandwidth. Every rank of the group must call it."""
    import torch.distributed as dist

    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        # 0.0, not inf: no byte crosses a link on a group of one.
        return {"all_reduce_ms_mean": 0.0, "all_reduce_ms_min": 0.0,
                "axis_size": 1.0, "bus_gbps": 0.0}
    if device is None:
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    x = torch.ones(num_floats, dtype=torch.float32, device=device)
    dist.all_reduce(x, group=group)  # warm the communicator
    host_sync(x)
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        host_sync(x)
        times.append(time.perf_counter() - t0)
    bytes_moved = 2 * (n - 1) / n * num_floats * 4
    return {
        "all_reduce_ms_mean": sum(times) / len(times) * 1e3,
        "all_reduce_ms_min": min(times) * 1e3,
        "axis_size": float(n),
        "bus_gbps": bytes_moved / min(times) / 1e9,
    }


def _check_finite(name: str):
    def hook(module, inputs, output) -> None:
        for t in _tensors(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"--debug_nans: non-finite output from module '{name}' "
                    f"({type(module).__name__}, shape {tuple(t.shape)})")
    return hook


def nan_debug_mode(enable: bool = True, model: torch.nn.Module | None = None) -> None:
    """Turn NaN debugging on or off: ``torch.autograd.set_detect_anomaly``
    (the backward op that made a NaN raises with its forward's stack),
    and, with ``model``, a forward hook on each of its modules that raises
    ``FloatingPointError`` at the first non-finite floating output and
    names the module (children run first, so the innermost module that
    made it). Off removes the model's hooks."""
    torch.autograd.set_detect_anomaly(enable)
    if model is None:
        return
    for handle in model.__dict__.pop("_nan_hooks", []):
        handle.remove()
    if enable:
        model.__dict__["_nan_hooks"] = [m.register_forward_hook(_check_finite(name or "<root>"))
                                        for name, m in model.named_modules()]
