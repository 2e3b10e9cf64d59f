"""Warmup by CUDA-graph capture: pay the host's cost before traffic.

Port of ``deeplearning_mpi_tpu/compiler/aot.py``. The reference lowers and
compiles each program ahead of time, and a compiled executable never
retraces. PyTorch runs eagerly, so there is nothing to compile; what a step
costs the host is its kernel launches (~700 a serving step, thousands a
train step). The port's counterpart is one ``torch.cuda.CUDAGraph`` per
program and static shape, captured before traffic and replayed with one
host call:

- :class:`CapturedProgram` is one program at one shape: static input
  buffers, the graph captured over them (on one shared graph memory pool)
  and its static output. A call copies the caller's arrays into the
  buffers and replays. On the CPU there is no graph: the buffers are built
  the same way and each call runs the program on them eagerly.
- :class:`WarmProgram` picks the captured program for a call's shape and
  runs a shape that warmup did not capture eagerly, as the reference's
  ``WarmProgram`` falls back to ``jit`` (``fallback_calls`` counts it).
- :class:`CapturedStep` is the train step's half (``Trainer.warmup``): the
  whole step (forward, ``autograd.grad``, clip, the optimizer, the NaN
  guard, EMA) at one batch's shapes as one :class:`CapturedProgram`. The
  step updates the parameters and buffers in place; the optimizer state
  and EMA it returns are copied, inside the program, into static copies
  that the trainer's state then holds, so a replay leaves the state the
  eager step would have returned and no tensor of it is a graph output.
  The metrics are static outputs: each call hands out clones, so a
  buffered step record is never overwritten by a later replay. Warmup runs
  the step eagerly before the capture, so it snapshots the state first and
  puts it back bitwise: warmup does not train.

A replay makes no host call into a kernel's wrapper, so the launch counts
the wrappers keep (``flash_attention_cuda.launches``, its backward's,
``flash_decode_cuda.launches`` and its int8 count) would miss it: each
capture records the counts its kernels added, takes them back (a capture
runs nothing), and each replay adds them again.

What has no counterpart here: the reference's ``compile_program`` cost
analysis (``xla_flops_per_step`` / ``xla_bytes_per_step`` are n/a:
PyTorch has no cost analysis, as ``telemetry/flops.xla_cost_analysis``
says, and the gauges are never set) and its buffer donation (PyTorch
donates nothing; ``compiler/cache.py``).
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

__all__ = ["CapturedProgram", "CapturedStep", "WarmProgram", "batch_key", "kernel_counters"]


def kernel_counters() -> list[tuple[Any, str]]:
    """``(wrapper, attribute)`` of every kernel launch count the port keeps."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

    return [
        (fa.flash_attention_cuda, "launches"),
        (fa.flash_attention_bwd_dq_cuda, "launches"),
        (fa.flash_attention_bwd_dkv_cuda, "launches"),
        (fd.flash_decode_cuda, "launches"),
        (fd.flash_decode_cuda, "int8_launches"),
    ]


def _add_counts(counts: dict[tuple[Any, str], int], sign: int = 1) -> None:
    for (wrapper, attr), n in counts.items():
        setattr(wrapper, attr, getattr(wrapper, attr) + sign * n)


class CapturedProgram:
    """``fn`` (tensors -> tensor) at the shapes of ``inputs``, captured.

    ``inputs`` are example tensors; their clones are the static buffers.
    On CUDA the program runs once eagerly on ``stream`` (so that anything
    it allocates once, such as K4's per-stream arrival counters, exists
    before capture, as PyTorch's graph notes require; ``warmup_runs``
    times), then is captured on that stream into a graph whose memory
    comes from ``pool``. No cyclic garbage collection runs during the
    capture (one collection runs just before it). The eager runs' kernel
    launches are real and stay counted. ``counters`` are more ``(object, attribute)`` launch counts
    that a replay adds again, beside :func:`kernel_counters` (a
    tensor-parallel engine's per-rank counts). On the CPU the one eager run
    is all warmup does.
    """

    #: CUDA graphs captured in this process, by every program
    total_captures = 0

    def __init__(
        self,
        fn: Callable[..., torch.Tensor],
        inputs: Sequence[torch.Tensor],
        *,
        pool: Any = None,
        stream: torch.cuda.Stream | None = None,
        warmup_runs: int = 1,
        counters: Sequence[tuple[Any, str]] = (),
    ) -> None:
        self.fn = fn
        self.inputs = tuple(t.clone() for t in inputs)
        self.graph: torch.cuda.CUDAGraph | None = None
        #: kernel launches one replay makes, by (wrapper, attribute)
        self.launches: dict[tuple[Any, str], int] = {}
        if not self.inputs[0].is_cuda:
            self.output = fn(*self.inputs)
            return
        stream = stream if stream is not None else torch.cuda.Stream(self.inputs[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(warmup_runs):
                fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(stream)
        before = {key: getattr(*key) for key in [*kernel_counters(), *counters]}
        self.graph = torch.cuda.CUDAGraph()
        # A dead program's graph freed mid-capture (a dropped engine or
        # trainer in a reference cycle, reclaimed by a collection that the
        # capture's own allocations trigger) invalidates the capture: collect
        # before it, and not during it.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.output = fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.launches = {key: getattr(*key) - n for key, n in before.items()
                         if getattr(*key) != n}
        _add_counts(self.launches, -1)
        CapturedProgram.total_captures += 1

    def __call__(self, *args: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Copy ``args`` (numpy arrays or tensors of the captured shapes)
        into the static buffers and run the program. The output is the
        static one: read it before the next call of any program that shares
        the graph pool."""
        for buf, a in zip(self.inputs, args):
            buf.copy_(torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
        if self.graph is None:
            return self.fn(*self.inputs)
        self.graph.replay()
        _add_counts(self.launches)
        return self.output


class WarmProgram:
    """The warmed callable: the :class:`CapturedProgram` for the call's
    shape (``key(*args)``), else ``fallback`` (the eager program)."""

    def __init__(
        self,
        programs: dict[Hashable, CapturedProgram],
        fallback: Callable[..., torch.Tensor],
        key: Callable[..., Hashable],
    ) -> None:
        self.programs = programs
        self.fallback = fallback
        self.key = key
        self.fallback_calls = 0

    def __call__(self, *args: Any) -> torch.Tensor:
        program = self.programs.get(self.key(*args))
        if program is None:
            self.fallback_calls += 1
            return self.fallback(*args)
        return program(*args)


def batch_key(batch: dict[str, torch.Tensor]) -> Hashable:
    """A batch's shapes and dtypes, the key of its captured step."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_tree_(dst: Any, src: Any) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree_(dst[k], src[k])
    else:
        dst.copy_(src)


class CapturedStep:
    """The train step ``step(state, batch) -> (state, metrics)`` at the
    shapes of ``batch``, as one :class:`CapturedProgram` (module
    docstring). ``state`` is the trainer's; :attr:`opt_state` and
    :attr:`ema_params` are its static copies, which the returned states
    hold. ``warmup_runs`` eager steps run on a side stream before the
    capture (PyTorch's advice for a backward), and the parameters,
    buffers, optimizer state and EMA are then restored bitwise."""

    def __init__(self, step: Callable, state: Any, batch: dict[str, torch.Tensor], *,
                 pool: Any = None, warmup_runs: int = 3) -> None:
        self.step = step
        self.model = state.model
        self.keys = sorted(batch)
        self.opt_state = _tree_map(torch.clone, state.opt_state)
        self.ema_params = (None if state.ema_params is None
                           else _tree_map(torch.clone, state.ema_params))
        self.outputs: dict[str, torch.Tensor] | None = None
        self._state = dataclasses.replace(state, opt_state=self.opt_state,
                                          ema_params=self.ema_params)
        live = self._live()
        with torch.no_grad():
            saved = [t.clone() for t in live]
        self.program = CapturedProgram(self._run, [batch[k] for k in self.keys], pool=pool,
                                       warmup_runs=warmup_runs)
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)

    @property
    def graph(self) -> torch.cuda.CUDAGraph | None:
        return self.program.graph

    def _live(self) -> list[torch.Tensor]:
        """Every tensor the step updates: parameters, buffers, optimizer
        state, EMA."""
        out = [p.data for p in self.model.parameters()] + list(self.model.buffers())
        _tree_map(out.append, self.opt_state)
        if self.ema_params is not None:
            _tree_map(out.append, self.ema_params)
        return out

    def _keep(self, new: Any) -> None:
        with torch.no_grad():
            _copy_tree_(self.opt_state, new.opt_state)
            if self.ema_params is not None:
                _copy_tree_(self.ema_params, new.ema_params)

    def _run(self, *tensors: torch.Tensor) -> dict[str, torch.Tensor]:
        new, metrics = self.step(self._state, dict(zip(self.keys, tensors)))
        self._keep(new)
        with torch.no_grad():
            if self.outputs is None:
                self.outputs = {k: v.detach().clone() for k, v in metrics.items()}
            else:
                for k, v in metrics.items():
                    self.outputs[k].copy_(v)
        return self.outputs

    def hold(self, state: Any) -> Any:
        """``state`` holding the static optimizer state and EMA (their
        values copied in first when ``state`` holds others)."""
        if state.model is not self.model:
            raise ValueError("the captured step belongs to another model")
        if state.opt_state is not self.opt_state or state.ema_params is not self.ema_params:
            self._keep(state)
        return dataclasses.replace(state, opt_state=self.opt_state, ema_params=self.ema_params)

    def __call__(self, state: Any, batch: dict[str, torch.Tensor]) -> tuple[Any, dict]:
        state = self.hold(state)
        out = self.program(*[batch[k] for k in self.keys])
        metrics = {k: v.clone() for k, v in out.items()}
        return dataclasses.replace(state, step=state.step + 1), metrics

    def eager(self, state: Any, batch: dict[str, torch.Tensor]) -> tuple[Any, dict]:
        """The step run eagerly (a batch of another shape), its optimizer
        state and EMA kept in the static copies."""
        new, metrics = self.step(self.hold(state), batch)
        self._keep(new)
        return dataclasses.replace(new, opt_state=self.opt_state,
                                   ema_params=self.ema_params), metrics
