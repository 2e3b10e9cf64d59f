"""Warmup by CUDA-graph capture: pay the host's cost before traffic.

Port of the serving half of ``deeplearning_mpi_tpu/compiler/aot.py``. The
reference lowers and compiles each serving program ahead of time, and a
compiled executable never retraces. PyTorch runs eagerly, so there is
nothing to compile; what a step costs the host is its ~700 kernel launches.
The port's counterpart is one ``torch.cuda.CUDAGraph`` per program and
static shape, captured before traffic and replayed with one host call:

- :class:`CapturedProgram` is one program at one shape: static input
  buffers, the graph captured over them (on one shared graph memory pool)
  and its static output. A call copies the caller's arrays into the
  buffers and replays. On the CPU there is no graph: the buffers are built
  the same way and each call runs the program on them eagerly.
- :class:`WarmProgram` picks the captured program for a call's shape and
  runs a shape that warmup did not capture eagerly, as the reference's
  ``WarmProgram`` falls back to ``jit`` (``fallback_calls`` counts it).

A replay makes no host call into a kernel's wrapper, so the launch counts
the wrappers keep (``flash_decode_cuda.launches`` and its int8 count) would
miss it: each capture records the counts its kernels added, takes them
back (a capture runs nothing), and each replay adds them again.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

__all__ = ["CapturedProgram", "WarmProgram", "kernel_counters"]


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
    before capture, as PyTorch's graph notes require), then is captured on
    that stream into a graph whose memory comes from ``pool``. The eager
    run's kernel launches are real and stay counted. On the CPU the one
    eager run is all warmup does.
    """

    def __init__(
        self,
        fn: Callable[..., torch.Tensor],
        inputs: Sequence[torch.Tensor],
        *,
        pool: Any = None,
        stream: torch.cuda.Stream | None = None,
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
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(stream)
        before = {key: getattr(*key) for key in kernel_counters()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.output = fn(*self.inputs)
        self.launches = {key: getattr(*key) - n for key, n in before.items()
                         if getattr(*key) != n}
        _add_counts(self.launches, -1)

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
