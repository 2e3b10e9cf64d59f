"""BatchNorm with the reference's semantics, global-batch under data parallelism.

The reference's CNNs use flax ``nn.BatchNorm``, and under data parallelism
their statistics are the GLOBAL batch's: GSPMD keeps the program's
unsharded meaning, so the batch mean of a ``data``-sharded array is the
global mean (``deeplearning_mpi_tpu/models/resnet.py``). Neither
``torch.nn.BatchNorm2d`` nor ``SyncBatchNorm`` computes what flax does, so
the port has its own:

- moments in at least float32 whatever the input dtype, the variance
  BIASED and by flax's fast form ``max(0, E[x²] - E[x]²)``
  (``nn.BatchNorm2d`` and ``SyncBatchNorm`` update the running variance
  with the unbiased one);
- the flax momentum rule ``ra = m·ra + (1-m)·batch`` with m = 0.9, eps
  1e-5, the running statistics as buffers (``running_mean``,
  ``running_var``);
- normalisation ``(x - mean)·rsqrt(var + eps)·scale + bias`` in (at
  least) float32, cast to the compute ``dtype``;
- with a data-parallel group bound (:func:`set_group`), ``(Σx, Σx², n)``
  are summed across it through the autograd-aware all-reduce, so every rank
  normalises by the global batch's moments and the backward sums their
  gradients: one rank of W computes what one process computes on the W
  ranks' rows. There is no silent drop to local statistics while a group
  is bound.

Under ``torch.utils.checkpoint`` (the UNet's ``remat``) the forward runs
again in the backward: :func:`checkpoint_contexts` marks that rerun, and
the running statistics advance once, in the first forward.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
from torch import nn

from deeplearning_mpi_tpu_torch.models.moe import MoEMLP
from deeplearning_mpi_tpu_torch.runtime.collectives import all_reduce_sum_autograd

_state = threading.local()


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_state, "recomputing", False)
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = prev


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation runs
    with the running-statistics update off."""
    return contextlib.nullcontext(), _recomputing()


def _layout(x: torch.Tensor) -> tuple[list[int], list[int], torch.dtype]:
    """Reduction dims, the per-channel broadcast shape and the (at least
    float32) dtype of the arithmetic, for a channels-first ``x``."""
    dims = [0, *range(2, x.dim())]
    return dims, [1, x.shape[1]] + [1] * (x.dim() - 2), torch.promote_types(x.dtype, torch.float32)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 of a channels-first tensor; see the
    module docstring. ``scale_init`` is the scale's initial value (the
    ResNets zero the last norm of each block)."""

    def __init__(self, num_features: int, *, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, scale_init: float = 1.0,
                 device=None) -> None:
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.full((num_features,), scale_init, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        #: the data-parallel group whose global batch the statistics span
        #: (None: this process's batch).
        self.group: dist.ProcessGroup | None = None

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        self.weight.fill_(self.scale_init)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _batch_moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dims, _, acc = _layout(x)
        c = x.shape[1]
        xf = x.to(acc)
        s1, s2 = xf.sum(dim=dims), (xf * xf).sum(dim=dims)
        n = torch.full((1,), float(x.numel() // c), dtype=acc, device=x.device)
        if self.group is not None:
            total = all_reduce_sum_autograd(torch.cat([s1, s2, n]), self.group)
            s1, s2, n = total[:c], total[c:2 * c], total[2 * c:]
        mean = s1 / n
        return mean, torch.clamp(s2 / n - mean * mean, min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_moments(x)
            if not getattr(_state, "recomputing", False):
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1.0 - m) * mean)
                    self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        _, shape, acc = _layout(x)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.to(acc) - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


def set_group(model: nn.Module, group: dist.ProcessGroup | None) -> None:
    """Bind every module of ``model`` whose result spans the global batch,
    :class:`BatchNorm`'s moments and ``MoEMLP``'s load-balance loss, to the
    data-parallel ``group`` (None: this process's batch)."""
    for module in model.modules():
        if isinstance(module, (BatchNorm, MoEMLP)):
            module.group = group
