"""Shared plumbing of the sequence-parallel schedules and the sharded step.

Port of ``deeplearning_mpi_tpu/parallel/seq_common.py`` (``repeat_grouped``,
``with_divisibility_fallback``) plus what the port needs in place of
``shard_map``: the two forms in which a schedule's per-rank step runs.

- :class:`GroupRing`, the process-group form: this process is one rank of
  the mesh's seq group and holds its ``[B, S/n, H, D]`` shards; a rotation
  is a send and receive round the group (``runtime.collectives``).
- :class:`LockstepRing`, the one-process form: one device holds the global
  ``[B, S, H, D]`` tensors and runs the ``n`` ranks' steps in lockstep; a
  rotation is a roll of the list of shards. It is the counterpart of the
  reference's factories over a virtual-device mesh (the same per-rank step,
  the same kernel calls, shifts and merge order), and what lets one card run
  the ring: NCCL refuses two ranks on one device.

A schedule holds one value a simulated rank in a list (one entry in the
process-group form) and loops over ``ring.ranks`` for its per-rank work,
so both forms run the same code. The MoE layer's routing over a sharded
sequence (``models.moe``) reads the group through the same two forms:
:meth:`GroupRing.all_gather` (every rank's value, no gradient),
:meth:`GroupRing.reduce` (the sum, identity backward: each rank's gradient
is its own share) and :meth:`GroupRing.gather` (the whole sequence, the
backward this rank's block).

**The one-process grid.** Two axes in one process are two of these
one-process forms side by side, each module calling its own axis's object:
``LockstepPipe`` x ``LockstepTP`` (pipeline stages of tensor-parallel
blocks), ``LockstepTP`` x ``LockstepRing`` (a ring or Ulysses attention fn
at each model rank's local heads), ``LockstepRing`` beside the MoE layer
(its routing run shard by shard with the cross-shard prefix) and
``LockstepTP`` inside the expert stacks.

:class:`SeqShards` is the train step's side: which slice of its whole rows
this process runs through the model, at which positions, and the shard's
share of the next-token loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from deeplearning_mpi_tpu_torch.ops.attention import repeat_kv
from deeplearning_mpi_tpu_torch.runtime import collectives


def repeat_grouped(core: Callable) -> Callable:
    """Wrap a matching-head-count attention core to accept GROUPED K/V (the
    fallback paths of the ``gqa_native`` factories)."""

    def fn(q, k, v, *, causal: bool = True, **kw):
        r = q.shape[2] // k.shape[2]
        return core(q, repeat_kv(k, r), repeat_kv(v, r), causal=causal, **kw)

    return fn


def with_divisibility_fallback(
    sp: int, sharded: Callable[[bool, int | None], Callable], fallback: Callable,
) -> Callable:
    """The one-process factories' attention fn over global ``[B, S, H, D]``
    tensors: ``sharded(causal, window)`` when ``sp`` divides the sequence;
    batch 1 (a single sequence) takes ``fallback``, a whole-sequence core;
    any other shape raises, since a real training shape must not silently
    lose its sequence sharding. (The reference also checks the batch against
    its data axis: the one-process form has none.)"""

    def attention_fn(q, k, v, *, causal: bool = True, window: int | None = None):
        if q.shape[1] % sp == 0:
            return sharded(causal, window)(q, k, v)
        if q.shape[0] == 1:
            kw = {"window": window} if window is not None else {}
            return fallback(q, k, v, causal=causal, **kw)
        raise ValueError(
            f"attention input [batch={q.shape[0]}, seq={q.shape[1]}] not divisible by mesh "
            f"(seq={sp}); pad the sequence length or change the mesh axes")

    return attention_fn


class GroupRing:
    """The process-group form: this process is rank ``ranks[0]`` of ``n``."""

    def __init__(self, group: dist.ProcessGroup | None) -> None:
        self.group = group
        self.n = dist.get_world_size(group)
        self.ranks = [dist.get_rank(group)]

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [x]

    def join(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def shift(self, xs: list[torch.Tensor], offset: int = 1, *,
              autograd: bool = False) -> list[torch.Tensor]:
        """Each rank's value sent ``offset`` ranks on (received from
        ``rank - offset``); ``autograd``: the gradient goes back."""
        fn = collectives.ring_shift_autograd if autograd else collectives.ring_shift
        return [fn(xs[0], self.group, offset=offset)]

    def all_to_all(self, xs: list[torch.Tensor], split_axis: int,
                   concat_axis: int) -> list[torch.Tensor]:
        """The tiled all-to-all, differentiable (backward: the inverse)."""
        return [collectives.all_to_all_autograd(xs[0], self.group, split_axis=split_axis,
                                                concat_axis=concat_axis)]

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """``[n, ...]``: every rank's value stacked in rank order (no
        gradient)."""
        return [collectives.all_gather(xs[0].detach()[None], self.group, axis=0)]

    def reduce(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The sum over the ranks; the backward is the identity, so each
        rank's gradient is its own share of a replicated total."""
        return collectives.reduce_from_group(xs[0], self.group)

    def gather(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The whole sequence (dim 1) from every rank's shard; the backward
        keeps this rank's block."""
        return collectives.gather_from_group(xs[0], self.group, axis=1)


class LockstepRing:
    """The one-process form: ``n`` ranks, each a shard of the sequence axis
    (dim 1) of a global tensor on this device."""

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.n = n
        self.ranks = list(range(n))

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        return list(x.chunk(self.n, dim=1))

    def join(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, dim=1)

    def shift(self, xs: list[torch.Tensor], offset: int = 1, *,
              autograd: bool = False) -> list[torch.Tensor]:
        return [xs[(i - offset) % self.n] for i in self.ranks]

    def all_to_all(self, xs: list[torch.Tensor], split_axis: int,
                   concat_axis: int) -> list[torch.Tensor]:
        n = self.n
        if xs[0].shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(xs[0].shape)} not "
                             f"divisible by the ring's {n} ranks")
        blocks = [x.chunk(n, dim=split_axis) for x in xs]
        return [torch.cat([blocks[j][i] for j in range(n)], dim=concat_axis) for i in range(n)]

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        every = torch.stack([x.detach() for x in xs])
        return [every for _ in self.ranks]

    def reduce(self, xs: list[torch.Tensor]) -> torch.Tensor:
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return total

    def gather(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, dim=1)


@dataclasses.dataclass(frozen=True)
class SeqShards:
    """This process's place on the seq axis: rank ``rank`` of ``size`` in
    ``group``. Every rank of the group holds the same whole rows ``[B, S]``
    and runs its slice ``[r*S/n, (r+1)*S/n)`` through the model. ``replica``
    is the data x seq group that shares a parameter replica, ``data_size``
    its data degree: the gradients are summed over it and divided by that."""

    group: dist.ProcessGroup | None
    size: int
    rank: int
    replica: dist.ProcessGroup | None = None
    data_size: int = 1

    def local_len(self, seq: int) -> int:
        if seq % self.size:
            raise ValueError(f"sequence length {seq} not divisible by the seq axis ({self.size})")
        return seq // self.size

    def inputs(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's slice of the rows and its global positions (RoPE)."""
        local = self.local_len(tokens.shape[1])
        start = self.rank * local
        positions = torch.arange(start, start + local, device=tokens.device)
        return tokens[:, start:start + local], positions[None].expand(tokens.shape[0], local)

    def lm_loss(self, logits: torch.Tensor, tokens: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
        """This rank's share of ``ops.loss.lm_cross_entropy`` on the whole
        rows: its positions predict the next token, across the shard edge
        (the last rank's last position has none), and the denominator is
        the whole rows' count of valid targets. Summed over the group, the
        shares give the whole rows' loss."""
        from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy_slice

        start = self.rank * self.local_len(tokens.shape[1])
        return lm_cross_entropy_slice(logits, tokens, start, mask)

    def chunked_lm_loss(self, x: torch.Tensor, head_kernel: torch.Tensor, tokens: torch.Tensor,
                        mask: torch.Tensor | None, chunk_size: int) -> torch.Tensor:
        """This rank's share of ``ops.loss.chunked_lm_loss`` on the whole
        rows, from its slice's pre-head activations: its own positions in
        chunks, the last predicting across the shard edge, over the whole
        rows' count of valid targets (:meth:`lm_loss`'s rule)."""
        from deeplearning_mpi_tpu_torch.ops.loss import chunked_lm_loss_slice

        start = self.rank * self.local_len(tokens.shape[1])
        return chunked_lm_loss_slice(x, head_kernel, tokens, start, chunk_size=chunk_size,
                                     mask=mask)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group (no gradient)."""
        return collectives.all_reduce_sum(x, self.group)
