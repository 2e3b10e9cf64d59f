"""Collectives over the process group, on tensors or dicts of tensors.

Port of ``deeplearning_mpi_tpu/runtime/collectives.py``. The reference's
are XLA collectives named by a mesh axis inside ``shard_map``; these are
``torch.distributed`` calls over a process group (``None``: the world),
NCCL on the card and gloo on the CPU. Each returns new tensors and leaves
its input as it was; a dict is handled leaf by leaf, one collective a leaf.

======================  =====================================================
reference (XLA)         here (torch.distributed)
======================  =====================================================
``all_reduce_sum``      ``all_reduce`` SUM
``all_reduce_mean``     ``all_reduce`` SUM, divided by the group's size
``all_gather``          ``all_gather``, concatenated along ``axis``
``reduce_scatter``      ``reduce_scatter`` (gloo has none: all-reduce, then
                        this rank's block — the same function)
``ring_shift``          ``batch_isend_irecv`` to ``rank + offset``
``ppermute`` (a ring)   :func:`ring_shift_autograd` (backward: ``-offset``)
``ppermute`` (a line)   :func:`stage_shift`: ``(i, i + 1)`` without the
                        wrap (the pipeline's activations; ``-1``: their
                        gradients)
``all_to_all`` (tiled)  :func:`all_to_all_autograd` (backward: the
                        inverse all-to-all)
``broadcast_from``      ``broadcast``
======================  =====================================================

The Megatron pair (``copy_to_group``: identity forward, all-reduce-sum
backward; ``reduce_from_group``: all-reduce-sum forward, identity backward)
carries the sharded layers of expert and tensor parallelism, and
``gather_from_group`` the tables every rank of a group reads whole (the
backward keeps this rank's block: every rank computed the same gradient).

The ``_autograd`` functions have a backward: :func:`all_reduce_sum_autograd`
all-reduces the gradient (BatchNorm's global-batch moments go through it),
:func:`ring_shift_autograd` sends it back the other way round the ring (the
plain ring attention's rotations) and :func:`all_to_all_autograd` undoes
its own exchange (Ulysses attention).
``counts`` counts the calls of each function (not the leaves), so a caller
can check how often a path communicated.
"""

from __future__ import annotations

import collections
from typing import Any, Callable

import torch
import torch.distributed as dist

Tree = Any

#: Calls of each collective since the last reset (``counts.clear()``).
counts: collections.Counter[str] = collections.Counter()


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def axis_size(group: dist.ProcessGroup | None = None) -> int:
    """The group's size — the reference's ``axis_size``."""
    return dist.get_world_size(group)


def _global(group: dist.ProcessGroup | None, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def squares(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t``'s squares in its dtype promoted to at least float32
    (float64 for a float64 model): a global norm's partial, before its sum
    over a group."""
    x = t.to(torch.promote_types(t.dtype, torch.float32))
    return (x * x).sum()


def sharded_norm(tensors: dict[str, torch.Tensor],
                 axes: list[tuple[Callable[[str, torch.Tensor], bool],
                                  Callable[[torch.Tensor], torch.Tensor]]]) -> torch.Tensor:
    """``optax.global_norm`` of a model whose leaves are split over several
    axes at once: ``axes`` holds one ``(is_split(name, leaf), sum_over)`` an
    axis. Each leaf's squares are summed over exactly the axes that split
    it, so a leaf replicated over an axis counts once. Every class of leaves
    (each subset of the axes, in a fixed order) takes its sums, empty or
    not, so every rank calls the same collectives."""
    home = next(iter(tensors.values())).device
    buckets: dict[tuple[int, ...], torch.Tensor] = {}
    for n, t in tensors.items():
        key = tuple(i for i, (split, _) in enumerate(axes) if split(n, t))
        sq = squares(t).to(home)
        buckets[key] = sq if key not in buckets else buckets[key] + sq
    total = torch.zeros((), device=home)
    for mask in range(1 << len(axes)):
        key = tuple(i for i in range(len(axes)) if mask >> i & 1)
        x = buckets.get(key, torch.zeros((), device=home))[None]
        for i in key:
            x = axes[i][1](x)
        total = total + x[0]
    return torch.sqrt(total)


def all_reduce_sum(tree: Tree, group: dist.ProcessGroup | None = None) -> Tree:
    """Sum across the group."""
    counts["all_reduce_sum"] += 1

    def fn(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    return _map(fn, tree)


def all_reduce_mean(tree: Tree, group: dist.ProcessGroup | None = None) -> Tree:
    """Mean across the group: the data-parallel gradient (DDP's average)."""
    counts["all_reduce_mean"] += 1
    n = dist.get_world_size(group)

    def fn(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / n

    return _map(fn, tree)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum_autograd(x: torch.Tensor, group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Sum across the group, differentiable (what
    ``torch.distributed.nn.functional.all_reduce`` computes): the backward
    all-reduces the incoming gradient, so a term that every rank's loss
    reads through the sum gets the sum of their gradients."""
    counts["all_reduce_sum_autograd"] += 1
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group. Where
    a replicated activation enters a layer whose ranks each hold a part of
    the weights (a column-parallel projection, a rank's experts), each rank's
    gradient covers only its part."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (each rank's partial output of a row-parallel
    projection or of its experts); identity backward, since every rank reads
    the same sum."""
    return _ReduceFromGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, axis: int) -> torch.Tensor:
        n = dist.get_world_size(group)
        ctx.args = n, dist.get_rank(group), axis
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        n, rank, axis = ctx.args
        return grad.chunk(n, dim=axis)[rank].contiguous(), None, None


def gather_from_group(x: torch.Tensor, group, *, axis: int) -> torch.Tensor:
    """Every rank's block concatenated along ``axis``, differentiable; the
    backward keeps this rank's block of the gradient WITHOUT a sum over the
    group: for a table that every rank reads whole into the same replicated
    computation, every rank holds the same full gradient already (summing it
    would count it once a rank)."""
    counts["gather_from_group"] += 1
    return _GatherFromGroup.apply(x, group, axis)


def all_gather(tree: Tree, group: dist.ProcessGroup | None = None, *, axis: int = 0) -> Tree:
    """Every rank's value, concatenated along ``axis`` in rank order."""
    counts["all_gather"] += 1
    n = dist.get_world_size(group)

    def fn(x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    return _map(fn, tree)


def reduce_scatter(tree: Tree, group: dist.ProcessGroup | None = None, *, axis: int = 0) -> Tree:
    """Sum across the group, then keep this rank's block of ``axis`` (which
    the group's size must divide)."""
    counts["reduce_scatter"] += 1
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    gloo = dist.get_backend(group) == "gloo"

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.shape[axis] % n:
            raise ValueError(f"reduce_scatter: axis {axis} of {tuple(x.shape)} not divisible "
                             f"by the group's {n} ranks")
        if gloo:
            total = x.clone()
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
            return total.chunk(n, dim=axis)[rank].contiguous()
        blocks = [b.contiguous() for b in x.chunk(n, dim=axis)]
        out = torch.empty_like(blocks[0])
        dist.reduce_scatter(out, blocks, op=dist.ReduceOp.SUM, group=group)
        return out

    return _map(fn, tree)


def ring_shift(x: torch.Tensor, group: dist.ProcessGroup | None = None, *,
               offset: int = 1) -> torch.Tensor:
    """Send this rank's value ``offset`` steps around the ring (negative:
    backward) and receive from the opposite neighbour."""
    counts["ring_shift"] += 1
    return _ring_shift(x, group, offset)


def _ring_shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if offset % n == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _global(group, (rank + offset) % n), group),
           dist.P2POp(dist.irecv, out, _global(group, (rank - offset) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def stage_shift(sends: list[torch.Tensor], recv_like: list[torch.Tensor],
                group: dist.ProcessGroup | None = None, *, offset: int = 1) -> list[torch.Tensor]:
    """The non-wrapping shift of the pipeline (the reference's ``ppermute``
    over the ``(i, i + 1)`` permutation): this rank sends ``sends`` to rank
    ``rank + offset`` and receives tensors shaped as ``recv_like`` from
    ``rank - offset``. Either list may be empty (the line's ends, and a
    tick on which a neighbour holds no microbatch); every send must meet
    a receive of the same shapes. The sends and receives go in one
    ``batch_isend_irecv`` so that neither order can deadlock. Returns the
    received tensors."""
    counts["stage_shift"] += 1
    rank = dist.get_rank(group)
    received = [torch.empty_like(t) for t in recv_like]
    ops = [dist.P2POp(dist.isend, t.contiguous(), _global(group, rank + offset), group)
           for t in sends]
    ops += [dist.P2POp(dist.irecv, t, _global(group, rank - offset), group) for t in received]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return received


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, offset: int) -> torch.Tensor:
        ctx.group, ctx.offset = group, offset
        return _ring_shift(x, group, offset)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _ring_shift(grad, ctx.group, -ctx.offset), None, None


def ring_shift_autograd(x: torch.Tensor, group: dist.ProcessGroup | None = None, *,
                        offset: int = 1) -> torch.Tensor:
    """:func:`ring_shift`, differentiable: the gradient of the received value
    goes back to the rank that sent it (a shift by ``-offset``), as the
    transpose of ``lax.ppermute`` does."""
    counts["ring_shift_autograd"] += 1
    return _RingShift.apply(x, group, offset)


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} not divisible by "
                         f"the group's {n} ranks")
    if n == 1:
        return x.clone()
    blocks = [b.contiguous() for b in x.chunk(n, dim=split_axis)]
    parts = [torch.empty_like(blocks[0]) for _ in range(n)]
    dist.all_to_all(parts, blocks, group=group)
    return torch.cat(parts, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
        ctx.args = group, split_axis, concat_axis
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(grad, group, concat_axis, split_axis), None, None, None


def all_to_all_autograd(x: torch.Tensor, group: dist.ProcessGroup | None = None, *,
                        split_axis: int, concat_axis: int) -> torch.Tensor:
    """The tiled ``lax.all_to_all``, differentiable: cut ``split_axis`` into
    one block a rank, send block ``j`` to rank ``j``, and concatenate the
    blocks received along ``concat_axis`` in rank order. The backward is the
    inverse exchange (split the gradient along ``concat_axis``, gather it
    along ``split_axis``)."""
    counts["all_to_all_autograd"] += 1
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def broadcast_from(x: torch.Tensor, src: int = 0,
                   group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Every rank receives rank ``src``'s value (``src`` is a rank of the
    group)."""
    counts["broadcast_from"] += 1
    out = x.clone().contiguous()
    dist.broadcast(out, src=_global(group, src), group=group)
    return out
