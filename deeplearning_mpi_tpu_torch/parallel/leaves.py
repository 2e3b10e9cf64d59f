"""Each parameter leaf of a process as a leaf of the reference's whole model.

The reference's parameters are global arrays: a stage leaf of the
pipelined LM is one ``[S, ...]`` array sharded over ``pipe``, an expert
stack one ``[E, in, out]`` array sharded over ``expert``, a Megatron kernel
one flax ``[in, out]`` array sharded over ``model``. Rules that read a leaf's
shape (ZeRO-1's placement, ``parallel.zero.zero1_dim``) and optimizers that
reduce over a leaf (Adafactor's factored moments and its block RMS,
``train.adafactor``) decide on that whole array. A process of the port holds
one or more MEMBERS of it: its stage, its experts, its model shard (in the
one-process forms, several of each).

:class:`LeafView` says, for one member, what the whole leaf is and how the
member sits in it: the whole shape in the reference's layout (flax's
``[in, out]`` for a Dense weight, which the port stores ``[out, in]``; the
stage stack as dim 0), which of its dims are split and over which axis
(``pipe``, ``expert``, ``model``), and the member's coordinate on each.
:func:`leaf_views` builds them for a model; :class:`Reducer` sums
per-member partials over exactly the members of one whole leaf that differ
on the reduced axes: locally among the members a process holds, then over
the axes' process groups (``sum_over``, the identity in the one-process
forms). Every rank calls the same collectives, one for each of the
model's axes, whatever it holds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from deeplearning_mpi_tpu_torch.runtime import collectives

#: The split axes, in the mesh's order.
AXES = ("pipe", "expert", "model")


@dataclasses.dataclass(frozen=True)
class LeafView:
    """One member of a whole leaf. ``key``: the whole leaf's name (shared by
    its members); ``shape``: the whole leaf in the reference's layout;
    ``split``: reference dim -> the axis that splits it; ``coords``: this
    member's index on each splitting axis; ``stacked``: dim 0 is the stage
    stack (a member holds one stage, stored without that dim);
    ``transposed``: the port stores the member as the transpose of the
    reference's."""

    key: str
    shape: tuple[int, ...]
    split: dict[int, str]
    coords: dict[str, int]
    stacked: bool = False
    transposed: bool = False

    def ref(self, t: torch.Tensor) -> torch.Tensor:
        """The member in the reference's layout (its stage a dim of 1)."""
        t = t.T if self.transposed else t
        return t[None] if self.stacked else t

    def port(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`ref`."""
        t = t[0] if self.stacked else t
        return t.T if self.transposed else t

    def port_dim(self, d: int) -> int | None:
        """A dim of the reference's whole leaf as a dim of the member as the
        port stores it (None: the stage dim, which the member lacks)."""
        if self.stacked:
            if d == 0:
                return None
            d -= 1
        return 1 - d if self.transposed else d

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def leaf_views(model: Any) -> dict[str, LeafView]:
    """:class:`LeafView` of each of ``model``'s parameters, by its own name
    (a model held whole: each leaf its own whole). Cached on the model."""
    cached = model.__dict__.get("_leaf_views")
    if cached is not None:
        return cached
    from deeplearning_mpi_tpu_torch.models.convert import flat_name, transposed_from_jax
    from deeplearning_mpi_tpu_torch.parallel.expert_parallel import is_expert_leaf
    from deeplearning_mpi_tpu_torch.parallel.pipeline import PipeLayout
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import split_name

    tp_layout = getattr(model, "tp_layout", None)
    pipe_layout = getattr(model, "pipe_layout", None)
    experts = getattr(model, "expert_shards", None)
    stages = 1 if pipe_layout is None else pipe_layout.num_stages
    per_stage = None if pipe_layout is None else model.config.num_layers // stages
    views = {}
    for name, p in model.named_parameters():
        whole, shard = split_name(name)
        base, stage = PipeLayout.split(whole) if pipe_layout is not None else (whole, None)
        flat = whole if per_stage is None else flat_name(whole, per_stage)
        shape, split, coords = list(p.shape), {}, {}
        if shard is not None:
            d = tp_layout.dims[whole]
            shape[d] *= tp_layout.tp.size
            split[d], coords["model"] = "model", shard
        if experts is not None and is_expert_leaf(name, p):
            shape[0] *= experts.size
            split[0], coords["expert"] = "expert", experts.rank
        transposed = p.dim() == 2 and transposed_from_jax(flat)
        if transposed:
            shape = shape[::-1]
            split = {1 - d: a for d, a in split.items()}
        if stage is not None:
            shape = [stages] + shape
            split = {0: "pipe", **{d + 1: a for d, a in split.items()}}
            coords["pipe"] = stage
        views[name] = LeafView(base, tuple(shape), split, coords, stage is not None, transposed)
    model.__dict__["_leaf_views"] = views
    return views


def axis_sums(model: Any) -> dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """Each split axis's sum over its process group (no gradient; the
    identity where one process holds every member)."""
    out = {}
    pipe_layout = getattr(model, "pipe_layout", None)
    if pipe_layout is not None:
        out["pipe"] = pipe_layout.sum_over
    experts = getattr(model, "expert_shards", None)
    if experts is not None:
        out["expert"] = experts.sum_over
    tp_layout = getattr(model, "tp_layout", None)
    if tp_layout is not None:
        out["model"] = tp_layout.sum_over
    return out


class Reducer:
    """Sums of per-member partials over the members of a whole leaf that
    differ on given axes. ``views``: the members' :class:`LeafView` by
    name; ``sums``: :func:`axis_sums` (none: one process holds every
    member)."""

    def __init__(self, views: dict[str, LeafView],
                 sums: dict[str, Callable[[torch.Tensor], torch.Tensor]] | None = None) -> None:
        sums = sums or {}
        self.views, self.sums = views, sums
        self.axes = [a for a in AXES if a in sums]

    def axes_of(self, name: str, dims: tuple[int, ...] | None = None) -> tuple[str, ...]:
        """The axes that split ``dims`` of ``name``'s whole leaf (all its
        dims when None), in :data:`AXES` order."""
        split = self.views[name].split
        return tuple(a for a in self.axes if any(
            axis == a and (dims is None or d in dims) for d, axis in split.items()))

    def __call__(self, partials: dict[tuple[str, str], torch.Tensor],
                 over: dict[tuple[str, str], tuple[str, ...]]) -> dict:
        """``partials[(tag, n)]`` summed over the members of ``n``'s whole
        leaf that share its coordinates on every axis but ``over[(tag,
        n)]``; the result has each partial's shape. One collective for each
        of the model's axes, on every rank: a sum over two axes is the sum
        over one, then over the other."""
        groups: dict[tuple, list] = {}
        for k in partials:
            tag, n = k
            v, axes = self.views[n], over[k]
            keep = tuple(sorted((a, c) for a, c in v.coords.items() if a not in axes))
            groups.setdefault((axes, tag, v.key, keep), []).append(k)
        out = {g: _sum_list([partials[k] for k in keys]) for g, keys in groups.items()}
        home = next(iter(partials.values()))
        acc = torch.promote_types(home.dtype, torch.float32)
        for axis in self.axes:
            mine = [g for g in out if axis in g[0]]
            flat = torch.cat([out[g].reshape(-1).to(acc) for g in mine]
                             + [torch.zeros(1, dtype=acc, device=home.device)])
            flat = self.sums[axis](flat)
            offset = 0
            for g in mine:
                t = out[g]
                out[g] = flat[offset:offset + t.numel()].view(t.shape).to(t.dtype)
                offset += t.numel()
        return {k: out[g] for g, keys in groups.items() for k in keys}


def reducer(model: Any) -> Reducer:
    """The :class:`Reducer` of ``model``'s leaves; cached on the model."""
    cached = model.__dict__.get("_leaf_reducer")
    if cached is None:
        cached = model.__dict__["_leaf_reducer"] = Reducer(leaf_views(model), axis_sums(model))
    return cached


def _sum_list(xs: list[torch.Tensor]) -> torch.Tensor:
    """The sum of ``xs`` in list order, on the first's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return total
