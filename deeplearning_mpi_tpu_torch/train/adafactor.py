"""Adafactor over the reference's whole leaves: ``optax.adafactor(lr,
multiply_by_parameter_scale=False)``'s factored second moments and its
block RMS clip, for the members of those leaves that one process holds.

The reference's optimizer sees global arrays: a stage leaf of the pipelined
LM as one stacked ``[S, ...]`` array, an expert stack as ``[E, in, out]``,
a Megatron kernel as its unsharded flax ``[in, out]``. So the factoring is
decided on that whole leaf (``parallel.leaves.LeafView``), each factor is
this member's part of the whole leaf's, and every mean or norm over a dim
that another member holds part of is summed over those members
(``parallel.leaves.Reducer``). This module also owns how the factors are
saved: :func:`gather_slots` makes them the whole leaves', as a checkpoint
holds them, and :func:`local_slots` cuts them back.
"""

from __future__ import annotations

from typing import Any

import torch

from deeplearning_mpi_tpu_torch.parallel.leaves import LeafView, leaf_views
from deeplearning_mpi_tpu_torch.runtime import collectives

#: ``optax.adafactor``'s: factor only tensors with two dims of at least
#: 128; second-moment decay ``1 - (count + 1) ** -0.8``; eps added to g**2;
#: each tensor's update clipped to RMS 1.0 (``clip_by_block_rms``).
MIN_DIM, DECAY, EPS, CLIP = 128, 0.8, 1e-30, 1.0
#: The slots, and the factored dim each of the factors reduces away:
#: ``v_row`` drops the larger of the two, ``v_col`` the other; ``v`` is the
#: full second moment of an unfactored leaf.
SLOTS = {"v_row": 1, "v_col": 0, "v": None}


def _factored_dims(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest; ties in axis order), or None when the second is under 128."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # stable, as np.argsort
    if shape[order[-2]] < MIN_DIM:
        return None
    return order[-2], order[-1]


def factored_dims(view: LeafView) -> tuple[int, int] | None:
    """:func:`_factored_dims` of the reference's whole leaf, which a member
    of a stage stack never has as one of the two."""
    dims = _factored_dims(view.shape)
    if dims is not None and view.stacked and 0 in dims:
        raise NotImplementedError("adafactor factoring a pipeline's stage dim (a stage count "
                                  f"of at least {MIN_DIM}) is not ported")
    return dims


def init(p: torch.Tensor, view: LeafView) -> tuple[torch.Tensor, ...]:
    """``(v_row, v_col, v)``: the row and column factors (in the reference's
    layout) of a factored tensor, else the full second moment; the unused
    slots are ``zeros(1)``, as in optax's ``FactoredState``. The factors
    are this member's part of the whole leaf's (without the stage dim of a
    stage stack)."""
    ref = view.ref(p)
    dims = factored_dims(view)
    one = torch.zeros(1, dtype=p.dtype, device=p.device)
    if dims is None:
        return one, one.clone(), torch.zeros_like(p)
    d1, d0 = dims
    cut = 1 if view.stacked else 0
    row = [n for i, n in enumerate(ref.shape) if i != d0][cut:]
    col = [n for i, n in enumerate(ref.shape) if i != d1][cut:]
    return (torch.zeros(row, dtype=p.dtype, device=p.device),
            torch.zeros(col, dtype=p.dtype, device=p.device), one)


def scale(
    grads: dict[str, torch.Tensor], state: dict[str, Any], leaves: Any, decay: torch.Tensor,
) -> tuple[dict[str, torch.Tensor], dict[str, dict[str, torch.Tensor]]]:
    """optax's ``scale_by_factored_rms`` then ``clip_by_block_rms(1)`` of
    the reference's whole leaves, for this process's members of them
    (``leaves``: a ``parallel.leaves.Reducer``): the factoring decided on
    the whole leaf, in the reference's layout; ``g**2``'s row and column
    means, ``v_row``'s mean over its row dim and the update's RMS summed
    over the members that split the dims they reduce. Returns ``(updates,
    new v_row / v_col / v)``."""
    views = leaves.views
    dims = {n: factored_dims(views[n]) for n in grads}
    refs = {n: views[n].ref(g) for n, g in grads.items()}
    factored = [n for n in grads if dims[n] is not None]
    parts, over = {}, {}
    for n in factored:
        d1, d0 = dims[n]
        sq = refs[n] * refs[n] + EPS
        for tag, d in (("row", d0), ("col", d1)):
            parts[(tag, n)] = sq.sum(dim=d)
            over[(tag, n)] = leaves.axes_of(n, (d,))
    sums = leaves(parts, over) if parts else {}
    new = {key: {} for key in SLOTS}
    stage = lambda n, t: t[None] if views[n].stacked else t  # noqa: E731
    rows, cols = {}, {}
    for n in factored:
        d1, d0 = dims[n]
        shape = views[n].shape
        rows[n] = decay * stage(n, state["v_row"][n]) + (1.0 - decay) * sums[("row", n)] / shape[d0]
        cols[n] = decay * stage(n, state["v_col"][n]) + (1.0 - decay) * sums[("col", n)] / shape[d1]
        parts[("row_mean", n)] = rows[n].sum(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
        over[("row_mean", n)] = leaves.axes_of(n, (d1,))
    means = leaves({k: v for k, v in parts.items() if k[0] == "row_mean"}, over) if rows else {}
    updates = {}
    for n, g in grads.items():
        if dims[n] is None:
            new["v"][n] = decay * state["v"][n] + (1.0 - decay) * (g * g + EPS)
            new["v_row"][n], new["v_col"][n] = state["v_row"][n], state["v_col"][n]
            updates[n] = g * new["v"][n] ** -0.5
            continue
        d1, d0 = dims[n]
        row_factor = (rows[n] / (means[("row_mean", n)] / views[n].shape[d1])) ** -0.5
        u = refs[n] * row_factor.unsqueeze(d0) * (cols[n] ** -0.5).unsqueeze(d1)
        updates[n] = views[n].port(u)
        cut = (lambda t: t[0]) if views[n].stacked else (lambda t: t)
        new["v_row"][n], new["v_col"][n], new["v"][n] = cut(rows[n]), cut(cols[n]), state["v"][n]
    squares = leaves({("rms", n): (u * u).sum() for n, u in updates.items()},
                     {("rms", n): leaves.axes_of(n) for n in updates})
    for n, u in updates.items():
        rms = torch.sqrt(squares[("rms", n)] / views[n].size)
        updates[n] = u / torch.clamp(rms / CLIP, min=1.0)
    return updates, new


# -- checkpoints ------------------------------------------------------------------
def _slot_dims(view: LeafView, slot: str) -> dict[str, int | None]:
    """Each axis that splits the whole leaf (but ``pipe``, whose members
    the pipeline's layout stacks) -> the dim of this member's ``slot`` it
    splits, or None where the slot does not keep that dim (a factor that
    reduced it away, or ``zeros(1)``, the slot a leaf does not use:
    replicated)."""
    dims = factored_dims(view)
    split = {d: a for d, a in view.split.items() if a != "pipe"}
    if slot == "v":
        return {a: None if dims is not None else view.port_dim(d) for d, a in split.items()}
    if dims is None:
        return {a: None for a in split.values()}
    gone = dims[SLOTS[slot]]
    kept = [d for d in range(len(view.shape)) if d != gone and not (view.stacked and d == 0)]
    return {a: kept.index(d) if d in kept else None for d, a in split.items()}


def gather_slots(model: Any, slots: dict[str, dict[str, torch.Tensor]]) -> dict:
    """The slots (this process's members, by the model's own names) as the
    whole model's: each slot gathered over the expert and model axes that
    split a dim it keeps (a collective over the group in the process-group
    forms), one copy where it does not keep that dim, then the stage stacks
    stacked (the pipeline's gather). Keyed by the whole model's names, as
    ``TrainState.arrays``."""
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import split_name

    views = leaf_views(model)
    experts = getattr(model, "expert_shards", None)
    tp_layout = getattr(model, "tp_layout", None)
    pipe_layout = getattr(model, "pipe_layout", None)
    out = {}
    for slot, tree in slots.items():
        whole: dict[str, dict[int, torch.Tensor]] = {}
        for n, t in tree.items():
            axes = _slot_dims(views[n], slot)
            if axes.get("expert") is not None:
                t = collectives.all_gather(t, experts.group, axis=axes["expert"])
            whole.setdefault(split_name(n)[0], {})[views[n].coords.get("model", 0)] = t
        merged = {}
        for name, members in whole.items():
            n = tp_layout.names[name][0] if tp_layout is not None else name
            k = _slot_dims(views[n], slot).get("model")
            if k is None:
                merged[name] = members[0]
            else:
                merged[name] = tp_layout.tp.whole([members[i] for i in sorted(members)], k)
        out[slot] = merged if pipe_layout is None else pipe_layout.gather(merged)
    return out


def local_slots(model: Any, slots: dict[str, dict[str, torch.Tensor]]) -> dict:
    """The inverse of :func:`gather_slots`: the whole model's slots cut to
    this process's members, by the model's own names (copies)."""
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import split_name

    views = leaf_views(model)
    experts = getattr(model, "expert_shards", None)
    tp_layout = getattr(model, "tp_layout", None)
    pipe_layout = getattr(model, "pipe_layout", None)
    out = {}
    for slot, tree in slots.items():
        if pipe_layout is not None:
            tree = pipe_layout.local(tree)
        mine = {}
        for n in views:
            name, i = split_name(n)
            t, axes = tree[name], _slot_dims(views[n], slot)
            if axes.get("model") is not None:
                t = tp_layout.tp.shards_of(t, axes["model"])[i]
            if axes.get("expert") is not None:
                t = t.chunk(experts.size, axes["expert"])[experts.rank]
            mine[n] = t.clone()
        out[slot] = mine
    return out
