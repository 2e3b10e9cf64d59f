"""Tensor parallelism: the Megatron-sharded TransformerLM over the mesh's model axis.

Port of ``deeplearning_mpi_tpu/parallel/tensor_parallel.py``. The reference
shards leaves by a GSPMD rule on the ``model`` axis and lets XLA insert the
collectives; GSPMD has no counterpart here, so the port keeps the RULE
(:func:`tp_spec`, :func:`param_spec`: which dim of which leaf, with the
reference's ``min_size``) and writes out the layers it implies:

- a Megatron pair, column-parallel in (``q_proj``, ``k_proj``,
  ``v_proj``; ``gate_proj``, ``up_proj``: the output dim split) and
  row-parallel out (``out_proj``; ``down_proj``: the input dim split), is
  :class:`TPPair`: each rank runs the plain module at its local width (H/tp
  and Hkv/tp heads, d_ff/tp), the replicated input enters through the copy
  (identity forward, all-reduce backward) and the partial outputs are summed
  (all-reduce forward, identity backward): ONE all-reduce a pair forward and
  one backward. The sum runs in the compute dtype (bf16 under bf16, as the
  reference's reduce of a bf16 dot), in rank order;
- the embedding ``[V, d]`` (and an untied ``lm_head``, vocab-parallel by the
  rule) is stored as its shards (:class:`ShardedTable`), so the moments and
  checkpoints follow the rule, and gathered whole once a forward. Its
  gradient is this rank's block of the full table's gradient with NO sum
  over the group: after each row-parallel sum every rank holds the same
  activations, so every rank computes the same full gradient
  (``runtime.collectives.gather_from_group``). The untied head gathers its
  WEIGHT (not its output), as the embedding does;
- everything else (the norms, the residual stream, the loss) is replicated.

The rule decides on the reference's layout (flax kernels ``[in, out]``;
the port's ``Dense.weight`` is ``[out, in]``, ``models/convert.py``) and
the decision is mapped through the transpose. It can split one side of a
pair and not the other (``min_size`` against a small grouped ``k_proj``);
the port shards a pair only whole, and refuses a config where the rule
splits one, or whose heads (not only H*D) the degree does not divide.

Two forms, as ``parallel/seq_common.py`` has for the seq axis:

- :class:`GroupTP`, the process-group form: this process is one rank of
  the model group (NCCL or gloo) and holds one shard of each sharded leaf;
- :class:`LockstepTP`, the one-process form: one process holds all ``tp``
  shards (shard ``i`` on ``devices[i]``) and runs the ranks in a loop; the
  all-reduce is the sum of the list in rank order, the gather a
  concatenation. It is the counterpart of the reference's single
  controller, and what lets one card run TP: NCCL refuses two ranks on one
  device. Its replicated computation runs once, on ``devices[0]``.

Under MoE (the reference's ``ep_spec``, ``parallel/expert_parallel.py``)
each expert stack ``[E, in, out]`` is split Megatron-wise inside every
expert: ``experts_gate`` / ``experts_up`` on their last dim, ``experts_down``
on dim -2, whatever their size; the router stays replicated. The routed
layer (``models.moe.MoEMLP``) runs each rank's d_ff/tp slice of its experts
and sums the ``down`` partials over the model group before the combine.

A sharded model names rank ``i``'s shard of ``<module>.<leaf>`` as
``<module>.shards.<i>.<leaf>`` (``i`` indexes the form's local ranks: 0 in
the process-group form). :class:`TPLayout` maps trees of those names to the
whole model's tree and back (``gather`` / ``local``: checkpoints, the
reference's weights), and gives the whole model's global norm.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from deeplearning_mpi_tpu_torch.models.convert import transposed_from_jax
from deeplearning_mpi_tpu_torch.runtime import collectives

#: Path substrings marking kernels that project back into the residual
#: stream (sharded on the input dim: Megatron row-parallel).
ROW_PARALLEL_MARKERS = ("out_proj", "down_proj")

#: The reference's ``min_size``: smaller leaves stay replicated.
MIN_SIZE = 1024

_SHARD_NAME = re.compile(r"^(.*)\.shards\.(\d+)\.(.*)$")


def tp_spec(shape: tuple[int, ...], tp: int, *, min_size: int = MIN_SIZE,
            path: str = "") -> int | None:
    """The reference's rule for one leaf in the REFERENCE's layout: the dim
    sharded over ``model``, or None (replicated). Row-parallel leaves
    (:data:`ROW_PARALLEL_MARKERS` in the path) shard dim -2, every other
    leaf of two or more dims dim -1, when ``tp`` divides it and the leaf
    holds at least ``min_size`` elements."""
    n = len(shape)
    if tp <= 1 or n < 2 or math.prod(shape) < min_size:
        return None
    if any(marker in path for marker in ROW_PARALLEL_MARKERS):
        return n - 2 if shape[-2] % tp == 0 else None
    return n - 1 if shape[-1] % tp == 0 else None


def on_reference_layout(name: str, shape: tuple[int, ...],
                        rule: Callable[..., int | None], *per_dim: tuple) -> int | None:
    """``rule(shape, *per_dim)``, a dim-choosing rule of the reference, for
    the port's leaf ``name`` of ``shape``, as a dim of the PORT's layout: a
    Dense weight (``[out, in]`` here, flax's ``[in, out]``) is decided on
    its transpose, each ``per_dim`` tuple (one entry a dim) reversed with
    it, and the chosen dim mapped back."""
    shape = tuple(shape)
    if len(shape) == 2 and transposed_from_jax(name):
        d = rule(shape[::-1], *(tuple(x)[::-1] for x in per_dim))
        return None if d is None else 1 - d
    return rule(shape, *per_dim)


def param_spec(name: str, shape: tuple[int, ...], tp: int, *,
               min_size: int = MIN_SIZE) -> int | None:
    """:func:`tp_spec`'s decision for the port's leaf ``name`` of ``shape``
    (the whole leaf), as a dim of the port's layout."""
    return on_reference_layout(
        name, shape, lambda s: tp_spec(s, tp, min_size=min_size, path=name))


def split_name(name: str) -> tuple[str, int | None]:
    """``(whole model's name, local shard index)`` of a sharded model's leaf
    name; ``(name, None)`` for a replicated leaf."""
    m = _SHARD_NAME.match(name)
    if m is None:
        return name, None
    return f"{m.group(1)}.{m.group(3)}", int(m.group(2))


class _Scatter(torch.autograd.Function):
    """The lockstep copy: ``x`` on each rank's device; the backward sums the
    ranks' gradients in rank order on ``x``'s device."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, *devices: torch.device):
        ctx.device, ctx.n = x.device, len(devices)
        return tuple(x.view_as(x) if d == x.device else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.device)
                total = g if total is None else total + g
        return (total, *([None] * ctx.n))


class GroupTP:
    """The process-group form: this process is rank ``rank`` of the model
    group ``group`` (``size`` ranks) and holds one shard, on ``device``."""

    lockstep = False

    def __init__(self, group: dist.ProcessGroup | None, device: str | torch.device) -> None:
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = [self.rank]
        self.devices = [torch.device(device)]

    def scatter(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The replicated ``x`` into this rank's shard of a column-parallel
        layer (backward: all-reduce)."""
        return [collectives.copy_to_group(x, self.group)]

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum of the ranks' partial outputs (backward: identity)."""
        return collectives.reduce_from_group(parts[0], self.group)

    def gather(self, parts: list[torch.Tensor], dim: int) -> torch.Tensor:
        """A sharded table whole (backward: this rank's block, no sum)."""
        return collectives.gather_from_group(parts[0], self.group, axis=dim)

    def shards_of(self, full: torch.Tensor, dim: int) -> list[torch.Tensor]:
        """This rank's block of a whole leaf (no gradient)."""
        return [full.chunk(self.size, dim)[self.rank]]

    def whole(self, shards: list[torch.Tensor], dim: int) -> torch.Tensor:
        """A leaf whole from every rank's block (no gradient; a collective)."""
        return collectives.all_gather(shards[0], self.group, axis=dim)

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce_sum(x, self.group)


class LockstepTP:
    """The one-process form: ``size`` ranks, shard ``i`` on ``devices[i]``
    (one device: every shard on it). The replicated computation runs on
    ``devices[0]``. Training takes one device; several serve inference
    (``cli.generate --tp``)."""

    lockstep = True

    def __init__(self, size: int, devices: list | tuple | str | torch.device = "cuda") -> None:
        if size < 1:
            raise ValueError(f"tensor parallelism needs at least one rank, got {size}")
        devices = [devices] if isinstance(devices, (str, torch.device)) else list(devices)
        devices = [torch.device(d) for d in devices]
        if len(devices) == 1:
            devices = devices * size
        if len(devices) != size:
            raise ValueError(f"{size} ranks need {size} devices (or one), got {len(devices)}")
        self.size = size
        self.ranks = list(range(size))
        self.devices = devices

    def scatter(self, x: torch.Tensor) -> list[torch.Tensor]:
        return list(_Scatter.apply(x, *self.devices))

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return total

    def gather(self, parts: list[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=dim)

    def shards_of(self, full: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [c.to(d) for c, d in zip(full.chunk(self.size, dim), self.devices)]

    def whole(self, shards: list[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat([s.to(self.devices[0]) for s in shards], dim=dim)

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        return x


class TPPair(nn.Module):
    """A Megatron pair over ``tp``: ``shards[i]`` (the plain Attention or
    SwiGLU at its local width) is rank ``i``'s. The input is copied to the
    ranks, the partial outputs of their row-parallel projections summed.
    Tensor arguments follow each rank to its device; a ``cache`` (a
    ``models.transformer.KVCache`` holding each rank's buffers) gives each
    rank its own."""

    def __init__(self, shards: list[nn.Module], tp: Any) -> None:
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.tp = tp

    def forward(self, x: torch.Tensor, *args, cache=None, **kw) -> torch.Tensor:
        parts = []
        for i, (shard, xi) in enumerate(zip(self.shards, self.tp.scatter(x))):
            a = [t.to(xi.device) if torch.is_tensor(t) else t for t in args]
            if cache is not None:
                kw["cache"] = cache.rank(i)
            parts.append(shard(xi, *a, **kw))
        return self.tp.reduce(parts)


class _Leaf(nn.Module):
    def __init__(self, shape: tuple[int, ...]) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))


class ShardedTable(nn.Module):
    """A ``[rows, cols]`` table (the embedding, an untied ``lm_head``)
    stored as ``tp``'s shards on ``dim``; :meth:`full` gathers it whole."""

    def __init__(self, shape: tuple[int, int], dim: int, tp: Any) -> None:
        super().__init__()
        local = list(shape)
        local[dim] //= tp.size
        self.shards = nn.ModuleList(_Leaf(tuple(local)) for _ in tp.ranks)
        self.dim, self.tp = dim, tp

    def full(self) -> torch.Tensor:
        return self.tp.gather([s.weight for s in self.shards], self.dim)


@dataclasses.dataclass
class TPLayout:
    """Which leaves of a model are sharded over ``tp`` and on which dim.
    ``dims``: the whole model's name -> the sharded dim (port layout);
    ``names``: the whole model's name -> the model's own names of its
    shards (one name for a replicated leaf), in the whole model's order."""

    tp: Any
    dims: dict[str, int]
    names: dict[str, list[str]]

    def gather(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A tree keyed by the model's own names (the parameters, a moment,
        the EMA) as the whole model's tree (no gradient; in the process-group
        form a collective over the model group, so every rank calls it)."""
        return {full: (self.tp.whole([tree[n] for n in local], self.dims[full])
                       if full in self.dims else tree[local[0]])
                for full, local in self.names.items()}

    def local(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The inverse of :meth:`gather`: the whole model's tree cut to this
        form's shards, keyed by the model's own names."""
        out = {}
        for full, local in self.names.items():
            if full in self.dims:
                out.update(zip(local, self.tp.shards_of(tree[full], self.dims[full])))
            else:
                out[local[0]] = tree[full]
        return out

    def is_split(self, name: str, leaf: torch.Tensor | None = None) -> bool:
        return is_tp_shard(name, leaf)

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model group (no gradient)."""
        return self.tp.sum_over(x)

    def global_norm(self, tensors: dict[str, torch.Tensor]) -> torch.Tensor:
        """``optax.global_norm`` of the whole model
        (``runtime.collectives.sharded_norm`` over the model axis)."""
        return collectives.sharded_norm(tensors, [(self.is_split, self.sum_over)])


#: The expert stacks' names (``models.moe.MoEMLP``); ``experts_down``
#: projects back into the residual stream (the reference's
#: ``ROW_PARALLEL_EXPERT_MARKERS``).
EXPERT_LEAVES = ("experts_gate", "experts_up", "experts_down")


def expert_spec(name: str, shape: tuple[int, ...], tp: int) -> int | None:
    """The model-axis part of the reference's ``ep_spec`` for an expert
    stack ``[E, in, out]`` (the port keeps flax's layout): ``down`` on dim
    -2, the others on dim -1, when ``tp`` divides it; no ``min_size``."""
    if tp <= 1:
        return None
    d = len(shape) - (2 if "down" in name.rsplit(".", 1)[-1] else 1)
    return d if shape[d] % tp == 0 else None


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the rule shards in a TransformerLM config: the whole model's
    leaves (names and shapes, in order), its sharded leaves and dims, and
    whether each kind of layer is split."""

    shapes: dict[str, tuple[int, ...]]
    dims: dict[str, int]
    attention: bool
    mlp: bool
    embed: bool
    lm_head: bool
    experts: bool = False


def plan(config: Any, tp: int, *, min_size: int = MIN_SIZE) -> Plan:
    """The rule over every leaf of ``config``'s model (shapes only), with
    the pairs checked: each Megatron pair is sharded whole or not at all,
    and a sharded pair's heads (H, Hkv) or d_ff split evenly; an MoE
    model's expert stacks by :func:`expert_spec`, the router replicated.
    Raises ``ValueError`` for a config the port refuses."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM

    shapes = {n: tuple(p.shape) for n, p in
              TransformerLM(config, dtype=torch.float32, device="meta").named_parameters()}
    moe = config.moe_experts > 0
    if moe and config.d_ff % tp:
        raise ValueError(f"--tp {tp} must divide d_ff ({config.d_ff}): the port splits each "
                         "expert's d_ff whole")
    dims = {}
    for n, shape in shapes.items():
        leaf = n.rsplit(".", 1)[-1]
        if ".router." in n:
            continue
        d = (expert_spec(n, shape, tp) if leaf in EXPERT_LEAVES
             else param_spec(n, shape, tp, min_size=min_size))
        if d is not None:
            dims[n] = d
    pairs = {"attention": ("q_proj", "k_proj", "v_proj", "out_proj")}
    if not moe:
        pairs["mlp"] = ("gate_proj", "up_proj", "down_proj")
    split = {"mlp": False}
    for kind, members in pairs.items():
        sub = "attn" if kind == "attention" else "mlp"
        got = {m: dims.get(f"layers.0.{sub}.{m}.weight") for m in members}
        want = {m: 1 if m in ROW_PARALLEL_MARKERS else 0 for m in members}
        if any(v is not None for v in got.values()) and got != want:
            raise ValueError(
                f"--tp {tp}: the reference's rule shards the {kind} pair as {got} (port dims); "
                "the port shards a Megatron pair only whole (every member at least "
                f"{min_size} elements and divisible by {tp})")
        split[kind] = got == want
    if split["attention"] and (config.num_heads % tp or config.kv_heads % tp):
        raise ValueError(f"--tp {tp} must divide num_heads ({config.num_heads}) and kv_heads "
                         f"({config.kv_heads}): the port splits whole heads")
    return Plan(shapes=shapes, dims=dims, attention=split["attention"], mlp=split["mlp"],
                embed="embed.weight" in dims, lm_head="lm_head.weight" in dims, experts=moe)


def place_shards(model: nn.Module, tp: Any) -> None:
    """Each rank's shards of ``model`` on its own device (``LockstepTP``
    over several)."""
    for n, p in model.named_parameters():
        i = split_name(n)[1]
        if i is not None:
            p.data = p.data.to(tp.devices[i])


def layout(model: nn.Module, tp_plan: Plan, rename: Callable[[str], str] | None = None) -> TPLayout:
    """The :class:`TPLayout` of a sharded ``model`` (its ``tp``) built to
    ``tp_plan``, in the order of the model's leaves. ``rename`` maps the
    model's whole-leaf names to the plan's (a pipelined model's stage leaves
    to the flat model's), where the two differ."""
    names: dict[str, list[str]] = {}
    dims: dict[str, int] = {}
    for n, _ in model.named_parameters():
        full = split_name(n)[0]
        names.setdefault(full, []).append(n)
        d = tp_plan.dims.get(full if rename is None else rename(full))
        if d is not None:
            dims[full] = d
    return TPLayout(model.tp, dims, names)


def is_tp_shard(name: str, leaf: torch.Tensor | None = None) -> bool:
    """Whether ``name`` is one rank's shard of a model-sharded leaf."""
    return split_name(name)[1] is not None


def axes_of(layout: Any) -> list[tuple[Callable, Callable]]:
    """A layout's ``(is_split(name, leaf), sum_over(x))`` pairs, one an axis
    (``runtime.collectives.sharded_norm``'s form)."""
    if isinstance(layout, Within):
        return axes_of(layout.inner) + axes_of(layout.outer)
    return [(layout.is_split, layout.sum_over)]


class Within:
    """One layout inside another: the model shards inside a pipelined
    model's stages (``parallel.pipeline.PipeLayout``) or inside an MoE
    model's expert shards (``parallel.expert_parallel.ExpertShards``), or a
    pipelined model's layout inside its expert shards. Each layout gives
    ``is_split(name, leaf)`` and ``sum_over(x)``; the global norm sums each
    leaf over exactly the axes that split it
    (``runtime.collectives.sharded_norm``). :meth:`gather` / :meth:`local`
    map this process's tree to the whole model's (the inner layout's
    gathered first) and back."""

    def __init__(self, inner: Any, outer: Any) -> None:
        self.inner, self.outer = inner, outer

    def gather(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return self.outer.gather(self.inner.gather(tree))

    def local(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return self.inner.local(self.outer.local(tree))

    def global_norm(self, tensors: dict[str, torch.Tensor]) -> torch.Tensor:
        return collectives.sharded_norm(tensors, axes_of(self))


def shard_state_dict(sd: dict[str, torch.Tensor], model: nn.Module) -> dict[str, torch.Tensor]:
    """A whole model's state dict (``models.convert.lm_params_from_jax``, a
    one-process checkpoint) cut to ``model``'s expert slices and model
    shards, for its ``load_state_dict``; as is for a model with neither."""
    from deeplearning_mpi_tpu_torch.parallel import expert_parallel

    sd = expert_parallel.shard_state_dict(sd, getattr(model, "expert_shards", None))
    tp_layout = getattr(model, "tp_layout", None)
    return sd if tp_layout is None else tp_layout.local(sd)
