"""ZeRO-1: the optimizer state sharded over the data group, two schedules.

Port of ``deeplearning_mpi_tpu/parallel/zero.py``. Each optimizer moment
of a large enough leaf is kept as its ``1/dp`` slice on the leaf's largest
free divisible dim (:func:`zero1_dim`, the reference's rule on the
reference's layout, the dim mapped through the transpose of a Dense
weight; the tensor-parallel dim is "taken"), so Adam's ``mu`` + ``nu``
drop from twice the parameters to twice the parameters / dp on every rank.
The parameters stay replicated over ``data`` (ZeRO-1, not ZeRO-3).

1. ``--zero`` (the reference's GSPMD placement, :class:`Zero1`): the
   port's data-parallel step as it is (one flat all-reduce of the
   gradients), then the clip on the whole gradients, the optimizer update
   on this rank's slice of each sharded leaf (where its moments live), and
   an all-gather of the updated slices into the replicated parameters.
   Every operation is elementwise or the same reduction, so the step is
   bitwise equal to the data-parallel step, clip and EMA included.
2. ``--zero_overlap`` (:func:`make_overlapped_train_step`, the
   reference's bucketed schedule): the same data-parallel step with
   :class:`BucketedReduce` in place of its flat all-reduce. The gradients
   of the sharded leaves are grouped into byte-bounded buckets
   (:func:`plan_buckets`); a hook on each leaf sees its gradient land in
   the backward, and once a bucket's last
   gradient has landed (in the last ``grad_accum`` chunk) its
   reduce-scatter is launched asynchronously on the data group, under the
   rest of the backward. The replicated leaves and the loss ride one
   residual all-reduce. The clip takes the global norm from the all-reduced
   sum of the shards' squares (the reference's pre-clip), then come the
   sharded update and the all-gather. Its sums associate differently from
   one all-reduce (bitwise equality is not claimed, as the reference's own
   claim does not hold either); it equals the data-parallel step within
   float64 round-off.

The overlapped schedule refuses what the reference's refuses
(:class:`OverlapUnsupported`, :func:`check_supported`): no data
parallelism, another mesh axis above 1, the MoE balance loss, the chunked
loss, BatchNorm statistics, and an optimizer state that does not mirror the
parameters; the trainer then falls back to ``--zero`` with the reason
logged (``train.trainer.Trainer.place_state``). Under ``--zero`` a leaf
whose optimizer slots do not mirror it (Adafactor's factored moments)
keeps them whole; the reference shards each such slot by its own shape.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import on_reference_layout
from deeplearning_mpi_tpu_torch.runtime import collectives

#: Leaves smaller than this stay replicated (scalars, counts, tiny biases).
MIN_SIZE = 1 << 14

#: Target gradient bytes per reduce-scatter bucket.
BUCKET_BYTES = 4 << 20

DATA_AXIS = "data"


class OverlapUnsupported(ValueError):
    """The overlapped schedule cannot express this configuration. Raised
    when the step is built, never mid-step, so the trainer can fall back to
    ``--zero`` with the reason logged."""


def zero1_dim(shape: tuple[int, ...], base: tuple = (), dp: int = 1, *,
              min_size: int = MIN_SIZE) -> int | None:
    """The reference's rule on a leaf of ``shape`` in the REFERENCE's
    layout: the largest dim that is free in ``base`` (the leaf's
    tensor-parallel spec: an axis name where taken) and divisible by
    ``dp``, the first on ties; None (replicated) for leaves under
    ``min_size`` or with no such dim."""
    if dp <= 1 or math.prod(shape) < min_size:
        return None
    dims = list(base) + [None] * (len(shape) - len(base))
    best = None
    for i, (size, taken) in enumerate(zip(shape, dims)):
        if taken is None and size % dp == 0:
            if best is None or size > shape[best]:
                best = i
    return best


def zero1_spec(shape: tuple[int, ...], base: tuple, dp: int, *,
               min_size: int = MIN_SIZE) -> tuple:
    """``base`` extended with a ``data`` shard on :func:`zero1_dim`'s dim
    (``base`` as is when none qualifies)."""
    best = zero1_dim(shape, base, dp, min_size=min_size)
    dims = list(base) + [None] * (len(shape) - len(base))
    if best is not None:
        dims[best] = DATA_AXIS
    return tuple(dims)


def param_zero_dim(name: str, shape: tuple[int, ...], dp: int, tp_dim: int | None = None, *,
                   min_size: int = MIN_SIZE) -> int | None:
    """:func:`zero1_dim` for the port's leaf ``name`` of WHOLE ``shape``
    (``tp_dim``: the dim tensor parallelism takes, port layout), as a dim
    of the port's layout: a Dense weight is decided on its transpose (the
    reference's ``[in, out]``, whose first-largest tie-break would pick the
    other dim of a square-ish ``[out, in]`` leaf) and the dim mapped back."""
    base = [None] * len(shape)
    if tp_dim is not None:
        base[tp_dim] = "model"
    return on_reference_layout(name, shape, lambda s, b: zero1_dim(s, b, dp, min_size=min_size),
                               tuple(base))


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The explicit schedule's plan: ``shard_dims[i]`` of leaf ``i`` (None:
    replicated), the sharded leaves grouped into byte-bounded buckets in
    leaf order, and the replicated leaves of the residual all-reduce."""

    shard_dims: tuple[int | None, ...]
    buckets: tuple[tuple[int, ...], ...]
    replicated: tuple[int, ...]


def plan_buckets(leaves: list[tuple[str, tuple[int, ...], int]], dp: int, *,
                 bucket_bytes: int = BUCKET_BYTES, min_size: int = MIN_SIZE) -> BucketPlan:
    """The reference's bucketing over ``leaves`` (``(name, shape, bytes an
    element)`` in order): a leaf larger than ``bucket_bytes`` gets a bucket
    of its own, buckets never split a leaf. Deterministic in the order, so
    every rank builds the same plan."""
    shard_dims = [param_zero_dim(n, s, dp, min_size=min_size) for n, s, _ in leaves]
    buckets: list[tuple[int, ...]] = []
    current: list[int] = []
    current_bytes = 0
    for i, ((_, shape, itemsize), d) in enumerate(zip(leaves, shard_dims)):
        if d is None:
            continue
        nbytes = math.prod(shape) * itemsize
        if current and current_bytes + nbytes > bucket_bytes:
            buckets.append(tuple(current))
            current, current_bytes = [], 0
        current.append(i)
        current_bytes += nbytes
    if current:
        buckets.append(tuple(current))
    return BucketPlan(tuple(shard_dims), tuple(buckets),
                      tuple(i for i, d in enumerate(shard_dims) if d is None))


def leaf_zero_dim(name: str, p: torch.Tensor, dp: int, views: dict, *,
                  min_size: int = MIN_SIZE) -> int | None:
    """:func:`zero1_dim` of the reference's whole leaf of this process's leaf
    ``name`` (``parallel.leaves.LeafView``: a stage leaf stacked ``[S,
    ...]``, an expert stack ``[E, in, out]``, a model shard whole; each axis
    that splits it a taken dim of its base spec), as a dim of ``p``."""
    view = views[name]
    base = [None] * len(view.shape)
    for d, axis in view.split.items():
        base[d] = axis
    d = zero1_dim(view.shape, tuple(base), dp, min_size=min_size)
    return None if d is None else view.port_dim(d)


def _mirrors(opt_state: dict, params: dict[str, torch.Tensor]) -> bool:
    """Whether every slot of the optimizer state is a tree of the
    parameters' names and shapes (Adam, SGD, Lion; not Adafactor)."""
    return all(set(v) == set(params) and all(v[n].shape == params[n].shape for n in params)
               for v in opt_state.values() if isinstance(v, dict))


@dataclasses.dataclass
class Zero1:
    """This process's ZeRO-1 place: rank ``rank`` of the data group
    ``group`` (``size`` ranks) keeps the ``1/size`` slice on ``dims[name]``
    of each sharded leaf's moments (names: the model's own). The dim is the
    reference's choice on its whole leaf (:func:`leaf_zero_dim`): under
    expert parallelism an expert stack's ``E`` is taken, and under pipeline
    parallelism the stacked ``[S, ...]`` leaf's stage dim is, the size
    threshold applying to the stacked leaf."""

    group: Any
    size: int
    rank: int
    dims: dict[str, int]

    @staticmethod
    def for_state(state: Any, group: Any, *, min_size: int = MIN_SIZE) -> "Zero1":
        """The placement of ``state``'s moments over the data ``group``. A
        leaf whose optimizer slots do not all mirror it (Adafactor's
        factored moments) keeps them whole."""
        from deeplearning_mpi_tpu_torch.parallel.leaves import leaf_views

        size = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        slots = [v for v in state.opt_state.values() if isinstance(v, dict)]
        views = leaf_views(state.model)
        dims = {}
        for n, p in state.model.named_parameters():
            if any(n not in v or v[n].shape != p.shape for v in slots):
                continue
            d = leaf_zero_dim(n, p, size, views, min_size=min_size)
            if d is not None:
                dims[n] = d
        return Zero1(group, size, rank, dims)

    def slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a replicated leaf (a view)."""
        d = self.dims.get(name)
        return t if d is None else t.chunk(self.size, d)[self.rank]

    def shard(self, opt_state: dict) -> dict:
        """A replicated optimizer state cut to this rank's slices (copies,
        so the whole moments are freed)."""
        return {k: {n: self.slice(n, t).clone() for n, t in v.items()} if isinstance(v, dict)
                else v for k, v in opt_state.items()}

    def gather(self, opt_state: dict) -> dict:
        """The whole optimizer state from every rank's slices (a collective
        over the data group, so every rank calls it)."""
        return {k: {n: collectives.all_gather(t, self.group, axis=self.dims[n])
                     if n in self.dims else t for n, t in v.items()}
                if isinstance(v, dict) else v for k, v in opt_state.items()}

    def gather_params(self, local: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The updated slices of every sharded leaf whole, in ONE all-gather
        over the data group (a flat buffer of this rank's slices)."""
        names = [n for n in local if n in self.dims]
        if not names:
            return dict(local)
        acc = local[names[0]].dtype
        flat = torch.cat([local[n].reshape(-1).to(acc) for n in names])
        every = collectives.all_gather(flat[None], self.group, axis=0)  # [size, numel]
        out, offset = dict(local), 0
        for n in names:
            t, k = local[n], local[n].numel()
            out[n] = torch.cat([every[r, offset:offset + k].view(t.shape) for r in range(self.size)],
                               dim=self.dims[n]).to(t.dtype)
            offset += k
        return out

    def global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of gradients whose sharded leaves are this rank's
        slices (the reference's pre-clip): each leaf's squares, the sharded
        ones summed over the data group (disjoint slices), added in leaf
        order."""
        sq = {n: collectives.squares(g) for n, g in grads.items()}
        sharded = [n for n in grads if n in self.dims]
        if sharded:
            sq.update(zip(sharded, shard_squares(torch.stack([sq[n] for n in sharded]),
                                                 self.group)))
        return torch.sqrt(sum(sq.values()))

    def update(self, tx: Any, grads: dict, opt_state: dict, params: dict,
               shards: Any = None, *, leaves: Any, sliced: bool = False
               ) -> tuple[dict[str, torch.Tensor], dict]:
        """The ZeRO-1 update: the clip, the optimizer on this rank's slices,
        the updated slices gathered. ``grads`` are whole (``--zero``: the
        clip's norm as without ZeRO) or, with ``sliced``, already this
        rank's slices (``--zero_overlap``: the norm is :meth:`global_norm`).
        ``leaves`` goes to ``tx.update``. Returns ``(new parameters, new sliced
        state)``."""
        if sliced:
            g = tx.clip(grads, self)
        else:
            g = {n: self.slice(n, t) for n, t in tx.clip(grads, shards).items()}
        p = {n: self.slice(n, t) for n, t in params.items()}
        updates, new_opt = tx.update(g, opt_state, p, leaves=leaves, shards=shards, clipped=True)
        return self.gather_params({n: p[n] + updates[n] for n in p}), new_opt


def check_supported(task: str, state: Any, dp: int, *, busy: dict[str, int],
                    aux_weight: float = 0.0, loss_chunk: int = 0) -> int:
    """The reference's ``_check_supported``: returns ``dp`` or raises
    :class:`OverlapUnsupported` with the reason. ``busy``: the other mesh
    axes' sizes."""
    if dp <= 1:
        raise OverlapUnsupported(
            f"'data' axis has size {dp} — no data parallelism to overlap")
    wide = [a for a, n in busy.items() if n > 1]
    if wide:
        raise OverlapUnsupported(
            f"non-data mesh axes in use ({wide}) — composed TP/EP/PP stays on the ZeRO-1 step")
    if aux_weight:
        raise OverlapUnsupported(
            "aux_weight != 0: the MoE load-balance loss spans all routed tokens and its "
            "cross-chunk folding is not in the overlapped schedule")
    if loss_chunk:
        raise OverlapUnsupported("loss_chunk > 0: the chunked head+loss path is not in the "
                                 "overlapped schedule")
    if state.batch_stats():
        raise OverlapUnsupported("model carries batch_stats (BatchNorm) — local-statistics "
                                 "mutation is not in the overlapped schedule")
    if task not in ("lm", "classification", "segmentation"):
        raise OverlapUnsupported(f"unknown task '{task}'")
    zero = state.zero
    params = {n: t if zero is None else zero.slice(n, t) for n, t in state.params().items()}
    if not _mirrors(state.opt_state, params):
        raise OverlapUnsupported(
            "optimizer state does not mirror parameter shapes (adafactor-style factored "
            "moments?) — the sharded update needs a shape-preserving state")
    return dp


# -- the overlapped schedule's pieces (one function each, so a test can hold
# -- a wrong copy of one against the bars) -------------------------------------
def bucket_ready(chunk: int, grad_accum: int) -> bool:
    """Whether a bucket may launch in ``chunk``: only in the last, once
    every chunk's gradient is in the sum."""
    return chunk == grad_accum - 1


def data_mean(summed: torch.Tensor, dp: int) -> torch.Tensor:
    """The data-parallel mean of a summed gradient."""
    return summed / dp


def shard_squares(squares: torch.Tensor, group: Any) -> torch.Tensor:
    """Each sharded leaf's sum of squares over the whole leaf: the shards'
    summed over the data group (disjoint shards)."""
    return collectives.all_reduce_sum(squares, group)


class _Bucket:
    """One bucket's reduce-scatter in flight: this rank's block of the
    flat ``[rank 0's slices | rank 1's | ...]`` sum."""

    def __init__(self, grads: list[torch.Tensor], dims: list[int], group: Any, dp: int,
                 rank: int) -> None:
        self.shapes = [g.chunk(dp, d)[rank].shape for g, d in zip(grads, dims)]
        acc = grads[0].dtype
        flat = torch.cat([g.chunk(dp, d)[r].reshape(-1).to(acc)
                          for r in range(dp) for g, d in zip(grads, dims)])
        per = flat.numel() // dp
        collectives.counts["reduce_scatter_bucket"] += 1
        self.flat = flat  # alive until the collective has read it
        if dist.get_backend(group) == "gloo":  # gloo has no reduce-scatter
            self.out, self.rank_block = flat, (rank * per, (rank + 1) * per)
            self.work = dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group, async_op=True)
        else:
            self.out, self.rank_block = torch.empty(per, dtype=acc, device=flat.device), (0, per)
            self.work = dist.reduce_scatter_tensor(self.out, flat, op=dist.ReduceOp.SUM,
                                                   group=group, async_op=True)

    def wait(self) -> list[torch.Tensor]:
        self.work.wait()
        a, b = self.rank_block
        block, out, offset = self.out[a:b], [], 0
        for shape in self.shapes:
            k = math.prod(shape)
            out.append(block[offset:offset + k].view(shape))
            offset += k
        return out


@dataclasses.dataclass
class BucketedReduce:
    """``--zero_overlap``'s gradient reduction, which
    ``train.trainer.make_train_step`` runs in place of its one flat
    all-reduce: each bucket of ``plan`` reduce-scattered over ``zero``'s
    data group once its last gradient of the last ``grad_accum`` chunk has
    landed, the replicated leaves and the step's scalars in one residual
    all-reduce. It hands back this rank's slices of the sharded leaves."""

    plan: BucketPlan
    zero: Zero1
    grad_accum: int

    @contextlib.contextmanager
    def hooks(self, params: list[torch.Tensor]):
        """One step's leaf hooks on ``params`` (the model's, in order),
        removed on exit; yields the step's :class:`_Flight`."""
        flight = _Flight(self)
        bucket_of = {i: b for b, leaves in enumerate(self.plan.buckets) for i in leaves}
        handles = [params[i].register_hook(flight.hook(i, b)) for i, b in bucket_of.items()]
        try:
            yield flight
        finally:
            for h in handles:
                h.remove()


class _Flight:
    """One step of :class:`BucketedReduce`: the chunk being differentiated,
    the earlier chunks' gradient sum, and the buckets in flight."""

    def __init__(self, reduce: BucketedReduce) -> None:
        self.r = reduce
        self.index, self.summed = 0, None
        self.ready: dict[int, torch.Tensor] = {}
        self.landed = [0] * len(reduce.plan.buckets)
        self.flights: list[_Bucket | None] = [None] * len(reduce.plan.buckets)

    def chunk(self, index: int, summed: list[torch.Tensor] | None) -> None:
        """Chunk ``index`` is next; ``summed``: the earlier chunks' gradients."""
        self.index, self.summed = index, summed

    def hook(self, i: int, b: int):
        def fn(g: torch.Tensor) -> None:
            if not bucket_ready(self.index, self.r.grad_accum):
                return
            self.ready[i] = g if self.summed is None else self.summed[i] + g
            self.landed[b] += 1
            if self.landed[b] == len(self.r.plan.buckets[b]):
                self.launch(b)
        return fn

    def launch(self, b: int) -> None:
        plan, zero = self.r.plan, self.r.zero
        leaves = plan.buckets[b]
        self.flights[b] = _Bucket([self.ready[i] for i in leaves],
                                  [plan.shard_dims[i] for i in leaves], zero.group, zero.size,
                                  zero.rank)

    def finish(self, grads: list[torch.Tensor], scalars: list[torch.Tensor]
               ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """The data means of ``grads`` (every chunk's sum, in the model's
        order; the sharded leaves as this rank's slices) and of
        ``scalars``."""
        plan, zero = self.r.plan, self.r.zero
        dp = zero.size
        for b, leaves in enumerate(plan.buckets):  # a leaf the backward never reached
            if self.flights[b] is None:
                for i in leaves:
                    self.ready.setdefault(i, grads[i])
                self.launch(b)
        rest = [grads[i] for i in plan.replicated]
        acc = torch.promote_types(rest[0].dtype if rest else torch.float32, torch.float32)
        flat = torch.cat([g.reshape(-1).to(acc) for g in rest]
                         + [x.reshape(1).to(acc) for x in scalars])
        flat = data_mean(collectives.all_reduce_sum(flat, zero.group), dp)
        out, offset = list(grads), 0
        for i in plan.replicated:
            out[i] = flat[offset:offset + grads[i].numel()].view_as(grads[i]).to(grads[i].dtype)
            offset += grads[i].numel()
        scalars = [flat[offset + k].to(x.dtype) for k, x in enumerate(scalars)]
        for b, leaves in enumerate(plan.buckets):
            for i, g in zip(leaves, self.flights[b].wait()):
                out[i] = data_mean(g, dp).to(grads[i].dtype)
        return out, scalars


def make_overlapped_train_step(
    task: str, state: Any, group: Any, *, busy: dict[str, int] | None = None,
    aux_weight: float = 0.0, grad_accum: int = 1, loss_chunk: int = 0, seg_loss: str = "bce",
    ema_decay: float = 0.0, bucket_bytes: int = BUCKET_BYTES,
) -> Callable:
    """The explicit bucketed ZeRO-1 step over the data ``group``:
    ``train.trainer.make_train_step`` with :class:`BucketedReduce` in place
    of its flat all-reduce, on a state placed by ``Zero1.shard``. Raises
    :class:`OverlapUnsupported` for what the schedule cannot express."""
    from deeplearning_mpi_tpu_torch.train.trainer import make_train_step

    dp = check_supported(task, state, 1 if group is None else dist.get_world_size(group),
                         busy=busy or {}, aux_weight=aux_weight, loss_chunk=loss_chunk)
    zero = state.zero
    if zero is None or zero.size != dp:
        raise ValueError("the overlapped ZeRO-1 step needs a state placed by Zero1.shard over "
                         "its data group")
    leaves = [(n, tuple(p.shape), p.element_size()) for n, p in state.model.named_parameters()]
    plan = plan_buckets(leaves, dp, bucket_bytes=bucket_bytes)
    if {leaves[i][0]: d for i, d in enumerate(plan.shard_dims) if d is not None} != zero.dims:
        raise OverlapUnsupported("the bucket plan's shard dims differ from the state's ZeRO-1 "
                                 "placement")
    step = make_train_step(task, aux_weight=aux_weight, grad_accum=grad_accum,
                           loss_chunk=loss_chunk, seg_loss=seg_loss, ema_decay=ema_decay,
                           group=group, overlap=BucketedReduce(plan, zero, grad_accum))
    step.bucket_plan = plan
    return step
