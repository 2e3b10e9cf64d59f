"""Pipeline parallelism: the GPipe schedule over the mesh's ``pipe`` axis.

Port of ``deeplearning_mpi_tpu/parallel/pipeline.py``. The reference runs
the schedule as one ``lax.scan`` inside a ``shard_map`` over ``pipe``, the
stage weights one stacked tree ``[S, ...]``. Here the ``pipe`` argument of
:func:`pipeline_apply` takes one of two forms, as ``parallel/seq_common.py``'s
``GroupRing`` / ``LockstepRing`` and ``parallel/tensor_parallel.py``'s
``GroupTP`` / ``LockstepTP`` do:

- :class:`GroupPipe`, the process-group form: rank ``r`` of the pipe group
  holds and runs stage ``r``; activations move to the next stage, and their
  gradients back, by point-to-point send / receive over the group
  (``runtime.collectives.stage_shift``);
- :class:`LockstepPipe`, the one-process form: one process holds every
  stage and runs them tick by tick; the shift is a list move. NCCL refuses
  two ranks on one card, so this is how one card runs an ``S``-stage
  pipeline.

``pipe=None`` (or a pipe of size 1) with an ``S``-stack runs the stack in
order, as the reference does on a mesh whose ``pipe`` axis is 1.

The schedule is the reference's: on clock tick ``t`` in ``0 .. M+S-2``
stage ``s`` works on microbatch ``t - s``; the last stage's tick-``t``
output is microbatch ``t - (S-1)`` (:func:`place_output`); the shift is the
non-wrapping ``(i, i+1)`` permutation (stage 0 receives nothing, the last
stage sends nothing); the outputs are broadcast from the last stage to
every pipe rank, as the reference's ``psum`` of the last stage's outputs.

**The bubble.** The reference runs every stage on every tick: its fill and
drain ticks compute on zeros or on a clamped repeat of the last microbatch
and throw the results away. The port does no work on those ticks, and its
kept outputs and gradients are the same. So a stage runs ``M`` times a
step whatever ``S`` is, and each kernel inside a layer launches
``num_layers x M`` times a forward (and as often in the backward).

**The backward.** The reference gets it from AD of the scan. Here each
stage keeps its microbatches' graphs from the forward (one
``torch.autograd.Function``); then, in reverse tick order, each stage
receives its output's gradient from stage ``s + 1`` (the last stage: the
gradient of the broadcast outputs, its own), differentiates its graph, and
sends its input's gradient to stage ``s - 1``. The stage parameters'
gradients are the Function's: ``torch.autograd.grad`` of a loss over the
outputs reaches them. On a pipe rank other than the last the gradient that
arrives for the broadcast outputs is that rank's copy of the replicated
loss's, and is not used: the last rank's counts once.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from deeplearning_mpi_tpu_torch.runtime import collectives

Acts = dict[str, torch.Tensor]
#: stage_fn(stage, activations) -> activations of the same keys and shapes.
StageFn = Callable[[Any, Acts], Acts]


def split_microbatches(tree: Mapping[str, torch.Tensor], num_microbatches: int) -> Acts:
    """``[B, ...]`` leaves -> ``[M, B/M, ...]`` microbatch-major views."""
    out = {}
    for key, x in tree.items():
        if x.shape[0] % num_microbatches:
            raise ValueError(f"batch {x.shape[0]} not divisible by {num_microbatches} "
                             "microbatches")
        out[key] = x.reshape(num_microbatches, x.shape[0] // num_microbatches, *x.shape[1:])
    return out


def merge_microbatches(tree: Mapping[str, torch.Tensor]) -> Acts:
    """Inverse of :func:`split_microbatches`."""
    return {k: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]) for k, x in tree.items()}


def place_output(t: int, num_stages: int, num_micro: int) -> int | None:
    """The microbatch whose output the last stage makes on tick ``t``
    (None: a bubble tick)."""
    m = t - (num_stages - 1)
    return m if 0 <= m < num_micro else None


class GroupPipe:
    """The process-group form: this process is rank ``rank`` of the pipe
    group ``group`` (``size`` ranks) and runs stage ``rank``."""

    lockstep = False

    def __init__(self, group: dist.ProcessGroup | None, device: str | torch.device) -> None:
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.stage_ids = [self.rank]
        self.device = torch.device(device)
        # NCCL takes point-to-point calls on a subset of a group only after a
        # first collective over all of it.
        dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    @property
    def runs_head(self) -> bool:
        """Whether this rank's head (and loss) gradients count: the last
        stage's."""
        return self.rank == self.size - 1

    def exchange(self, sends: dict[int, list[torch.Tensor]],
                 want: dict[int, list[torch.Tensor]], offset: int) -> dict[int, list]:
        """Stage ``s``'s ``sends[s]`` to stage ``s + offset``; stage ``s``
        of ``want`` receives tensors shaped as ``want[s]`` from ``s - offset``."""
        got = collectives.stage_shift(sends.get(self.rank, []), want.get(self.rank, []),
                                      self.group, offset=offset)
        return {self.rank: got} if self.rank in want else {}

    def broadcast(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The last stage's ``tensors`` on every rank (the others pass
        buffers of the same shapes)."""
        return [collectives.broadcast_from(t, src=self.size - 1, group=self.group)
                for t in tensors]

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce_sum(x, self.group)

    def all_gather(self, flat: torch.Tensor) -> torch.Tensor:
        """``[size, N]``: every rank's ``[N]`` vector, in rank order."""
        return collectives.all_gather(flat[None], self.group, axis=0)


class LockstepPipe:
    """The one-process form: ``size`` stages, all held and run here."""

    lockstep = True
    runs_head = True

    def __init__(self, size: int) -> None:
        if size < 1:
            raise ValueError(f"a pipeline needs at least one stage, got {size}")
        self.size = size
        self.stage_ids = list(range(size))

    def exchange(self, sends: dict[int, list[torch.Tensor]],
                 want: dict[int, list[torch.Tensor]], offset: int) -> dict[int, list]:
        return {s: sends[s - offset] for s in want}

    def broadcast(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        return tensors

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _stage_getter(stages: Any) -> tuple[int, Callable[[int], Any], Callable[[int], list]]:
    """``(stack size, stage i's object, stage i's parameter leaves)`` of a
    stack: a mapping of tensors stacked ``[n, ...]`` (the reference's form;
    stage ``i`` gets the slices ``[i]``) or a sequence of per-stage
    ``nn.Module`` s."""
    if isinstance(stages, Mapping):
        leading = {v.shape[0] for v in stages.values()}
        if len(leading) != 1:
            raise ValueError(f"inconsistent stage-stack sizes: {sorted(leading)}")
        leaves = [v for v in stages.values() if v.requires_grad]
        return leading.pop(), lambda i: {k: v[i] for k, v in stages.items()}, lambda i: leaves
    stages = list(stages)
    return (len(stages), lambda i: stages[i],
            lambda i: [p for p in stages[i].parameters() if p.requires_grad])


class _Plan:
    """What one :func:`pipeline_apply` call runs: the stages this process
    holds, the schedule's sizes and the activation keys."""

    def __init__(self, stage_fn, stages, microbatches: Acts, pipe) -> None:
        stack, self.stage, self.leaves = _stage_getter(stages)
        counts = {x.shape[0] for x in microbatches.values()}
        if len(counts) != 1:
            raise ValueError(f"inconsistent microbatch counts: {sorted(counts)}")
        self.num_micro = counts.pop()
        if pipe is None or pipe.size == 1:
            pipe = LockstepPipe(stack)
        local = len(pipe.stage_ids)
        if stack != local:
            raise ValueError(
                f"stage_params leaves must all be stacked [{local}, ...] to match the pipe "
                f"(size {pipe.size}, {local} stage(s) in this process); got leading dim {stack}")
        self.stage_fn, self.pipe = stage_fn, pipe
        self.num_stages = pipe.size
        self.keys = list(microbatches)
        self.floats = [k for k in self.keys if microbatches[k].is_floating_point()]

    def index(self, s: int) -> int:
        """Stage ``s``'s position in this process's stack."""
        return self.pipe.stage_ids.index(s)

    def active(self, s: int, t: int) -> bool:
        return 0 <= t - s < self.num_micro

    def ticks(self) -> range:
        return range(self.num_micro + self.num_stages - 1)


def _forward(plan: _Plan, xs: Acts, keep: bool):
    """The forward schedule. Returns the outputs ``[M, ...]`` (on every
    pipe rank) and, with ``keep``, each ``(stage, microbatch)``'s graph
    ``(input leaves, outputs)`` and the output slot of each microbatch."""
    S, M, pipe = plan.num_stages, plan.num_micro, plan.pipe
    last = S - 1
    inbox: dict[int, list] = {}
    outs: list[Acts | None] = [None] * M
    graphs, placed = {}, {}
    for t in plan.ticks():
        produced = {}
        for s in pipe.stage_ids:
            m = t - s
            if not plan.active(s, t):
                continue
            x = ({k: xs[k][m] for k in plan.keys} if s == 0
                 else dict(zip(plan.keys, inbox.pop(s))))
            if keep:
                x = {k: v.detach().requires_grad_(k in plan.floats and (s > 0 or v.requires_grad))
                     for k, v in x.items()}
            y = plan.stage_fn(plan.stage(plan.index(s)), x)
            if set(y) != set(plan.keys):
                raise ValueError(f"stage_fn returned keys {sorted(y)}, expected {plan.keys}")
            if keep:
                graphs[(s, m)] = (x, y)
            if s == last:
                slot = place_output(t, S, M)
                placed[m] = slot
                if slot is not None:
                    outs[slot] = {k: v.detach() for k, v in y.items()}
            produced[s] = [y[k].detach() for k in plan.keys]
        want = {s: [xs[k][0] for k in plan.keys] for s in pipe.stage_ids
                if s > 0 and plan.active(s - 1, t)}
        inbox = pipe.exchange({s: v for s, v in produced.items() if s < last}, want, offset=1)
    template = {k: xs[k][0] for k in plan.keys}
    rows = [o if o is not None else {k: torch.zeros_like(v) for k, v in template.items()}
            for o in outs]
    stacked = [torch.stack([r[k] for r in rows]) for k in plan.keys]
    if last not in pipe.stage_ids:
        stacked = [torch.zeros_like(v) for v in stacked]
    return pipe.broadcast(stacked), graphs, placed


class _PipelineFn(torch.autograd.Function):
    """The schedule with its own backward (module docstring). Inputs: the
    plan, the stage context, the microbatch tensors in ``plan.keys``
    order, then every stage parameter leaf this process holds."""

    @staticmethod
    def forward(ctx, plan: _Plan, stage_context, *tensors):
        xs = dict(zip(plan.keys, tensors[:len(plan.keys)]))
        with torch.enable_grad():
            outs, graphs, placed = _forward(plan, xs, keep=True)
        ctx.plan, ctx.stage_context = plan, stage_context
        ctx.graphs, ctx.placed = graphs, placed
        ctx.xs = {k: v.detach() for k, v in xs.items()}
        ctx.params = list(tensors[len(plan.keys):])
        ctx.mark_non_differentiable(*[o for k, o in zip(plan.keys, outs) if k not in plan.floats])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grad_outs):
        plan, pipe = ctx.plan, ctx.plan.pipe
        S, floats = plan.num_stages, plan.floats
        last = S - 1
        g_out = {k: g if g is not None else torch.zeros_like(ctx.xs[k])
                 for k, g in zip(plan.keys, grad_outs) if k in floats}
        position = {id(p): i for i, p in enumerate(ctx.params)}
        p_grads: list = [None] * len(ctx.params)
        x_grads = {k: torch.zeros_like(ctx.xs[k]) for k in floats}
        inbox: dict[int, list] = {}
        for t in reversed(plan.ticks()):
            sent = {}
            for s in pipe.stage_ids:
                m = t - s
                if not plan.active(s, t):
                    continue
                x, y = ctx.graphs.pop((s, m))
                if s == last:
                    slot = ctx.placed[m]
                    g_y = {k: (g_out[k][slot] if slot is not None
                               else torch.zeros_like(y[k])) for k in floats}
                else:
                    g_y = dict(zip(floats, inbox.pop(s)))
                outs = [(y[k], g_y[k]) for k in floats if y[k].requires_grad]
                ins = [x[k] for k in floats if x[k].requires_grad]
                leaves = plan.leaves(plan.index(s))
                context = (ctx.stage_context(plan.stage(plan.index(s)))
                           if ctx.stage_context is not None else contextlib.nullcontext())
                with context:
                    got = (torch.autograd.grad([o for o, _ in outs], ins + leaves,
                                               [g for _, g in outs], allow_unused=True)
                           if outs else [None] * (len(ins) + len(leaves)))
                for p, g in zip(leaves, got[len(ins):]):
                    if g is not None:
                        i = position[id(p)]
                        p_grads[i] = g if p_grads[i] is None else p_grads[i] + g
                g_x = dict(zip([k for k in floats if x[k].requires_grad], got[:len(ins)]))
                g_x = [g_x.get(k) if g_x.get(k) is not None else torch.zeros_like(x[k])
                       for k in floats]
                if s == 0:
                    for k, g in zip(floats, g_x):
                        x_grads[k][m] = g
                else:
                    sent[s] = [g.detach() for g in g_x]
            want = {s: [ctx.xs[k][0] for k in floats] for s in pipe.stage_ids
                    if s < last and plan.active(s + 1, t)}
            inbox = pipe.exchange(sent, want, offset=-1)
        ctx.graphs = None
        first = 0 in pipe.stage_ids
        x_out = [x_grads[k] if first and k in floats and ctx.needs_input_grad[2 + i] else None
                 for i, k in enumerate(plan.keys)]
        return (None, None, *x_out, *p_grads)


def pipeline_apply(stage_fn: StageFn, stages: Any, microbatches: Mapping[str, torch.Tensor], *,
                   pipe: Any = None, stage_context: Callable[[Any], Any] | None = None) -> Acts:
    """Run ``M`` microbatches through the ``S`` pipelined stages (GPipe).

    ``stages``: this process's stages, in stage order — a mapping of
    tensors stacked ``[n, ...]`` (stage ``i`` gets the slices ``[i]``) or a
    sequence of per-stage modules; ``stage_fn(stage,
    activations)`` is one stage's computation, its output of the same keys
    and shapes as its input. ``microbatches``: ``[M, mb, ...]`` tensors
    (:func:`split_microbatches`), the same on every pipe rank. ``pipe``: a
    :class:`GroupPipe` (``stages`` holds this rank's one stage), a
    :class:`LockstepPipe` of ``S`` (``stages`` holds all ``S``), or None
    (the stack run in order). ``stage_context(stage)``: a context manager
    around each stage's backward (a stage that recomputes its forward
    there, under remat, runs it as its forward ran).

    Returns the last stage's outputs ``[M, mb, ...]`` on every pipe rank.
    """
    plan = _Plan(stage_fn, stages, dict(microbatches), pipe)
    xs = {k: microbatches[k] for k in plan.keys}
    leaves = []
    for i in range(len(plan.pipe.stage_ids)):
        leaves += [p for p in plan.leaves(i) if all(p is not q for q in leaves)]
    needs_grad = torch.is_grad_enabled() and (
        any(v.requires_grad for v in xs.values()) or bool(leaves))
    if not needs_grad:
        with torch.no_grad():
            outs, _, _ = _forward(plan, xs, keep=False)
    else:
        outs = _PipelineFn.apply(plan, stage_context, *xs.values(), *leaves)
    return dict(zip(plan.keys, outs))


class PipeLayout:
    """How a pipelined model's parameters are laid out over the pipe: the
    stage leaves ``stages.{s}.{leaf}`` of this process's stages, and the
    replicated rest (``embed_head``). Its whole-model view (a checkpoint's
    tree) stacks each stage leaf over the stages as ``stages.{leaf}``
    ``[S, ...]``, the reference's layout."""

    def __init__(self, pipe: Any, num_stages: int) -> None:
        self.pipe = pipe if pipe is not None and pipe.size > 1 else None
        self.num_stages = num_stages
        self.stage_ids = self.pipe.stage_ids if self.pipe is not None else list(range(num_stages))

    @staticmethod
    def split(name: str) -> tuple[str, int | None]:
        """``(leaf name without the stage, stage)``; ``(name, None)`` for a
        replicated leaf."""
        if not name.startswith("stages."):
            return name, None
        _, stage, rest = name.split(".", 2)
        return f"stages.{rest}", int(stage)

    def gather(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The whole model's tree from this process's: stage leaves stacked
        ``[S, ...]`` (a collective over the pipe group in the process-group
        form: every rank calls it), the rest as is."""
        out, local = {}, {}
        for name, t in tree.items():
            base, stage = self.split(name)
            if stage is None:
                out[name] = t
            else:
                local.setdefault(base, {})[stage] = t
        if not local:
            return out
        if self.pipe is None or self.pipe.lockstep:
            for base, per in local.items():
                out[base] = torch.stack([per[s] for s in range(self.num_stages)])
            return out
        (stage,) = self.stage_ids
        bases = list(local)
        acc = torch.promote_types(torch.float32, local[bases[0]][stage].dtype)
        flat = torch.cat([local[b][stage].reshape(-1).to(acc) for b in bases])
        every = self.pipe.all_gather(flat)
        offset = 0
        for b in bases:
            t = local[b][stage]
            out[b] = every[:, offset:offset + t.numel()].reshape(
                self.num_stages, *t.shape).to(t.dtype)
            offset += t.numel()
        return out

    def local(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This process's leaves of a whole-model tree (:meth:`gather`'s)."""
        out = {}
        for name, t in tree.items():
            if name.startswith("stages."):
                rest = name[len("stages."):]
                for s in self.stage_ids:
                    out[f"stages.{s}.{rest}"] = t[s]
            else:
                out[name] = t
        return out

    def is_split(self, name: str, leaf: torch.Tensor | None = None) -> bool:
        """Whether ``name`` is a stage leaf (one stage's, split over the pipe)."""
        return self.split(name)[1] is not None

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the pipe group (no gradient)."""
        return x if self.pipe is None else self.pipe.sum_over(x)

    def global_norm(self, tensors: dict[str, torch.Tensor]) -> torch.Tensor:
        """``optax.global_norm`` of the whole model
        (``runtime.collectives.sharded_norm`` over the pipe axis)."""
        return collectives.sharded_norm(tensors, [(self.is_split, self.sum_over)])

    def reduce(self, names: Sequence[str], grads: list[torch.Tensor],
               loss: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        """After a pipelined backward on a pipe rank: the replicated leaves'
        gradients (the tied embedding's encode part on the first stage, its
        head part and the final norm's on the last) summed over the pipe
        group once, and the loss taken from the last stage. One
        ``all_reduce_sum`` of a flat bucket; the stage leaves as they are.
        In the one-process forms this is the identity."""
        if self.pipe is None or self.pipe.lockstep:
            return grads, loss
        idx = [i for i, n in enumerate(names) if self.split(n)[1] is None]
        acc = torch.promote_types(torch.float32, grads[idx[0]].dtype)
        mine = loss.detach().reshape(1).to(acc) * float(self.pipe.rank == self.pipe.size - 1)
        flat = torch.cat([grads[i].reshape(-1).to(acc) for i in idx] + [mine])
        flat = self.pipe.sum_over(flat)
        out, offset = list(grads), 0
        for i in idx:
            g = grads[i]
            out[i] = flat[offset:offset + g.numel()].view_as(g).to(g.dtype)
            offset += g.numel()
        return out, flat[offset].to(loss.dtype)
