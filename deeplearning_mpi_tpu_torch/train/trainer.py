"""Train/eval step factories, the optimizers and LR schedules, the trainer.

Port of ``deeplearning_mpi_tpu/train/trainer.py`` for the ``lm``,
``classification`` and ``segmentation`` tasks. What is carried over exactly:

- the loss is the masked mean over valid rows (tokens for the LM);
  ``grad_accum`` chunks are combined by their valid-token weight, so the
  result equals the full-batch mean even under a ragged token mask; under
  BatchNorm each chunk normalises over its own rows and the running
  statistics advance once a chunk;
- a non-finite loss (or, with ``guard_metrics``, a non-finite gradient
  norm) skips the update: parameters, BatchNorm statistics, optimizer state
  and EMA stay as they were while ``step`` still advances, and the epoch
  mean leaves the step out;
- clipping by global norm and the optimizers compute what optax computes
  (``clip_by_global_norm``, ``sgd`` with coupled L2 before the momentum
  trace, ``adam``, ``adamw`` and ``lion`` with decoupled decay, and
  ``adafactor`` with factored second moments), with the LR schedules as
  functions of the optimizer's own update count;
- the ``__loss_scale__`` / ``__grad_scale__`` batch keys: the first scales
  the reported and the differentiated loss, the second only the
  differentiated one;
- the MoE load-balance loss (``models.moe``): ``aux_weight`` times it is
  added to the differentiated total only; under ``grad_accum`` with the
  weight ``aux_weight / grad_accum`` a chunk while the data loss keeps its
  token weights; the ``moe_dropped_frac`` metric, the mean over chunks of
  the routed layers' mean, only when a routed layer ran, and its epoch
  mean in the trainer. The port also reports ``moe_aux_loss``, the
  load-balance loss before its weight (the mean over chunks), when the
  routing sows one;
- the trainer's cadence: eval and checkpoint every ``eval_every`` epochs,
  a final eval and save, and a graceful exit (:class:`Preempted`) after a
  final save when a shutdown was requested; eval reports ``accuracy`` or
  ``dice`` weighted by the valid rows.

**Data parallelism** (``group``: the mesh's data-axis process group) is the
reference's global-batch semantics over one process a device: each rank
feeds its rows of the global batch, BatchNorm sums its moments across the
group (``models/norm.py``), and right after ``torch.autograd.grad`` the
gradients and the loss (and the MoE dropped fraction) go through ONE
``all_reduce_mean`` over a flat bucket. So every rank applies the same
update, and the NaN guard, which reads the all-reduced loss, skips on every
rank when one rank's shard is non-finite: the replicas never diverge. DDP
does not fit this step: it does not support ``torch.autograd.grad``, and
its buffer broadcast and local BatchNorm statistics contradict the
reference's global batch. Under ``grad_accum`` the loader hands each rank
its share of each of the reference's contiguous global chunks
(``data/loader.py``), so ``x.chunk(grad_accum)[i]`` here is this rank's
part of the reference's chunk ``i``, and BatchNorm's chunk statistics and
the MoE load-balance loss (averaged over the group inside the forward) are
the global chunk's.

**Sequence parallelism** (``seq``: a ``parallel.seq_common.SeqShards``,
the LM only): every rank of a seq group holds the same whole rows and runs
its ``S / n`` slice through the model at its global positions, the
attention fn (ring or Ulysses) attending across the group. Its loss is its
slice's share of the whole rows' next-token loss (the last position of a
slice predicts the first token of the next; the denominator counts the
whole rows' targets), so the shares add up to the reference's loss. The
parameters are replicated over ``seq`` and each rank's gradient is its
tokens' share: gradients and loss are SUMMED over seq and averaged over
data, one ``all_reduce_sum`` of the flat bucket over the replica group
(``runtime.mesh.replica_group``, data x seq) divided by the data size.
Eval sums the loss shares over the seq group. Under remat the forward, and
so the ring's rotations and kernel launches, run again in the backward.

**Expert parallelism** (the model's ``expert_shards``): a rank holds its
share of the experts and the rest replicated; the gradient mean stays one
flat all-reduce over the DATA group, expert slices included (no gradient
is averaged over the expert group), and the global norm of the clip and of
``grad_norm`` sums the expert slices' squares over the expert group.

**Tensor parallelism** (the model's ``tp``, ``parallel.tensor_parallel``)
alike: each rank holds its shards of the Megatron pairs and the embedding,
every rank of a model group computes the same loss, and the gradients of
model-sharded leaves are NOT averaged over the model group; the data mean
stays the one flat all-reduce over the data group, and the global norm
sums each sharded leaf's squares over the model group once (the
replicated leaves once). Adafactor reads the reference's whole leaves
under either (below).

**Pipeline parallelism** (the model's ``pipe_layout``,
``models.pipeline_lm.PipelinedLM``): a pipe rank holds its stage and a
replica of the embedding and head, and every rank of a pipe group feeds the
same rows. Each ``grad_accum`` chunk is pipelined into the model's
microbatches. After the backward the replicated leaves' gradients (the
tied embedding's encode part on the first stage, its head part and the
final norm's on the last) and the last stage's loss go through ONE
``all_reduce_sum`` over the pipe group (``PipeLayout.reduce``), then the
data mean as above; the global norm sums the stage leaves' squares over the
pipe group and counts the replicated leaves once. Under ``expert`` the
stages hold their share of the experts, as the flat model does.

**Composed layouts**: each gradient is reduced over exactly the axes
that replicate it, and the clip's norm sums each leaf's squares over
exactly the axes that split it (``runtime.collectives.sharded_norm``;
the state's ``shards``). Under ``pipe x model`` the Megatron sums run
inside each stage and the pipe sum of the replicated leaves at each model
coordinate, so the tied table's shards are summed shard by shard; under
``seq x model`` the replica plane (data x seq) is taken at each model
coordinate; under ``expert x seq`` and ``expert x model`` the expert slices
stay local, the rest as above; under ``pipe x expert`` the expert slices
of each stage.

**Adafactor under split leaves** (``parallel.leaves``): the factoring is
decided on the reference's whole leaf (the unsharded ``[in, out]`` kernel,
the ``[E, in, out]`` expert stack, the stacked ``[S, ...]`` stage leaf);
``g**2``'s row and column means, ``v_row``'s mean over its row dim and the
block RMS of ``clip_by_block_rms(1)`` sum their partials over the axes that
split the dims they reduce. So a ``--pp 2`` step clips each stage leaf by
the RMS of its stacked leaf, as the reference does, and differs from a
``--pp 1`` step.

**The chunked loss under ``seq``**: each shard chunks its own slice, the
last position predicting across the shard edge, and its share is its
summed terms over the whole rows' count (``ops.loss.chunked_lm_loss_slice``).

**ZeRO-1** (the state's ``zero``, ``parallel.zero.Zero1``, placed by
:meth:`Trainer.place_state`): the optimizer moments are this rank's slices
over the data group; after the same gradient all-reduce the clip runs on
the whole gradients, the update on this rank's slices, and the updated
slices are all-gathered, so the step is bitwise the data-parallel one.
The placement is the reference's on its whole leaves beside the other
axes: an expert stack's ``E`` and a stage stack's ``S`` are taken, and
under ``seq`` the slices are over data only, after the gradients' sum over
seq.
``zero_overlap`` (``parallel.zero.make_overlapped_train_step``) swaps the
flat all-reduce for bucketed reduce-scatters launched from the backward
(``overlap``), or falls back with the reason logged.

The step is eager PyTorch. The NaN guard selects with ``torch.where`` on
the device and Adam's bias correction takes its bases as scalars, so a step
makes no host sync; the trainer reads its metrics once per epoch.
:meth:`Trainer.warmup` (``train_lm --aot_warmup``) is the reference's AOT
compile of the step: on CUDA the whole step captured as one CUDA graph
(``compiler.aot.CapturedStep``), on the CPU the same static-buffer program
run eagerly.

**Telemetry** (the reference's, ``telemetry/``): the trainer always keeps a
``MetricsRegistry`` (a ``RunLogger`` becomes one of its sinks). Every
``metrics_every`` steps the step's scalars are buffered on the card
unread; at epoch end one device-to-host copy emits them as ``step``
records, then the ``epoch`` record: the mean loss, images (sequences) a
second, the ``StepTimer``'s latency percentiles (one sync every 25 steps),
MFU against the card's peak (``mfu``, and with remat ``mfu_issued`` /
``mfu_gap``) over the world size and the global batch's FLOPs, the
collective bytes and their overlap estimate, and the device-memory high
water marks of the most loaded card of the run (one small all-gather an
epoch). A profiler traces steps 3-5 (``PROFILE_STEPS``). With a span
recorder (``tracer``) each step is fenced and its ``data_wait`` / ``h2d``
/ ``compute`` / ``collective_tail`` phases measured, ``other`` the
residual, so the phases sum to the epoch's duration exactly; without one
the loop adds no sync. Not ported yet (ROADMAP): chaos, guardrails and
auto-resume.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Any, Callable, Iterable

import torch
from torch.func import functional_call

from deeplearning_mpi_tpu_torch.models.moe import (
    collect_aux_loss,
    collect_dropped_fraction,
    collecting,
)
from deeplearning_mpi_tpu_torch.models.norm import set_group
from deeplearning_mpi_tpu_torch.ops.loss import (
    chunked_lm_loss,
    dice_loss,
    lm_cross_entropy,
    sigmoid_binary_cross_entropy,
    softmax_cross_entropy,
)
from deeplearning_mpi_tpu_torch.ops.metrics import dice_score, top1_accuracy
from deeplearning_mpi_tpu_torch.parallel.leaves import reducer as leaf_reducer
from deeplearning_mpi_tpu_torch.resilience.preemption import GracefulShutdown, Preempted
from deeplearning_mpi_tpu_torch.runtime import collectives
from deeplearning_mpi_tpu_torch.telemetry import flops as tflops
from deeplearning_mpi_tpu_torch.telemetry.memory import hbm_usage
from deeplearning_mpi_tpu_torch.telemetry.registry import LoggerSink, MetricsRegistry
from deeplearning_mpi_tpu_torch.telemetry.trace import annotate
from deeplearning_mpi_tpu_torch.train import adafactor
from deeplearning_mpi_tpu_torch.train.state import TrainState
from deeplearning_mpi_tpu_torch.utils.profiling import StepTimer, host_sync

Batch = dict[str, torch.Tensor]
#: batch key holding the model input, per task.
_INPUTS = {"classification": "image", "segmentation": "image", "lm": "tokens"}
#: count (a tensor of optimizer updates so far) -> learning rate (a tensor)
Schedule = Callable[[torch.Tensor], torch.Tensor]


# -- losses -------------------------------------------------------------------
def _lm_mask(batch: Batch, where: torch.Tensor | None) -> torch.Tensor | None:
    # Combine the loader's [B] validity mask with any [B, S] token mask.
    mask = batch.get("mask")
    if where is not None:
        where_bs = where[:, None].expand(batch["tokens"].shape).float()
        mask = where_bs if mask is None else mask * where_bs
    return mask


def _lm_loss(outputs, batch: Batch, where: torch.Tensor | None = None) -> torch.Tensor:
    return lm_cross_entropy(outputs, batch["tokens"], _lm_mask(batch, where))


def _lm_loss_chunked(chunk_size: int) -> Callable[..., torch.Tensor]:
    """LM loss over ``(prehead x, head kernel)`` model outputs — pair with
    ``TransformerLM(return_prehead=True)``."""

    def fn(outputs, batch: Batch, where: torch.Tensor | None = None) -> torch.Tensor:
        x, head_kernel = outputs
        return chunked_lm_loss(x, head_kernel, batch["tokens"], chunk_size=chunk_size,
                               mask=_lm_mask(batch, where))

    return fn


def _loss_fn(task: str, loss_chunk: int = 0, seg_loss: str = "bce",
             seq: Any = None) -> Callable[..., torch.Tensor]:
    """The task's loss ``(outputs, batch, where=None)``; ``where`` ([B]
    validity) excludes wrap-padded eval rows. ``seg_loss``: ``bce`` (the
    original repo's), ``dice`` or ``bce_dice`` (their sum), on the UNet's
    ``[..., 0]`` logits. ``seq``: the LM loss is this sequence shard's share."""
    if seq is not None:
        if task != "lm":
            raise NotImplementedError("sequence parallelism shards the LM's loss only")
        if loss_chunk > 0:
            return lambda outputs, batch, where=None: seq.chunked_lm_loss(
                *outputs, batch["tokens"], _lm_mask(batch, where), loss_chunk)
        return lambda logits, batch, where=None: seq.lm_loss(logits, batch["tokens"],
                                                             _lm_mask(batch, where))
    if task == "lm":
        return _lm_loss_chunked(loss_chunk) if loss_chunk > 0 else _lm_loss
    if task == "classification":
        return lambda logits, batch, where=None: softmax_cross_entropy(
            logits, batch["label"], where)
    if task == "segmentation":
        terms = {"bce": (sigmoid_binary_cross_entropy,), "dice": (dice_loss,),
                 "bce_dice": (sigmoid_binary_cross_entropy, dice_loss)}
        if seg_loss not in terms:
            raise ValueError(f"unknown seg_loss '{seg_loss}'")
        fns = terms[seg_loss]
        return lambda logits, batch, where=None: sum(
            fn(logits[..., 0], batch["mask"], where) for fn in fns)
    raise ValueError(f"unknown task '{task}'")


# -- LR schedules ---------------------------------------------------------------
def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``."""
    if steps <= 0:
        return lambda count: torch.full_like(count, init)
    return lambda count: (init - end) * (1 - count.clamp(0, steps) / steps) + end


def _cosine(init: float, steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` to 0."""
    return lambda count: init * 0.5 * (1 + torch.cos(math.pi * count.clamp(max=steps) / steps))


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """``optax.join_schedules``."""

    def fn(count: torch.Tensor) -> torch.Tensor:
        out = schedules[0](count)
        for boundary, schedule in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, schedule(count - boundary))
        return out

    return fn


def build_lr_schedule(
    base_lr: float, schedule: str = "constant", *, warmup_steps: int = 0, decay_steps: int = 0,
) -> float | Schedule:
    """LR over optimizer steps, as the reference's: ``constant`` with no
    warmup is the bare float; ``cosine`` / ``linear`` decay from ``base_lr``
    to 0 over ``decay_steps`` after a linear warmup from 0. A schedule maps
    a float32 count tensor to the LR, on the count's device."""
    if schedule == "constant":
        if not warmup_steps:
            return base_lr
        return _join([_linear(0.0, base_lr, warmup_steps), lambda c: torch.full_like(c, base_lr)],
                     [warmup_steps])
    if decay_steps <= warmup_steps:
        raise ValueError(
            f"{schedule} schedule needs decay_steps ({decay_steps}) > "
            f"warmup_steps ({warmup_steps}) — set it to the planned total "
            "optimizer steps (steps_per_epoch * num_epochs)"
        )
    if schedule == "cosine":
        return _join([_linear(0.0, base_lr, warmup_steps),
                      _cosine(base_lr, decay_steps - warmup_steps)], [warmup_steps])
    if schedule == "linear":
        return _join([_linear(0.0, base_lr, warmup_steps),
                      _linear(base_lr, 0.0, decay_steps - warmup_steps)], [warmup_steps])
    raise ValueError(f"unknown lr schedule '{schedule}'")


# -- optimizers -----------------------------------------------------------------
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm over every element of every tensor
    (in float32, or float64 for float64 tensors)."""
    return torch.sqrt(sum(collectives.squares(t) for t in tensors))


def _model_norm(grads: dict[str, torch.Tensor], shards: Any) -> torch.Tensor:
    """:func:`global_norm` of the whole model: with expert ``shards`` (or a
    tensor-parallel layout), every rank's slices count, each once."""
    return global_norm(grads.values()) if shards is None else shards.global_norm(grads)


#: optax's defaults, which the reference's ``build_optimizer`` keeps.
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
LION_BETAS = (0.9, 0.99)
@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optax-style chain over named tensors: ``init(params) -> state``
    and ``update(grads, state, params) -> (updates, new state)``, pure
    functions that allocate new tensors (the caller decides what to keep).
    ``updates`` are added to the parameters; the LR is scaled in."""

    name: str
    learning_rate: float | Schedule
    momentum: float = 0.9
    weight_decay: float = 0.0
    clip_norm: float | None = None

    def init(self, params: dict[str, torch.Tensor], views: dict[str, Any]) -> dict[str, Any]:
        """The state of ``params``; ``views`` (``parallel.leaves.leaf_views``
        of their model) places Adafactor's factors on the reference's whole
        leaves."""
        device = next(iter(params.values())).device
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        state: dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        if self.name == "sgd":
            state["trace"] = zeros()
        elif self.name in ("adam", "adamw"):
            state["mu"], state["nu"] = zeros(), zeros()
        elif self.name == "lion":
            state["mu"] = zeros()
        elif self.name == "adafactor":
            slots = {n: adafactor.init(p, views[n]) for n, p in params.items()}
            for i, key in enumerate(adafactor.SLOTS):
                state[key] = {n: t[i] for n, t in slots.items()}
        return state

    def _lr(self, count: torch.Tensor) -> float | torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count.float())
        return self.learning_rate

    def clip(self, grads: dict[str, torch.Tensor], shards: Any = None) -> dict[str, torch.Tensor]:
        """``clip_by_global_norm`` (as is without ``clip_norm``); the norm
        spans ``shards``' other ranks (:func:`_model_norm`)."""
        if self.clip_norm is None:
            return grads
        g_norm = _model_norm(grads, shards)
        keep = g_norm < self.clip_norm
        return {n: torch.where(keep, g, (g / g_norm) * self.clip_norm) for n, g in grads.items()}

    def update(
        self, grads: dict[str, torch.Tensor], state: dict[str, Any],
        params: dict[str, torch.Tensor], *, leaves: Any, shards: Any = None,
        clipped: bool = False,
    ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        """``shards`` (``parallel.expert_parallel.ExpertShards``, or a
        tensor-parallel or pipeline layout): the sharded leaves are this
        rank's slices, and the clip's global norm spans every rank's.
        ``clipped``: the caller has applied :meth:`clip` (ZeRO-1 updates
        slices of gradients clipped whole). ``leaves`` (the model's
        ``parallel.leaves.Reducer``): Adafactor's factored moments and block
        RMS over the reference's whole leaves."""
        if not clipped:
            grads = self.clip(grads, shards)
        lr = self._lr(state["count"])
        count = state["count"] + 1
        new: dict[str, Any] = {"count": count}
        wd = self.weight_decay
        if self.name == "sgd":
            if wd:
                grads = {n: g + wd * params[n] for n, g in grads.items()}
            new["trace"] = {n: g + self.momentum * state["trace"][n] for n, g in grads.items()}
            direction = new["trace"]
        elif self.name in ("adam", "adamw"):
            b1, b2 = ADAM_BETAS
            new["mu"] = {n: (1 - b1) * g + b1 * state["mu"][n] for n, g in grads.items()}
            new["nu"] = {n: (1 - b2) * g * g + b2 * state["nu"][n] for n, g in grads.items()}
            # Scalar ** Tensor: the base rides as a kernel argument, so no
            # host value is copied to the card (a sync, and not capturable).
            c = count.float()
            bc1 = 1 - torch.pow(b1, c)
            bc2 = 1 - torch.pow(b2, c)
            direction = {n: (new["mu"][n] / bc1) / (torch.sqrt(new["nu"][n] / bc2) + ADAM_EPS)
                         for n in grads}
            if self.name == "adamw":
                direction = {n: u + wd * params[n] for n, u in direction.items()}
        elif self.name == "lion":
            b1, b2 = LION_BETAS
            direction = {n: torch.sign((1 - b1) * g + b1 * state["mu"][n])
                         for n, g in grads.items()}
            new["mu"] = {n: (1 - b2) * g + b2 * state["mu"][n] for n, g in grads.items()}
            direction = {n: u + wd * params[n] for n, u in direction.items()}
        elif self.name == "adafactor":
            # chain(scale_by_factored_rms, clip_by_block_rms(1), scale(lr),
            # [add_decayed_weights(wd)], scale(-1)): the decay is not scaled
            # by the LR.
            decay = 1.0 - (state["count"].float() + 1.0) ** -adafactor.DECAY
            scaled, slots = adafactor.scale(grads, state, leaves, decay)
            new.update(slots)
            return {n: -(lr * u + wd * params[n] if wd else lr * u)
                    for n, u in scaled.items()}, new
        else:
            raise ValueError(f"unknown optimizer '{self.name}'")
        return {n: -lr * u for n, u in direction.items()}, new


def build_optimizer(
    name: str, learning_rate: float | Schedule, *, momentum: float = 0.9,
    weight_decay: float = 0.0, clip_norm: float | None = None,
) -> Optimizer:
    """The reference's optimizers (``sgd``: coupled L2 before momentum;
    ``adam``; ``adamw`` and ``lion``: decoupled decay; ``adafactor`` as
    ``optax.adafactor(lr, multiply_by_parameter_scale=False,
    weight_decay_rate=weight_decay or None)``), each with an optional
    ``clip_norm`` in front. A checkpoint holds the optimizer state, so a
    resume must name the optimizer the run started with."""
    if name not in ("sgd", "adam", "adamw", "adafactor", "lion"):
        raise ValueError(f"unknown optimizer '{name}'")
    return Optimizer(name, learning_rate, momentum=momentum, weight_decay=weight_decay,
                     clip_norm=clip_norm)


# -- steps ----------------------------------------------------------------------
def _forward(state: TrainState, task: str, x: torch.Tensor, params: dict | None = None,
             seq: Any = None):
    kw = {"attention_fn": state.attention_fn} if task == "lm" else {}
    args = (x,)
    if seq is not None:  # this rank's slice of the rows, at its positions
        args = seq.inputs(x)
    if params is None:
        return state.model(*args, **kw)
    return functional_call(state.model, params, args, kw)


def _mean_over_group(grads: list[torch.Tensor], scalars: list[torch.Tensor],
                     group, seq: Any = None) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The data-parallel mean of the gradients and the scalars (the loss,
    the MoE dropped fraction): one ``all_reduce_mean`` over a flat float32
    bucket (float64 for float64 gradients). With ``seq``: summed over the
    seq axis and averaged over data, one ``all_reduce_sum`` over the replica
    group divided by the data size."""
    acc = functools.reduce(torch.promote_types, [g.dtype for g in grads], torch.float32)
    flat = torch.cat([g.reshape(-1).to(acc) for g in grads]
                     + [x.reshape(1).to(acc) for x in scalars])
    if seq is None:
        flat = collectives.all_reduce_mean(flat, group)
    else:
        flat = collectives.all_reduce_sum(flat, seq.replica) / seq.data_size
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset: offset + g.numel()].view_as(g).to(g.dtype))
        offset += g.numel()
    tail = flat[offset:]
    return out, [tail[i].to(x.dtype) for i, x in enumerate(scalars)]


def make_train_step(
    task: str, *, aux_weight: float = 0.0, grad_accum: int = 1, loss_chunk: int = 0,
    seg_loss: str = "bce", ema_decay: float = 0.0, guard_metrics: bool = False,
    group: Any = None, seq: Any = None, overlap: Any = None,
) -> Callable[[TrainState, Batch], tuple[TrainState, dict[str, torch.Tensor]]]:
    """Build the optimizer step for a task (``lm``, ``classification``,
    ``segmentation``).

    ``grad_accum > 1`` splits the batch into that many equal chunks, each
    weighted by its valid-token count over the full batch's, and runs one
    update. ``aux_weight`` scales the MoE load-balance loss into the
    differentiated total. ``loss_chunk > 0`` takes the chunked head+loss (pair with
    ``TransformerLM(return_prehead=True)``). ``seg_loss`` picks the
    segmentation objective. ``ema_decay > 0`` advances the state's EMA
    after each accepted update (``ema = d*ema + (1-d)*params``).
    ``guard_metrics`` adds the gradient global norm to the metrics and to
    the finite guard. ``group`` (a process group, or None for one process)
    makes the step data-parallel (module docstring): BatchNorm spans the
    group and the gradients and loss are averaged over it. ``seq`` (a
    ``parallel.seq_common.SeqShards``) shards the LM's sequence over its
    group (module docstring). ``overlap`` (a ``parallel.zero.BucketedReduce``,
    ``--zero_overlap``) reduces the gradients over ``group`` in buckets
    launched from the backward, in place of the one flat all-reduce, and
    hands the ZeRO-1 update this rank's slices. Metrics are
    device scalars: ``loss``, ``finite`` (1.0 or 0.0), with
    ``guard_metrics`` ``grad_norm``, ``moe_dropped_frac`` when the model
    has routed layers and ``moe_aux_loss`` when they sow a balance loss
    (module docstring).
    """
    loss_fn = _loss_fn(task, loss_chunk, seg_loss, seq)
    input_key = _INPUTS[task]

    def chunk_weight(chunk: Batch) -> torch.Tensor:
        # The chunk loss's own denominator: the cross-chunk weighted mean
        # then reproduces the full-batch mean. Only the LM can be ragged.
        mask = chunk.get("mask") if task == "lm" else None
        if mask is not None:
            return mask[:, 1:].float().sum()
        return torch.ones((), device=chunk[input_key].device)

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, dict[str, torch.Tensor]]:
        batch = dict(batch)
        loss_scale = batch.pop("__loss_scale__", None)
        grad_scale = batch.pop("__grad_scale__", None)
        model = state.model
        model.train()
        set_group(model, group)
        shards = state.shards
        names, params = zip(*model.named_parameters())
        # BatchNorm advances its statistics in the forward; a skipped step
        # puts them back.
        stats_before = {n: b.clone() for n, b in model.named_buffers()}

        def loss_and_grads(chunk: Batch, data_scale=None, aux_scale=None):
            # The routed layers keep sowing through the backward: under remat
            # it reruns each block, which must record what its first run did.
            with collecting(model) as sown:
                outputs = _forward(state, task, chunk[input_key], seq=seq)
                aux = collect_aux_loss(sown) if sown.aux else None
                drop = collect_dropped_fraction(sown)
                loss = loss_fn(outputs, chunk)
                if loss_scale is not None:
                    loss = loss * loss_scale
                total = loss if data_scale is None else data_scale * loss
                if aux_weight and aux is not None:
                    total = total + (aux_weight if aux_scale is None else aux_scale) * aux
                if grad_scale is not None:
                    total = total * grad_scale
                grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            return loss.detach(), grads, drop, None if aux is None else aux.detach()

        hooks = contextlib.nullcontext() if overlap is None else overlap.hooks(list(params))
        with hooks as flight:
            if grad_accum == 1:
                loss, grads, drop, aux = loss_and_grads(batch)
            else:
                for key, x in batch.items():
                    if x.shape[0] % grad_accum:
                        raise ValueError(
                            f"batch dim of batch[{key!r}] (shape {tuple(x.shape)}) not "
                            f"divisible by grad_accum={grad_accum}"
                        )
                if task == "lm" and batch.get("mask") is not None:
                    w_total = torch.clamp(chunk_weight(batch), min=1.0)
                else:
                    w_total = float(grad_accum)
                loss, grads, drop, aux = 0.0, None, None, None
                for i in range(grad_accum):
                    if flight is not None:
                        flight.chunk(i, grads)
                    chunk = {k: x.chunk(grad_accum)[i] for k, x in batch.items()}
                    w = chunk_weight(chunk) / w_total
                    c_loss, c_grads, c_drop, c_aux = loss_and_grads(
                        chunk, data_scale=w, aux_scale=aux_weight / grad_accum)
                    loss = loss + w * c_loss
                    grads = c_grads if grads is None else [a + b for a, b in zip(grads, c_grads)]
                    # Equal chunk shares: these cover every routed token.
                    if c_drop is not None:
                        drop = c_drop / grad_accum if drop is None else drop + c_drop / grad_accum
                    if c_aux is not None:
                        aux = c_aux / grad_accum if aux is None else aux + c_aux / grad_accum
        pipe_layout = getattr(model, "pipe_layout", None)
        if pipe_layout is not None:
            grads, loss = pipe_layout.reduce(names, grads, loss)
        scalars = [loss] + ([] if drop is None else [drop])
        if flight is not None:
            grads, scalars = flight.finish(grads, scalars)
        elif group is not None or seq is not None:
            grads, scalars = _mean_over_group(grads, scalars, group, seq)
        loss, drop = scalars[0], (None if drop is None else scalars[1])
        # The norm of gradients that are this rank's ZeRO-1 slices spans the
        # data group.
        norm_shards = state.zero if flight is not None else shards

        with torch.no_grad():
            grads = dict(zip(names, grads))
            old = {n: p.detach() for n, p in zip(names, params)}
            leaves = leaf_reducer(model)
            if state.zero is None:
                updates, new_opt = state.tx.update(grads, state.opt_state, old, leaves=leaves,
                                                   shards=shards)
                new = None
            else:  # ZeRO-1: the update on this rank's slices, gathered
                new, new_opt = state.zero.update(state.tx, grads, state.opt_state, old, shards,
                                                 leaves=leaves, sliced=flight is not None)
            grad_norm = _model_norm(grads, norm_shards) if guard_metrics else None
            finite = torch.isfinite(loss)
            if grad_norm is not None:
                finite = finite & torch.isfinite(grad_norm)
            # NaN/Inf guard: keep the old parameters, statistics, optimizer
            # state and EMA.
            keep = lambda new, cur: torch.where(finite, new, cur)  # noqa: E731
            for n in names:
                old[n].copy_(keep(old[n] + updates[n] if new is None else new[n], old[n]))
            for n, b in model.named_buffers():
                b.copy_(keep(b, stats_before[n]))
            opt_state = _tree_map2(keep, new_opt, state.opt_state)
            ema = state.ema_params
            if ema_decay:
                if ema is None:
                    raise ValueError(
                        "ema_decay set but the state tracks no EMA — build it "
                        "with create_train_state(..., ema=True)"
                    )
                ema = {n: keep(ema_decay * e + (1.0 - ema_decay) * old[n], e)
                       for n, e in ema.items()}
        metrics = {"loss": loss, "finite": finite.float()}
        if grad_norm is not None:
            metrics["grad_norm"] = grad_norm
        if drop is not None:
            metrics["moe_dropped_frac"] = drop
        if aux is not None:
            metrics["moe_aux_loss"] = aux
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state,
                                   ema_params=ema), metrics

    return step


def _tree_map2(fn, a, b):
    """``fn`` over the tensor leaves of two dicts of the same structure."""
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def make_eval_step(
    task: str, *, loss_chunk: int = 0, seg_loss: str = "bce", seq: Any = None,
) -> Callable[[TrainState, Batch], dict[str, torch.Tensor]]:
    """The eval step: loss and the task's metric (``accuracy``; ``dice`` of
    the sigmoid > 0.5 masks) on one batch, with the EMA weights when
    tracked and the running BatchNorm statistics. Wrap-padded rows
    (``__valid__`` 0) are excluded; ``weight`` is the count of real rows,
    for the caller's weighted mean. ``seq``: the loss shares of the seq
    group summed, so every rank of it reports the rows' loss."""
    loss_fn = _loss_fn(task, loss_chunk, seg_loss, seq)
    input_key = _INPUTS[task]

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> dict[str, torch.Tensor]:
        state.model.eval()
        outputs = _forward(state, task, batch[input_key], state.ema_params, seq)
        valid = batch.get("__valid__")
        loss = loss_fn(outputs, batch, valid)
        metrics = {"loss": loss if seq is None else seq.sum(loss)}
        if task == "classification":
            metrics["accuracy"] = top1_accuracy(outputs, batch["label"], valid)
        elif task == "segmentation":
            pred = (torch.sigmoid(outputs[..., 0]) > 0.5).float()
            metrics["dice"] = dice_score(pred, batch["mask"], valid)
        metrics["weight"] = (valid.sum() if valid is not None
                             else torch.tensor(float(batch[input_key].shape[0])))
        return metrics

    return step


class Trainer:
    """The epoch loop: per-epoch mean loss over finite steps, eval and
    checkpoint every ``eval_every`` epochs and after the last, per-epoch
    timing and the reference's telemetry (module docstring). ``checkpointer``
    (a ``train.checkpoint.Checkpointer``) saves the state; ``shutdown`` (a
    :class:`GracefulShutdown`) is read after each epoch. ``group`` makes the
    steps data-parallel; eval then averages over every rank's rows. ``seq``
    shards the LM's sequence (``make_train_step``). ``aux_weight`` weighs
    the MoE load-balance loss. ``zero`` / ``zero_overlap``: ZeRO-1 over
    ``group`` (:meth:`place_state`).

    Telemetry, as the reference's ``Trainer``: ``metrics`` (a
    ``MetricsRegistry``; one is built when None), ``metrics_every`` (record
    every Nth step's scalars; 0 = none), ``flops_per_step`` /
    ``issued_flops_per_step`` (the global batch's model FLOPs, and with
    remat's recompute: MFU), ``comm_bytes_per_step`` (static collective
    bytes a device), ``profiler`` (``utils.profiling.Profiler``: steps
    ``PROFILE_STEPS``), ``tracer`` (``telemetry.SpanRecorder``: the step
    phases), ``logger`` (``utils.logging.RunLogger``: it logs, and its
    sidecar becomes a sink)."""

    #: step window traced when a profiler is attached (skips the first steps)
    PROFILE_STEPS = (3, 6)

    def __init__(
        self, state: TrainState, task: str = "lm", *, eval_every: int = 10,
        aux_weight: float = 0.0, grad_accum: int = 1, loss_chunk: int = 0,
        seg_loss: str = "bce",
        ema_decay: float = 0.0, log: Callable[[str], None] = print, checkpointer: Any = None,
        shutdown: GracefulShutdown | None = None, group: Any = None, seq: Any = None,
        zero: bool = False, zero_overlap: bool = False, logger: Any = None,
        profiler: Any = None, tracer: Any = None,
        metrics: MetricsRegistry | None = None, metrics_every: int = 1,
        flops_per_step: float | None = None, issued_flops_per_step: float | None = None,
        comm_bytes_per_step: float | None = None,
    ) -> None:
        self.state = state
        self.task = task
        self.eval_every = eval_every
        self.logger = logger
        self.log = logger.log if logger is not None else log
        self.checkpointer = checkpointer
        self.shutdown = shutdown
        self.group = group
        self.seq = seq
        self.zero, self.zero_overlap = zero or zero_overlap, zero_overlap
        self.world = 1 if group is None else collectives.axis_size(group)
        # One registry a trainer, always: every record (step, epoch, eval)
        # takes MetricsRegistry.emit, and a logger's sidecar is one sink.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if logger is not None and hasattr(logger, "log_metrics") and not any(
                isinstance(s, LoggerSink) for s in self.metrics.sinks):
            self.metrics.add_sink(LoggerSink(logger))
        self.metrics_every = metrics_every
        self.flops_per_step = flops_per_step
        self.issued_flops_per_step = issued_flops_per_step
        self.comm_bytes_per_step = comm_bytes_per_step
        self.profiler = profiler
        self.tracer = tracer
        self._profiled = False
        #: host-side step counter: reading ``state.step`` would sync
        self._global_step = 0
        self._step_kwargs = dict(aux_weight=aux_weight, grad_accum=grad_accum,
                                 loss_chunk=loss_chunk, seg_loss=seg_loss, ema_decay=ema_decay)
        self.train_step = make_train_step(task, group=group, seq=seq, **self._step_kwargs)
        self.eval_step = make_eval_step(task, loss_chunk=loss_chunk, seg_loss=seg_loss, seq=seq)
        self.history: list[dict[str, float]] = []
        self.place_state()

    def place_state(self) -> None:
        """Place the optimizer state and choose the step, as the reference's
        ``Trainer.place_state``: the data-parallel step (sharded over the
        model's other axes) as built; with ``zero`` the moments cut to this
        rank's slices over the data group (``parallel.zero.Zero1``: the
        reference's placement on its whole leaves, an expert stack's ``E``
        and a stage stack's ``S`` taken; under ``seq`` the slices are over
        data only and replicated over seq, the gradients summed over seq
        before the update), which that step then updates; with
        ``zero_overlap`` the bucketed schedule
        (``parallel.zero.make_overlapped_train_step``) where it applies, else
        the ZeRO-1 step with the reason logged (no data parallelism, another
        axis above 1, the balance or chunked loss, BatchNorm statistics, a
        state that does not mirror the parameters): a fallback from one
        schedule to another, never from the card."""
        if not self.zero:
            return
        from deeplearning_mpi_tpu_torch.parallel.zero import (
            OverlapUnsupported,
            Zero1,
            make_overlapped_train_step,
        )

        state = self.state
        if state.zero is None:
            zero = Zero1.for_state(state, self.group)
            self.state = dataclasses.replace(state, zero=zero,
                                             opt_state=zero.shard(state.opt_state))
        if not self.zero_overlap:
            return
        model = state.model
        pipe = getattr(model, "pipe_layout", None)
        busy = {"pipe": 1 if pipe is None or pipe.pipe is None else pipe.pipe.size,
                "expert": 1 if state.expert_shards is None else state.expert_shards.size,
                "seq": 1 if self.seq is None else self.seq.size,
                "model": model.tp.size if getattr(model, "tp", None) is not None else 1}
        try:
            self.train_step = make_overlapped_train_step(
                self.task, self.state, self.group, busy=busy, **self._step_kwargs)
            self.log("overlap: explicit bucketed ZeRO-1 schedule active")
        except OverlapUnsupported as err:
            self.log(f"overlap unsupported ({err}); falling back to the ZeRO-1 step (--zero)")

    def apply_tuned_step(self, db: Any = None, *, model: str, batch_size: int, seq_len: int,
                         dtype: Any = torch.float32, mesh: Any = None) -> dict[str, Any] | None:
        """Adopt a tuned whole-step schedule (``cli.autotune --step``) for
        ``mesh`` (None: one process), as the reference's
        ``Trainer.apply_tuned_step``: the ``step|<model>|<batch>x<seq>|
        <mesh>|<dtype>|<backend>`` entry of ``db`` (a ``TuningDB``, a path,
        or None for the process default) sets ``grad_accum`` and the
        overlapped ZeRO-1 schedule, and the step is rebuilt. The remat
        policy is a model property: it is returned for the caller (the CLI
        applies it when it builds the model). A missing, corrupt or
        entry-less DB changes nothing and returns None."""
        from deeplearning_mpi_tpu_torch.compiler.autotune import TuningDB, tuned_step_schedule

        try:
            if db is not None and not isinstance(db, TuningDB):
                db = TuningDB.load(db)
            params = tuned_step_schedule(model, (batch_size, seq_len), mesh, dtype, db=db)
        except Exception:
            return None
        if not params:
            return None
        if params.get("grad_accum"):
            self._step_kwargs["grad_accum"] = int(params["grad_accum"])
        if "overlap" in params:
            self.zero_overlap = bool(params["overlap"])
            self.zero = self.zero or self.zero_overlap
        self.train_step = make_train_step(self.task, group=self.group, seq=self.seq,
                                          **self._step_kwargs)
        self.place_state()
        self.log("tuned step schedule applied: "
                 + ", ".join(f"{k}={v}" for k, v in sorted(params.items())))
        return params

    def capture_refusal(self) -> str | None:
        """The layout :meth:`warmup` cannot capture yet (ROADMAP Queue 1
        item 9.1b), or None: the step of one process on one device, dense
        or MoE. A process group's collectives, the lockstep forms and the
        ZeRO-1 placement are not captured."""
        model = self.state.model
        if self.group is not None:
            return "data parallelism over a process group (--dp, --nproc, --coordinator)"
        if self.seq is not None:
            return "sequence parallelism (--sp)"
        if getattr(model, "pipe_layout", None) is not None:
            return "pipeline parallelism (--pp)"
        if getattr(model, "tp", None) is not None:
            return "tensor parallelism (--tp)"
        if self.state.expert_shards is not None:
            return "expert parallelism (--ep)"
        if self.zero:
            return "ZeRO-1 (--zero, --zero_overlap)"
        return None

    def warmup(self, batch: Batch) -> Any:
        """Capture the train step at ``batch``'s shapes before the loop, as
        the reference's ``Trainer.warmup`` compiles it: on CUDA one CUDA
        graph of the whole step (``compiler.aot.CapturedStep``); on the CPU
        there is no graph, the reason is logged and the same static-buffer
        program runs eagerly. ``self.train_step`` becomes a
        ``compiler.aot.WarmProgram``: a batch of another shape runs the
        eager step (``fallback_calls``). Warmup does not train: the state
        after it is bitwise the state before.

        Into the trainer's registry: ``train_compile_seconds`` (the
        capture's seconds) and ``compile_cache_{hit,miss}_total`` (the
        kernel cache's lookups during warmup, ``compiler/cache.py``).
        ``xla_flops_per_step`` / ``xla_bytes_per_step`` are never set:
        PyTorch has no cost analysis. A layout :meth:`capture_refusal`
        names raises ``ValueError``."""
        from deeplearning_mpi_tpu_torch.compiler import aot
        from deeplearning_mpi_tpu_torch.compiler.cache import kernel_cache

        refusal = self.capture_refusal()
        if refusal is not None:
            raise ValueError(f"warmup: {refusal} is not captured yet (ROADMAP Queue 1 item 9.1b)")
        cache = kernel_cache()
        hits, misses = cache.hits, cache.misses
        t0 = time.perf_counter()
        program = aot.CapturedStep(self.train_step, self.state, batch)
        seconds = time.perf_counter() - t0
        self.state = program.hold(self.state)
        self.metrics.gauge("train_compile_seconds").set(seconds)
        self.metrics.counter("compile_cache_hit_total").inc(cache.hits - hits)
        self.metrics.counter("compile_cache_miss_total").inc(cache.misses - misses)
        self.train_step = aot.WarmProgram({aot.batch_key(batch): program}, program.eager,
                                          lambda state, batch: aot.batch_key(batch))
        if program.graph is None:
            device = next(self.state.model.parameters()).device
            self.log(f"warmup: no CUDA graph on {device}; the train step's static-buffer "
                     f"program runs eagerly ({seconds:.2f}s)")
        else:
            self.log(f"warmup: train_step captured as one CUDA graph in {seconds:.2f}s (kernel "
                     f"cache {cache.hits - hits} hit(s), {cache.misses - misses} miss(es))")
        return program

    def run_epoch(self, loader: Any, epoch: int) -> dict[str, float]:
        """One training epoch; the mean loss leaves non-finite steps out. An
        MoE model's epoch mean ``moe_dropped_frac`` covers every step. Emits
        the buffered ``step`` records at its end and returns the epoch's
        stats (the ``epoch`` record, which :meth:`fit` emits)."""
        t0 = time.perf_counter()
        loss_sum = finite_sum = drop_sum = None
        n_batches = sequences = 0
        timer = StepTimer(sync_every=25)
        tracer = self.tracer
        #: measured step phases (tracing only); "other" is the residual
        phase_s = {"data_wait": 0.0, "h2d": 0.0, "compute": 0.0, "collective_tail": 0.0}
        it = iter(loader.epoch(epoch))
        while True:
            if tracer is None:
                try:
                    batch = next(it)
                except StopIteration:
                    break
            else:
                t_fetch = time.monotonic()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t_have = time.monotonic()
                phase_s["data_wait"] += t_have - t_fetch
            if self.profiler is not None and not self._profiled:
                if n_batches == self.PROFILE_STEPS[0]:
                    self.profiler.start()
                elif n_batches == self.PROFILE_STEPS[1]:
                    self.profiler.stop()
                    self._profiled = True
            if tracer is None:
                with annotate("trainer/train_step"):
                    self.state, metrics = self.train_step(self.state, batch)
            else:
                # Fenced step (opt-in syncs): h2d = what the card still owed
                # when the host had the batch; compute = launch until the
                # loss is ready; collective_tail = what the update (the
                # optimizer and its collectives) still owed after it.
                step_trace = f"step:{self._global_step}"
                host_sync(batch)
                t_h2d = time.monotonic()
                phase_s["h2d"] += t_h2d - t_have
                with annotate("trainer/train_step"):
                    self.state, metrics = self.train_step(self.state, batch)
                host_sync(metrics["loss"])
                t_loss = time.monotonic()
                phase_s["compute"] += t_loss - t_h2d
                host_sync(list(self.state.model.parameters()))
                t_tail = time.monotonic()
                phase_s["collective_tail"] += t_tail - t_loss
                tracer.record_span("data_wait", t_fetch, t_have, trace=step_trace)
                tracer.record_span("h2d", t_have, t_h2d, trace=step_trace)
                tracer.record_span("compute", t_h2d, t_loss, trace=step_trace)
                tracer.record_span("collective_tail", t_loss, t_tail, trace=step_trace,
                                   epoch=epoch)
            timer.tick(metrics["loss"])
            if self.metrics_every and self._global_step % self.metrics_every == 0:
                # The card's scalars, unread until flush_steps.
                self.metrics.record_step(self._global_step, metrics)
            self._global_step += 1
            contrib = torch.where(metrics["finite"] > 0, metrics["loss"], 0.0)  # NaN*0 is NaN
            loss_sum = contrib if loss_sum is None else loss_sum + contrib
            finite_sum = metrics["finite"] if finite_sum is None else finite_sum + metrics["finite"]
            if "moe_dropped_frac" in metrics:
                d = metrics["moe_dropped_frac"]
                drop_sum = d if drop_sum is None else drop_sum + d
            n_batches += 1
            sequences += batch[_INPUTS[self.task]].shape[0] * self.world
        if not n_batches:
            raise ValueError("empty epoch — dataset smaller than one batch")
        n_finite = float(finite_sum)  # one host sync per epoch
        mean_loss = float(loss_sum) / n_finite if n_finite else float("nan")
        duration = time.perf_counter() - t0
        stats = {"epoch": epoch, "loss": mean_loss, "duration_s": duration,
                 "images_per_s": sequences / duration}
        if drop_sum is not None:
            stats["moe_dropped_frac"] = float(drop_sum) / n_batches
        stats.update(timer.summary(items_per_step=sequences // n_batches))
        stats.update(self._derived(duration / n_batches, duration,
                                   phase_s if tracer is not None else None))
        # The buffered step scalars: ONE device-to-host copy for the epoch.
        extra = {"epoch": epoch}
        if self.comm_bytes_per_step is not None:
            extra["comm_bytes"] = float(self.comm_bytes_per_step)
        self.metrics.flush_steps(extra=extra)
        if n_finite < n_batches:
            self.log(f"Epoch {epoch}: skipped {n_batches - int(n_finite)} non-finite loss batch(es)")
        unit = "sequences" if self.task == "lm" else "images"
        self.log(f"Epoch {epoch}: loss {mean_loss:.4f}, {duration:.1f}s, "
                 f"{stats['images_per_s']:.1f} {unit}/s")
        if drop_sum is not None:
            self.log(f"Epoch {epoch}: moe_dropped_frac {stats['moe_dropped_frac']:.4f}")
        return stats

    def _derived(self, step_seconds: float, duration: float,
                 phase_s: dict[str, float] | None) -> dict[str, float]:
        """The epoch's derived telemetry, as the reference's ``run_epoch``:
        MFU over every device of the run (``mfu``; ``mfu_issued`` and
        ``mfu_gap`` with the issued FLOPs), the traced phases (``other``
        the residual) and the MFU gap's share of each, the collective bytes
        and their overlap estimate, and the device-memory high-water marks
        of the run's most loaded card (none on the CPU). Every rank computes
        the same numbers: the memory's all-gather is a collective."""
        import torch.distributed as dist

        stats: dict[str, float] = {}
        world = collectives.world_size()
        if self.flops_per_step:
            stats["mfu"] = tflops.mfu(self.flops_per_step, step_seconds, n_devices=world)
        if self.issued_flops_per_step:
            issued = tflops.mfu(self.issued_flops_per_step, step_seconds, n_devices=world)
            if issued is not None:
                stats["mfu_issued"] = issued
                if stats.get("mfu") is not None:
                    stats["mfu_gap"] = issued - stats["mfu"]
        if phase_s is not None:
            phase_s = {**phase_s, "other": max(duration - sum(phase_s.values()), 0.0)}
            for name, secs in phase_s.items():
                stats[f"phase_{name}_s"] = secs
            if "mfu_gap" in stats:
                stats.update(tflops.mfu_gap_attribution(
                    phase_s, duration, mfu_issued=stats["mfu_issued"], mfu_gap=stats["mfu_gap"]))
        if self.comm_bytes_per_step is not None:
            stats["comm_bytes_per_step"] = float(self.comm_bytes_per_step)
            if self.issued_flops_per_step:
                frac = tflops.overlap_fraction(self.comm_bytes_per_step,
                                               self.issued_flops_per_step, n_devices=world)
                if frac is not None:
                    stats["overlap_fraction"] = frac
        hbm = hbm_usage(group=dist.group.WORLD if world > 1 else None)
        if hbm:
            stats.update(hbm)
        return stats

    def evaluate(self, loader: Any) -> dict[str, float]:
        """Weighted mean of the eval metrics over the loader (over every
        rank's rows, with a group); perplexity for the LM."""
        sums: dict[str, torch.Tensor] = {}
        weight = None
        for batch in loader.epoch(0):
            metrics = self.eval_step(self.state, batch)
            w = metrics.pop("weight").to(metrics["loss"].device)
            for k, v in metrics.items():
                sums[k] = sums[k] + v * w if k in sums else v * w
            weight = w if weight is None else weight + w
        if weight is None:
            raise ValueError("empty eval loader")
        if self.group is not None:
            keys = sorted(sums)
            total = collectives.all_reduce_sum(
                torch.stack([sums[k].float() for k in keys] + [weight.float()]), self.group)
            sums, weight = dict(zip(keys, total[:-1])), total[-1]
        if not float(weight):
            raise ValueError("empty eval loader")
        means = {k: float(v) / float(weight) for k, v in sums.items()}
        if self.task == "lm":
            means["perplexity"] = math.exp(min(means["loss"], 30.0))
        return means

    def report_eval(self, stats: dict[str, float]) -> None:
        """Record and log a standalone evaluation (``--eval_only``)."""
        self.history.append(dict(stats))
        self.log("Eval-only: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(stats.items())))
        self.metrics.emit("eval_only", stats)

    def _save(self, epoch: int) -> None:
        """Save the state; with a tracer, as a ``checkpoint`` span."""
        if self.tracer is None:
            self.checkpointer.save(self.state, epoch=epoch)
            return
        t0 = time.monotonic()
        self.checkpointer.save(self.state, epoch=epoch)
        self.tracer.record_span("checkpoint", t0, time.monotonic(), trace=f"epoch:{epoch}",
                                epoch=epoch)

    def fit(self, train_loader: Any, num_epochs: int, *, eval_loader: Any = None,
            start_epoch: int = 0) -> list[dict[str, float]]:
        """Train epochs ``start_epoch .. num_epochs - 1`` with the
        reference's cadence: eval and save every ``eval_every`` epochs, a
        final eval and save unless the last epoch had them. A requested
        shutdown saves the epoch just trained and raises :class:`Preempted`.
        Each epoch's stats (with its eval) are an ``epoch`` record; a final
        eval after the last epoch's record is a ``final_eval`` record."""
        if start_epoch >= num_epochs:
            self.log(f"nothing to do: start epoch {start_epoch} >= num_epochs {num_epochs}")
            return self.history
        last_evaled = last_saved = -1
        for epoch in range(start_epoch, num_epochs):
            stats = self.run_epoch(train_loader, epoch)
            if self.shutdown is not None and self.shutdown.requested():
                if self.checkpointer is not None:
                    self._save(epoch)
                self.history.append(stats)
                self.metrics.emit("epoch", stats)
                self.log(f"shutdown requested: final checkpoint saved at epoch {epoch}, "
                         "exiting cleanly")
                raise Preempted(epoch)
            if epoch % self.eval_every == 0:
                if eval_loader is not None:
                    ev = self.evaluate(eval_loader)
                    last_evaled = epoch
                    stats.update({f"eval_{k}": v for k, v in ev.items()})
                    self.log(f"Epoch {epoch} eval: "
                             + ", ".join(f"{k} {v:.4f}" for k, v in ev.items()))
                if self.checkpointer is not None:
                    self._save(epoch)
                    last_saved = epoch
            self.history.append(stats)
            self.metrics.emit("epoch", stats)
        final_epoch = num_epochs - 1
        if eval_loader is not None and last_evaled != final_epoch:
            final = self.evaluate(eval_loader)
            self.history[-1].update({f"eval_{k}": v for k, v in final.items()})
            self.log("Final eval: " + ", ".join(f"{k} {v:.4f}" for k, v in final.items()))
            self.metrics.emit("final_eval",
                              {"epoch": final_epoch, **{f"eval_{k}": v for k, v in final.items()}})
        if self.checkpointer is not None and last_saved != final_epoch:
            self._save(final_epoch)
        if self.profiler is not None:
            self.profiler.stop()  # closes a window a short epoch left open
        return self.history
