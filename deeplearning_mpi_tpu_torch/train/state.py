"""Train state: the model, its optimizer and optimizer state, the step.

Port of ``deeplearning_mpi_tpu/train/state.py``. The reference's state is
one immutable pytree; here it is a dataclass around the ``nn.Module``,
whose parameters the train step updates in place (no second copy of the
weights outlives the step), the optimizer chain with its state (a dict of
tensors that the step replaces), and an optional EMA of the parameters.
The model's attention core rides the state, as the reference's
``apply_fn`` carries the flax module's ``attention_fn``.

:meth:`TrainState.arrays` is the checkpoint's view of the state (the
reference's ``_arrays_only``), and :meth:`TrainState.fill` takes such a
view back into a template state. A model with buffers (the CNNs'
BatchNorm running statistics) carries them as ``batch_stats``, the
reference's collection of that name; the train step advances them in
place.

Under expert parallelism (the model's ``expert_shards``) a process holds
its slice of every expert stack and of the stacks' optimizer moments and
EMA: :meth:`TrainState.arrays` gathers the full stacks (a collective over
the expert group, so every rank calls it) and :meth:`TrainState.fill`
takes full stacks and keeps this rank's slice. Under tensor parallelism
(the model's ``tp_layout``) the shards of every sharded leaf are gathered
whole, and under ZeRO-1 (``zero``, ``parallel.zero.Zero1``) the optimizer
moments' slices over the data group: both collectives, so every rank calls
:meth:`TrainState.arrays`, and :meth:`TrainState.fill` keeps this rank's
part. A checkpoint is thus the same tree at every expert, tensor, data and
ZeRO layout, and restores under any other. A pipelined model's tree (its
``pipe_layout``, ``parallel.pipeline.PipeLayout``) holds each stage leaf
stacked over the stages, ``[S, ...]``, the reference's layout: gathered
over the pipe group (a collective) and cut back to this rank's stage, so it
restores under the same stage count at any data or pipe form. The
composed layouts gather both: a pipelined model's model shards, then its
stages (``parallel.tensor_parallel.Within``); an MoE model's expert slices
over the expert group, then each expert's d_ff over the model group, and
its stages last when it is pipelined; :meth:`TrainState.fill` cuts in the
reverse order. Adafactor's moments follow the reference's whole leaves
(``train.adafactor.gather_slots``), so they too are saved whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from deeplearning_mpi_tpu_torch.parallel.expert_parallel import map_expert_leaves
from deeplearning_mpi_tpu_torch.parallel.leaves import leaf_views
from deeplearning_mpi_tpu_torch.train import adafactor


@dataclasses.dataclass
class TrainState:
    """Everything the optimizer touches."""

    model: nn.Module
    #: the optimizer chain (``train.trainer.build_optimizer``): pure
    #: ``init`` / ``update`` functions over named tensors.
    tx: Any
    opt_state: dict[str, Any]
    step: int = 0
    #: exponential moving average of the parameters (None = EMA off),
    #: seeded with a copy of them, so no bias correction is needed.
    ema_params: dict[str, torch.Tensor] | None = None
    #: the attention core the model's full-sequence forward runs.
    attention_fn: Callable | None = None
    #: ZeRO-1: the optimizer moments are this rank's slices over the data
    #: group (``parallel.zero.Zero1``; None: whole).
    zero: Any = None

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def eval_params(self) -> dict[str, torch.Tensor]:
        """The EMA weights when tracked, else the live parameters."""
        return self.params() if self.ema_params is None else self.ema_params

    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The model's buffers (BatchNorm running statistics); empty for the LM."""
        return {n: b.detach() for n, b in self.model.named_buffers()}

    @property
    def expert_shards(self) -> Any:
        """The model's expert sharding (None: every expert is here)."""
        return getattr(self.model, "expert_shards", None)

    @property
    def shards(self) -> Any:
        """What the global norm spans beyond this process's leaves: the
        expert sharding, the tensor-parallel layout or the pipeline's, or
        two of them composed (None: none)."""
        layout, experts = _layout(self.model), self.expert_shards
        if layout is not None and experts is not None:
            from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import Within

            return Within(layout, experts)
        return experts or layout

    def arrays(self) -> dict[str, Any]:
        """What a checkpoint holds: ``step`` (an int32 scalar, as the
        reference's), ``params``, ``opt_state`` and, only when present,
        ``batch_stats`` and ``ema_params`` — so the LM's and EMA-off
        checkpoints keep their exact tree. Expert stacks are gathered whole
        (module docstring)."""
        factored = _factored_slots(self.opt_state)
        out: dict[str, Any] = {
            "step": torch.tensor(self.step, dtype=torch.int32),
            "params": {n: p.detach() for n, p in self.model.named_parameters()},
            "opt_state": {k: v for k, v in self.opt_state.items() if k not in factored},
        }
        stats = self.batch_stats()
        if stats:
            out["batch_stats"] = stats
        if self.ema_params is not None:
            out["ema_params"] = self.ema_params
        shards = self.expert_shards
        if shards is not None:
            out = {k: map_expert_leaves(shards.gather, v) for k, v in out.items()}
        if self.zero is not None:
            out["opt_state"] = self.zero.gather(out["opt_state"])
        layout = _layout(self.model)
        if layout is not None:
            out = {k: _named_trees(layout.gather, v, k) for k, v in out.items()}
        if factored:
            whole = {**out["opt_state"], **adafactor.gather_slots(self.model, factored)}
            out["opt_state"] = {k: whole[k] for k in self.opt_state}
        return out

    @torch.no_grad()
    def fill(self, arrays: dict[str, Any]) -> "TrainState":
        """This state with ``arrays`` (a tree of :meth:`arrays`' form, or a
        part of one) taken in: the parameters are copied into the model in
        place; ``opt_state`` and ``ema_params`` replace the template's where
        given; ``batch_stats`` is copied into the buffers. Full expert stacks
        are cut to this rank's slice. The caller has checked names, shapes
        and dtypes."""
        factored = _factored_slots(arrays.get("opt_state", {}))
        if factored:
            arrays = {**arrays, "opt_state": {k: v for k, v in arrays["opt_state"].items()
                                              if k not in factored}}
        layout = _layout(self.model)
        if layout is not None:  # first, so a stacked stage leaf is cut to its stage
            local = lambda tree: {n: t.clone() for n, t in layout.local(tree).items()}  # noqa: E731
            arrays = {k: _named_trees(local, v, k) for k, v in arrays.items()}
        shards = self.expert_shards
        if shards is not None:
            arrays = {k: map_expert_leaves(lambda t: shards.local(t).clone(), v)
                      for k, v in arrays.items()}
        if self.zero is not None and "opt_state" in arrays:
            arrays = {**arrays, "opt_state": self.zero.shard(arrays["opt_state"])}
        if factored:
            mine = {**arrays["opt_state"], **adafactor.local_slots(self.model, factored)}
            arrays = {**arrays, "opt_state": {k: mine[k] for k in self.opt_state}}
        if "params" in arrays:
            for n, p in self.model.named_parameters():
                p.copy_(arrays["params"][n])
        if "batch_stats" in arrays:
            for n, b in self.model.named_buffers():
                b.copy_(arrays["batch_stats"][n])
        return dataclasses.replace(
            self,
            step=int(arrays["step"]) if "step" in arrays else self.step,
            opt_state=arrays.get("opt_state", self.opt_state),
            ema_params=arrays.get("ema_params", self.ema_params),
        )


def _factored_slots(opt_state: dict) -> dict:
    """Adafactor's slots: its factors follow the reference's whole leaves,
    not the parameters' shards, so its slots are gathered and cut by
    ``train.adafactor`` (empty for another optimizer)."""
    return {k: opt_state[k] for k in adafactor.SLOTS if k in opt_state}


def _layout(model: nn.Module) -> Any:
    """The model's tensor-parallel or pipeline layout, or both composed
    (a pipelined model's ``layout``; None: neither)."""
    if getattr(model, "pipe_layout", None) is not None:
        return model.layout
    return getattr(model, "tp_layout", None)


def _named_trees(fn: Callable[[dict], dict], tree: Any, key: str) -> Any:
    """``fn`` over the trees keyed by parameter names in one top-level
    entry of :meth:`TrainState.arrays`: ``params``, ``ema_params``,
    ``batch_stats`` and each slot of ``opt_state`` (its ``count`` as is)."""
    if key == "opt_state":
        return {k: fn(v) if isinstance(v, dict) else v for k, v in tree.items()}
    if key in ("params", "ema_params"):
        return fn(tree)
    return tree


def create_train_state(
    model: nn.Module, tx: Any, *, attention_fn: Callable | None = None, ema: bool = False,
) -> TrainState:
    """Wrap an initialised model with a fresh optimizer state for ``tx``
    (``tx=None``: no optimizer, an empty state — the template of a
    params-only restore). Adafactor's factors of a model whose leaves are
    split sit on the reference's whole leaves (``parallel.leaves``)."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return TrainState(
        model=model, tx=tx,
        opt_state={} if tx is None else tx.init(params, leaf_views(model)),
        ema_params={n: p.clone() for n, p in params.items()} if ema else None,
        attention_fn=attention_fn,
    )
