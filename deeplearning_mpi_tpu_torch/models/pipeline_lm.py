"""Pipeline-parallel Transformer LM: the blocks in stages over the ``pipe`` axis.

Port of ``deeplearning_mpi_tpu/models/pipeline_lm.py``. The decomposition
is the reference's:

- :class:`EmbedHead`, the token embedding (``encode``) and the final norm
  and logits (``decode``; ``prehead`` for the chunked loss, tied
  embeddings only), runs outside the pipeline on the whole batch, and
  every pipe rank holds a replica of it;
- the ``num_layers`` blocks split into ``num_stages`` equal
  :class:`StageBlocks` (``block_{j}``, each a port ``Block``), driven over
  ``num_microbatches`` microbatches by
  :func:`~deeplearning_mpi_tpu_torch.parallel.pipeline.pipeline_apply`.

The reference stacks the stages in one tree ``[S, ...]``; here each stage is
its own module, ``stages.{s}``, and a process holds the stages its pipe
gives it (all ``S`` for a :class:`~deeplearning_mpi_tpu_torch.parallel.pipeline.LockstepPipe`
or no pipe, its rank's one for a ``GroupPipe``). ``pipe_layout``
(``parallel.pipeline.PipeLayout``) maps that onto the reference's stacked
tree for checkpoints, the global norm and the pipe's gradient sum.

Under a ``GroupPipe`` the last stage runs the head: the outputs are
broadcast to every pipe rank, which computes the same logits and loss, but
only the last rank's head and the first rank's embedding take gradients,
so the train step's one sum of the replicated leaves over the pipe group
(``PipeLayout.reduce``) counts each part of the tied embedding's gradient
once.

Tensor parallelism inside the stages (``tp``, a
``parallel.tensor_parallel.GroupTP`` over the model group or a
``LockstepTP``): every stage's blocks are the Megatron-sharded blocks of
``TransformerLM(tp=...)`` and ``EmbedHead``'s tied table (or untied head) is
stored as its model shards and gathered whole each time it is read, the
reference's rule laid over the stage stacks
(``parallel/tensor_parallel.py:80-103`` in the reference). The pipe's
sends go to the same model coordinate of the next stage: the pipe group is
the mesh's, at this process's model coordinate. ``tp_layout`` maps the
shards to the whole leaves; the state composes it with ``pipe_layout``
(``parallel.tensor_parallel.Within``).

Expert parallelism inside the stages (``expert_shards``, a
``parallel.expert_parallel.ExpertShards`` over the expert group): every
stage's routed layers hold this process's share of their experts and sum
the combine over the expert group, per microbatch; the pipe group is the
mesh's at this process's expert coordinate, so the ranks of one expert
group run the same stage on the same microbatches. A checkpoint gathers the
expert stacks whole before it stacks the stages, so it is the same tree at
every expert degree.

MoE through the stages: a stage's routed layers report to a record of
that stage's forward (``models.moe.collecting``), and each microbatch
carries an ``aux`` and a ``drop`` scalar through the schedule, the sums
over stages of its stages' load-balance losses and layer-mean dropped
fractions (:func:`reduce_moe_scalars` turns them into the model's).
The model then re-emits both into the caller's record, as the reference
re-emits its ``mutable`` collections, so the train step reads a pipelined
model's balance loss as it reads the flat model's; a dense pipeline emits
no dropped fraction.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from deeplearning_mpi_tpu_torch import resolve_device
from deeplearning_mpi_tpu_torch.models.moe import (
    collect_aux_loss,
    collect_dropped_fraction,
    collecting,
)
from deeplearning_mpi_tpu_torch.models.transformer import (
    REMAT_POLICIES,
    Block,
    Dense,
    RMSNorm,
    TransformerConfig,
    TransformerLM,
    run_block,
)
from deeplearning_mpi_tpu_torch.parallel.pipeline import (
    PipeLayout,
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
)


class StageBlocks(nn.Module):
    """One pipeline stage: ``num_blocks`` consecutive blocks ``block_{j}``,
    each under the ``remat`` policy as ``TransformerLM``'s blocks."""

    def __init__(self, config: TransformerConfig, num_blocks: int, dtype: torch.dtype,
                 remat: str = "none", tp=None, tp_plan=None, expert_shards=None) -> None:
        super().__init__()
        self.num_blocks, self.remat = num_blocks, remat
        for j in range(num_blocks):
            setattr(self, f"block_{j}", Block(config, dtype, expert_shards=expert_shards, tp=tp,
                                              tp_plan=tp_plan))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                attention_fn: Callable | None = None) -> torch.Tensor:
        for j in range(self.num_blocks):
            x = run_block(getattr(self, f"block_{j}"), x, positions, attention_fn, self.remat)
        return x


class EmbedHead(nn.Module):
    """The embedding in, the logits out: the non-pipelined ends of the LM.
    ``live=False`` computes the same values with the parameters detached
    (a pipe rank whose head gradient does not count). Under ``tp_plan`` the
    table (and an untied head) is stored as ``tp``'s shards
    (``ShardedTable``) and gathered whole where it is read."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype, tp=None,
                 tp_plan=None) -> None:
        super().__init__()
        from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import ShardedTable

        self.config, self.dtype = config, dtype
        shape = (config.vocab_size, config.d_model)
        if tp_plan is not None and tp_plan.embed:
            self.embed = ShardedTable(shape, tp_plan.dims["embed.weight"], tp)
        else:
            self.embed = nn.Embedding(*shape)
        self.final_norm = RMSNorm(config.d_model)
        if config.tied_embeddings:
            self.lm_head = None
        elif tp_plan is not None and tp_plan.lm_head:
            self.lm_head = ShardedTable(shape, tp_plan.dims["lm_head.weight"], tp)
        else:
            self.lm_head = Dense(config.d_model, config.vocab_size, dtype)

    def _table(self, params: dict, key: str) -> torch.Tensor:
        """The ``[V, d]`` table ``key`` (``embed`` / ``lm_head``) whole: as
        held, or gathered from its model shards."""
        table = getattr(self, key)
        if isinstance(table, (nn.Embedding, Dense)):
            return params[f"{key}.weight"]
        return table.tp.gather([params[f"{key}.shards.{i}.weight"]
                                for i in range(len(table.shards))], table.dim)

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self._table(self._params(True), "embed").to(self.dtype))

    def _params(self, live: bool) -> dict[str, torch.Tensor]:
        return {n: p if live else p.detach() for n, p in self.named_parameters()}

    def _norm(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        return functional_call(self.final_norm, {"scale": params["final_norm.scale"]}, (x,))

    def decode(self, x: torch.Tensor, live: bool = True) -> torch.Tensor:
        """Float32 logits (float64 in a float64 model), as ``TransformerLM.head``."""
        params = self._params(live)
        x = self._norm(x, params)
        if self.lm_head is None:
            logits = x.to(self.dtype) @ self._table(params, "embed").to(self.dtype).T
        else:
            logits = F.linear(x.to(self.dtype), self._table(params, "lm_head").to(self.dtype))
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def prehead(self, x: torch.Tensor, live: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """(final-norm activations, head kernel ``[d, V]``) for the chunked
        loss (``ops.loss.chunked_lm_loss``); tied embeddings only."""
        if self.lm_head is not None:
            raise ValueError("prehead requires tied_embeddings")
        params = self._params(live)
        return self._norm(x, params), self._table(params, "embed").T


def reduce_moe_scalars(aux: torch.Tensor, drop: torch.Tensor,
                       num_stages: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's load-balance loss and dropped fraction from the
    per-microbatch ``[M]`` sums over stages: each microbatch's aux is the
    sum of its stages' Switch losses, so their mean over microbatches keeps
    the flat model's scale; a microbatch's drop is the sum of ``S`` stage
    means over equal layer counts, so its mean over microbatches divided by
    ``S`` is the all-layer mean the flat model reports."""
    return aux.mean(), drop.mean() / num_stages


class PipelinedLM(nn.Module):
    """GPipe-parallel causal LM: ``forward(tokens)`` is ``TransformerLM``'s
    full-sequence forward (logits ``[B, S, V]``, or with ``return_prehead``
    the chunked loss's pair), run as ``num_microbatches`` microbatches
    through ``num_stages`` stages over ``pipe``, the blocks and the table
    sharded over ``tp`` (module docstring). Weights are float32; ``device``
    defaults to CUDA (raises without it; ``tp.devices[0]`` under ``tp``)."""

    def __init__(
        self, config: TransformerConfig, *, num_stages: int, num_microbatches: int = 4,
        dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cuda",
        remat: str = "none", return_prehead: bool = False, pipe: Any = None, tp: Any = None,
        expert_shards: Any = None,
    ) -> None:
        super().__init__()
        if return_prehead and not config.tied_embeddings:
            raise ValueError("return_prehead requires tied_embeddings")
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r} (expected one of {REMAT_POLICIES})")
        pipe = pipe if pipe is not None and pipe.size > 1 else None
        if pipe is not None and pipe.size != num_stages:
            raise ValueError(f"num_stages {num_stages} != pipe size {pipe.size}")
        if config.num_layers % num_stages:
            raise ValueError(f"num_layers {config.num_layers} not divisible into "
                             f"{num_stages} stages")
        tp = tp if tp is not None and tp.size > 1 else None
        plan = None
        if tp is not None:
            from deeplearning_mpi_tpu_torch.parallel import tensor_parallel

            plan = tensor_parallel.plan(config, tp.size)
            device = tp.devices[0]
        self.config, self.dtype, self.pipe = config, dtype, pipe
        self.num_stages, self.num_microbatches = num_stages, num_microbatches
        self.return_prehead = return_prehead
        self.tp, self.tp_plan = tp, plan
        self.expert_shards = expert_shards if config.moe_experts > 0 else None
        self.pipe_layout = PipeLayout(pipe, num_stages)
        per_stage = config.num_layers // num_stages
        self.stages = nn.ModuleDict({
            str(s): StageBlocks(config, per_stage, dtype, remat, tp, plan, self.expert_shards)
            for s in self.pipe_layout.stage_ids})
        self.embed_head = EmbedHead(config, dtype, tp, plan)
        #: the caller's ``models.moe.collecting`` record (re-emission).
        self.sown = None
        self.to(resolve_device(device))
        self.tp_layout = None
        if tp is not None:
            from deeplearning_mpi_tpu_torch.models.convert import flat_name

            tensor_parallel.place_shards(self, tp)
            self.tp_layout = tensor_parallel.layout(
                self, plan, rename=lambda n: flat_name(n, per_stage))

    @property
    def device(self) -> torch.device:
        return self.embed_head.final_norm.scale.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "PipelinedLM":
        """The weights ``TransformerLM(config).init_weights(seed)`` draws,
        each block in its stage (drawn whole on the CPU, so every rank and
        every stage count hold the same model)."""
        flat = TransformerLM(self.config, dtype=self.dtype, device="cpu").init_weights(seed)
        return self.load_flat_state_dict(flat.state_dict())

    def load_flat_state_dict(self, sd: dict[str, torch.Tensor]) -> "PipelinedLM":
        """Load a flat ``TransformerLM`` state dict: this process's stages and
        the embedding and head."""
        from deeplearning_mpi_tpu_torch.models.convert import pipelined_from_flat

        self.load_full_state_dict(pipelined_from_flat(sd, self.num_stages))
        return self

    def load_full_state_dict(self, sd: dict[str, torch.Tensor]) -> None:
        """Load the whole pipelined model's state dict (every stage, whole
        leaves), keeping this process's stages, expert slices and model
        shards."""
        from deeplearning_mpi_tpu_torch.parallel.expert_parallel import shard_state_dict

        mine = {n: t for n, t in sd.items()
                if PipeLayout.split(n)[1] in (None, *self.pipe_layout.stage_ids)}
        if self.tp_layout is not None:
            mine = self.tp_layout.local(mine)
        self.load_state_dict(shard_state_dict(mine, self.expert_shards))

    @property
    def layout(self) -> Any:
        """The model's whole layout: the pipe's, with the model shards
        inside it under ``tp`` (``parallel.tensor_parallel.Within``)."""
        if self.tp_layout is None:
            return self.pipe_layout
        from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import Within

        return Within(self.tp_layout, self.pipe_layout)

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The whole model's parameters as a flat ``TransformerLM`` state
        dict (a collective over a process-group pipe, expert or model
        group), detached."""
        from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked
        from deeplearning_mpi_tpu_torch.parallel.expert_parallel import map_expert_leaves

        params = {n: p.detach() for n, p in self.named_parameters()}
        if self.expert_shards is not None:
            params = map_expert_leaves(self.expert_shards.gather, params)
        return flat_from_stacked(self.layout.gather(params))

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None, *,
                attention_fn: Callable | None = None):
        batch, seq = tokens.shape
        if positions is None:
            positions = torch.arange(seq, device=tokens.device)[None].expand(batch, seq)
        outer = self.sown
        x = self.embed_head.encode(tokens)
        xs = split_microbatches({"x": x, "pos": positions}, self.num_microbatches)
        zeros = torch.zeros(self.num_microbatches, dtype=torch.float32, device=x.device)
        xs["aux"], xs["drop"] = zeros, zeros.clone()
        seen = {"aux": False, "drop": False}

        def stage_fn(stage: StageBlocks, acts: dict) -> dict:
            with collecting(stage) as sown:
                y = stage(acts["x"], acts["pos"], attention_fn)
            seen["aux"] |= bool(sown.aux)
            aux = acts["aux"] + collect_aux_loss(sown).to(acts["aux"])
            drop = collect_dropped_fraction(sown)
            seen["drop"] |= drop is not None
            drop = acts["drop"] + (0.0 if drop is None else drop.to(acts["drop"]))
            return {"x": y, "pos": acts["pos"], "aux": aux, "drop": drop}

        ys = pipeline_apply(stage_fn, list(self.stages.values()), xs, pipe=self.pipe,
                            stage_context=collecting)
        aux, drop = reduce_moe_scalars(ys.pop("aux"), ys.pop("drop"), self.num_stages)
        if outer is not None:
            if seen["aux"]:
                outer.aux.append(aux)
            if seen["drop"]:
                outer.dropped.append(drop.detach())
        out = merge_microbatches(ys)["x"]
        live = self.pipe is None or self.pipe.runs_head
        if self.return_prehead:
            return self.embed_head.prehead(out, live)
        return self.embed_head.decode(out, live)
