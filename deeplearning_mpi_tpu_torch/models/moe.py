"""Mixture-of-Experts MLP with capacity-based dense dispatch (GShard-style).

Port of ``deeplearning_mpi_tpu/models/moe.py``: an f32 router (a bias-free
``[E, d]`` projection and a softmax), two routing disciplines that build
one ``combine`` tensor ``[B, S, E, C]`` (f32, the gate weights at each
token's capacity slot; ``dispatch = combine > 0``), stacked SwiGLU experts
``experts_gate`` / ``experts_up`` ``[E, d, d_ff]`` and ``experts_down``
``[E, d_ff, d]``, and the dispatch, expert and combine contractions in the
compute dtype. Capacity is per batch row: ``min(S, max(1, ceil(k * S * cf
/ E)))``; an over-capacity token's block output is exact zeros, so it
rides the residual connection.

- ``token_choice`` (GShard / Switch): each token takes its top-k experts
  (ties to the lower index, as ``jax.lax.top_k``), the gates renormalised
  with a 1e-9 floor; capacity positions are claimed slot by slot (slot 0
  before slot 1, sequence order within a slot); the Switch load-balance
  loss ``E * sum_e frac_tokens_e * mean_probs_e`` on the slot-0
  assignments, and the fraction of (token, slot) claims dropped;
- ``expert_choice``: each expert takes its top-C tokens weighted by raw
  affinity; no balance loss; the fraction of tokens no expert took.

The reference's layer *sows* its load-balance loss and dropped fraction
into flax collections; here a forward under :func:`collecting` hands them
to a :class:`Sown` record, and :func:`collect_aux_loss` /
:func:`collect_dropped_fraction` read it as the reference's functions of
those names read the collections (0.0 / None for a dense model).

Under sequence parallelism (``seq``: a ``parallel.seq_common.GroupRing``
over the mesh's seq group, this process running its shard; or a
``LockstepRing`` in one process) the routing is the whole sequence's, as
the reference's over its global arrays. Capacity comes from the global
length. Token choice: each shard's slot-``j`` positions are its exclusive
cumsum plus the claims of the earlier shards in slot ``j`` and of every
shard in the earlier slots (one all-gather of the per-row, per-expert
counts, ``[k, B, E]``, a layer). Expert choice: each expert's top-C over the
whole row (the router probabilities gathered over the group, the backward
this shard's block), each shard keeping its rows of the combine. The
balance loss's ``frac_tokens`` and ``mean_probs`` are means over the whole
(B, S) before their product (the probabilities' sum through an identity-
backward reduction, so each shard's gradient is its own share); the
dropped fraction a shard reports is its share of the whole, which the
train step's sum over the seq group adds up.

Under tensor parallelism (``tp``, the reference's ``ep_spec`` over
``model``: ``parallel.tensor_parallel``) each rank's experts hold a d_ff/tp
slice (``shards.{i}.experts_*``); the routing and dispatch are replicated,
the dispatched tokens enter the slices through the Megatron copy and the
experts' ``down`` partials are summed over the model group before the
combine.

Under data parallelism (``models.norm.set_group``) the load-balance loss is
the GLOBAL batch's, as GSPMD computes it: ``frac_tokens`` and
``mean_probs`` are averaged over the data group before their product
(``mean_probs`` through a differentiable all-reduce). Under expert
parallelism (``shards``) the layer holds its ``E / ep`` experts and joins
the group's partial combines (``parallel/expert_parallel.py``). The
forward's stages run under ``torch.profiler`` ranges named as the
reference's trace annotations (``moe/route``, ``moe/dispatch``,
``moe/experts``, ``moe/combine``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from deeplearning_mpi_tpu_torch.parallel.expert_parallel import (
    ExpertShards,
    copy_to_experts,
    reduce_from_experts,
)
from deeplearning_mpi_tpu_torch.runtime.collectives import all_reduce_sum_autograd

ROUTINGS = ("token_choice", "expert_choice")


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: ties go to the lower index
    (``torch.topk`` promises no order among ties)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


@dataclasses.dataclass
class Sown:
    """What the routed layers of one forward reported, in layer order."""

    aux: list[torch.Tensor] = dataclasses.field(default_factory=list)
    dropped: list[torch.Tensor] = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def collecting(model: nn.Module) -> Iterator[Sown]:
    """Record the load-balance losses and dropped fractions of the forwards
    of ``model`` run inside the block (the reference's ``mutable=[...]``).
    Every submodule with a ``sown`` slot reports: the routed layers, and a
    pipelined model that re-emits its stages' totals
    (``models.pipeline_lm``). Nested blocks restore the outer record."""
    sown = Sown()
    layers = [m for m in model.modules() if hasattr(m, "sown")]
    before = [m.sown for m in layers]
    for m in layers:
        m.sown = sown
    try:
        yield sown
    finally:
        for m, prev in zip(layers, before):
            m.sown = prev


def collect_aux_loss(sown: Sown) -> torch.Tensor:
    """The sum of every sown load-balance loss; a scalar 0.0 for a dense
    model (and for expert-choice routing, which sows none)."""
    if not sown.aux:
        return torch.zeros(())
    return sum(sown.aux[1:], sown.aux[0])


def collect_dropped_fraction(sown: Sown) -> torch.Tensor | None:
    """The mean over routed layers of the dropped / unserved fraction;
    None for a dense model."""
    if not sown.dropped:
        return None
    return sum(sown.dropped[1:], sown.dropped[0]) / len(sown.dropped)


def expert_swiglu(module: nn.Module, expert_in: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``module``'s stacked SwiGLU experts (``experts_gate`` / ``experts_up``
    ``[E, d, f]``, ``experts_down`` ``[E, f, d]``) on ``[E, B, C, d]``, in
    ``dtype``."""
    w_gate, w_up, w_down = (w.to(dtype) for w in
                            (module.experts_gate, module.experts_up, module.experts_down))
    hidden = (F.silu(torch.einsum("egcd,edf->egcf", expert_in, w_gate))
              * torch.einsum("egcd,edf->egcf", expert_in, w_up))
    return torch.einsum("egcf,efd->egcd", hidden, w_down)


class ExpertStacks(nn.Module):
    """One model rank's d_ff slice of the expert stacks."""

    def __init__(self, experts: int, d_model: int, d_ff: int) -> None:
        super().__init__()
        self.experts_gate = nn.Parameter(torch.empty(experts, d_model, d_ff))
        self.experts_up = nn.Parameter(torch.empty(experts, d_model, d_ff))
        self.experts_down = nn.Parameter(torch.empty(experts, d_ff, d_model))


class MoEMLP(nn.Module):
    """Routed mixture of SwiGLU experts with a fixed capacity per expert; a
    drop-in for ``SwiGLU`` (``[B, S, d] -> [B, S, d]``). ``shards`` (an
    :class:`ExpertShards`) keeps only this rank's experts; ``tp`` splits
    each expert's d_ff over a model group; ``seq`` routes a sharded
    sequence (module docstring)."""

    def __init__(
        self, d_model: int, d_ff: int, dtype: torch.dtype, *, num_experts: int = 8,
        top_k: int = 2, capacity_factor: float = 1.25, routing: str = "token_choice",
        shards: ExpertShards | None = None, tp: Any = None, seq: Any = None,
    ) -> None:
        super().__init__()
        if routing not in ROUTINGS:
            raise ValueError(f"unknown MoE routing '{routing}'")
        self.dtype = dtype
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.routing = capacity_factor, routing
        #: this rank's share of the experts over the expert group
        self.ep = shards
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.seq = seq if seq is not None and seq.n > 1 else None
        local = num_experts if shards is None else shards.local_count(num_experts)
        #: the f32 router ``[E, d]``: ``forward`` feeds it its weights' dtype,
        #: float32 (float64 in a model made double)
        self.router = nn.Linear(d_model, num_experts, bias=False)
        if self.tp is None:
            self.experts_gate = nn.Parameter(torch.empty(local, d_model, d_ff))
            self.experts_up = nn.Parameter(torch.empty(local, d_model, d_ff))
            self.experts_down = nn.Parameter(torch.empty(local, d_ff, d_model))
        else:
            #: model rank ``i``'s d_ff slice, named ``shards.{i}.experts_*``
            self.shards = nn.ModuleList(
                ExpertStacks(local, d_model, d_ff // self.tp.size) for _ in self.tp.ranks)
        #: set by :func:`collecting` for the forwards that report.
        self.sown: Sown | None = None
        #: the data-parallel group (``models.norm.set_group``).
        self.group: Any = None

    @property
    def local_experts(self) -> int:
        stack = self.experts_gate if self.tp is None else self.shards[0].experts_gate
        return stack.shape[0]

    def capacity(self, seq: int) -> int:
        """Per batch row, from the WHOLE sequence's length ``seq``."""
        cap = max(1, math.ceil(self.top_k * seq * self.capacity_factor / self.num_experts))
        return min(cap, seq)

    def _global_len(self, local: int) -> int:
        """The whole sequence's length from the rows here: ``local`` is one
        shard's in the process-group form, all of them in one process."""
        if self.seq is None:
            return local
        return local * self.seq.n // len(self.seq.ranks)

    def _token_choice(self, probs: list[torch.Tensor], capacity: int, seq: Any = None):
        """(each shard's combine [B,S,E,C] f32, slot-0 token counts [E],
        the shards' kept claims). ``probs``: the shards here (one, the whole
        sequence, without ``seq``)."""
        k, n_exp = self.top_k, self.num_experts
        tops = [top_k(p, k) for p in probs]
        before = total = None
        if seq is not None:
            # [n, k, B, E]: every shard's claims a slot, row and expert.
            claims = [torch.stack([F.one_hot(idx[..., j], n_exp).sum(dim=1) for j in range(k)])
                      for _, idx in tops]
            every = seq.all_gather(claims)
        combines, kept = [], probs[0].new_zeros(())
        for i, (gates, expert_idx) in enumerate(tops):
            batch, s_local, _ = expert_idx.shape
            gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
            combine = probs[i].new_zeros(batch, s_local, n_exp, capacity)
            count = torch.zeros(batch, 1, n_exp, dtype=torch.int64, device=gates.device)
            if seq is not None:
                before = every[i][:seq.ranks[i]].sum(dim=0)[:, :, None]  # [k, B, 1, E]
                total = every[i].sum(dim=0)[:, :, None]
            for slot in range(k):
                mask = F.one_hot(expert_idx[..., slot], n_exp)
                # exclusive cumsum over the sequence + claims of earlier slots
                # (and, on a shard, of the earlier shards in this slot)
                pos = torch.cumsum(mask, dim=1) - mask + count
                if before is not None:
                    pos = pos + before[slot]
                keep = (mask * (pos < capacity)).float()
                kept = kept + keep.sum()
                # The reference adds gate * keep * one_hot(pos, C): one slot per
                # (token, expert), so a scatter adds the same values.
                slot_gate = (gates[..., slot, None] * keep)[..., None]
                combine = combine.scatter_add(3, pos.clamp(max=capacity - 1)[..., None],
                                              slot_gate)
                count = count + (mask.sum(dim=1, keepdim=True) if total is None
                                 else total[slot])
            combines.append(combine)
        primary = sum(F.one_hot(idx[..., 0], n_exp).float().sum(dim=(0, 1)) for _, idx in tops)
        return combines, primary, kept

    def _expert_choice(self, probs: list[torch.Tensor], capacity: int, seq: Any = None):
        """(each shard's combine [B,S,E,C] f32, the shards' uncovered
        tokens): each expert's top-C over the whole row. ``probs`` as
        :meth:`_token_choice`'s."""
        whole = probs[0] if seq is None else seq.gather(probs)
        batch, n, n_exp = whole.shape
        gates, token_idx = top_k(whole.transpose(1, 2), capacity)  # [B, E, C]
        # combine[b, s, e, c] = gates[b, e, c] where token_idx[b, e, c] == s
        combine = whole.new_zeros(batch, n_exp, capacity, n).scatter(
            3, token_idx[..., None], gates[..., None]).permute(0, 3, 1, 2)
        picks = torch.zeros(batch, n, device=whole.device).scatter_add(
            1, token_idx.reshape(batch, -1), torch.ones(batch, n_exp * capacity,
                                                        device=whole.device))
        if seq is None:
            return [combine], 1.0 - (picks > 0).float().mean()
        local = probs[0].shape[1]
        rows = [slice(r * local, (r + 1) * local) for r in seq.ranks]
        return ([combine[:, sl] for sl in rows],
                sum((picks[:, sl] == 0).float().sum() for sl in rows))

    def _balance_loss(self, primary: torch.Tensor, probs: list[torch.Tensor],
                      seq: Any, tokens: int) -> torch.Tensor:
        """Switch's ``E * sum_e frac_tokens_e * mean_probs_e`` over the global
        batch: both means over the whole (B, S) (``primary``: the shards'
        slot-0 counts; ``tokens``: the whole rows' count) and averaged over
        the data group, before the product."""
        if seq is None:
            frac_tokens, mean_probs = primary / tokens, probs[0].mean(dim=(0, 1))
        else:
            if len(seq.ranks) == 1:  # this shard's counts: the group's total
                primary = seq.reduce([primary])
            frac_tokens = primary / tokens
            mean_probs = seq.reduce([p.sum(dim=(0, 1)) for p in probs]) / tokens
        if self.group is not None:
            n = torch.distributed.get_world_size(self.group)
            both = all_reduce_sum_autograd(torch.cat([frac_tokens, mean_probs]),
                                           self.group) / n
            frac_tokens, mean_probs = both[:self.num_experts], both[self.num_experts:]
        return self.num_experts * (frac_tokens * mean_probs).sum()

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """The local experts on ``[E, B, C, d]``: whole, or each model rank's
        d_ff slice with the ``down`` partials summed over the group."""
        if self.tp is None:
            return expert_swiglu(self, expert_in, self.dtype)
        parts = [expert_swiglu(stack, xi, self.dtype)
                 for stack, xi in zip(self.shards, self.tp.scatter(expert_in))]
        return self.tp.reduce(parts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.seq
        batch = x.shape[0]
        seq_len = self._global_len(x.shape[1])
        capacity = self.capacity(seq_len)
        group = None if self.ep is None else self.ep.group
        with record_function("moe/route"):
            probs = torch.softmax(self.router(x.to(self.router.weight.dtype)),
                                  dim=-1)  # [B, S, E] f32
            route = probs if group is None else copy_to_experts(probs, group)
            shards = [route] if seq is None else seq.split(route)
            if self.routing == "expert_choice":
                combines, dropped = self._expert_choice(shards, capacity, seq)
                if seq is not None:  # these shards' unserved tokens, of the whole rows'
                    dropped = dropped / float(batch * seq_len)
            else:
                combines, primary, kept = self._token_choice(shards, capacity, seq)
                if seq is None:
                    dropped = 1.0 - kept / float(batch * seq_len * self.top_k)
                else:  # these shards' share: their claims not kept, of the whole rows'
                    claims = float(batch * self.top_k * sum(p.shape[1] for p in shards))
                    dropped = (claims - kept) / float(batch * seq_len * self.top_k)
            combine = combines[0] if seq is None else seq.join(combines)
            if self.sown is not None:
                if self.routing == "token_choice":
                    own = [probs] if seq is None else seq.split(probs)
                    self.sown.aux.append(self._balance_loss(primary, own, seq,
                                                            batch * seq_len))
                self.sown.dropped.append(dropped.detach())
        xe = x.to(self.dtype)
        if group is not None:
            first = self.ep.rank * self.local_experts
            combine = combine[:, :, first:first + self.local_experts]
            xe = copy_to_experts(xe, group)
        with record_function("moe/dispatch"):
            dispatch = (combine > 0.0).to(self.dtype)
            # groups g = batch rows: [B,S,E,C] x [B,S,d] -> [E,B,C,d]
            expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xe)
        with record_function("moe/experts"):
            expert_out = self._experts(expert_in)
        with record_function("moe/combine"):
            # combine carries the gate weights; dropped tokens get exact zeros
            out = torch.einsum("gsec,egcd->gsd", combine.to(self.dtype), expert_out)
            return out if group is None else reduce_from_experts(out, group)


def mlp_from_config(config: Any, d_model: int, d_ff: int, dtype: torch.dtype,
                    shards: ExpertShards | None = None, tp: Any = None,
                    seq: Any = None) -> MoEMLP:
    """The routed MLP of a transformer config's MoE fields."""
    return MoEMLP(d_model, d_ff, dtype, num_experts=config.moe_experts,
                  top_k=config.moe_top_k, capacity_factor=config.moe_capacity_factor,
                  routing=config.moe_routing, shards=shards, tp=tp, seq=seq)
