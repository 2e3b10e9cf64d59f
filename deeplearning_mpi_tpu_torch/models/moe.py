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


class MoEMLP(nn.Module):
    """Routed mixture of SwiGLU experts with a fixed capacity per expert; a
    drop-in for ``SwiGLU`` (``[B, S, d] -> [B, S, d]``). ``shards`` (an
    :class:`ExpertShards`) keeps only this rank's experts."""

    def __init__(
        self, d_model: int, d_ff: int, dtype: torch.dtype, *, num_experts: int = 8,
        top_k: int = 2, capacity_factor: float = 1.25, routing: str = "token_choice",
        shards: ExpertShards | None = None,
    ) -> None:
        super().__init__()
        if routing not in ROUTINGS:
            raise ValueError(f"unknown MoE routing '{routing}'")
        self.dtype = dtype
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.routing = capacity_factor, routing
        self.shards = shards
        local = num_experts if shards is None else shards.local_count(num_experts)
        #: the f32 router ``[E, d]``: ``forward`` feeds it its weights' dtype,
        #: float32 (float64 in a model made double)
        self.router = nn.Linear(d_model, num_experts, bias=False)
        self.experts_gate = nn.Parameter(torch.empty(local, d_model, d_ff))
        self.experts_up = nn.Parameter(torch.empty(local, d_model, d_ff))
        self.experts_down = nn.Parameter(torch.empty(local, d_ff, d_model))
        #: set by :func:`collecting` for the forwards that report.
        self.sown: Sown | None = None
        #: the data-parallel group (``models.norm.set_group``).
        self.group: Any = None

    def capacity(self, seq: int) -> int:
        cap = max(1, math.ceil(self.top_k * seq * self.capacity_factor / self.num_experts))
        return min(cap, seq)

    def _token_choice(self, probs: torch.Tensor, capacity: int):
        """(combine [B,S,E,C] f32, slot-0 token fractions [E], dropped claim
        fraction)."""
        batch, seq, n_exp = probs.shape
        gates, expert_idx = top_k(probs, self.top_k)
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
        combine = probs.new_zeros(batch, seq, n_exp, capacity)
        count = torch.zeros(batch, 1, n_exp, dtype=torch.int64, device=probs.device)
        kept = probs.new_zeros(())
        for slot in range(self.top_k):
            mask = F.one_hot(expert_idx[..., slot], n_exp)
            # exclusive cumsum over the sequence + claims of earlier slots
            pos = torch.cumsum(mask, dim=1) - mask + count
            keep = (mask * (pos < capacity)).float()
            kept = kept + keep.sum()
            # The reference adds gate * keep * one_hot(pos, C): one slot per
            # (token, expert), so a scatter adds the same values.
            slot_gate = (gates[..., slot, None] * keep)[..., None]
            combine = combine.scatter_add(3, pos.clamp(max=capacity - 1)[..., None], slot_gate)
            count = count + mask.sum(dim=1, keepdim=True)
        frac_tokens = F.one_hot(expert_idx[..., 0], n_exp).float().mean(dim=(0, 1))
        dropped = 1.0 - kept / float(batch * seq * self.top_k)
        return combine, frac_tokens, dropped

    def _expert_choice(self, probs: torch.Tensor, capacity: int):
        """(combine [B,S,E,C] f32, uncovered-token fraction)."""
        batch, seq, n_exp = probs.shape
        gates, token_idx = top_k(probs.transpose(1, 2), capacity)  # [B, E, C]
        # combine[b, s, e, c] = gates[b, e, c] where token_idx[b, e, c] == s
        combine = probs.new_zeros(batch, n_exp, capacity, seq).scatter(
            3, token_idx[..., None], gates[..., None]).permute(0, 3, 1, 2)
        picks = torch.zeros(batch, seq, device=probs.device).scatter_add(
            1, token_idx.reshape(batch, -1), torch.ones(batch, n_exp * capacity,
                                                        device=probs.device))
        uncovered = 1.0 - (picks > 0).float().mean()
        return combine, uncovered

    def _balance_loss(self, frac_tokens: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        """Switch's ``E * sum_e frac_tokens_e * mean_probs_e`` over the global
        batch: both means averaged over the data group before the product."""
        mean_probs = probs.mean(dim=(0, 1))
        if self.group is not None:
            n = torch.distributed.get_world_size(self.group)
            both = all_reduce_sum_autograd(torch.cat([frac_tokens, mean_probs]),
                                           self.group) / n
            frac_tokens, mean_probs = both[:self.num_experts], both[self.num_experts:]
        return self.num_experts * (frac_tokens * mean_probs).sum()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        capacity = self.capacity(x.shape[1])
        group = None if self.shards is None else self.shards.group
        with record_function("moe/route"):
            probs = torch.softmax(self.router(x.to(self.router.weight.dtype)),
                                  dim=-1)  # [B, S, E] f32
            route = probs if group is None else copy_to_experts(probs, group)
            if self.routing == "expert_choice":
                combine, dropped = self._expert_choice(route, capacity)
                frac_tokens = None
            else:
                combine, frac_tokens, dropped = self._token_choice(route, capacity)
            if self.sown is not None:
                if frac_tokens is not None:
                    self.sown.aux.append(self._balance_loss(frac_tokens, probs))
                self.sown.dropped.append(dropped.detach())
        xe = x.to(self.dtype)
        if group is not None:
            first = self.shards.rank * self.experts_gate.shape[0]
            combine = combine[:, :, first:first + self.experts_gate.shape[0]]
            xe = copy_to_experts(xe, group)
        w_gate, w_up, w_down = (w.to(self.dtype) for w in
                                (self.experts_gate, self.experts_up, self.experts_down))
        with record_function("moe/dispatch"):
            dispatch = (combine > 0.0).to(self.dtype)
            # groups g = batch rows: [B,S,E,C] x [B,S,d] -> [E,B,C,d]
            expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xe)
        with record_function("moe/experts"):
            hidden = (F.silu(torch.einsum("egcd,edf->egcf", expert_in, w_gate))
                      * torch.einsum("egcd,edf->egcf", expert_in, w_up))
            expert_out = torch.einsum("egcf,efd->egcd", hidden, w_down)
        with record_function("moe/combine"):
            # combine carries the gate weights; dropped tokens get exact zeros
            out = torch.einsum("gsec,egcd->gsd", combine.to(self.dtype), expert_out)
            return out if group is None else reduce_from_experts(out, group)


def mlp_from_config(config: Any, d_model: int, d_ff: int, dtype: torch.dtype,
                    shards: ExpertShards | None = None) -> MoEMLP:
    """The routed MLP of a transformer config's MoE fields."""
    return MoEMLP(d_model, d_ff, dtype, num_experts=config.moe_experts,
                  top_k=config.moe_top_k, capacity_factor=config.moe_capacity_factor,
                  routing=config.moe_routing, shards=shards)
