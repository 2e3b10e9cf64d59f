"""Expert parallelism: the MoE expert stacks sharded over the mesh's expert axis.

Port of ``deeplearning_mpi_tpu/parallel/expert_parallel.py``. There a
stacked expert weight ``[E, in, out]`` (a leaf whose path holds
``experts``) shards its leading dim over the ``expert`` mesh axis, tokens
are sharded over ``data`` only and REPLICATED over ``expert``
(``runtime/mesh.py``), and GSPMD inserts the collectives. Here each process
of an expert group holds its ``E / ep`` experts (:class:`ExpertShards`),
and two autograd functions give the reference's semantics:

- every rank of the group computes the router and the dispatch for all of
  its data shard, runs its own experts, and the combine's output is summed
  over the group: :func:`reduce_from_experts` (all-reduce-sum forward,
  identity backward);
- where the replicated activations enter the rank's own experts (the
  dispatch's tokens and the router probabilities the combine weights are
  built from), :func:`copy_to_experts` (identity forward, all-reduce-sum
  backward) adds the other ranks' experts' gradients, so ``x`` and the
  router get the full gradient once on every rank. The load-balance loss
  reads the probabilities outside it: its gradient is every rank's own and
  is not summed (summing it too would give ``ep`` times the reference).

The optimizer moments mirror the parameters (the same names and shapes),
so they shard alike; :meth:`ExpertShards.global_norm` is the global norm
over the whole model, the other ranks' experts included.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from deeplearning_mpi_tpu_torch.runtime import collectives

#: Param-name substring marking stacked per-expert weights ``[E, ...]``.
EXPERT_MARKER = "experts"


def is_expert_leaf(name: str, leaf: torch.Tensor) -> bool:
    """Whether ``name`` / ``leaf`` is a stacked expert weight (or its
    optimizer moment): ``experts`` in the name and at least 3 dims."""
    return EXPERT_MARKER in name and leaf.dim() >= 3


def copy_to_experts(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the expert
    group (each rank's gradient covers only its own experts)."""
    return collectives.copy_to_group(x, group)


def reduce_from_experts(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the expert group (each rank's partial combine); identity
    backward (every rank reads the same sum)."""
    return collectives.reduce_from_group(x, group)


@dataclasses.dataclass(frozen=True)
class ExpertShards:
    """This process's share of the experts: rank ``rank`` of an expert group
    of ``size`` holds experts ``[rank * E/size, (rank + 1) * E/size)``."""

    group: Any
    size: int
    rank: int

    def local_count(self, num_experts: int) -> int:
        if num_experts % self.size:
            raise ValueError(f"{num_experts} experts do not split over an expert group of "
                             f"{self.size}")
        return num_experts // self.size

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full ``[E, ...]`` stack."""
        n = self.local_count(full.shape[0])
        return full[self.rank * n:(self.rank + 1) * n]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full ``[E, ...]`` stack from every rank's slice (a collective
        over the expert group)."""
        return collectives.all_gather(local, self.group, axis=0)

    @staticmethod
    def is_split(name: str, leaf: torch.Tensor) -> bool:
        return is_expert_leaf(name, leaf)

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the expert group (no gradient)."""
        return collectives.all_reduce_sum(x, self.group)

    def global_norm(self, tensors: dict[str, torch.Tensor]) -> torch.Tensor:
        """``optax.global_norm`` of the whole model
        (``runtime.collectives.sharded_norm`` over the expert axis)."""
        return collectives.sharded_norm(tensors, [(self.is_split, self.sum_over)])


def map_expert_leaves(fn, tree: Any, name: str = "") -> Any:
    """``fn`` over every expert leaf of a tree of dicts (a param tree, or
    an optimizer state whose slots are param trees); other leaves as is."""
    if isinstance(tree, dict):
        return {k: map_expert_leaves(fn, v, k) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) and is_expert_leaf(name, tree) else tree


def shard_state_dict(sd: dict[str, torch.Tensor], shards: ExpertShards | None) -> dict:
    """A full state dict (``models.convert.lm_params_from_jax``) cut to this
    rank's experts, for ``load_state_dict`` of an expert-sharded model."""
    if shards is None:
        return sd
    return {n: shards.local(t) if is_expert_leaf(n, t) else t for n, t in sd.items()}
