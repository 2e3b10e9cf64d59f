"""Static collective-byte accounting: bytes a step from shapes alone.

Port of the reference's ``telemetry/comms.py``, its formulas exactly. Each
collective has a closed-form per-device byte cost on a ring (the standard
algorithmic-bandwidth accounting of the NCCL literature):

- all-reduce:      2·(n−1)/n · B   (reduce-scatter + all-gather halves)
- reduce-scatter:    (n−1)/n · B
- all-gather:        (n−1)/n · B
- all-to-all:        (n−1)/n · B   (each device keeps 1/n locally)
- ppermute:                    B   (every element moves one hop)

``B`` is the device-local buffer in bytes; the numbers are per device.
Static accounting costs nothing a step, and a disagreement between it and
a measured profile is itself a finding.

The per-model helpers follow where the collectives are:
``dp_grad_allreduce_bytes`` (every model, backward), and the LM's
Ulysses all-to-alls, ring K/V rotations, pipeline activation shifts and
MoE dispatch / combine, the backward costed as a mirror of the forward.
"""

from __future__ import annotations

from typing import Any

import torch


def _nbytes(shape: tuple[int, ...], dtype: torch.dtype = torch.float32) -> float:
    size = 1
    for s in shape:
        size *= s
    return float(size * dtype.itemsize)


def allreduce_bytes(buffer_bytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * buffer_bytes


def reduce_scatter_bytes(buffer_bytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * buffer_bytes


def all_gather_bytes(buffer_bytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * buffer_bytes


def all_to_all_bytes(buffer_bytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * buffer_bytes


def ppermute_bytes(buffer_bytes: float, n: int) -> float:
    return buffer_bytes if n > 1 else 0.0


def param_count(params: Any) -> int:
    """Parameters of the WHOLE model. ``params``: a module, counted over
    the reference's whole leaves (``parallel.leaves.leaf_views``: a tp,
    pp or ep rank holds shards of them, and a pipe rank a replica of the
    embedding), or a dict / list of tensors, counted as given."""
    if isinstance(params, torch.nn.Module):
        from deeplearning_mpi_tpu_torch.parallel.leaves import leaf_views

        whole = {v.key: v.size for v in leaf_views(params).values()}
        return int(sum(whole.values()))
    leaves = params.values() if isinstance(params, dict) else params
    return int(sum(t.numel() for t in leaves))


def dp_grad_allreduce_bytes(
    n_params: int, dp: int, *, dtype: torch.dtype = torch.float32, zero: bool = False
) -> float:
    """Per-device gradient-sync bytes a step over the data group. ZeRO-1
    swaps the all-reduce for a reduce-scatter of the gradients and an
    all-gather of the updated parameters: the same leading term."""
    buf = n_params * float(dtype.itemsize)
    if zero:
        return reduce_scatter_bytes(buf, dp) + all_gather_bytes(buf, dp)
    return allreduce_bytes(buf, dp)


def ulysses_attention_bytes(
    batch_local: int,
    seq_local: int,
    heads: int,
    head_dim: int,
    seq_axis: int,
    *,
    kv_heads: int | None = None,
    num_layers: int = 1,
    dtype: torch.dtype = torch.bfloat16,
    training: bool = True,
) -> float:
    """Per-device bytes of the Ulysses schedule: 4 all-to-alls a layer
    forward (q, k, v in, at the grouped head count for k / v; the context
    out), mirrored in the backward when training."""
    if seq_axis <= 1:
        return 0.0
    kv = kv_heads or heads
    q_buf = _nbytes((batch_local, seq_local, heads, head_dim), dtype)
    kv_buf = _nbytes((batch_local, seq_local, kv, head_dim), dtype)
    fwd = (
        all_to_all_bytes(q_buf, seq_axis) * 2      # q in, context out
        + all_to_all_bytes(kv_buf, seq_axis) * 2   # k, v in
    )
    return num_layers * fwd * (2.0 if training else 1.0)


def ring_attention_bytes(
    batch_local: int,
    seq_local: int,
    heads: int,
    head_dim: int,
    seq_axis: int,
    *,
    kv_heads: int | None = None,
    rotations: int | None = None,
    num_layers: int = 1,
    dtype: torch.dtype = torch.bfloat16,
    training: bool = True,
) -> float:
    """Per-device bytes of ring attention: (rotations − 1) K/V shift pairs
    a layer (the last rotation sends nothing), grouped K/V, mirrored in the
    backward."""
    if seq_axis <= 1:
        return 0.0
    kv = kv_heads or heads
    n_rot = (rotations if rotations is not None else seq_axis) - 1
    if n_rot <= 0:
        return 0.0
    kv_buf = _nbytes((batch_local, seq_local, kv, head_dim), dtype)
    fwd = num_layers * n_rot * 2 * ppermute_bytes(kv_buf, seq_axis)
    return fwd * (2.0 if training else 1.0)


def pipeline_bytes(
    microbatch_shape: tuple[int, ...],
    num_microbatches: int,
    pipe_axis: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    training: bool = True,
) -> float:
    """Per-device bytes of the GPipe schedule: one activation shift a tick,
    ``M + S − 1`` ticks, mirrored in the backward."""
    if pipe_axis <= 1:
        return 0.0
    buf = _nbytes(microbatch_shape, dtype)
    steps = num_microbatches + pipe_axis - 1
    fwd = steps * ppermute_bytes(buf, pipe_axis)
    return fwd * (2.0 if training else 1.0)


def moe_dispatch_bytes(
    tokens_local: int,
    d_model: int,
    expert_axis: int,
    *,
    top_k: int = 1,
    capacity_factor: float = 1.0,
    num_layers: int = 1,
    dtype: torch.dtype = torch.bfloat16,
    training: bool = True,
) -> float:
    """Per-device bytes of expert-parallel MoE: dispatch and combine are
    each an all-to-all of the routed activations (``top_k ·
    capacity_factor`` slots a token, an upper bound), a MoE layer,
    mirrored in the backward."""
    if expert_axis <= 1:
        return 0.0
    buf = _nbytes((tokens_local, d_model), dtype) * top_k * capacity_factor
    fwd = num_layers * 2 * all_to_all_bytes(buf, expert_axis)
    return fwd * (2.0 if training else 1.0)
