"""Ulysses all-to-all sequence parallelism over the seq axis.

Port of ``deeplearning_mpi_tpu/parallel/ulysses.py`` (``ulysses_attention``,
``make_ulysses_attention_fn``). Two tiled all-to-alls trade the sequence
sharding for a head sharding round a whole-sequence attention core::

    [B, S/n, H, D] --all_to_all--> [B, S, H/n, D]   (1/n of the heads)
    ... the inner core on whole sequences ...
    [B, S, H/n, D] --all_to_all--> [B, S/n, H, D]

so any single-device core runs unchanged, the window passed through. The
inner is ``flash_attention`` on CUDA tensors (K1, with K2/K3 under
``FlashAttentionFn``), as the reference's on the TPU, and the plain
``dense_attention`` on the CPU. Grouped K/V ride the all-to-alls when
``Hkv % n == 0`` (q chunk ``i``'s kv heads are then exactly kv chunk
``i``) and are repeated after; otherwise they are repeated first. Heads
that ``n`` does not divide raise. The gradient runs through autograd and
the all-to-alls' inverse (``runtime.collectives.all_to_all_autograd``).

Beside tensor parallelism each model rank calls the fn at its local heads
``H / tp`` (``head_groups = tp``). The reference's Ulysses sees the whole
model's ``H`` heads (its ``shard_map`` leaves the head dim whole), so the
divisibility it raises on is ``H % n``, and the port raises the same error
on the same count. Where ``n`` divides ``H`` but not the local ``H / tp``,
the all-to-alls trade the sequence sharding for one over the local
(batch, head) pairs instead, K/V repeated first: the same attention, each
rank's kernel on whole sequences of ``B * H / (tp * n)`` single-head rows.
Either form of ``parallel.seq_common``: a mesh's seq group, or ``sp=n``
over global tensors on one device.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from deeplearning_mpi_tpu_torch.ops.attention import dense_attention, repeat_kv
from deeplearning_mpi_tpu_torch.parallel.seq_common import (
    GroupRing,
    LockstepRing,
    repeat_grouped,
    with_divisibility_fallback,
)

#: (q, k, v [B, S, H, D], causal=..., [window=...]) -> [B, S, H, D] on whole sequences.
InnerAttentionFn = Callable[..., torch.Tensor]


def default_inner(q, k, v, **kw) -> torch.Tensor:
    """K1 (``flash_attention``) on CUDA tensors, ``dense_attention`` on the CPU."""
    if q.is_cuda:
        from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, **kw)
    return dense_attention(q, k, v, **kw)


def _pairs_attention(q, k, v, ring: Any, inner: InnerAttentionFn, **kw) -> torch.Tensor:
    """Ulysses over the (batch, head) pairs: ``[B, S/n, h, D]`` as
    ``[B*h, S/n, 1, D]``, the pairs split over the ranks and the sequence
    gathered; full K/V."""
    batch, _, heads, dim = q.shape
    if (batch * heads) % ring.n:
        raise ValueError(f"ulysses attention over (batch, head) pairs needs batch x local heads "
                         f"({batch} x {heads}) divisible by the 'seq' axis size ({ring.n})")

    def to_pairs(xs):
        return [x.permute(0, 2, 1, 3).reshape(batch * heads, x.shape[1], 1, dim) for x in xs]

    def from_pairs(xs):
        return [x.reshape(batch, heads, x.shape[1], dim).permute(0, 2, 1, 3) for x in xs]

    to_seq = functools.partial(ring.all_to_all, split_axis=0, concat_axis=1)
    qh, kh, vh = (to_seq(to_pairs(ring.split(t))) for t in (q, k, v))
    ctx = [inner(a, b, c, **kw) for a, b, c in zip(qh, kh, vh)]
    return ring.join(from_pairs(ring.all_to_all(ctx, split_axis=1, concat_axis=0)))


def ulysses_attention(q, k, v, *, ring: Any, causal: bool = True, window: int | None = None,
                      inner: InnerAttentionFn = default_inner,
                      head_groups: int = 1) -> torch.Tensor:
    """All-to-all attention: ``q`` ``[B, S, H, D]``, grouped or full K/V,
    as ``ring`` holds them; the output as ``q``. ``head_groups``: the model
    ranks the whole model's heads are split over (``H`` here is one rank's
    ``H / head_groups``); ``n`` must divide the whole count (module
    docstring)."""
    n = ring.n
    heads = q.shape[2]
    if heads % k.shape[2]:
        raise ValueError(f"GQA K/V heads ({k.shape[2]}) must divide q heads ({heads})")
    rep = heads // k.shape[2]
    if (heads * head_groups) % n:
        raise ValueError(f"ulysses attention needs heads ({heads * head_groups}) divisible by the "
                         f"'seq' axis size ({n})")
    kw = {"window": window} if window is not None else {}
    if n == 1:
        return inner(q, repeat_kv(k, rep), repeat_kv(v, rep), causal=causal, **kw)
    if heads % n:
        return _pairs_attention(q, repeat_kv(k, rep), repeat_kv(v, rep), ring, inner,
                                causal=causal, **kw)
    to_heads = functools.partial(ring.all_to_all, split_axis=2, concat_axis=1)
    qh = to_heads(ring.split(q))
    if rep > 1 and k.shape[2] % n == 0:  # grouped: bytes / rep
        kh = [repeat_kv(x, rep) for x in to_heads(ring.split(k))]
        vh = [repeat_kv(x, rep) for x in to_heads(ring.split(v))]
    else:
        kh = to_heads(ring.split(repeat_kv(k, rep)))
        vh = to_heads(ring.split(repeat_kv(v, rep)))
    ctx = [inner(a, b, c, causal=causal, **kw) for a, b, c in zip(qh, kh, vh)]
    return ring.join(ring.all_to_all(ctx, split_axis=1, concat_axis=2))


def make_ulysses_attention_fn(mesh: Any = None, *, sp: int | None = None,
                              inner: InnerAttentionFn = default_inner,
                              head_groups: int = 1) -> Any:
    """An attention fn for ``TransformerLM(attention_fn=...)``, marked
    ``gqa_native``: with ``mesh`` the process-group form over its seq group
    (q, k, v this process's shards; the heads split over its model axis),
    with ``sp=n`` the one-process form over global tensors, the heads split
    into ``head_groups`` model ranks (batch 1 takes the whole-sequence
    ``inner``; a sequence ``n`` does not divide raises)."""
    if (mesh is None) == (sp is None):
        raise ValueError("pass a mesh (process-group form) or sp (one-process form)")
    if mesh is not None:
        from deeplearning_mpi_tpu_torch.runtime.mesh import model_size, seq_group

        ring = GroupRing(seq_group(mesh))
        head_groups = model_size(mesh)
    else:
        ring = LockstepRing(sp)

    def _sharded(causal: bool, window: int | None = None):
        return functools.partial(ulysses_attention, ring=ring, causal=causal, window=window,
                                 inner=inner, head_groups=head_groups)

    if mesh is not None:
        def fn(q, k, v, *, causal: bool = True, window: int | None = None):
            return _sharded(causal, window)(q, k, v)
    else:
        fn = with_divisibility_fallback(sp, _sharded, repeat_grouped(inner))
    fn.gqa_native = True
    return fn
