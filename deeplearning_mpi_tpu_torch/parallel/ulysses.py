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


def ulysses_attention(q, k, v, *, ring: Any, causal: bool = True, window: int | None = None,
                      inner: InnerAttentionFn = default_inner) -> torch.Tensor:
    """All-to-all attention: ``q`` ``[B, S, H, D]`` with ``H % n == 0``,
    grouped or full K/V, as ``ring`` holds them; the output as ``q``."""
    n = ring.n
    heads = q.shape[2]
    if heads % k.shape[2]:
        raise ValueError(f"GQA K/V heads ({k.shape[2]}) must divide q heads ({heads})")
    rep = heads // k.shape[2]
    if heads % n:
        raise ValueError(f"ulysses attention needs heads ({heads}) divisible by the 'seq' axis "
                         f"size ({n})")
    kw = {"window": window} if window is not None else {}
    if n == 1:
        return inner(q, repeat_kv(k, rep), repeat_kv(v, rep), causal=causal, **kw)
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
                              inner: InnerAttentionFn = default_inner) -> Any:
    """An attention fn for ``TransformerLM(attention_fn=...)``, marked
    ``gqa_native``: with ``mesh`` the process-group form over its seq group
    (q, k, v this process's shards), with ``sp=n`` the one-process form over
    global tensors (batch 1 takes the whole-sequence ``inner``; a sequence
    ``n`` does not divide raises)."""
    if (mesh is None) == (sp is None):
        raise ValueError("pass a mesh (process-group form) or sp (one-process form)")
    if mesh is not None:
        from deeplearning_mpi_tpu_torch.runtime.mesh import seq_group

        ring = GroupRing(seq_group(mesh))
    else:
        ring = LockstepRing(sp)

    def _sharded(causal: bool, window: int | None = None):
        return functools.partial(ulysses_attention, ring=ring, causal=causal, window=window,
                                 inner=inner)

    if mesh is not None:
        def fn(q, k, v, *, causal: bool = True, window: int | None = None):
            return _sharded(causal, window)(q, k, v)
    else:
        fn = with_divisibility_fallback(sp, _sharded, repeat_grouped(inner))
    fn.gqa_native = True
    return fn
