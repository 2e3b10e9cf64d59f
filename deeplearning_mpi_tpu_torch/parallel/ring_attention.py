"""Ring attention with the plain inner: the online-softmax ring in PyTorch.

Port of ``deeplearning_mpi_tpu/parallel/ring_attention.py`` (``_block_update``,
``windowed_rotations``, ``ring_attention``, ``make_ring_attention_fn``). Q
stays resident on its rank; the K/V shards rotate round the seq group (the
reference's ``lax.ppermute``), and a flash-style online softmax accumulates
the output in float32 over the visiting blocks: running output, denominator
and row max, the finite ``NEG_INF``, masked pairs re-zeroed so a query
with no valid key yields a zero row, and the causal / window mask in global
coordinates. GROUPED K/V (GQA) rotate and are repeated after each hop.
There are ``n_upd - 1`` rotations, the last update outside the loop (its
transfer would be thrown away). Its gradient runs through autograd, the
rotations' through ``runtime.collectives.ring_shift_autograd`` (backward:
the other way round).

This is the CPU inner, and ``flash=False``'s, as the reference's is off the
TPU (``make_ring_attention_fn`` auto-selects by device: the kernel ring of
``parallel.ring_flash`` on CUDA tensors). The factory makes either form of
``parallel.seq_common``: over a mesh's seq group (this process's shards)
or, with ``sp=n``, the one-process form over global tensors.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from deeplearning_mpi_tpu_torch.ops.attention import NEG_INF, _f32_matmul, dense_attention, repeat_kv
from deeplearning_mpi_tpu_torch.parallel.seq_common import (
    GroupRing,
    LockstepRing,
    repeat_grouped,
    with_divisibility_fallback,
)

Acc = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _block_update(q, k, v, acc: Acc, *, causal: bool, q_offset: int, kv_offset: int,
                  window: int | None = None) -> Acc:
    """One online-softmax step over a K/V block. ``acc = (o, l, m)``: the
    running un-normalised output ``[B, Sq, H, D]``, denominator and row max
    ``[B, Sq, H]``, all float32 (float64 for float64 inputs)."""
    o, l, m = acc
    q_len, kv_len = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    scores = _f32_matmul(q.transpose(1, 2), k.transpose(1, 2).transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(q_len, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(kv_len, device=q.device)[None, :]
        valid = q_pos >= k_pos
        if window is not None:
            valid &= q_pos - k_pos < window
        scores = torch.where(valid, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1).transpose(1, 2))  # [B, Sq, H]
    # Rows with nothing valid yet keep m_new == NEG_INF, where exp(0) would
    # be 1: re-zero the masked pairs.
    p = torch.exp(scores - m_new.transpose(1, 2)[..., None])
    if causal:
        p = torch.where(valid, p, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1).transpose(1, 2)
    pv = _f32_matmul(p.to(v.dtype), v.transpose(1, 2)).transpose(1, 2)  # [B, Sq, H, D]
    return o * alpha[..., None] + pv, l_new, m_new


def windowed_rotations(window: int | None, s_local: int, n: int) -> int:
    """The rotations that can reach any query's window: rotation ``t``
    brings the shard ``t`` behind, whose newest key is ``(t-1)*s_local + 1``
    positions back, so only ``t <= ceil((window-1)/s_local)`` can count."""
    if window is None:
        return n
    delta = (window - 1 + s_local - 1) // s_local
    return min(n, delta + 1)


def ring_attention(q, k, v, *, ring: Any, causal: bool = True,
                   window: int | None = None) -> torch.Tensor:
    """Blockwise ring attention: ``q`` ``[B, S, H, D]``, ``k``/``v`` with
    ``Hkv`` heads dividing ``H``, as ``ring`` holds them (its shards in the
    process-group form, the global tensors in the one-process form).
    Returns the attention output in ``q``'s dtype and layout."""
    if window is not None and not causal:
        raise ValueError("window attention is causal by definition")
    qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
    n, s_local = ring.n, qs[0].shape[1]
    n_upd = windowed_rotations(window, s_local, n)
    rep = q.shape[2] // k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    accs = [(torch.zeros(qi.shape, dtype=acc, device=q.device),
             torch.zeros(qi.shape[:3], dtype=acc, device=q.device),
             torch.full(qi.shape[:3], NEG_INF, dtype=acc, device=q.device))
            for qi in qs]

    def update(t):
        for i, idx in enumerate(ring.ranks):
            accs[i] = _block_update(
                qs[i], repeat_kv(ks[i], rep), repeat_kv(vs[i], rep), accs[i], causal=causal,
                q_offset=idx * s_local, kv_offset=((idx - t) % n) * s_local, window=window)

    # After t rotations rank idx holds the shard of rank (idx - t) mod n.
    for t in range(n_upd - 1):
        k_nxt, v_nxt = ring.shift(ks, autograd=True), ring.shift(vs, autograd=True)
        update(t)
        ks, vs = k_nxt, v_nxt
    update(n_upd - 1)
    outs = [torch.where(l[..., None] > 0, o / torch.clamp(l, min=1e-30)[..., None], 0.0)
            for o, l, _ in accs]
    return ring.join(outs).to(q.dtype)


def _auto_flash(flash: bool | None, q: torch.Tensor) -> bool:
    """``flash=None``: the kernel ring on CUDA tensors, the plain one on the CPU."""
    return q.is_cuda if flash is None else flash


def make_ring_attention_fn(mesh: Any = None, *, sp: int | None = None,
                           flash: bool | None = None, kernels: Any = None) -> Any:
    """An attention fn ``(q, k, v, causal=, window=)`` for
    ``TransformerLM(attention_fn=...)``, marked ``gqa_native`` (the model
    passes grouped K/V).

    With ``mesh``: the process-group form over its seq group; q, k, v are
    this process's sequence shards. With ``sp=n`` and no mesh: the
    one-process form over global tensors (``seq_common.LockstepRing``); a
    single sequence (batch 1) takes the whole-sequence core, and a sequence
    that ``n`` does not divide raises. ``flash`` picks the inner: True the
    kernel ring (``parallel.ring_flash``: K1 forward, K2/K3 backward),
    False this module's plain ring, None (the default) by device, the
    kernel ring on CUDA tensors. ``kernels`` (``ring_flash.PLAIN``) swaps
    the kernel ring's K1-K3 for their plain versions, for holding the
    kernels against them."""
    if (mesh is None) == (sp is None):
        raise ValueError("pass a mesh (process-group form) or sp (one-process form)")
    if kernels is not None:
        if flash is False:
            raise ValueError("kernels= picks the kernel ring's K1-K3: it needs flash")
        flash = True
    if mesh is not None:
        from deeplearning_mpi_tpu_torch.runtime.mesh import seq_group

        ring = GroupRing(seq_group(mesh))
    else:
        ring = LockstepRing(sp)

    @functools.lru_cache(maxsize=8)
    def _sharded(causal: bool, window: int | None = None):
        def fn(q, k, v):
            # Windows reaching the global sequence are plain causal.
            w = window
            if w is not None and w >= q.shape[1] * (ring.n if mesh is not None else 1):
                w = None
            if _auto_flash(flash, q):
                from deeplearning_mpi_tpu_torch.parallel.ring_flash import ring_flash_attention

                return ring_flash_attention(q, k, v, ring=ring, causal=causal, window=w,
                                            kernels=kernels)
            return ring_attention(q, k, v, ring=ring, causal=causal, window=w)

        return fn

    if mesh is not None:
        def fn(q, k, v, *, causal: bool = True, window: int | None = None):
            return _sharded(causal, window)(q, k, v)
    else:
        def whole(q, k, v, *, causal=True, **kw):
            from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention

            core = flash_attention if _auto_flash(flash, q) and q.is_cuda else dense_attention
            return core(q, k, v, causal=causal, **kw)

        fn = with_divisibility_fallback(sp, _sharded, repeat_grouped(whole))
    fn.gqa_native = True
    return fn
