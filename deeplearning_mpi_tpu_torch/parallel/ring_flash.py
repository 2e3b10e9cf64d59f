"""Ring attention with the kernel inner: K1 forward, K2/K3 backward a rotation.

Port of ``deeplearning_mpi_tpu/parallel/ring_flash.py`` (``_merge``,
``_block_fwd``, ``_ring_fwd_pass``, the custom VJP ``_ring_flash`` and
``ring_flash_attention``). Each rotation runs K1
(``ops.kernels.flash_attention``) on the resident Q shard against the
visiting K/V block, with the lse and a float32 output, and the partials
merge by logsumexp in float32::

    lse_new = logaddexp(lse, lse_b)
    o_new   = o * exp(lse - lse_new) + o_b * exp(lse_b - lse_new)

A visiting block is the diagonal (K1 causal: both shards share one global
offset), entirely in the past (K1 with ``causal=False``) or entirely in the
future (skipped: no kernel, but the rank still sends and receives at every
rotation, so the ranks never take different branches round a transfer).
Under a window the schedule is trimmed to ``windowed_rotations`` and the
past blocks run K1 causal with the window and a static ``shift`` of the
rotation distance times the shard length. The output is cast to q's dtype
once, after the last merge.

The backward (:class:`RingFlashFn`) is a second ring: K2/K3
(``flash_attention_bwd``, float32 gradients) take the forward's GLOBAL lse
and output, so each block's ``p = exp(s - lse)`` is already globally
normalised; dq accumulates on its rank; float32 dK/dV accumulators travel
with their block, the full circle home, or under a window ``n_upd - 1``
hops and one hop back. Grouped (GQA) K/V rotate and are repeated before
each kernel; the kernels' dK/dV are group-summed back to the grouped shape
before they join the travelling accumulators.

The reference falls back to its XLA ring when the local sequence does not
tile; the port's kernels mask ragged edges themselves, so there is no
fallback. Ring size 1 is one flash call on repeated K/V. The schedule runs
in either form of ``parallel.seq_common`` (a process group, or the
one-process lockstep form over global tensors). :data:`PLAIN` swaps K1-K3
for their plain versions, to hold the kernels against them in the same
schedule.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from deeplearning_mpi_tpu_torch.ops.attention import NEG_INF, repeat_kv
from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
from deeplearning_mpi_tpu_torch.parallel.ring_attention import windowed_rotations


class Kernels(NamedTuple):
    """The forward (K1) and backward (K2/K3) entries a rotation calls."""

    fwd: Callable
    bwd: Callable


#: K1-K3: the CUDA kernels on CUDA tensors, their plain versions on the CPU.
KERNELS = Kernels(fa.flash_attention, fa.flash_attention_bwd)
#: The plain versions on any device (the check of the kernels).
PLAIN = Kernels(fa.flash_attention_reference, fa.flash_attention_bwd_reference)


def _merge(o, lse, o_b, lse_b):
    """Logsumexp-weighted recombination of normalised partials: ``o`` f32
    ``[B, S, H, D]``, ``lse`` f32 ``[B, S, H]``. ``NEG_INF`` is finite, so a
    row no block has reached stays zero through ``logaddexp``."""
    lse_new = torch.logaddexp(lse, lse_b)
    w = torch.exp(lse - lse_new)[..., None]
    w_b = torch.exp(lse_b - lse_new)[..., None]
    return o * w + o_b.float() * w_b, lse_new


def _fwd_pass(ring, kern: Kernels, qs, ks, vs, causal: bool, window: int | None):
    """Every contributing rotation, each rank's partials merged; returns
    the lists ``(o f32 [B, S_l, H, D], lse f32 [B, S_l, H])``."""
    n, s_local = ring.n, qs[0].shape[1]
    rep = qs[0].shape[2] // ks[0].shape[2]
    os = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lses = [torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device) for q in qs]

    def block(i, k_blk, v_blk, **kw):
        o_b, lse_b = kern.fwd(qs[i], repeat_kv(k_blk, rep), repeat_kv(v_blk, rep),
                              return_lse=True, out_dtype=torch.float32, **kw)
        os[i], lses[i] = _merge(os[i], lses[i], o_b, lse_b.transpose(1, 2))

    n_upd = windowed_rotations(window, s_local, n)
    k_blk, v_blk = ks, vs
    for t in range(n_upd):
        if t < n_upd - 1:  # the next transfer before this rotation's kernels
            k_nxt, v_nxt = ring.shift(k_blk), ring.shift(v_blk)
        for i, idx in enumerate(ring.ranks):
            if window is not None:
                if t == 0:  # the diagonal: local causal + window
                    block(i, k_blk[i], v_blk[i], causal=True,
                          window=window if window < s_local else None)
                elif idx >= t:  # wrapped deliveries are in the future
                    block(i, k_blk[i], v_blk[i], causal=True, window=window, shift=t * s_local)
                continue
            src = (idx - t) % n
            if not causal or src < idx:
                block(i, k_blk[i], v_blk[i], causal=False)
            elif src == idx:
                block(i, k_blk[i], v_blk[i], causal=True)
        if t < n_upd - 1:
            k_blk, v_blk = k_nxt, v_nxt
    return os, lses


class RingFlashFn(torch.autograd.Function):
    """The reference's ``_ring_flash`` custom VJP over ``ring``'s form: the
    forward saves q, k, v, the output (q's dtype) and the global lse; the
    backward is the second ring of K2/K3 (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, kern: Kernels, causal: bool, window: int | None):
        os, lses = _fwd_pass(ring, kern, ring.split(q), ring.split(k), ring.split(v),
                             causal, window)
        o = ring.join(os).to(q.dtype)
        ctx.save_for_backward(q, k, v, o, ring.join(lses))
        ctx.args = ring, kern, causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring, kern, causal, window = ctx.args
        qs, ks, vs, os, dos = (ring.split(t) for t in (q, k, v, o, do.to(o.dtype)))
        # The kernels read the lse as contiguous [B, H, S].
        lses = [x.transpose(1, 2).contiguous() for x in ring.split(lse)]
        n, s_local = ring.n, qs[0].shape[1]
        rep = q.shape[2] // k.shape[2]
        zeros = lambda ts: [torch.zeros(t.shape, dtype=torch.float32, device=t.device)  # noqa: E731
                            for t in ts]
        dq, dk, dv = zeros(qs), zeros(ks), zeros(vs)

        def accumulate(i, k_blk, v_blk, **kw):
            dq_b, dk_b, dv_b = kern.bwd(qs[i], repeat_kv(k_blk, rep), repeat_kv(v_blk, rep),
                                        os[i], dos[i], lses[i], grad_dtype=torch.float32, **kw)
            if rep > 1:  # repeat_kv's adjacency: full head h_kv * rep + r
                b, s, h, d = dk_b.shape
                dk_b = dk_b.reshape(b, s, h // rep, rep, d).sum(3)
                dv_b = dv_b.reshape(b, s, h // rep, rep, d).sum(3)
            dq[i], dk[i], dv[i] = dq[i] + dq_b, dk[i] + dk_b, dv[i] + dv_b

        n_upd = windowed_rotations(window, s_local, n)
        k_blk, v_blk = ks, vs
        for t in range(n_upd):
            if t < n_upd - 1:
                k_nxt, v_nxt = ring.shift(k_blk), ring.shift(v_blk)
            for i, idx in enumerate(ring.ranks):
                if window is not None:
                    if t == 0 or idx >= t:
                        accumulate(i, k_blk[i], v_blk[i], causal=True,
                                   window=window if (t or window < s_local) else None,
                                   shift=t * s_local)
                    continue
                src = (idx - t) % n
                if not causal or src < idx:
                    accumulate(i, k_blk[i], v_blk[i], causal=False)
                elif src == idx:
                    accumulate(i, k_blk[i], v_blk[i], causal=True)
            if window is None or t < n_upd - 1:
                # dK/dV travel with their block (the last hop completes the circle).
                dk, dv = ring.shift(dk), ring.shift(dv)
            if t < n_upd - 1:
                k_blk, v_blk = k_nxt, v_nxt
        if window is not None and n_upd > 1:
            # One hop home instead of the rest of the circle.
            dk, dv = ring.shift(dk, -(n_upd - 1)), ring.shift(dv, -(n_upd - 1))
        return (ring.join(dq).to(q.dtype), ring.join(dk).to(k.dtype), ring.join(dv).to(v.dtype),
                None, None, None, None)


def ring_flash_attention(q, k, v, *, ring: Any, causal: bool = True, window: int | None = None,
                         kernels: Kernels | None = None) -> torch.Tensor:
    """Ring attention with the kernel inner: ``q`` ``[B, S, H, D]``, grouped
    or full K/V, as ``ring`` holds them (``parallel.seq_common``); ``window``
    trims the rotations. Returns the output in q's dtype."""
    if window is not None and not causal:
        raise ValueError("window attention is causal by definition")
    kern = kernels or KERNELS
    if ring.n == 1 and kern is KERNELS:
        rep = q.shape[2] // k.shape[2]
        return fa.flash_attention(q, repeat_kv(k, rep), repeat_kv(v, rep), causal=causal,
                                  window=window)
    return RingFlashFn.apply(q, k, v, ring, kern, causal, window)
