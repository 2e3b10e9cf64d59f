"""Scaled dot-product attention: dense, KV-cached decode, batched decode.

Port of ``deeplearning_mpi_tpu/ops/attention.py``. Same conventions: inputs
``[batch, seq, heads, head_dim]`` ("BSHD"), scores and softmax in float32
whatever the input dtype, output in the input dtype, and the finite
``NEG_INF`` mask — a query row with no valid key outputs zeros (stock
``scaled_dot_product_attention`` would give NaN there, so it is not the
oracle and the port never calls it).

The masked-matmul schedules here are XLA code in the reference, so they are
plain ``torch.matmul``/``einsum``. The hand-written kernel sits behind
``use_kernel``: ``ops.kernels.flash_decode`` (K4) carries every decode step
on CUDA, offline and in the serving engine alike.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative mask value; -inf breaks softmax when a row is fully masked

#: Without the kernel, buffers at or below this length take the one-shot
#: masked path and longer ones the blockwise walk. The value is the
#: reference's (measured on a TPU). On the H100 K4 beat the masked path at
#: every length measured (L 1024-8192, B1/B8, f32/bf16: PERF.md), so CUDA
#: tensors take K4 at every length.
DECODE_DENSE_MAX = 4096


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Repeat each KV head ``n_rep`` times along the head axis of
    ``[B, S, Hkv, D]`` (GQA → MHA)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with float32 accumulation and result (the reference's
    ``preferred_element_type=float32``): bf16 products are exact in f32.
    Float64 operands stay float64."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return torch.matmul(a.to(acc), b.to(acc))


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Full-materialization attention over ``[B, S, H, D]`` inputs.

    ``q_offset``/``kv_offset`` are the absolute positions of the first query
    / key row (causal masking in global coordinates). ``window``: each query
    attends only its last ``window`` keys (self included); requires
    ``causal``."""
    if window is not None and not causal:
        raise ValueError("window attention is causal by definition; pass causal=True")
    q_len, head_dim = q.shape[-3], q.shape[-1]
    kv_len = k.shape[-3]
    scale = head_dim**-0.5
    # [B, H, Sq, Skv] scores in f32.
    scores = _f32_matmul(q.transpose(-3, -2), k.transpose(-3, -2).transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(q_len, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(kv_len, device=q.device)[None, :]
        valid = q_pos >= k_pos
        if window is not None:
            valid &= q_pos - k_pos < window
        scores = torch.where(valid, scores, NEG_INF)
        # A query row with NO valid key contributes zero, not a uniform
        # average of V.
        weights = torch.where(
            valid.any(dim=-1)[:, None], torch.softmax(scores, dim=-1), 0.0
        )
    else:
        weights = torch.softmax(scores, dim=-1)
    out = _f32_matmul(weights.to(v.dtype), v.transpose(-3, -2))  # [B, H, Sq, D]
    return out.transpose(-3, -2).to(q.dtype)


def _grouped_dense_decode(
    q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
    valid: torch.Tensor, *, zero_empty_rows: bool,
) -> torch.Tensor:
    """One masked grouped matmul over the whole buffer: ``q`` ``[B, 1, H,
    D]``, buffers ``[B, L, Hkv, D]`` read as-is (never repeated), ``valid``
    ``[B or 1, L]``."""
    batch, _, heads, head_dim = q.shape
    kv_heads = k_buf.shape[2]
    group = heads // kv_heads
    qg = q[:, 0].reshape(batch, kv_heads, group, head_dim)
    # [B, Hkv, G, D] x [B, Hkv, D, L] -> [B, Hkv, G, L]
    s = _f32_matmul(qg, k_buf.permute(0, 2, 3, 1)) * head_dim**-0.5
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if zero_empty_rows:
        w = torch.where(valid.any(dim=-1)[:, None, None, None], w, 0.0)
    out = _f32_matmul(w.to(v_buf.dtype), v_buf.permute(0, 2, 1, 3))  # [B, Hkv, G, D]
    return out.reshape(batch, heads, head_dim)[:, None].to(q.dtype)


def _check_decode_shapes(q: torch.Tensor, k_buf: torch.Tensor, name: str) -> None:
    if q.shape[1] != 1:
        raise ValueError(f"{name} takes one query token, got {q.shape[1]}")
    heads, kv_heads = q.shape[2], k_buf.shape[2]
    if heads % kv_heads:
        raise ValueError(
            f"query heads ({heads}) must be a multiple of KV heads ({kv_heads})"
        )


def decode_attention(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    index: int,
    *,
    block: int = 2048,
    dense_max: int = DECODE_DENSE_MAX,
    window: int | None = None,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """One KV-cached decode step over the filled prefix ``0..index``.

    ``q`` ``[B, 1, H, D]`` (RoPE applied), buffers ``[B, max_len, Hkv, D]``
    with ``Hkv`` dividing ``H`` (grouped heads read natively).
    ``use_kernel`` (default: on CUDA tensors) runs K4, O(index) reads.
    Otherwise two schedules, on the static buffer length: ``max_len <=
    dense_max`` is one masked grouped matmul over the whole buffer; longer
    buffers take the flash-decoding walk (``block``-row chunks, online
    softmax, starting at the window's first block under ``window``).
    """
    _check_decode_shapes(q, k_buf, "decode_attention")
    length = k_buf.shape[1]
    index = int(index)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel and length <= dense_max:
        pos = torch.arange(length, device=q.device)
        valid = pos <= index
        if window is not None:
            valid &= pos > index - window
        return _grouped_dense_decode(
            q, k_buf, v_buf, valid[None], zero_empty_rows=False
        )
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_decode import (
        flash_decode,
        flash_decode_reference,
    )

    rows = torch.full((q.shape[0],), index, dtype=torch.int32, device=q.device)
    if use_kernel:
        return flash_decode(q, k_buf, v_buf, rows, window=window)
    return flash_decode_reference(q, k_buf, v_buf, rows, window=window, block=block)


def batched_decode_attention(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    index: torch.Tensor,
    *,
    window: int | None = None,
    use_kernel: bool | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One decode step where every row sits at its OWN fill level.

    ``index`` is ``[B]`` int: row ``b`` attends cache positions
    ``0..index[b]``; negative marks an inactive row, whose output is zero.
    Default schedule: one masked grouped matmul over the whole buffer with a
    per-row prefix mask. ``use_kernel=True``: K4
    (:func:`~deeplearning_mpi_tpu_torch.ops.kernels.flash_decode.flash_decode`),
    which takes the per-row index natively and reads O(own index) rows.
    ``use_kernel=None``: K4 on CUDA, the matmul schedule on the CPU. int8
    buffers with their ``[B, L, Hkv]`` float32 scales go to K4 only (the
    matmul schedule takes pages dequantized by the caller).
    """
    _check_decode_shapes(q, k_buf, "batched_decode_attention")
    batch = q.shape[0]
    index = torch.as_tensor(index, device=q.device)
    if tuple(index.shape) != (batch,):
        raise ValueError(
            f"index must be [{batch}] (one fill level per row), got {tuple(index.shape)}"
        )
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        from deeplearning_mpi_tpu_torch.ops.kernels.flash_decode import flash_decode

        return flash_decode(q, k_buf, v_buf, index, window=window, k_scale=k_scale,
                            v_scale=v_scale)
    if k_scale is not None or v_scale is not None:
        raise ValueError("int8 K/V with scales take K4 (use_kernel); dequantize them first")
    pos = torch.arange(k_buf.shape[1], device=q.device)
    valid = pos[None, :] <= index[:, None]
    if window is not None:
        valid &= pos[None, :] > index[:, None] - window
    return _grouped_dense_decode(q, k_buf, v_buf, valid, zero_empty_rows=True)
