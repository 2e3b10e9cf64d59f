"""K4: flash-decode — CUDA kernel and its plain PyTorch version (the walk).

Port of ``deeplearning_mpi_tpu/ops/pallas/flash_decode.py``. One query
token per row over a grouped ``[B, L, Hkv, D]`` cache, with a per-row fill
level ``index`` (``[B]``; a scalar broadcasts): row ``b`` attends
positions ``0..index[b]`` (the last ``window`` of them under ``window``),
and reads nothing past ``index[b]``. ``index < 0`` marks an inactive row:
its output is zero (the reference zeroes such rows outside its kernel, in
``batched_decode_attention``). Buffers are bfloat16, float32, or int8 with
per-(token, head) float32 scales from :func:`quantize_kv`.

On CUDA tensors K4 splits each row's walk over blocks of ``SPLIT_ROWS``
cache rows and merges the splits' partials in the same launch
(``csrc/flash_decode.cu``); on CPU tensors the plain walk runs.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning_mpi_tpu_torch.ops.attention import NEG_INF
from deeplearning_mpi_tpu_torch.ops.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: Chunk of cache rows per step of the plain walk.
DEFAULT_DECODE_BLOCK = 1024

#: K4's blocking (``csrc/flash_decode.cu``): a block of ``WARPS`` warps takes
#: one ``SPLIT_ROWS``-row split of a row's cache, each warp one
#: ``CHUNK_ROWS``-row chunk of it.
WARPS, CHUNK_ROWS = 4, 32
SPLIT_ROWS = WARPS * CHUNK_ROWS


class DecodeParams(ctypes.Structure):
    """Mirrors ``struct DecodeParams`` in ``csrc/flash_decode.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "k_scale", "v_scale", "index", "o", "part_acc", "part_ml",
            "counters",
        )]
        + [(n, ctypes.c_int32) for n in (
            "B", "L", "H", "Hkv", "D", "window", "q_dtype", "kv_dtype", "n_split",
        )]
        + [("scale", ctypes.c_float)]
    )


#: Per (device, stream): K4's arrival counters, one per (row, kv head);
#: every launch leaves them at zero.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < n:
        counters = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return counters


def quantize_kv(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row-per-head int8 for KV buffers: ``[B, L, Hkv, D]``
    float -> ``(int8 [B, L, Hkv, D], float32 scales [B, L, Hkv])``.

    This is the kernel-side scheme of the reference's
    ``ops/pallas/flash_decode.py`` (a 1e-8 floor on amax, no clip) — not
    the engine's ``ops/quant.py`` one, which floors the scale and clips."""
    x = buf.float()
    amax = x.abs().amax(dim=-1)
    scales = torch.clamp(amax, min=1e-8) / 127.0
    return torch.round(x / scales[..., None]).to(torch.int8), scales


def _rows(index, batch: int, device) -> torch.Tensor:
    index = torch.as_tensor(index, dtype=torch.int32, device=device)
    if index.ndim == 0:
        return index.expand(batch).contiguous()
    if tuple(index.shape) != (batch,):
        raise ValueError(
            f"index must be a scalar or [{batch}] (one fill level per row), "
            f"got shape {tuple(index.shape)}"
        )
    return index.contiguous()


def _validate(q, k_buf, v_buf, k_scale, v_scale) -> None:
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be given together")
    if quantized and (k_buf.dtype != torch.int8 or v_buf.dtype != torch.int8):
        raise ValueError(
            f"scales given but buffers are not int8 (k={k_buf.dtype}, "
            f"v={v_buf.dtype}) — quantize BOTH with quantize_kv first"
        )
    if not quantized and k_buf.dtype == torch.int8:
        raise ValueError("int8 buffers need k_scale and v_scale")
    if q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query token, got {q.shape[1]}")
    if q.shape[2] % k_buf.shape[2]:
        raise ValueError(
            f"query heads ({q.shape[2]}) must be a multiple of KV heads ({k_buf.shape[2]})"
        )


def flash_decode_reference(
    q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
    index: torch.Tensor, *, window: int | None = None,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    block: int = DEFAULT_DECODE_BLOCK,
) -> torch.Tensor:
    """The plain PyTorch version of K4: the flash-decoding walk over
    ``block``-row chunks with an online softmax, per-row masks, and the
    reference kernel's roundings (K/V cast to q's dtype, probabilities to
    V's compute dtype before the V product)."""
    _validate(q, k_buf, v_buf, k_scale, v_scale)
    batch, _, heads, head_dim = q.shape
    length, kv_heads = k_buf.shape[1], k_buf.shape[2]
    group = heads // kv_heads
    index = _rows(index, batch, q.device).long()
    qg = q[:, 0].reshape(batch, kv_heads, group, head_dim).float()
    acc = torch.zeros(batch, kv_heads, group, head_dim, device=q.device)
    m = torch.full((batch, kv_heads, group), NEG_INF, device=q.device)
    l = torch.zeros(batch, kv_heads, group, device=q.device)
    top = int(index.max())
    lo = 0
    if window is not None:
        lo = max(int((index - window + 1).clamp(min=0).min()), 0)
    for start in range(lo // block * block, min(top + 1, length), block):
        sl = slice(start, min(start + block, length))
        k_blk = k_buf[:, sl].to(q.dtype).float()  # [B, b, Hkv, D]
        v_blk = v_buf[:, sl].to(q.dtype)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, k_blk) * head_dim**-0.5
        if k_scale is not None:
            s = s * k_scale[:, sl].permute(0, 2, 1)[:, :, None, :]
        pos = torch.arange(sl.start, sl.stop, device=q.device)
        valid = pos[None, :] <= index[:, None]
        if window is not None:
            valid &= pos[None, :] > index[:, None] - window
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if v_scale is not None:
            p = p * v_scale[:, sl].permute(0, 2, 1)[:, :, None, :]
        pv = torch.einsum("bhgk,bkhd->bhgd", p.to(v_blk.dtype).float(), v_blk.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = torch.where(l[..., None] > 0, acc / torch.clamp(l, min=1e-37)[..., None], 0.0)
    return out.reshape(batch, heads, head_dim)[:, None].to(q.dtype)


def flash_decode_cuda(
    q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
    index: torch.Tensor, *, window: int | None = None,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K4 on CUDA tensors (``index`` already ``[B]`` int32): the
    split walk and its merge, one launch, on a workspace of per-split
    partials."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode kernel takes float32 or bfloat16 q, got {q.dtype}")
    if k_buf.dtype != torch.int8 and k_buf.dtype != q.dtype:
        raise TypeError(
            f"flash_decode kernel takes K/V in q's dtype or int8, got q={q.dtype} "
            f"k={k_buf.dtype}"
        )
    if k_buf.dtype != v_buf.dtype or k_buf.shape != v_buf.shape:
        raise ValueError("K and V buffers must share one shape and dtype")
    head_dim = q.shape[3]
    if head_dim % 8 or head_dim > 128:
        raise ValueError(
            f"flash_decode kernel is compiled for head dims that are multiples of 8 "
            f"up to 128; got shape {tuple(q.shape)}"
        )
    # The kernel copies rows in 16-byte units: buffers must start 16-byte aligned.
    q, k_buf, v_buf = (
        t if t.is_contiguous() and t.data_ptr() % 16 == 0
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k_buf, v_buf)
    )
    index = _rows(index, q.shape[0], q.device)
    if k_scale is not None:
        k_scale, v_scale = k_scale.float().contiguous(), v_scale.float().contiguous()
    batch, _, heads, _ = q.shape
    length, kv_heads = k_buf.shape[1], k_buf.shape[2]
    n_split = -(-length // SPLIT_ROWS)
    o = torch.empty_like(q)
    # Partials of every (row, kv head, split): acc [G, D], then (m, l) [G, 2].
    parts = batch * kv_heads * n_split * (heads // kv_heads)
    work = torch.empty(parts * (head_dim + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    params = DecodeParams(
        q=q.data_ptr(), k=k_buf.data_ptr(), v=v_buf.data_ptr(),
        k_scale=k_scale.data_ptr() if k_scale is not None else None,
        v_scale=v_scale.data_ptr() if v_scale is not None else None,
        index=index.data_ptr(), o=o.data_ptr(),
        part_acc=work.data_ptr(), part_ml=work[parts * head_dim:].data_ptr(),
        counters=_counters(q.device, stream, batch * kv_heads).data_ptr(),
        B=batch, L=length, H=heads, Hkv=kv_heads, D=head_dim,
        window=window or 0, q_dtype=_DTYPE_CODE[q.dtype],
        kv_dtype=_DTYPE_CODE[k_buf.dtype], n_split=n_split,
        scale=head_dim**-0.5,
    )
    lib = _build.load("flash_decode")
    with torch.cuda.device(q.device):
        err = lib.flash_decode(ctypes.addressof(params), stream)
    _build.check(err, "flash_decode")
    flash_decode_cuda.launches += 1
    if k_scale is not None:
        flash_decode_cuda.int8_launches += 1
    return o


#: K4 launches, and those of them on int8 K/V (a CUDA graph's replays add
#: the launches it captured: ``compiler.aot.CapturedProgram``)
flash_decode_cuda.launches = 0
flash_decode_cuda.int8_launches = 0


def flash_decode(
    q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
    index, *, window: int | None = None,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One fused decode step over each row's filled prefix: ``q`` ``[B, 1,
    H, D]``, grouped buffers ``[B, L, Hkv, D]``, ``index`` scalar or
    ``[B]``; returns ``[B, 1, H, D]`` in q's dtype. CPU tensors take the
    plain walk, CUDA tensors K4."""
    _validate(q, k_buf, v_buf, k_scale, v_scale)
    rows = _rows(index, q.shape[0], q.device)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_decode_reference(
            q, k_buf, v_buf, rows, window=window, k_scale=k_scale, v_scale=v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu tensors, got {q.device}")
    return flash_decode_cuda(
        q, k_buf, v_buf, rows, window=window, k_scale=k_scale, v_scale=v_scale
    )
