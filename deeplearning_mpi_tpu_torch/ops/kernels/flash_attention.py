"""K1: flash-attention forward — CUDA kernel and its plain PyTorch version.

Port of ``deeplearning_mpi_tpu/ops/pallas/flash_attention.py``'s forward
(``_fwd_kernel`` via ``_fwd_pallas``; entries ``flash_attention``,
``flash_attention_bhsd`` and the ring's ``flash_fwd_block``). One kernel
(``csrc/flash_attention_fwd.cu``) serves both layouts: it takes element
strides, so BHSD input costs no transposes. Options: ``causal``, sliding
``window``, a static q-position ``shift`` (requires ``window``, as in the
reference), a logsumexp output ``[B, H, S]`` float32 (the reference stores
it lane-replicated as ``[B, H, S, 128]``; compare against ``lse[..., 0]``)
and a float32 ``out_dtype``.

The kernel masks the ragged edge itself, so any sequence length runs; the
only shape rule is the head dim (a multiple of 8 up to 128). Another head
dim on CUDA raises — it is never handed to the plain version.

Forward only: the backward kernels (K2, K3) come with the training slice,
so an input that requires grad raises instead of silently running a
forward that cannot be differentiated.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning_mpi_tpu_torch.ops.attention import NEG_INF
from deeplearning_mpi_tpu_torch.ops.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


class FwdParams(ctypes.Structure):
    """Mirrors ``struct FwdParams`` in ``csrc/flash_attention_fwd.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "o", "lse")]
        + [(f"{t}_{s}", ctypes.c_int64) for t in "qkvo" for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_int32) for n in (
            "B", "H", "S", "D", "causal", "window", "shift", "in_dtype", "out_dtype",
        )]
        + [("scale", ctypes.c_float)]
    )


def _validate(q, k, v, causal: bool, window: int | None, shift: int) -> None:
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one shape (repeat_kv grouped heads first), "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None:
        if not causal:
            raise ValueError("window attention is causal by definition; pass causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if shift and window is None:
        raise ValueError("shift requires window (ring rotation use only)")
    if shift < 0:
        raise ValueError(f"shift must be >= 0, got {shift}")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "flash_attention is forward-only in this slice: its backward "
            "kernels (K2 dq, K3 dk/dv) arrive with the training slice; run "
            "under torch.no_grad() or use dense_attention for gradients"
        )


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None, shift: int = 0,
    return_lse: bool = False, out_dtype: torch.dtype | None = None,
    layout: str = "bshd",
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K1: the same function, materializing
    the ``[B, H, S, S]`` float32 scores. Probabilities are rounded to the
    input dtype before the V product, as the reference kernel does."""
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    seq, head_dim = q.shape[2], q.shape[3]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * head_dim**-0.5
    if causal:
        q_pos = shift + torch.arange(seq, device=q.device)[:, None]
        k_pos = torch.arange(seq, device=q.device)[None, :]
        valid = q_pos >= k_pos
        if window is not None:
            valid &= q_pos - k_pos < window
    else:
        valid = torch.ones(seq, seq, dtype=torch.bool, device=q.device)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    o = torch.where(l > 0, o / torch.where(l == 0, 1.0, l), 0.0)
    o = o.to(out_dtype or q.dtype)
    if layout == "bshd":
        o = o.transpose(1, 2)
    if not return_lse:
        return o
    lse = torch.where(
        l > 0, m + torch.log(torch.clamp(l, min=1e-37)), NEG_INF
    )[..., 0]
    return o, lse


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: int | None, shift: int, return_lse: bool,
    out_dtype: torch.dtype | None, layout: str,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors (``layout`` names which axes are S and H)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be q's dtype or float32, got {out_dtype}")
    head_dim = q.shape[3]
    if head_dim % 8 or head_dim > _MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention kernel is compiled for head dims that are "
            f"multiples of 8 up to {_MAX_HEAD_DIM}; got shape {tuple(q.shape)}"
        )
    # The kernel loads 8-element vectors: every row must start 16-byte aligned.
    q, k, v = (
        t if t.stride(3) == 1 and t.data_ptr() % 16 == 0
        and all(st % 8 == 0 for st in t.stride()[:3])
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v)
    )
    s_ax, h_ax = (1, 2) if layout == "bshd" else (2, 1)
    batch, seq, heads = q.shape[0], q.shape[s_ax], q.shape[h_ax]
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = (
        torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    strides = {}
    for name, t in zip("qkvo", (q, k, v, o)):
        strides.update({
            f"{name}_sb": t.stride(0), f"{name}_ss": t.stride(s_ax),
            f"{name}_sh": t.stride(h_ax),
        })
    params = FwdParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        lse=lse.data_ptr() if lse is not None else None,
        B=batch, H=heads, S=seq, D=head_dim,
        causal=int(causal), window=window or 0, shift=shift,
        in_dtype=_DTYPE_CODE[q.dtype], out_dtype=_DTYPE_CODE[out_dtype],
        scale=head_dim**-0.5, **strides,
    )
    lib = _build.load("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(ctypes.addressof(params), stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0


def _dispatch(q, k, v, *, causal, window, shift, return_lse, out_dtype, layout):
    _validate(q, k, v, causal, window, shift)
    kw = dict(causal=causal, window=window, shift=shift, return_lse=return_lse,
              out_dtype=out_dtype, layout=layout)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return flash_attention_cuda(q, k, v, **kw)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None, shift: int = 0,
    return_lse: bool = False, out_dtype: torch.dtype | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over ``[B, S, H, D]`` (drop-in for ``dense_attention``
    as a model's full-sequence core). Returns the output, or ``(output,
    lse)`` with ``return_lse``."""
    return _dispatch(q, k, v, causal=causal, window=window, shift=shift,
                     return_lse=return_lse, out_dtype=out_dtype, layout="bshd")


def flash_attention_bhsd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None, shift: int = 0,
    return_lse: bool = False, out_dtype: torch.dtype | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` over ``[B, H, S, D]`` — same kernel, other
    strides, no transposes."""
    return _dispatch(q, k, v, causal=causal, window=window, shift=shift,
                     return_lse=return_lse, out_dtype=out_dtype, layout="bhsd")


#: Read by a model to project q/k/v straight into this entry's layout.
flash_attention_bhsd.layout = "bhsd"
