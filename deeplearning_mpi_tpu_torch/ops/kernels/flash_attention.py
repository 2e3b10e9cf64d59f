"""K1, K2 and K3: flash attention, forward and backward — CUDA kernels, their
plain PyTorch versions, and the autograd join.

Port of ``deeplearning_mpi_tpu/ops/pallas/flash_attention.py``: the forward
``_fwd_kernel`` (K1, via ``_fwd_pallas``), the backward ``_bwd_dq_kernel``
(K2) and ``_bwd_dkv_kernel`` (K3, both via ``_bwd_pallas``), the custom VJP
``_flash`` that joins them, and the entries ``flash_attention``,
``flash_attention_bhsd`` and the ring's ``flash_fwd_block`` /
``flash_bwd_block`` (here :func:`flash_attention` with ``return_lse`` and
:func:`flash_attention_bwd`). One kernel of each kind
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) serves
both layouts: they take element strides, so BHSD input costs no transposes.
Options: ``causal``, sliding ``window``, a static q-position ``shift``
(requires ``window``, as in the reference), a logsumexp output ``[B, H, S]``
float32 (the reference stores it lane-replicated as ``[B, H, S, 128]``;
compare against ``lse[..., 0]``), a float32 ``out_dtype`` and, in the
backward, a float32 ``grad_dtype``.

The kernels mask the ragged edge themselves, so any sequence length runs;
the only shape rule is the head dim (a multiple of 8 up to 128). Another
head dim on CUDA raises — it is never handed to the plain version.

Under autograd (grad enabled and an input that requires grad) the entries
run :class:`FlashAttentionFn`: its forward runs K1 with the lse and saves
``q, k, v, o, lse``; its backward runs K2 and K3. On CPU tensors the same
Function runs the plain versions. ``return_lse`` and ``out_dtype`` are
forward-only options (the ring's) and raise under autograd, as the
reference's ``_flash`` offers neither.
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


def _valid_pairs(seq: int, causal: bool, window: int | None, shift: int, device) -> torch.Tensor:
    """``[S, S]`` bool: query row i (at position i + shift) sees key j."""
    if not causal:
        return torch.ones(seq, seq, dtype=torch.bool, device=device)
    q_pos = shift + torch.arange(seq, device=device)[:, None]
    k_pos = torch.arange(seq, device=device)[None, :]
    valid = q_pos >= k_pos
    if window is not None:
        valid &= q_pos - k_pos < window
    return valid


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
    valid = _valid_pairs(seq, causal, window, shift, q.device)
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


def _check_head_dim(q: torch.Tensor) -> int:
    head_dim = q.shape[3]
    if head_dim % 8 or head_dim > _MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention kernel is compiled for head dims that are "
            f"multiples of 8 up to {_MAX_HEAD_DIM}; got shape {tuple(q.shape)}"
        )
    return head_dim


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where a row would not start 16-byte
    aligned: the kernels load 8-element vectors."""
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(names: str, tensors, layout: str) -> dict[str, int]:
    """``{name_sb, name_ss, name_sh}`` element strides for each tensor."""
    s_ax, h_ax = (1, 2) if layout == "bshd" else (2, 1)
    out = {}
    for name, t in zip(names.split(), tensors):
        out.update({f"{name}_sb": t.stride(0), f"{name}_ss": t.stride(s_ax),
                    f"{name}_sh": t.stride(h_ax)})
    return out


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
    head_dim = _check_head_dim(q)
    q, k, v = (_aligned(t) for t in (q, k, v))
    s_ax, h_ax = (1, 2) if layout == "bshd" else (2, 1)
    batch, seq, heads = q.shape[0], q.shape[s_ax], q.shape[h_ax]
    # q's strides: on BHSD views of BSHD storage the output is such a view too.
    o = torch.empty_like(q, dtype=out_dtype)
    lse = (
        torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    strides = _strides("q k v o", (q, k, v, o), layout)
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


class BwdParams(ctypes.Structure):
    """Mirrors ``struct BwdParams`` in ``csrc/flash_attention_bwd.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk", "dv",
        )]
        + [(f"{t}_{s}", ctypes.c_int64)
           for t in ("q", "k", "v", "o", "do", "dq", "dk", "dv") for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_int32) for n in (
            "B", "H", "S", "D", "causal", "window", "shift", "in_dtype", "grad_dtype",
        )]
        + [("scale", ctypes.c_float)]
    )


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *,
    causal: bool = True, window: int | None = None, shift: int = 0,
    grad_dtype: torch.dtype | None = None, layout: str = "bshd",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K2 and K3: ``(dq, dk, dv)``, materializing
    the ``[B, H, S, S]`` float32 scores. The reference's rounding points are
    kept: ``p`` and ``ds`` are rounded to the input dtype before their
    products, ``dp`` and the sums are float32, ``delta = rowsum(o * do)``
    comes from the stored ``o``. Masked pairs get ``p = ds = 0`` explicitly,
    so a row with no valid key (lse ``NEG_INF``) has zero gradient."""
    if layout == "bshd":
        q, k, v, o, do = (t.transpose(1, 2) for t in (q, k, v, o, do))
    seq, head_dim = q.shape[2], q.shape[3]
    scale = head_dim**-0.5
    in_dtype = q.dtype
    valid = _valid_pairs(seq, causal, window, shift, q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (o.float() * dof).sum(dim=-1, keepdim=True)
    ds = torch.where(valid, p * (dp - delta) * scale, 0.0)
    dv = torch.matmul(p.to(in_dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(in_dtype).float().transpose(-1, -2), q.float())
    dq = torch.matmul(ds.to(in_dtype).float(), k.float())
    grads = tuple(g.to(grad_dtype or in_dtype) for g in (dq, dk, dv))
    if layout == "bshd":
        grads = tuple(g.transpose(1, 2) for g in grads)
    return grads


def _bwd_params(q, k, v, o, do, lse, delta, dq, dk, dv, *,
                causal, window, shift, grad_dtype, layout) -> BwdParams:
    s_ax, h_ax = (1, 2) if layout == "bshd" else (2, 1)
    head_dim = q.shape[3]
    return BwdParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        dout=do.data_ptr(), lse=lse.data_ptr(), delta=delta.data_ptr(),
        dq=dq.data_ptr() if dq is not None else None,
        dk=dk.data_ptr() if dk is not None else None,
        dv=dv.data_ptr() if dv is not None else None,
        B=q.shape[0], H=q.shape[h_ax], S=q.shape[s_ax], D=head_dim,
        causal=int(causal), window=window or 0, shift=shift,
        in_dtype=_DTYPE_CODE[q.dtype], grad_dtype=_DTYPE_CODE[grad_dtype],
        scale=head_dim**-0.5,
        **_strides("q k v o do", (q, k, v, o, do), layout),
        **_strides("dq dk dv", [t if t is not None else q for t in (dq, dk, dv)], layout),
    )


def _bwd_inputs(q, k, v, o, do, lse, grad_dtype):
    """Check and align the backward's inputs; returns them with the grad dtype."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention backward takes float32 or bfloat16, got {q.dtype}")
    if not all(t.dtype == q.dtype and t.shape == q.shape for t in (k, v, o, do)):
        raise ValueError("q, k, v, o and do must share one shape and dtype")
    grad_dtype = grad_dtype or q.dtype
    if grad_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"grad_dtype must be q's dtype or float32, got {grad_dtype}")
    _check_head_dim(q)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 [B, H, S] tensor")
    return (*(_aligned(t) for t in (q, k, v, o, do)), lse, grad_dtype)


def _launch(entry: str, params: BwdParams, device) -> None:
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(ctypes.addressof(params), stream)
    _build.check(err, entry)


def flash_attention_bwd_dq_cuda(
    q, k, v, o, do, lse, *, causal: bool, window: int | None, shift: int,
    grad_dtype: torch.dtype | None, layout: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (after its ``delta = rowsum(o * do)`` pre-pass) on CUDA
    tensors; returns ``(dq, delta)``, delta ``[B, H, S]`` float32 for K3."""
    q, k, v, o, do, lse, grad_dtype = _bwd_inputs(q, k, v, o, do, lse, grad_dtype)
    dq = torch.empty_like(q, dtype=grad_dtype)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    params = _bwd_params(q, k, v, o, do, lse, delta, dq, None, None, causal=causal,
                         window=window, shift=shift, grad_dtype=grad_dtype, layout=layout)
    _launch("flash_attention_bwd_dq", params, q.device)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq, delta


def flash_attention_bwd_dkv_cuda(
    q, k, v, o, do, lse, delta, *, causal: bool, window: int | None, shift: int,
    grad_dtype: torch.dtype | None, layout: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on CUDA tensors, with the ``delta`` K2's pre-pass wrote;
    returns ``(dk, dv)``."""
    q, k, v, o, do, lse, grad_dtype = _bwd_inputs(q, k, v, o, do, lse, grad_dtype)
    if delta.shape != lse.shape or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError("delta must be a contiguous float32 [B, H, S] tensor")
    dk = torch.empty_like(k, dtype=grad_dtype)
    dv = torch.empty_like(v, dtype=grad_dtype)
    params = _bwd_params(q, k, v, o, do, lse, delta, None, dk, dv, causal=causal,
                         window=window, shift=shift, grad_dtype=grad_dtype, layout=layout)
    _launch("flash_attention_bwd_dkv", params, q.device)
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *,
    causal: bool = True, window: int | None = None, shift: int = 0,
    grad_dtype: torch.dtype | None = None, layout: str = "bshd",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of flash attention from its output ``o``, output
    gradient ``do`` and logsumexp ``lse`` ``[B, H, S]`` — the counterpart of
    the reference's ``flash_bwd_block``. K2 and K3 on CUDA tensors, the plain
    version on CPU tensors."""
    _validate(q, k, v, causal, window, shift)
    kw = dict(causal=causal, window=window, shift=shift, grad_dtype=grad_dtype, layout=layout)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, do, lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward K1 with the lse,
    backward K2 and K3 (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, shift, layout):
        kw = dict(causal=causal, window=window, shift=shift, layout=layout)
        fwd = flash_attention_reference if q.device.type == "cpu" else flash_attention_cuda
        o, lse = fwd(q, k, v, return_lse=True, out_dtype=None, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.to(o.dtype), lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _dispatch(q, k, v, *, causal, window, shift, return_lse, out_dtype, layout):
    _validate(q, k, v, causal, window, shift)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if return_lse or out_dtype not in (None, q.dtype):
            raise ValueError(
                "return_lse and out_dtype are forward-only options: the "
                "differentiable path returns the output in the input dtype"
            )
        return FlashAttentionFn.apply(q, k, v, causal, window, shift, layout)
    kw = dict(causal=causal, window=window, shift=shift, return_lse=return_lse,
              out_dtype=out_dtype, layout=layout)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, **kw)
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


#: Read by a model to call this entry on ``[B, H, S, D]`` views of its q/k/v.
flash_attention_bhsd.layout = "bhsd"
