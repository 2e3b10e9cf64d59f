"""Loss functions of the LM, classification and segmentation trainers.

Port of ``deeplearning_mpi_tpu/ops/loss.py``. Every loss is computed in
float32 whatever the input dtype: the model runs bf16 matmuls, but the
log-softmax and the reductions need f32 accumulation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element negative log-likelihood, f32 (f64 for f64 logits)
    log-softmax over the last axis."""
    log_probs = torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                                  dim=-1)
    return -torch.gather(log_probs, -1, labels.long()[..., None])[..., 0]


def masked_mean(values: torch.Tensor, where: torch.Tensor | None) -> torch.Tensor:
    """Mean of ``values``, optionally weighted by a broadcast-compatible
    validity mask (0 = excluded); the denominator is ``max(sum(w), 1)``."""
    if where is None:
        return values.mean()
    w = where.float()
    return (values * w).sum() / torch.clamp(w.sum(), min=1.0)


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, where: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels; ``where`` ([B],
    1 = real example) excludes wrap-padded eval rows."""
    return masked_mean(_token_nll(logits, labels), where)


def bce_per_image(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-image mean binary cross-entropy on logits, shape ``[B]``:
    ``max(x, 0) - x*y + log1p(exp(-|x|))``, the stable form."""
    logits, targets = logits.float(), targets.float()
    per_elem = torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return per_elem.mean(dim=tuple(range(1, per_elem.dim())))


def sigmoid_binary_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, where: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean binary cross-entropy on logits (``BCEWithLogitsLoss``); ``where``
    ([B], 1 = real example) excludes wrap-padded eval rows."""
    return masked_mean(bce_per_image(logits, targets), where)


def dice_per_image(logits: torch.Tensor, targets: torch.Tensor, *, eps: float = 1e-8) -> torch.Tensor:
    """Per-image soft Dice loss (1 - soft Dice of the sigmoid), shape ``[B]``."""
    probs = torch.sigmoid(logits.float())
    targets = targets.float()
    axes = tuple(range(1, logits.dim()))
    intersection = (probs * targets).sum(dim=axes)
    union = probs.sum(dim=axes) + targets.sum(dim=axes)
    return 1.0 - (2.0 * intersection + eps) / (union + eps)


def dice_loss(
    logits: torch.Tensor, targets: torch.Tensor, where: torch.Tensor | None = None, *,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Soft Dice loss averaged over the batch; ``where`` as above."""
    return masked_mean(dice_per_image(logits, targets, eps=eps), where)


def lm_cross_entropy(
    logits: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Next-token LM loss: predict ``tokens[:, 1:]`` from ``logits[:, :-1]``;
    ``mask`` (1 = real token) excludes padding from the mean."""
    nll = _token_nll(logits[:, :-1], tokens[:, 1:])
    return masked_mean(nll, None if mask is None else mask[:, 1:])


def lm_cross_entropy_slice(
    logits: torch.Tensor, tokens: torch.Tensor, start: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """A sequence slice's share of :func:`lm_cross_entropy` on whole rows:
    ``logits`` ``[B, S_l, V]`` are those of positions ``start ..
    start+S_l-1`` of ``tokens`` ``[B, S]``; each predicts the next token of
    the whole row (none for the row's last position). The sum of the nll
    over the slice's valid targets is divided by the whole rows' count of
    valid targets, so the slices' shares add up to the whole rows' loss."""
    targets = tokens[:, start + 1:start + logits.shape[1] + 1]
    nll = _token_nll(logits[:, :targets.shape[1]], targets)
    if mask is None:
        return nll.sum() / max(tokens.shape[0] * (tokens.shape[1] - 1), 1)
    w = mask[:, 1:].float()
    return (nll * w[:, start:start + targets.shape[1]]).sum() / torch.clamp(w.sum(), min=1.0)


def _chunk_nll_sum(
    x_c: torch.Tensor, kernel: torch.Tensor, labels_c: torch.Tensor, w_c: torch.Tensor
) -> torch.Tensor:
    logits = torch.einsum("btd,dv->btv", x_c, kernel)  # the only logits tile alive
    return (_token_nll(logits, labels_c) * w_c).sum()


def chunked_lm_loss(
    x: torch.Tensor,
    head_kernel: torch.Tensor,
    tokens: torch.Tensor,
    *,
    chunk_size: int,
    mask: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Next-token loss from pre-head activations, never holding the full
    ``[B, S, V]`` logits.

    ``x`` is the final-norm output ``[B, S, d]``, ``head_kernel`` ``[d, V]``
    (tied embeddings: ``embed.weight.T``). The S-1 prediction positions are
    padded to whole chunks with zero weight; each chunk's head matmul and
    cross-entropy run under ``torch.utils.checkpoint``, so the backward
    recomputes its ``[B, chunk, V]`` logits instead of saving them.
    ``compute_dtype`` is the matmul dtype (default ``x.dtype``); logits are
    cast to f32 before the log-softmax, as in the dense path.
    """
    compute_dtype = compute_dtype or x.dtype
    labels = tokens[:, 1:]
    weights = (
        torch.ones(labels.shape, dtype=torch.float32, device=x.device)
        if mask is None else mask[:, 1:].float()
    )
    total = _chunked_nll(x[:, :-1].to(compute_dtype), head_kernel.to(compute_dtype), labels,
                         weights, chunk_size)
    return total / torch.clamp(weights.sum(), min=1.0)


def _chunked_nll(x_in: torch.Tensor, kernel: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """The weighted nll sum of ``x_in``'s prediction positions, in chunks of
    ``chunk_size`` (the last padded with zero weight), each under
    ``torch.utils.checkpoint``."""
    n_pos = x_in.shape[1]
    chunk_size = max(1, min(chunk_size, n_pos))
    pad = (-n_pos) % chunk_size
    if pad:
        x_in = F.pad(x_in, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        weights = F.pad(weights, (0, pad))  # zero weight = excluded
    total = torch.zeros((), dtype=torch.float32, device=x_in.device)
    for start in range(0, n_pos + pad, chunk_size):
        sl = slice(start, start + chunk_size)
        total = total + checkpoint(
            _chunk_nll_sum, x_in[:, sl], kernel, labels[:, sl], weights[:, sl],
            use_reentrant=False, preserve_rng_state=False,  # no random op to replay
        )
    return total


def chunked_lm_loss_slice(
    x: torch.Tensor,
    head_kernel: torch.Tensor,
    tokens: torch.Tensor,
    start: int,
    *,
    chunk_size: int,
    mask: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """A sequence slice's share of :func:`chunked_lm_loss` on whole rows, as
    :func:`lm_cross_entropy_slice` is :func:`lm_cross_entropy`'s: ``x``
    ``[B, S_l, d]`` holds positions ``start .. start+S_l-1`` of ``tokens``
    ``[B, S]``; each predicts the next token of the whole row, across the
    slice's edge (none for the row's last position). The slice's own
    positions are cut into chunks; their weighted nll sum is divided by the
    whole rows' count of valid targets, so the slices' shares add up to the
    whole rows' loss."""
    compute_dtype = compute_dtype or x.dtype
    labels = tokens[:, start + 1:start + x.shape[1] + 1]
    every = (torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=x.device)
             if mask is None else mask[:, 1:].float())
    weights = every[:, start:start + labels.shape[1]]
    total = _chunked_nll(x[:, :labels.shape[1]].to(compute_dtype),
                         head_kernel.to(compute_dtype), labels, weights, chunk_size)
    return total / torch.clamp(every.sum(), min=1.0)
