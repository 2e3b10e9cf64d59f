"""Evaluation metrics: top-1 accuracy and the per-image Dice coefficient.

Port of ``deeplearning_mpi_tpu/ops/metrics.py``, with its conventions:
Dice is ``(2|pred ∩ true| + eps) / (|pred| + |true| + eps)`` with eps 1e-8,
and an image whose predicted and true masks are both empty scores 1.0.
"""

from __future__ import annotations

import torch

from deeplearning_mpi_tpu_torch.ops.loss import masked_mean


def top1_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, where: torch.Tensor | None = None
) -> torch.Tensor:
    """Fraction of argmax predictions equal to the integer labels; ``where``
    ([B], 1 = real example) excludes wrap-padded rows."""
    return masked_mean((logits.argmax(dim=-1) == labels.long()).float(), where)


def dice_score(
    pred_mask: torch.Tensor, true_mask: torch.Tensor, where: torch.Tensor | None = None, *,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Mean per-image Dice of binary ``[B, ...spatial]`` masks (the caller
    thresholds), both-empty images counting 1.0."""
    pred, true = pred_mask.float(), true_mask.float()
    axes = tuple(range(1, pred.dim()))
    intersection = (pred * true).sum(dim=axes)
    denom = pred.sum(dim=axes) + true.sum(dim=axes)
    dice = (2.0 * intersection + eps) / (denom + eps)
    dice = torch.where(denom == 0, torch.ones_like(dice), dice)
    return masked_mean(dice, where)
