"""The model zoo: the decoder-only TransformerLM (training and inference),
the ResNet family and the UNet, their converters and generation."""

from __future__ import annotations

from typing import Any

from torch import nn

from deeplearning_mpi_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from deeplearning_mpi_tpu_torch.models.unet import UNet  # noqa: F401

_RESNETS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def get_model(name: str, **kwargs: Any) -> nn.Module:
    """Build a CNN by name — the registry behind the trainers' ``--arch``.
    The LM is built from its config (``models.transformer``)."""
    if name in _RESNETS:
        return _RESNETS[name](**kwargs)
    if name.startswith("vit_"):
        raise NotImplementedError(
            f"{name}: the ViT family is not ported yet (ROADMAP Queue 1 item 8)")
    if name == "unet":
        return UNet(**kwargs)
    if name == "unet3d":
        kwargs.setdefault("spatial_dims", 3)
        return UNet(**kwargs)
    raise ValueError(f"unknown model '{name}'; choose from {sorted(_RESNETS) + ['unet', 'unet3d']}")
