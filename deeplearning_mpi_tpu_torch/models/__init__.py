"""The model zoo: the decoder-only TransformerLM (training and inference)
and its pipelined form, the ResNet family, the UNet and the ViT family,
their converters and generation."""

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
from deeplearning_mpi_tpu_torch.models.vit import ViT, vit_small, vit_tiny  # noqa: F401

_RESNETS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}

_VITS = {"vit_tiny": vit_tiny, "vit_small": vit_small}


def get_model(name: str, **kwargs: Any) -> nn.Module:
    """Build an image model by name — the registry behind the trainers'
    ``--arch``. The LM is built from its config (``models.transformer``)."""
    if name in _RESNETS:
        return _RESNETS[name](**kwargs)
    if name in _VITS:
        kwargs.pop("stem", None)  # the patch conv is the stem; the CNN knob does not apply
        if kwargs.pop("torch_padding", False):
            raise ValueError("torch_padding is a CNN numerics option; a ViT has no strided "
                             "conv padding")
        return _VITS[name](**kwargs)
    if name == "unet":
        return UNet(**kwargs)
    if name == "unet3d":
        kwargs.setdefault("spatial_dims", 3)
        return UNet(**kwargs)
    raise ValueError(f"unknown model '{name}'; choose from "
                     f"{sorted(_RESNETS) + sorted(_VITS) + ['unet', 'unet3d']}")
