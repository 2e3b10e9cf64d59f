"""ResNet family (18/34/50/101/152), the reference's topology and numerics.

Port of ``deeplearning_mpi_tpu/models/resnet.py``: torchvision's v1.5
topology (stride on the bottleneck's 3x3), so ResNet-18 with 10 classes has
11,181,642 parameters. Each layer keeps the flax module's name
(``Conv_0``, ``BatchNorm_0``, ``BasicBlock_3``, ``Dense_0``), so a flax
tree maps onto the port leaf by leaf (``models.convert``).

The model takes the loader's NHWC batch; ``x.permute(0, 3, 1, 2)`` is a
``channels_last`` NCHW view, which cuDNN runs without a copy. Parameters
stay float32; ``dtype=torch.bfloat16`` casts each conv and dense input and
weight, and the logits come out float32. Strided convs pad as flax
``'SAME'`` unless ``torch_padding`` asks for torch's symmetric padding
(``models/layers.py``). BatchNorm is :class:`~.norm.BatchNorm`: global-
batch statistics when a data-parallel group is bound.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deeplearning_mpi_tpu_torch import resolve_device
from deeplearning_mpi_tpu_torch.models.layers import Conv, Dense, channels_first, init_weights
from deeplearning_mpi_tpu_torch.models.norm import BatchNorm


class _Block(nn.Module):
    """The layers of one residual block under their flax names, run in
    order: conv, norm, (relu between pairs), then the projection when the
    shape changes."""

    def _make(self, specs, in_features, out_features, strides, norm_kw, conv_kw):
        # specs: (features, kernel, stride, padding, zero-init scale) per conv.
        c = in_features
        for i, (features, k, s, pad, zero) in enumerate(specs):
            setattr(self, f"Conv_{i}", Conv(c, features, (k, k), strides=s, padding=pad, **conv_kw))
            setattr(self, f"BatchNorm_{i}", BatchNorm(features, scale_init=0.0 if zero else 1.0,
                                                      **norm_kw))
            c = features
        self.n_main = len(specs)
        self.project = strides != 1 or in_features != out_features
        if self.project:
            i = self.n_main
            setattr(self, f"Conv_{i}", Conv(in_features, out_features, (1, 1), strides=strides,
                                            **conv_kw))
            setattr(self, f"BatchNorm_{i}", BatchNorm(out_features, **norm_kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = x
        for i in range(self.n_main):
            y = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(y))
            if i < self.n_main - 1:
                y = F.relu(y)
        if self.project:
            i = self.n_main
            residual = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(residual))
        return F.relu(y + residual)


class BasicBlock(_Block):
    """Two 3x3 convs + identity shortcut (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int, *, norm_kw, conv_kw,
                 pad3="SAME") -> None:
        super().__init__()
        self._make([(filters, 3, strides, pad3, False), (filters, 3, 1, pad3, True)],
                   in_features, filters, strides, norm_kw, conv_kw)


class Bottleneck(_Block):
    """1x1 reduce -> 3x3 (strided) -> 1x1 expand x4 (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int, *, norm_kw, conv_kw,
                 pad3="SAME") -> None:
        super().__init__()
        self._make([(filters, 1, 1, "SAME", False), (filters, 3, strides, pad3, False),
                    (filters * 4, 1, 1, "SAME", True)],
                   in_features, filters * 4, strides, norm_kw, conv_kw)


class ResNet(nn.Module):
    """Configurable ResNet over RGB images; ``stage_sizes`` and
    ``block_cls`` pick the variant. ``stem`` is ``'imagenet'`` (7x7/2 +
    3x3/2 max-pool, the reference's) or ``'cifar'`` (3x3/1)."""

    def __init__(self, stage_sizes, block_cls, *, num_classes: int = 10, num_filters: int = 64,
                 stem: str = "imagenet", dtype: torch.dtype = torch.float32,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 torch_padding: bool = False, device: str | torch.device = "cuda") -> None:
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem '{stem}'")
        device = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.num_classes = num_classes
        self.stem = stem
        self.dtype = dtype
        norm_kw = {"momentum": bn_momentum, "eps": bn_epsilon, "dtype": dtype, "device": device}
        conv_kw = {"dtype": dtype, "device": device}
        pad7 = ((3, 3), (3, 3)) if torch_padding else "SAME"
        pad3 = ((1, 1), (1, 1)) if torch_padding else "SAME"
        if stem == "imagenet":
            self.Conv_0 = Conv(3, num_filters, (7, 7), strides=2, padding=pad7, **conv_kw)
        else:
            self.Conv_0 = Conv(3, num_filters, (3, 3), **conv_kw)
        self.BatchNorm_0 = BatchNorm(num_filters, **norm_kw)
        self.blocks: list[str] = []
        c = num_filters
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"{block_cls.__name__}_{len(self.blocks)}"
                setattr(self, name, block_cls(c, num_filters * 2 ** stage, strides,
                                              norm_kw=norm_kw, conv_kw=conv_kw, pad3=pad3))
                self.blocks.append(name)
                c = num_filters * 2 ** stage * block_cls.expansion
        self.Dense_0 = Dense(c, num_classes, dtype=dtype, device=device)

    def init_weights(self, seed: int = 0) -> "ResNet":
        return init_weights(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, C]`` images -> ``[B, num_classes]`` float32 logits."""
        x = channels_first(x).to(self.dtype)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).float()


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet((3, 8, 36, 3), Bottleneck, **kw)
