"""UNet (2-D and 3-D), the reference's topology and numerics.

Port of ``deeplearning_mpi_tpu/models/unet.py``: ``DoubleConv`` =
2x[conv 3^d SAME + BatchNorm + ReLU]; four down blocks (DoubleConv, then a
2^d max-pool, the pre-pool output kept as the skip); a bottleneck of twice
the last width; four up blocks (2x upsampling by a 2^d stride-2 transposed
conv, or by linear resize and a 1^d conv, the skip concatenated on the
channels, DoubleConv); a 1^d head with a bias. The blocks keep the flax
names (``down_i``, ``bottleneck``, ``up_i``, and ``ConvTranspose_i`` /
``Conv_i`` for the top-level layers), so a flax tree maps leaf by leaf.

``reference_topology`` is the original repo's decoder (the upsample keeps
its channels, the concat is ``[upsampled, skip]``); ``spatial_dims=3``
builds the volumetric variant on ``[B, D, H, W, C]``; ``remat`` recomputes
each DoubleConv in the backward (``torch.utils.checkpoint``; the running
statistics still advance once a forward). Input ``[B, *spatial, C]``,
output ``[B, *spatial, out_classes]`` float32, so the losses read
``[..., 0]`` as the reference's trainer does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deeplearning_mpi_tpu_torch import resolve_device
from deeplearning_mpi_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    channels_first,
    init_weights,
)
from deeplearning_mpi_tpu_torch.models.norm import BatchNorm, checkpoint_contexts

_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_RESIZE = {2: "bilinear", 3: "trilinear"}


class DoubleConv(nn.Module):
    """2x[conv 3^d SAME + BatchNorm + ReLU]."""

    def __init__(self, in_features: int, features: int, spatial_dims: int, *, norm_kw,
                 conv_kw) -> None:
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3,) * spatial_dims, **conv_kw)
        self.BatchNorm_0 = BatchNorm(features, **norm_kw)
        self.Conv_1 = Conv(features, features, (3,) * spatial_dims, **conv_kw)
        self.BatchNorm_1 = BatchNorm(features, **norm_kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.Conv_1(x)))


class UNet(nn.Module):
    """Encoder/decoder UNet with skip connections; see the module docstring."""

    def __init__(self, out_classes: int = 1, features=(64, 128, 256, 512), *,
                 bilinear: bool = False, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5, spatial_dims: int = 2,
                 remat: bool = False, reference_topology: bool = False, in_channels: int = 3,
                 device: str | torch.device = "cuda") -> None:
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        device = resolve_device(device)
        self.out_classes = out_classes
        self.features = tuple(features)
        self.bilinear = bilinear
        self.dtype = dtype
        self.spatial_dims = d = spatial_dims
        self.remat = remat
        self.reference_topology = reference_topology
        norm_kw = {"momentum": bn_momentum, "eps": bn_epsilon, "dtype": dtype, "device": device}
        conv_kw = {"dtype": dtype, "device": device}
        double = lambda cin, f: DoubleConv(cin, f, d, norm_kw=norm_kw, conv_kw=conv_kw)  # noqa: E731

        c = in_channels
        for i, f in enumerate(self.features):
            setattr(self, f"down_{i}", double(c, f))
            c = f
        self.bottleneck = double(c, self.features[-1] * 2)
        c = self.features[-1] * 2
        n_conv = 0
        for i, f in enumerate(reversed(self.features)):
            if bilinear:
                up = c
                if not reference_topology:
                    setattr(self, f"Conv_{n_conv}", Conv(c, f, (1,) * d, **conv_kw))
                    n_conv += 1
                    up = f
            else:
                up = c if reference_topology else f
                setattr(self, f"ConvTranspose_{i}", ConvTranspose(c, up, (2,) * d, **conv_kw))
            setattr(self, f"up_{i}", double(up + f, f))
            c = f
        self.head_name = f"Conv_{n_conv}"
        setattr(self, self.head_name, Conv(c, out_classes, (1,) * d, use_bias=True, init="lecun",
                                           **conv_kw))

    def init_weights(self, seed: int = 0) -> "UNet":
        return init_weights(self, seed)

    def _double(self, name: str, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False, context_fn=checkpoint_contexts)
        return block(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.spatial_dims
        if x.dim() != d + 2:
            raise ValueError(
                f"expected [batch, {'x'.join('S' * d)}, channels] input for "
                f"spatial_dims={d}; got shape {tuple(x.shape)}"
            )
        levels = 2 ** len(self.features)
        if any(s % levels for s in x.shape[1:-1]):
            raise ValueError(
                f"UNet spatial size {tuple(x.shape[1:-1])} must be divisible by {levels} "
                f"({len(self.features)} pooling levels)"
            )
        x = channels_first(x).to(self.dtype)
        skips = []
        for i in range(len(self.features)):
            x = self._double(f"down_{i}", x)
            skips.append(x)
            x = _POOL[d](x, 2)
        x = self._double("bottleneck", x)
        n_conv = 0
        for i, skip in enumerate(reversed(skips)):
            if self.bilinear:
                x = F.interpolate(x, scale_factor=2, mode=_RESIZE[d], align_corners=False)
                if not self.reference_topology:
                    x = getattr(self, f"Conv_{n_conv}")(x)
                    n_conv += 1
            else:
                x = getattr(self, f"ConvTranspose_{i}")(x)
            x = torch.cat([x, skip] if self.reference_topology else [skip, x], dim=1)
            x = self._double(f"up_{i}", x)
        x = getattr(self, self.head_name)(x)
        return x.movedim(1, -1).float()
