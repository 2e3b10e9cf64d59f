"""Convolution and dense layers with the reference's (flax) semantics.

The CNNs of the reference are flax ``nn.Conv`` / ``nn.ConvTranspose`` /
``nn.Dense`` layers in NHWC. These run channels-first tensors (a permuted
NHWC tensor is a ``channels_last`` NCHW one, which cuDNN takes without a
copy) and keep three of flax's rules a plain ``nn.Conv2d`` does not:

- ``'SAME'`` padding is flax's: ``ceil(n / s)`` outputs, the total padding
  split with the smaller half first — ``(0, 1)`` for a 3x3 stride-2 conv on
  an even size, ``(2, 3)`` for the 7x7/2 stem at 32x32, where
  ``padding=k // 2`` is ``(1, 1)`` / ``(3, 3)``;
- ``dtype`` is the compute dtype: the input, weight and bias are cast to
  it, while the parameters stay float32;
- the weights initialise with flax's distributions, drawn on the CPU from
  a generator (:meth:`reset_parameters`).

Weights are stored in PyTorch's layouts (``[out, in, *k]`` for a conv,
``[in, out, *k]`` for a transposed conv, ``[out, in]`` for a dense);
``models.convert.cnn_variables_from_jax`` maps flax trees onto them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
#: flax's truncated-normal variance correction (``variance_scaling``).
_TRUNC_STD = 0.87962566103423978


def _tuple(v, n: int) -> tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``'SAME'`` padding ``(lo, hi)`` of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(host: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal, variance 1 / fan_in."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(host, std=std, a=-2 * std, b=2 * std, generator=gen)


class Conv(nn.Module):
    """flax ``nn.Conv`` on channels-first input: ``features`` outputs,
    ``kernel_size``, ``strides``, ``padding`` (``'SAME'`` or per-dim
    ``(lo, hi)`` pairs), an optional bias, compute ``dtype``. ``init`` is
    ``'he_fan_out'`` (the CNNs' ``variance_scaling(2, fan_out, normal)``)
    or ``'lecun'`` (flax's default)."""

    def __init__(self, in_features: int, features: int, kernel_size, *, strides=1,
                 padding="SAME", use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 init: str = "he_fan_out", device=None) -> None:
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        nd = len(self.kernel_size)
        self.strides = _tuple(strides, nd)
        self.padding = padding
        self.dtype = dtype
        self.init = init
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel_size,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        out_f, in_f = self.weight.shape[:2]
        receptive = math.prod(self.kernel_size)
        host = torch.empty(self.weight.shape)
        if self.init == "he_fan_out":
            host.normal_(0.0, math.sqrt(2.0 / (out_f * receptive)), generator=gen)
        else:
            lecun_normal_(host, in_f * receptive, gen)
        self.weight.copy_(host)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = x.shape[2:]
        if self.padding == "SAME":
            pads = [same_padding(n, k, s) for n, k, s in zip(spatial, self.kernel_size, self.strides)]
        else:
            pads = [tuple(p) for p in self.padding]
        x = x.to(self.dtype)
        weight = self.weight.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        return _CONV[len(spatial)](x, weight, bias, stride=self.strides, padding=padding)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with ``kernel_size == strides`` and
    ``'SAME'`` padding (the UNet's 2x upsampling): each input position
    writes its own ``k``-block of the output, so the output is ``s`` times
    the input. With a bias; LeCun init over ``in * prod(k)``."""

    def __init__(self, in_features: int, features: int, kernel_size, *,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, *self.kernel_size,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        host = torch.empty(self.weight.shape)
        lecun_normal_(host, self.weight.shape[0] * math.prod(self.kernel_size), gen)
        self.weight.copy_(host)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _CONV_T[len(self.kernel_size)](
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=self.kernel_size)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ W + b`` in ``dtype``, LeCun init."""

    def __init__(self, in_features: int, features: int, *, dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        host = torch.empty(self.weight.shape)
        lecun_normal_(host, self.weight.shape[1], gen)
        self.weight.copy_(host)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """An NHWC (NDHWC) batch as channels-first. On the card this is a view
    (``channels_last`` memory, which cuDNN takes as it is); on the CPU it
    is a contiguous copy: the channels-last backward of a 1x1 stride-2 conv
    (the ResNets' projection shortcut) corrupts the heap in PyTorch 2.13's
    CPU build (oneDNN 3.12)."""
    x = x.movedim(-1, 1)
    return x.contiguous() if x.device.type == "cpu" else x


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init of every layer of ``model`` in registration order, drawn
    on the CPU so every device and every rank gets the same weights."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    return model
