"""Seeded ``.pth`` state dicts and functional oracles for the import tests
and ``chip_smoke.py`` phase 23d (no JAX here: the card's machine need not
have it).

:func:`resnet18_sd` has torchvision resnet18's key set and
:func:`unet_sd` the reference UNet's (``pytorch/unet/model.py``), at any
width, from a numpy seed; :func:`oracle_resnet18` / :func:`oracle_unet`
run ``F.conv2d`` / ``F.batch_norm`` / ``F.conv_transpose2d`` over the raw
state dict (NCHW in, NCHW out), on whatever device its tensors are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WIDTHS = (8, 16, 32, 64)


def _t(g, *shape, scale=None):
    fan_in = int(np.prod(shape[1:])) or 1
    s = 1 / np.sqrt(fan_in) if scale is None else scale
    return torch.tensor(g.normal(size=shape, scale=s).astype(np.float32))


def _bn(sd, g, prefix, c):
    sd[f"{prefix}.weight"] = torch.tensor((1 + g.normal(size=(c,), scale=0.1)).astype(np.float32))
    sd[f"{prefix}.bias"] = _t(g, c, scale=0.1)
    sd[f"{prefix}.running_mean"] = _t(g, c, scale=0.1)
    sd[f"{prefix}.running_var"] = torch.tensor((1 + g.random(c)).astype(np.float32))
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(3)


def resnet18_sd(width: int = 16, num_classes: int = 10, seed: int = 0) -> dict:
    """torchvision resnet18's key set, its channels ``width * 2**stage``."""
    g = np.random.default_rng(seed)
    sd = {"conv1.weight": _t(g, width, 3, 7, 7)}
    _bn(sd, g, "bn1", width)
    cin = width
    for stage in range(1, 5):
        c = width * 2 ** (stage - 1)
        for b in range(2):
            p = f"layer{stage}.{b}"
            sd[f"{p}.conv1.weight"] = _t(g, c, cin if b == 0 else c, 3, 3)
            _bn(sd, g, f"{p}.bn1", c)
            sd[f"{p}.conv2.weight"] = _t(g, c, c, 3, 3)
            _bn(sd, g, f"{p}.bn2", c)
            if b == 0 and cin != c:
                sd[f"{p}.downsample.0.weight"] = _t(g, c, cin, 1, 1)
                _bn(sd, g, f"{p}.downsample.1", c)
        cin = c
    sd["fc.weight"] = _t(g, num_classes, cin)
    sd["fc.bias"] = _t(g, num_classes)
    return sd


def unet_sd(widths=WIDTHS, out_classes: int = 1, seed: int = 0) -> dict:
    """The reference UNet's key set (``down_conv*``, ``double_conv``,
    ``up_conv*`` with ``up_sample``, ``conv_last``) at ``widths``."""
    g = np.random.default_rng(seed)
    sd = {}

    def double(prefix, cin, cout):
        for idx, (ci, co) in zip((0, 3), ((cin, cout), (cout, cout))):
            sd[f"{prefix}.double_conv.{idx}.weight"] = _t(g, co, ci, 3, 3)
            sd[f"{prefix}.double_conv.{idx}.bias"] = _t(g, co, scale=0.1)
            _bn(sd, g, f"{prefix}.double_conv.{idx + 1}", co)

    cin = 3
    for n, c in enumerate(widths, start=1):
        double(f"down_conv{n}.double_conv", cin, c)
        cin = c
    double("double_conv", cin, 2 * cin)
    c_up = 2 * cin
    for m, c in zip((4, 3, 2, 1), reversed(widths)):
        sd[f"up_conv{m}.up_sample.weight"] = _t(g, c_up, c_up, 2, 2, scale=1 / np.sqrt(4 * c_up))
        sd[f"up_conv{m}.up_sample.bias"] = _t(g, c_up, scale=0.1)
        double(f"up_conv{m}.double_conv", c_up + c, c)
        c_up = c
    sd["conv_last.weight"] = _t(g, out_classes, widths[0], 1, 1)
    sd["conv_last.bias"] = _t(g, out_classes, scale=0.1)
    return sd


def _oracle_bn(x, sd, p):
    return F.batch_norm(x, sd[f"{p}.running_mean"], sd[f"{p}.running_var"], sd[f"{p}.weight"],
                        sd[f"{p}.bias"], training=False, eps=1e-5)


def oracle_resnet18(x, sd):
    x = F.relu(_oracle_bn(F.conv2d(x, sd["conv1.weight"], stride=2, padding=3), sd, "bn1"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage in range(1, 5):
        for b in range(2):
            p = f"layer{stage}.{b}"
            stride = 2 if stage > 1 and b == 0 else 1
            y = F.relu(_oracle_bn(F.conv2d(x, sd[f"{p}.conv1.weight"], stride=stride, padding=1),
                                  sd, f"{p}.bn1"))
            y = _oracle_bn(F.conv2d(y, sd[f"{p}.conv2.weight"], padding=1), sd, f"{p}.bn2")
            identity = x
            if f"{p}.downsample.0.weight" in sd:
                identity = _oracle_bn(F.conv2d(x, sd[f"{p}.downsample.0.weight"], stride=stride),
                                      sd, f"{p}.downsample.1")
            x = F.relu(y + identity)
    return F.linear(x.mean(dim=(2, 3)), sd["fc.weight"], sd["fc.bias"])


def oracle_unet(x, sd):
    def double(x, prefix):
        for idx in (0, 3):
            x = F.conv2d(x, sd[f"{prefix}.double_conv.{idx}.weight"],
                         sd[f"{prefix}.double_conv.{idx}.bias"], padding=1)
            x = F.relu(_oracle_bn(x, sd, f"{prefix}.double_conv.{idx + 1}"))
        return x

    skips = []
    for n in range(1, 5):
        x = double(x, f"down_conv{n}.double_conv")
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = double(x, "double_conv")
    for m, skip in zip((4, 3, 2, 1), reversed(skips)):
        x = F.conv_transpose2d(x, sd[f"up_conv{m}.up_sample.weight"],
                               sd[f"up_conv{m}.up_sample.bias"], stride=2)
        x = double(torch.cat([x, skip], dim=1), f"up_conv{m}.double_conv")
    return F.conv2d(x, sd["conv_last.weight"], sd["conv_last.bias"])
