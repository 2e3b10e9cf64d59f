"""Import the reference's PyTorch ``.pth`` checkpoints into the port.

Port of ``deeplearning_mpi_tpu/utils/torch_import.py``. The reference
saves raw DDP state_dicts — ``torch.save(ddp_model.state_dict(), path)``
every 10 epochs (``pytorch/resnet/main.py:139``,
``pytorch/unet/train.py:216``) — so a migrating user arrives with ``.pth``
files whose keys carry DDP's ``module.`` prefix. This module maps them onto
the port's own modules, which keep PyTorch's layouts: OIHW conv weights,
``(in, out, kH, kW)`` transposed-conv weights (the port's ``ConvTranspose``
is PyTorch's, so no flip) and ``(out, in)`` linear weights copy as they
are. What remains is:

- the names: the port's layers carry the flax names of the reference
  (``Conv_0``, ``BatchNorm_0``, ``BasicBlock_3``, ``down_1``, ``up_0``,
  ``ConvTranspose_0``, ``Dense_0``);
- BatchNorm: ``weight`` / ``bias`` / ``running_mean`` / ``running_var``
  keep their names under the port's module; ``num_batches_tracked`` has no
  counterpart (the port's BatchNorm has a fixed momentum) and is dropped;
- the UNet's bias fold: the reference's 3x3 convs keep torch's default
  ``bias=True`` before a BatchNorm (``pytorch/unet/model.py:9-13``), and the
  port's DoubleConv convs carry no bias, so the bias is folded into the BN
  running mean: BN(Wx + b) with stats (m, v) equals BN(Wx) with stats
  (m - b, v), exactly.

UNet checkpoints restore into ``UNet(reference_topology=True)`` (the
reference's decoder keeps channels through the upsample); ResNet ones into
``models.resnet`` with ``stem="imagenet", torch_padding=True`` (torch's
symmetric padding of the strided convs). :func:`load_pth` reads with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

StateDict = dict[str, torch.Tensor]


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Drop the ``module.`` prefix DDP adds to every key; a plain model's
    dict passes through, a mixed one is refused."""
    keys = list(state_dict)
    prefixed = [k.startswith("module.") for k in keys]
    if all(prefixed):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    if any(prefixed):
        bad = [k for k, p in zip(keys, prefixed) if not p][:3]
        raise ValueError(f"state_dict mixes DDP-prefixed and bare keys (e.g. {bad}); "
                         "refusing to guess")
    return dict(state_dict)


def _f32(t: Any) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def _set(out: StateDict, name: str, value: torch.Tensor) -> None:
    if name in out:
        raise ValueError(f"duplicate assignment at {name}")
    out[name] = value


def _bn(sd: Mapping[str, Any], src: str, out: StateDict, dst: str, *,
        mean_shift: torch.Tensor | None = None) -> None:
    _set(out, f"{dst}.weight", _f32(sd[f"{src}.weight"]))
    _set(out, f"{dst}.bias", _f32(sd[f"{src}.bias"]))
    mean = _f32(sd[f"{src}.running_mean"])
    _set(out, f"{dst}.running_mean", mean if mean_shift is None else mean - mean_shift)
    _set(out, f"{dst}.running_var", _f32(sd[f"{src}.running_var"]))


def _double_conv(sd: Mapping[str, Any], src: str, out: StateDict, dst: str) -> None:
    """One reference DoubleConv (``<src>.double_conv.{0,1,3,4}``) -> the
    port's ``Conv_{0,1}`` / ``BatchNorm_{0,1}`` under ``dst``, each conv's
    bias folded into the following BN's running mean."""
    for ours, (conv_i, bn_i) in enumerate(((0, 1), (3, 4))):
        conv = f"{src}.double_conv.{conv_i}"
        _set(out, f"{dst}.Conv_{ours}.weight", _f32(sd[f"{conv}.weight"]))
        _bn(sd, f"{src}.double_conv.{bn_i}", out, f"{dst}.BatchNorm_{ours}",
            mean_shift=_f32(sd[f"{conv}.bias"]))


def convert_reference_unet(state_dict: Mapping[str, Any]) -> StateDict:
    """Reference UNet state_dict -> ``state_dict`` of the port's
    ``UNet(reference_topology=True)`` (``bilinear`` as the file was trained).

    Key layout (``pytorch/unet/model.py:51-68``): ``down_conv{1..4}``
    encoder blocks, ``double_conv`` bottleneck, ``up_conv{4..1}`` decoder
    blocks (each with an ``up_sample`` ConvTranspose2d in conv_transpose
    mode), ``conv_last`` 1x1 head. The decoder order reverses: ``up_conv4``
    (deepest) is the port's ``up_0``."""
    sd = strip_ddp_prefix(state_dict)
    out: StateDict = {}
    # DownBlock/UpBlock hold a DoubleConv named double_conv whose inner
    # Sequential is also named double_conv; the bottleneck is one level.
    for n in range(1, 5):
        _double_conv(sd, f"down_conv{n}.double_conv", out, f"down_{n - 1}")
    _double_conv(sd, "double_conv", out, "bottleneck")
    for i, m in enumerate((4, 3, 2, 1)):
        up = f"up_conv{m}.up_sample"
        if f"{up}.weight" in sd:  # conv_transpose mode; bilinear has no params
            _set(out, f"ConvTranspose_{i}.weight", _f32(sd[f"{up}.weight"]))
            _set(out, f"ConvTranspose_{i}.bias", _f32(sd[f"{up}.bias"]))
        _double_conv(sd, f"up_conv{m}.double_conv", out, f"up_{i}")
    # 1x1 head: bias kept (no BN follows), model.py:68.
    _set(out, "Conv_0.weight", _f32(sd["conv_last.weight"]))
    _set(out, "Conv_0.bias", _f32(sd["conv_last.bias"]))

    doubles = ([f"down_conv{n}.double_conv" for n in range(1, 5)] + ["double_conv"]
               + [f"up_conv{m}.double_conv" for m in range(1, 5)])
    known = {"conv_last"} | {f"{d}.double_conv.{i}" for d in doubles for i in (0, 1, 3, 4)}
    known |= {f"up_conv{m}.up_sample" for m in range(1, 5)}
    extra = sorted({k.rsplit(".", 1)[0] for k in sd} - known)
    if extra:
        raise ValueError(f"unrecognized modules in state_dict: {extra[:5]}")
    return out


# torchvision ResNet naming (public API): stem conv1/bn1, stages layer1..4
# of numbered blocks, each conv1/bn1/conv2/bn2 (+conv3/bn3 for Bottleneck)
# and an optional downsample.{0,1}, head fc (``pytorch/resnet/main.py:40-41``).
_RESNET_BLOCKS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
_BOTTLENECK = {"resnet50", "resnet101", "resnet152"}


def convert_torchvision_resnet(state_dict: Mapping[str, Any], arch: str = "resnet18") -> StateDict:
    """torchvision ResNet state_dict -> ``state_dict`` of the port's
    ``models.resnet`` model (``stem="imagenet", torch_padding=True``).

    The port's blocks are flat-numbered across stages (``BasicBlock_0..7``
    for resnet18; ``Bottleneck_*`` for 50/101/152), convs and norms numbered
    in order with the downsample projection last (``Conv_2``/``BatchNorm_2``
    basic, ``Conv_3``/``BatchNorm_3`` bottleneck)."""
    if arch not in _RESNET_BLOCKS:
        raise ValueError(f"unknown arch {arch!r}; one of {sorted(_RESNET_BLOCKS)}")
    sd = strip_ddp_prefix(state_dict)
    bottleneck = arch in _BOTTLENECK
    n_convs = 3 if bottleneck else 2
    block_name = "Bottleneck" if bottleneck else "BasicBlock"
    out: StateDict = {}
    _set(out, "Conv_0.weight", _f32(sd["conv1.weight"]))
    _bn(sd, "bn1", out, "BatchNorm_0")
    flat = 0
    known = {"conv1", "bn1", "fc"}
    for stage, n_blocks in enumerate(_RESNET_BLOCKS[arch], start=1):
        for b in range(n_blocks):
            src, ours = f"layer{stage}.{b}", f"{block_name}_{flat}"
            for c in range(1, n_convs + 1):
                _set(out, f"{ours}.Conv_{c - 1}.weight", _f32(sd[f"{src}.conv{c}.weight"]))
                _bn(sd, f"{src}.bn{c}", out, f"{ours}.BatchNorm_{c - 1}")
            if f"{src}.downsample.0.weight" in sd:
                _set(out, f"{ours}.Conv_{n_convs}.weight",
                     _f32(sd[f"{src}.downsample.0.weight"]))
                _bn(sd, f"{src}.downsample.1", out, f"{ours}.BatchNorm_{n_convs}")
            known |= {f"{src}.conv{c}" for c in range(1, n_convs + 1)}
            known |= {f"{src}.bn{c}" for c in range(1, n_convs + 1)}
            known |= {f"{src}.downsample.0", f"{src}.downsample.1"}
            flat += 1
    _set(out, "Dense_0.weight", _f32(sd["fc.weight"]))
    _set(out, "Dense_0.bias", _f32(sd["fc.bias"]))
    # Every module in the file must be consumed: a resnet34 .pth imported as
    # resnet18 has every resnet18 key at the right shape and would
    # otherwise silently drop 9 trained blocks.
    extra = sorted({k.rsplit(".", 1)[0] for k in sd} - known)
    if extra:
        raise ValueError(f"state_dict has modules {arch} does not ({extra[:5]}…) — wrong --arch?")
    return out


def load_pth(path: str) -> dict[str, Any]:
    """Read a ``.pth`` file the way the reference wrote it (CPU map,
    tensors only)."""
    return torch.load(path, map_location="cpu", weights_only=True)
