"""``.pth`` import into the port (``utils/torch_import.py``, ``cli.import_torch``)
against the JAX package's importer and a functional oracle.

The state dicts are written from seeded numpy tensors under torchvision's
ResNet-18 key names (with DDP's ``module.`` prefix) and the reference
UNet's (``pytorch/unet/model.py``), at narrow widths. On the same file:

- the port's ResNet-18 (``torch_padding=True``) and ``UNet(reference_topology
  =True)`` restored through the port's converters give eval logits within
  the port's CNN tolerance (``ATOL = 1e-5``, ``tests/test_torch_cnn.py``) of
  the JAX package's models restored through ``convert_*``, and of a
  functional oracle (``F.conv2d`` / ``F.batch_norm`` /
  ``F.conv_transpose2d`` over the raw state dict);
- ``cli.import_torch`` writes a checkpoint that ``train_resnet --eval_only``
  and ``train_unet --eval_only`` restore and evaluate on the CPU;
- a mismatched head width is refused, listing the mismatched leaves.

Tightened first: the UNet import without its conv-bias fold misses the
oracle by far more than ``ATOL``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu_torch.utils import torch_import
from torch_pth_fixtures import WIDTHS, oracle_resnet18, oracle_unet, resnet18_sd, unet_sd

torch.set_num_threads(1)

ATOL = 1e-5


def _port_resnet(sd):
    from deeplearning_mpi_tpu_torch.models.resnet import resnet18

    m = resnet18(num_classes=10, num_filters=16, torch_padding=True, device="cpu")
    m.load_state_dict(torch_import.convert_torchvision_resnet(sd, "resnet18"), strict=True)
    return m.eval()


def _port_unet(sd):
    from deeplearning_mpi_tpu_torch.models.unet import UNet

    m = UNet(out_classes=1, features=WIDTHS, reference_topology=True, device="cpu")
    m.load_state_dict(torch_import.convert_reference_unet(sd), strict=True)
    return m.eval()


def _images(seed, size):
    return np.random.default_rng(seed).normal(size=(2, size, size, 3)).astype(np.float32)


def _close(got, want):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    return err <= ATOL, err


def test_resnet18_matches_jax_import_and_oracle():
    import jax.numpy as jnp

    from deeplearning_mpi_tpu.models.resnet import resnet18 as jax_resnet18
    from deeplearning_mpi_tpu.utils.torch_import import convert_torchvision_resnet

    sd = {f"module.{k}": v for k, v in resnet18_sd().items()}
    x = _images(5, 32)
    with torch.no_grad():
        got = _port_resnet(sd)(torch.from_numpy(x)).numpy()
        oracle = oracle_resnet18(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                 torch_import.strip_ddp_prefix(sd)).numpy()
    variables = convert_torchvision_resnet(sd, "resnet18")
    ref = jax_resnet18(num_classes=10, num_filters=16, torch_padding=True).apply(
        variables, jnp.asarray(x), train=False)
    for want in (oracle, np.asarray(ref)):
        ok, err = _close(got, want)
        assert ok, err


def test_unet_matches_jax_import_and_oracle():
    import jax.numpy as jnp

    from deeplearning_mpi_tpu.models.unet import UNet as JaxUNet
    from deeplearning_mpi_tpu.utils.torch_import import convert_reference_unet

    sd = unet_sd()
    x = _images(1, 16)
    with torch.no_grad():
        got = _port_unet(sd)(torch.from_numpy(x)).numpy()
        oracle = oracle_unet(torch.from_numpy(x.transpose(0, 3, 1, 2)), sd).numpy()
    ref = JaxUNet(out_classes=1, features=WIDTHS, reference_topology=True).apply(
        convert_reference_unet(sd), jnp.asarray(x), train=False)
    for want in (oracle.transpose(0, 2, 3, 1), np.asarray(ref)):
        ok, err = _close(got, want)
        assert ok, err


def test_unet_without_its_bias_fold_is_caught(monkeypatch):
    """The bar rejects the wrong copy: dropping the conv-bias fold into the
    running mean moves the logits far past ``ATOL``."""
    sd = unet_sd()
    x = _images(1, 16)

    def no_fold(sd, src, out, dst, *, mean_shift=None):
        return bn(sd, src, out, dst)

    bn = torch_import._bn
    monkeypatch.setattr(torch_import, "_bn", no_fold)
    with torch.no_grad():
        got = _port_unet(sd)(torch.from_numpy(x)).numpy()
        oracle = oracle_unet(torch.from_numpy(x.transpose(0, 3, 1, 2)), sd).numpy()
    ok, err = _close(got, oracle.transpose(0, 2, 3, 1))
    assert not ok and err > 100 * ATOL


def test_conversion_refusals():
    sd = resnet18_sd()
    with pytest.raises(ValueError, match="unknown arch"):
        torch_import.convert_torchvision_resnet(sd, "resnet19")
    sd["layer1.2.conv1.weight"] = torch.zeros(16, 16, 3, 3)
    with pytest.raises(ValueError, match="wrong --arch"):
        torch_import.convert_torchvision_resnet(sd, "resnet18")
    u = unet_sd()
    u["surprise.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unrecognized"):
        torch_import.convert_reference_unet(u)
    with pytest.raises(ValueError, match="mixes"):
        torch_import.strip_ddp_prefix({"module.a": 1, "b": 2})
    assert torch_import.strip_ddp_prefix({"module.a.w": 1}) == {"a.w": 1}


@pytest.mark.parametrize("arch", ["resnet18", "unet"])
def test_import_cli_then_eval_only(arch, tmp_path):
    """The CLI at the trainers' widths: import, then ``--eval_only``
    restores the verified step and evaluates it."""
    from deeplearning_mpi_tpu_torch.cli import import_torch, train_resnet, train_unet

    pth = tmp_path / f"{arch}.pth"
    if arch == "resnet18":
        torch.save({f"module.{k}": v for k, v in resnet18_sd(width=64).items()}, pth)
    else:
        torch.save(unet_sd(widths=(64, 128, 256, 512)), pth)
    assert import_torch.main(["--input", str(pth), "--arch", arch, "--model_dir",
                              str(tmp_path / "ck"), "--device", "cpu"]) == 0
    common = ["--device", "cpu", "--synthetic", "--eval_only", "--model_dir",
              str(tmp_path / "ck"), "--num_workers", "0"]
    if arch == "resnet18":
        trainer = train_resnet.train(common + ["--batch_size", "8", "--train_samples", "16",
                                               "--torch_padding"])
        assert "accuracy" in trainer.history[-1]
    else:
        trainer = train_unet.train(common + ["--batch_size", "2", "--train_samples", "8",
                                             "--image_size", "32", "--reference_topology"])
        assert "dice" in trainer.history[-1]


def test_mismatched_head_width_is_refused(tmp_path):
    from deeplearning_mpi_tpu_torch.cli import import_torch

    pth = tmp_path / "unet2.pth"
    torch.save(unet_sd(widths=(64, 128, 256, 512), out_classes=2), pth)
    with pytest.raises(SystemExit, match=r"shapes do not match(.|\n)*Conv_0\.bias"):
        import_torch.main(["--input", str(pth), "--arch", "unet", "--model_dir",
                           str(tmp_path / "ck"), "--device", "cpu"])
    assert not (tmp_path / "ck").exists()
