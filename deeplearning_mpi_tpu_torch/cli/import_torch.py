"""Convert a reference PyTorch ``.pth`` checkpoint into a port checkpoint
that ``--resume`` / ``--eval_only`` restore.

    python -m deeplearning_mpi_tpu_torch.cli.import_torch --arch unet --input unet_distributed.pth \\
        --model_dir saved_models
    python -m deeplearning_mpi_tpu_torch.cli.train_unet --resume --reference_topology \\
        --model_dir saved_models ...
    python -m deeplearning_mpi_tpu_torch.cli.import_torch --arch resnet18 --input resnet.pth \\
        --model_dir saved_models --device cpu
    python -m deeplearning_mpi_tpu_torch.cli.train_resnet --resume --torch_padding \\
        --model_dir saved_models ...

Port of ``deeplearning_mpi_tpu/cli/import_torch.py``. It reads the file
(``utils.torch_import.load_pth``), maps it onto the port's model
(``convert_reference_unet`` / ``convert_torchvision_resnet``), and writes a
``Checkpointer`` step of a fresh ``TrainState``: the imported parameters
and BatchNorm statistics, the optimizer state that the matching trainer's
parser defaults build (the reference never saved optimizer state), step 0,
under ``--model_dir/--model_filename`` at epoch ``--epoch``. A file whose
shapes differ from a fresh model of the flags (a head width, a bilinear
decoder) is refused, listing the mismatched leaves. The model is built on
``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any


def build_parser() -> argparse.ArgumentParser:
    from deeplearning_mpi_tpu_torch.utils.config import add_not_applicable

    parser = argparse.ArgumentParser(prog="import_torch", description=__doc__.split("\n")[0])
    parser.add_argument("--input", required=True, help="path to the .pth file")
    parser.add_argument("--arch", required=True,
                        choices=["unet", "resnet18", "resnet34", "resnet50", "resnet101",
                                 "resnet152"])
    parser.add_argument("--model_dir", default="saved_models")
    parser.add_argument("--model_filename", default=None,
                        help="checkpoint name (default: the matching trainer's default, so "
                        "--resume finds it)")
    parser.add_argument("--epoch", type=int, default=0,
                        help="epoch label for the checkpoint (the .pth carries none)")
    parser.add_argument("--num_classes", type=int, default=10,
                        help="resnet head width (reference: 10, main.py:41)")
    parser.add_argument("--out_classes", type=int, default=1,
                        help="unet head channels (reference default 2, run.sh trains 1)")
    parser.add_argument("--bilinear", action="store_true",
                        help="the .pth came from up_sample_mode='bilinear'")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    add_not_applicable(parser, "platform")
    return parser


def build_target(args: argparse.Namespace, device: Any) -> tuple[Any, Any, str]:
    """The port model the flags describe (uninitialised: the import fills
    it), the optimizer the matching trainer's parser defaults build (its
    state tree must equal the restore template that trainer builds), and
    that trainer's default checkpoint name."""
    from deeplearning_mpi_tpu_torch.train.trainer import build_optimizer
    from deeplearning_mpi_tpu_torch.utils import config

    if args.arch == "unet":
        from deeplearning_mpi_tpu_torch.cli import train_unet
        from deeplearning_mpi_tpu_torch.models import UNet

        model = UNet(out_classes=args.out_classes, bilinear=args.bilinear,
                     reference_topology=True, device=device)
        d = train_unet.build_parser().parse_args([])
        tx = build_optimizer(d.optimizer, config.build_lr(d, 1), clip_norm=d.clip_norm)
    else:
        from deeplearning_mpi_tpu_torch.cli import train_resnet
        from deeplearning_mpi_tpu_torch.models import get_model

        model = get_model(args.arch, num_classes=args.num_classes, stem="imagenet",
                          torch_padding=True, device=device)
        d = train_resnet.build_parser().parse_args([])
        tx = build_optimizer(d.optimizer, config.build_lr(d, 1), momentum=d.momentum,
                             weight_decay=d.weight_decay)
    return model, tx, d.model_filename


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from deeplearning_mpi_tpu_torch import resolve_device
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_mpi_tpu_torch.utils import torch_import

    device = resolve_device(args.device)
    state_dict = torch_import.load_pth(args.input)
    imported = (torch_import.convert_reference_unet(state_dict) if args.arch == "unet"
                else torch_import.convert_torchvision_resnet(state_dict, args.arch))
    model, tx, default_name = build_target(args, device)
    # Shapes, not just names: a head-width mismatch (a .pth trained at the
    # reference's default out_classes=2 imported without --out_classes 2)
    # has the same names and would otherwise fail later, opaquely.
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in imported.items()}
    if want != got:
        diffs = sorted(k for k in want.keys() | got.keys() if want.get(k) != got.get(k))
        raise SystemExit(
            f"imported param shapes do not match a fresh {args.arch} init —\nmodel flags "
            f"(--out_classes/--num_classes/--bilinear) probably disagree with how the .pth "
            f"was trained.\nmismatched leaves: {diffs[:8]}")
    model.load_state_dict(imported, strict=True)
    state = create_train_state(model, tx)
    name = args.model_filename or default_name
    Checkpointer(f"{args.model_dir}/{name}").save(state, epoch=args.epoch)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"imported {args.arch} ({n_params:,} params) from {args.input} -> "
          f"{args.model_dir}/{name} @ epoch {args.epoch} on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
