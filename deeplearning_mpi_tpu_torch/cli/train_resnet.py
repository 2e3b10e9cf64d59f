"""Data-parallel ResNet image classification on CIFAR-10.

Port of ``deeplearning_mpi_tpu/cli/train_resnet.py``, the original repo's
first workload: ResNet-18 with a 10-class head, SGD momentum 0.9 / weight
decay 1e-5, cross-entropy, per-epoch mean loss, eval (accuracy) and
checkpoint every ``--eval_every`` epochs. The flags and defaults are the
JAX CLI's (epochs 100, global batch 128, lr 0.1, seed 0, ``--arch``,
``--stem``, ``--torch_padding``, ``--synthetic``), plus ``--device`` and
``--nproc``.

One process a device: on ``cuda`` over NCCL, on ``cpu`` over gloo. Each
rank trains on its rows of every global batch, BatchNorm's statistics and
the gradient mean span the data group (``train/trainer.py``), and rank 0
logs and writes the checkpoints.

    python -m deeplearning_mpi_tpu_torch.cli.train_resnet --synthetic          # one card
    torchrun --nproc_per_node 8 -m deeplearning_mpi_tpu_torch.cli.train_resnet --synthetic
    python -m deeplearning_mpi_tpu_torch.cli.train_resnet --device cpu --nproc 2 --synthetic \\
        --num_epochs 1 --batch_size 8 --train_samples 32

``--arch vit_tiny`` / ``vit_small`` trains the ViT family
(``models/vit.py``) on the same data and trainer; ``--torch_padding`` is a
CNN flag and is refused with it, as in the reference.

Real data: ``--data_dir`` holding ``cifar-10-batches-py`` (``cli.download
cifar10 --from_file``). Not ported yet: the native C++ transforms and the
flags ``reject_unported`` names.
"""

from __future__ import annotations

import argparse
import sys

import torch

from deeplearning_mpi_tpu_torch.utils import config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="train_resnet", description=__doc__.split("\n")[0])
    config.add_topology_flags(parser)
    config.add_training_flags(parser, num_epochs=100, batch_size=128, learning_rate=0.1,
                              random_seed=0, model_filename="resnet_distributed",
                              optimizer="sgd", weight_decay=1e-5)
    parser.add_argument("--arch", default="resnet18",
                        choices=["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                                 "vit_tiny", "vit_small"])
    parser.add_argument("--stem", default="imagenet", choices=["imagenet", "cifar"])
    parser.add_argument("--torch_padding", action="store_true",
                        help="torch's symmetric padding on strided convs")
    parser.add_argument("--data_dir", default="data", help="dir containing cifar-10-batches-py")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic CIFAR-like data (no dataset needed)")
    parser.add_argument("--train_samples", type=int, default=2048, help="synthetic dataset size")
    parser.add_argument("--momentum", type=float, default=0.9)
    return parser


def build_model(args: argparse.Namespace, device):
    """The flags' ResNet or ViT on ``device``, seeded by ``--random_seed``."""
    from deeplearning_mpi_tpu_torch.models import get_model

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    kw = {} if args.arch.startswith("vit") else {"torch_padding": args.torch_padding}
    return get_model(args.arch, num_classes=10, stem=args.stem, dtype=dtype, device=device,
                     **kw).init_weights(args.random_seed)


def build(argv: list[str] | None = None) -> config.Run:
    """Parse ``argv``, join the group and build the run (not yet run)."""
    args = build_parser().parse_args(argv)
    config.reject_unported(args)
    if args.torch_padding and args.arch.startswith("vit"):
        raise SystemExit("--torch_padding is a CNN numerics flag (strided-conv padding); it "
                         "does not apply to --arch " + args.arch)
    from deeplearning_mpi_tpu_torch.data import CIFAR10, Loader, SyntheticCIFAR10
    from deeplearning_mpi_tpu_torch.data.cifar10 import eval_transform, train_transform
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_rank, data_size

    topo, mesh, group = config.setup_runtime(args)
    device = topo.device
    if args.synthetic:
        train_ds = SyntheticCIFAR10(args.train_samples, seed=args.random_seed)
        eval_ds = SyntheticCIFAR10(max(args.batch_size, args.train_samples // 8),
                                   seed=args.random_seed + 1)
    else:
        train_ds = CIFAR10(args.data_dir, train=True)
        eval_ds = CIFAR10(args.data_dir, train=False)
    ranks = {"num_replicas": data_size(mesh), "rank": data_rank(mesh)}
    train_loader = Loader(train_ds, args.batch_size, shuffle=True, seed=args.random_seed,
                          transform=train_transform, device=device,
                          grad_accum=args.grad_accum, **ranks)
    eval_loader = Loader(eval_ds, args.batch_size, shuffle=False, drop_last=False,
                         transform=eval_transform, device=device, **ranks)
    model = build_model(args, device)
    tx = config.build_optimizer_from_flags(args, train_loader, momentum=args.momentum)
    run = config.build_run(args, topo, group, task="classification", model=model, tx=tx,
                           train_loader=train_loader, eval_loader=eval_loader)
    n_params = sum(p.numel() for p in model.parameters())
    run.trainer.log(
        f"train_resnet: {args.arch}{'' if args.arch.startswith('vit') else f' ({args.stem} stem)'}"
        f", {n_params} params, {len(train_ds)} train / "
        f"{len(eval_ds)} eval images, global batch {args.batch_size} over {topo.num_processes} "
        f"process(es) ({topo.backend or 'no group'}), {train_loader.steps_per_epoch()} "
        f"steps/epoch, {args.dtype}, on {device}")
    return run


def train(argv: list[str] | None = None):
    """Build the run and train (or evaluate); returns the ``Trainer``."""
    return config.execute(build(argv))


def main(argv: list[str] | None = None) -> int:
    return config.cli_main("deeplearning_mpi_tpu_torch.cli.train_resnet",
                           build_parser().parse_args, train, argv)


if __name__ == "__main__":
    sys.exit(main())
