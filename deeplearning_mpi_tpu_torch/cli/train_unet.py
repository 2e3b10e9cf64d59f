"""Data-parallel UNet binary semantic segmentation (2-D, or 3-D volumes).

Port of ``deeplearning_mpi_tpu/cli/train_unet.py``, the original repo's
second workload: the UNet of 64/128/256/512 features and a 1024-wide
bottleneck, Adam 1e-4 with clip 1.0, BCE on logits (``--loss dice`` and
``bce_dice`` as the reference offers), a non-finite loss skipping the step,
an 80/20 split under the seed, and Dice eval and checkpoint every
``--eval_every`` epochs. The flags and defaults are the JAX CLI's (epochs
100, global batch 16, seed 42, ``--scale 0.2``, ``--bilinear``,
``--reference_topology``, ``--volumetric``, ``--remat``, ``--synthetic``,
``--image_size``, ``--val_fraction``), plus ``--device`` and ``--nproc``.
Data parallelism as ``cli/train_resnet.py``.

    python -m deeplearning_mpi_tpu_torch.cli.train_unet --synthetic --image_size 256
    python -m deeplearning_mpi_tpu_torch.cli.train_unet --device cpu --nproc 2 --synthetic \\
        --num_epochs 1 --batch_size 4 --train_samples 20 --image_size 32

Real data: ``--data_dir`` with ``images/`` and ``masks/`` (Pillow needed).
Resilience (``--max_restarts``, ``--restart_delay_s``, ``--chaos``,
``--guardrails``, ``--digest_every``) as ``cli/train_lm.py``'s.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.utils import config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="train_unet", description=__doc__.split("\n")[0])
    config.add_topology_flags(parser)
    config.add_training_flags(parser, num_epochs=100, batch_size=16, learning_rate=1e-4,
                              random_seed=42, model_filename="unet_distributed")
    parser.add_argument("--data_dir", default="data", help="dir with images/ and masks/ subdirs")
    parser.add_argument("--scale", type=float, default=0.2, help="image downscale factor")
    parser.add_argument("--mask_suffix", default="", help="mask filename suffix, e.g. _mask")
    parser.add_argument("--bilinear", action="store_true",
                        help="bilinear upsampling instead of transposed conv")
    parser.add_argument("--reference_topology", action="store_true",
                        help="the original repo's decoder channel plan")
    parser.add_argument("--val_fraction", type=float, default=0.2, help="held-out fraction")
    parser.add_argument("--clip_norm", type=float, default=1.0)
    parser.add_argument("--loss", default="bce", choices=("bce", "dice", "bce_dice"))
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic ellipse-segmentation data")
    parser.add_argument("--train_samples", type=int, default=256)
    parser.add_argument("--image_size", type=int, default=64, help="synthetic image size")
    parser.add_argument("--volumetric", action="store_true",
                        help="3-D UNet on [D,H,W,1] synthetic ellipsoid volumes")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each DoubleConv in the backward")
    return parser


class _Subset:
    def __init__(self, dataset, indices) -> None:
        self.dataset, self.indices = dataset, indices

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]


def build_model(args: argparse.Namespace, device):
    """The flags' UNet on ``device``, seeded by ``--random_seed``."""
    from deeplearning_mpi_tpu_torch.models import UNet

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return UNet(out_classes=1, bilinear=args.bilinear, dtype=dtype,
                spatial_dims=3 if args.volumetric else 2, remat=args.remat,
                reference_topology=args.reference_topology,
                in_channels=1 if args.volumetric else 3, device=device).init_weights(args.random_seed)


def build(argv: list[str] | None = None) -> config.Run:
    """Parse ``argv``, join the group and build the run (not yet run)."""
    args = build_parser().parse_args(argv)
    config.reject_unported(args)
    from deeplearning_mpi_tpu_torch.data import (
        Loader,
        SegmentationFolderDataset,
        SyntheticShapesDataset,
        SyntheticVolumesDataset,
    )
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_rank, data_size

    topo, mesh, group = config.setup_runtime(args)
    from deeplearning_mpi_tpu_torch.resilience.supervisor import preflight

    preflight(data_dir=None if (args.synthetic or args.volumetric) else args.data_dir,
              model_dir=args.model_dir, log_dir=args.log_dir,
              global_batch_size=args.batch_size, mesh=mesh, grad_accum=args.grad_accum)
    device = topo.device
    if args.volumetric:
        full = SyntheticVolumesDataset(args.train_samples, size=args.image_size,
                                       seed=args.random_seed)
    elif args.synthetic:
        full = SyntheticShapesDataset(args.train_samples, size=args.image_size,
                                      seed=args.random_seed)
    else:
        full = SegmentationFolderDataset(f"{args.data_dir}/images", f"{args.data_dir}/masks",
                                         scale=args.scale, mask_suffix=args.mask_suffix)
    # The split is the same permutation on every process.
    order = np.random.default_rng(args.random_seed).permutation(len(full))
    n_val = max(int(len(full) * args.val_fraction), 1)
    train_ds, eval_ds = _Subset(full, order[n_val:]), _Subset(full, order[:n_val])
    ranks = {"num_replicas": data_size(mesh), "rank": data_rank(mesh)}
    train_loader = Loader(train_ds, args.batch_size, shuffle=True, seed=args.random_seed,
                          device=device, grad_accum=args.grad_accum,
                          num_workers=args.num_workers, **ranks)
    # drop_last=False: a small validation set wrap-pads to one full batch.
    eval_loader = Loader(eval_ds, args.batch_size, shuffle=False, drop_last=False,
                         device=device, num_workers=args.num_workers, **ranks)
    model = build_model(args, device)
    tx = config.build_optimizer_from_flags(args, train_loader, clip_norm=args.clip_norm)
    run = config.build_run(args, topo, group, task="segmentation", model=model, tx=tx,
                           train_loader=train_loader, eval_loader=eval_loader,
                           model_factory=lambda: build_model(args, device),
                           seg_loss=args.loss)
    n_params = sum(p.numel() for p in model.parameters())
    run.trainer.log(
        f"train_unet: {n_params} params, {len(train_ds)} train / {len(eval_ds)} eval "
        f"{'volumes' if args.volumetric else 'images'}, global batch {args.batch_size} over "
        f"{topo.num_processes} process(es) ({topo.backend or 'no group'}), "
        f"{train_loader.steps_per_epoch()} steps/epoch, loss {args.loss}, {args.dtype}, "
        f"on {device}")
    # Analytic train FLOPs -> MFU; a folder's non-square images count as the
    # square (cube) of the same pixel (voxel) count, as the reference does.
    from deeplearning_mpi_tpu_torch.telemetry.flops import unet_train_flops

    dim = 3 if args.volumetric else 2
    if args.volumetric:
        sample_hw = (args.image_size,) * 3
    elif args.synthetic:
        sample_hw = (args.image_size, args.image_size)
    else:
        sample_hw = full[0]["image"].shape[:2]
    voxels = 1.0
    for size in sample_hw:
        voxels *= float(size)
    config.build_observability(args, run.trainer, flops_per_step=unet_train_flops(
        args.batch_size, voxels ** (1.0 / dim), in_channels=1 if args.volumetric else 3,
        out_channels=1, dim=dim))
    return run


def train(argv: list[str] | None = None):
    """Build the run and train (or evaluate); returns the ``Trainer``."""
    return config.execute(build(argv))


def main(argv: list[str] | None = None) -> int:
    return config.cli_main("deeplearning_mpi_tpu_torch.cli.train_unet",
                           build_parser().parse_args, train, argv)


if __name__ == "__main__":
    sys.exit(main())
