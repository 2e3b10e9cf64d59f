"""A CNN's step-1 gradients on one GPU against the CPU, by conv backend.

    python3 deeplearning_mpi_tpu_torch/cli/probe_cnn.py [--model unet|resnet18] [--batch N]
        [--size S] [--out FILE]

Builds the full-width model (the UNet of ``train_unet``'s defaults at
``--size`` x ``--size``, or ResNet-18 with the imagenet stem at 32x32) from
seed 42, takes ``--batch`` synthetic images and targets, and runs one
train-mode forward and backward (the trainer's loss) in float32 with TF32
off on the CPU and on the card three times: cuDNN as PyTorch picks it,
cuDNN restricted to deterministic algorithms, and cuDNN off (PyTorch's own
CUDA convolutions). For each card run it prints the relative L2 error of
every top-level module's output and of every parameter's gradient against
the CPU's (the worst six and the median). Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def _run(model, task, batch, device):
    """Outputs of the model's top-level modules and the parameter gradients."""
    import torch

    from deeplearning_mpi_tpu_torch.train.trainer import _INPUTS, _loss_fn

    model = copy.deepcopy(model).to(device).train()
    acts = {}
    for name, module in model.named_children():
        module.register_forward_hook(
            lambda m, i, o, name=name: acts.__setitem__(name, o.detach().double().cpu()))
    batch = {k: v.to(device) for k, v in batch.items()}
    loss = _loss_fn(task)(model(batch[_INPUTS[task]]), batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return acts, [g.double().cpu() for g in grads]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="unet", choices=("unet", "resnet18"))
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--size", type=int, default=256, help="UNet image size")
    parser.add_argument("--out", default=None, help="also write the result JSON here")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from deeplearning_mpi_tpu_torch.data import SyntheticCIFAR10, SyntheticShapesDataset
    from deeplearning_mpi_tpu_torch.data.cifar10 import eval_transform
    from deeplearning_mpi_tpu_torch.models import UNet, resnet18

    if not torch.cuda.is_available():
        print("probe_cnn: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.model == "unet":
        task, model = "segmentation", UNet(device="cpu").init_weights(42)
        ds = SyntheticShapesDataset(args.batch, size=args.size, seed=1)
        rows = [ds[i] for i in range(args.batch)]
        batch = {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in rows[0]}
    else:
        task, model = "classification", resnet18(device="cpu").init_weights(42)
        ds = SyntheticCIFAR10(args.batch, seed=1)
        rows = [ds[i] for i in range(args.batch)]
        stacked = eval_transform({k: np.stack([r[k] for r in rows]) for k in rows[0]})
        batch = {k: torch.from_numpy(v) for k, v in stacked.items()}
    names = [n for n, _ in model.named_parameters()]
    cpu_acts, cpu_grads = _run(model, task, batch, "cpu")
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp(min=1e-30))  # noqa: E731
    result = {"model": args.model, "batch": args.batch, "card": torch.cuda.get_device_name(0),
              "runs": {}}
    for label, flags in (("cudnn", {}), ("cudnn_deterministic", {"deterministic": True}),
                         ("cudnn_off", {"enabled": False})):
        for key, value in {"enabled": True, "deterministic": False, **flags}.items():
            setattr(torch.backends.cudnn, key, value)
        acts, grads = _run(model, task, batch, "cuda")
        fwd = {n: rel(acts[n], cpu_acts[n]) for n in cpu_acts}
        grad = {n: rel(a, b) for n, a, b in zip(names, grads, cpu_grads)}
        worst = sorted(grad, key=grad.get)[-6:]
        result["runs"][label] = {"forward": fwd, "grad_worst": {n: grad[n] for n in worst},
                                 "grad_median": sorted(grad.values())[len(grad) // 2]}
        print(f"{label}: forward relative L2 by module, max {max(fwd.values()):.2e} "
              f"({max(fwd, key=fwd.get)})", flush=True)
        print(f"{label}: gradients relative L2, median {result['runs'][label]['grad_median']:.2e}, "
              f"worst {[(n, f'{grad[n]:.2e}') for n in worst]}", flush=True)
    torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = True, False
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
