"""CIFAR-10 dataset + augmentations (numpy, on the host).

The port's own copy of ``deeplearning_mpi_tpu/data/cifar10.py``: the
``cifar-10-batches-py`` pickles (:class:`CIFAR10`), the hermetic
:class:`SyntheticCIFAR10`, and the vectorized batch transforms
RandomCrop(32, padding 4) + RandomHorizontalFlip + normalization. The
transforms draw from the ``Generator`` in the reference's order (crop rows,
crop columns, then flips), so equal seeds give equal crops and flips.

Layout is NHWC uint8 on the host; normalization to float32 happens in the
batch transform so the host-to-device copy moves 4x fewer bytes.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

# torchvision's standard CIFAR-10 normalization constants (main.py:84-86 uses
# (0.4914, 0.4822, 0.4465) / (0.2023, 0.1994, 0.2010)).
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


class CIFAR10:
    """CIFAR-10 from the standard ``cifar-10-batches-py`` directory.

    Examples are ``{"image": uint8 [32,32,3], "label": int32 []}``.
    """

    def __init__(self, data_dir: str | Path, *, train: bool = True) -> None:
        batch_dir = Path(data_dir) / "cifar-10-batches-py"
        if not batch_dir.is_dir():
            raise FileNotFoundError(
                f"{batch_dir} not found. Bring cifar-10-python.tar.gz in and ingest it with "
                "`python -m deeplearning_mpi_tpu_torch.cli.download cifar10 --from_file ...`, "
                "or use SyntheticCIFAR10 (--synthetic)."
            )
        names = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        images, labels = [], []
        for name in names:
            with open(batch_dir / name, "rb") as f:
                entry = pickle.load(f, encoding="latin1")
            images.append(entry["data"])
            labels.extend(entry["labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = np.ascontiguousarray(data.transpose(0, 2, 3, 1))  # NHWC
        self.labels = np.asarray(labels, np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        return {"image": self.images[index], "label": self.labels[index]}


class SyntheticCIFAR10:
    """Deterministic fake CIFAR-10 with learnable structure.

    Each class gets a fixed random 32×32×3 template; examples are the template
    plus noise, so a real classifier can overfit it — which makes end-to-end
    "loss goes down / accuracy goes up" tests meaningful without any dataset
    on disk (the original repo downloads CIFAR-10 once before a job,
    ``resnet/download.py``; the port never downloads).
    """

    def __init__(self, n: int = 512, *, num_classes: int = 10, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self.templates = rng.integers(
            0, 256, size=(num_classes, 32, 32, 3)
        ).astype(np.float32)
        self.labels = rng.integers(0, num_classes, size=n).astype(np.int32)
        self.noise_seeds = rng.integers(0, 2**31, size=n)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.noise_seeds[index])
        img = self.templates[self.labels[index]] + rng.normal(0, 16, (32, 32, 3))
        return {
            "image": np.clip(img, 0, 255).astype(np.uint8),
            "label": self.labels[index],
        }


def train_transform(
    batch: dict[str, np.ndarray], rng: np.random.Generator, *, flip: bool = True
) -> dict[str, np.ndarray]:
    """RandomCrop(32, padding=4) + RandomHorizontalFlip + normalize.

    Vectorized parity with the reference's torchvision train transform
    (``pytorch/resnet/main.py:82-87``), applied to a whole uint8 batch.
    ``flip=False`` drops the horizontal flip for datasets whose classes are
    not mirror-invariant (e.g. digits/characters — a mirrored 3 is not a 3);
    CIFAR classes are, so the default matches the reference.
    """
    images = batch["image"]
    n, h, w, c = images.shape
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="constant")
    ys = rng.integers(0, 9, size=n)
    xs = rng.integers(0, 9, size=n)
    windows = np.lib.stride_tricks.sliding_window_view(padded, (h, w), axis=(1, 2))
    cropped = windows[np.arange(n), ys, xs].transpose(0, 2, 3, 1)
    if flip:
        flipped = rng.random(n) < 0.5
        cropped[flipped] = cropped[flipped, :, ::-1]
    return {"image": _normalize(cropped), "label": batch["label"]}


def eval_transform(
    batch: dict[str, np.ndarray], rng: np.random.Generator | None = None
) -> dict[str, np.ndarray]:
    """Normalize only — parity with the reference's test transform
    (``pytorch/resnet/main.py:88``)."""
    return {"image": _normalize(batch["image"]), "label": batch["label"]}


def _normalize(images_u8: np.ndarray) -> np.ndarray:
    x = images_u8.astype(np.float32) / 255.0
    return (x - CIFAR10_MEAN) / CIFAR10_STD
