"""Segmentation datasets: Carvana-style image/mask folders + synthetic shapes.

The port's own copy of ``deeplearning_mpi_tpu/data/segmentation.py``:
index image ids from a directory, pair each image with its mask by filename
stem, rescale by ``scale`` (NEAREST for masks, BICUBIC for images),
normalize images to [0, 1] and binarize masks; and the hermetic synthetic
ellipse (2-D) and ellipsoid (3-D) datasets, which need numpy only. Pillow
is imported by the folder dataset alone, when it opens a file.

NHWC float32; a mask is ``[H, W]`` float32 in {0, 1}.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_IMAGE_SUFFIXES = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff"}


def load_image(path: Path):
    """Open one image as a ``PIL.Image`` (``.npy`` files through numpy)."""
    from PIL import Image

    if path.suffix == ".npy":
        return Image.fromarray(np.load(path))
    return Image.open(path)


class SegmentationFolderDataset:
    """Image/mask folder pairs, matched by stem, scaled and binarized.

    Parity with ``BasicDataset(images_dir, mask_dir, scale, mask_suffix)``
    (``data_loading.py:52-129``): every image must have exactly one mask named
    ``<stem><mask_suffix>.*`` and matching pre-scale dimensions; ``scale``
    in (0, 1] resizes both.
    """

    def __init__(
        self,
        images_dir: str | Path,
        mask_dir: str | Path,
        scale: float = 1.0,
        mask_suffix: str = "",
    ) -> None:
        if not 0 < scale <= 1:
            raise ValueError("scale must be in (0, 1]")  # data_loading.py:56
        self.images_dir = Path(images_dir)
        self.mask_dir = Path(mask_dir)
        self.scale = scale
        self.mask_suffix = mask_suffix
        self.ids = sorted(
            p.stem
            for p in self.images_dir.iterdir()
            if p.suffix.lower() in _IMAGE_SUFFIXES or p.suffix in (".npy",)
        )
        if not self.ids:
            raise RuntimeError(
                f"no input images in {images_dir}"  # data_loading.py:62
            )

    def __len__(self) -> int:
        return len(self.ids)

    def _find(self, directory: Path, stem: str) -> Path:
        matches = list(directory.glob(stem + ".*"))
        if len(matches) != 1:
            raise AssertionError(
                f"expected exactly one file for id {stem} in {directory}, "
                f"found {len(matches)}"  # data_loading.py:112-114
            )
        return matches[0]

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        stem = self.ids[index]
        image = load_image(self._find(self.images_dir, stem))
        mask = load_image(self._find(self.mask_dir, stem + self.mask_suffix))
        if image.size != mask.size:
            raise AssertionError(
                f"image and mask {stem} sizes differ: {image.size} vs {mask.size}"
            )  # data_loading.py:115-118
        w, h = image.size
        new_w, new_h = int(w * self.scale), int(h * self.scale)
        if new_w <= 0 or new_h <= 0:
            raise AssertionError("scaled size is zero")  # data_loading.py:83
        from PIL import Image

        image = image.convert("RGB").resize((new_w, new_h), Image.BICUBIC)
        mask = mask.resize((new_w, new_h), Image.NEAREST)  # data_loading.py:85-87
        image_arr = np.asarray(image, np.float32) / 255.0  # [0,1], :95-99
        mask_arr = (np.asarray(mask, np.float32) > 0).astype(np.float32)  # binarize, :121-127
        if mask_arr.ndim == 3:
            mask_arr = mask_arr[..., 0]
        return {"image": image_arr, "mask": mask_arr}


class CarvanaDataset(SegmentationFolderDataset):
    """Parity with ``CarvanaDataset`` — masks named ``<id>_mask``
    (``data_loading.py:132-134``)."""

    def __init__(self, images_dir, mask_dir, scale: float = 1.0) -> None:
        super().__init__(images_dir, mask_dir, scale, mask_suffix="_mask")


class SyntheticShapesDataset:
    """Deterministic random-ellipse masks — a learnable segmentation task.

    Hermetic stand-in for the Fluorescent Neuronal Cells data the reference
    ships docs for (``pytorch/unet/data/README.md:1-9``): each example is a
    noisy image containing a bright ellipse; the mask marks the ellipse. A
    UNet can genuinely learn it, so e2e Dice tests mean something.
    """

    def __init__(self, n: int = 64, *, size: int = 64, seed: int = 0) -> None:
        self.size = size
        rng = np.random.default_rng(seed)
        self.item_seeds = rng.integers(0, 2**31, size=n)

    def __len__(self) -> int:
        return len(self.item_seeds)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.item_seeds[index])
        s = self.size
        cy, cx = rng.uniform(0.25 * s, 0.75 * s, 2)
        ry, rx = rng.uniform(0.1 * s, 0.25 * s, 2)
        yy, xx = np.mgrid[0:s, 0:s]
        mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.float32)
        image = rng.normal(0.3, 0.08, (s, s, 3)).astype(np.float32)
        image += mask[..., None] * rng.uniform(0.3, 0.5)
        return {"image": np.clip(image, 0, 1), "mask": mask}


class SyntheticVolumesDataset:
    """Deterministic random-ellipsoid 3-D masks — the volumetric analog of
    :class:`SyntheticShapesDataset`, feeding the 3-D UNet (BASELINE.md config
    ladder #5; no reference analog — its data is 2-D microscopy,
    ``pytorch/unet/data/README.md:1-9``). Examples:
    ``{"image": [D, H, W, 1] float32, "mask": [D, H, W] float32}``.
    """

    def __init__(self, n: int = 32, *, size: int = 32, seed: int = 0) -> None:
        self.size = size
        rng = np.random.default_rng(seed)
        self.item_seeds = rng.integers(0, 2**31, size=n)

    def __len__(self) -> int:
        return len(self.item_seeds)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.item_seeds[index])
        s = self.size
        cz, cy, cx = rng.uniform(0.25 * s, 0.75 * s, 3)
        rz, ry, rx = rng.uniform(0.12 * s, 0.25 * s, 3)
        zz, yy, xx = np.mgrid[0:s, 0:s, 0:s]
        mask = (
            ((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            <= 1
        ).astype(np.float32)
        image = rng.normal(0.3, 0.08, (s, s, s, 1)).astype(np.float32)
        image += mask[..., None] * rng.uniform(0.3, 0.5)
        return {"image": np.clip(image, 0, 1), "mask": mask}
