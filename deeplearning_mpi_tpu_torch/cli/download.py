"""Dataset check and offline ingest — the step before training on real data.

Port of ``deeplearning_mpi_tpu/cli/download.py`` without its network path:
the port never downloads. ``cifar10 --from_file`` ingests a
``cifar-10-python.tar.gz`` carried in by hand (md5-verified unless ``--md5
none``; extracted with the ``data`` filter, or, where that filter is
missing, only after every member is checked to be a regular file or a
directory with a relative path inside the destination), then checks the
``cifar-10-batches-py`` layout ``data.cifar10.CIFAR10`` reads. ``--check``
validates what is there: the CIFAR pickles, or a Carvana-style
``images/`` + ``masks/`` folder (every image paired with one mask of the
same size; Pillow is needed for the sizes).

    python -m deeplearning_mpi_tpu_torch.cli.download cifar10 --from_file cifar-10-python.tar.gz
    python -m deeplearning_mpi_tpu_torch.cli.download cifar10 --check --data_dir data
    python -m deeplearning_mpi_tpu_torch.cli.download carvana --check --data_dir data
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import tarfile
from pathlib import Path

CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"
_CIFAR_MEMBERS = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]


def _md5(path: Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def check_cifar10(data_dir: Path) -> bool:
    """True iff the ``cifar-10-batches-py`` pickles are all present."""
    batch_dir = data_dir / "cifar-10-batches-py"
    missing = [m for m in _CIFAR_MEMBERS if not (batch_dir / m).is_file()]
    if missing:
        print(f"{batch_dir}: missing {missing}" if batch_dir.is_dir()
              else f"{batch_dir}: not found")
        return False
    print(f"{batch_dir}: complete ({len(_CIFAR_MEMBERS)} batch files)")
    return True


def _unsafe_members(tar: tarfile.TarFile) -> list[str]:
    """Members that are not plain files or directories, or whose path leaves
    the destination."""
    return [m.name for m in tar.getmembers()
            if m.name.startswith(("/", "..")) or ".." in Path(m.name).parts
            or not (m.isfile() or m.isdir())]


def ingest_cifar10(tarball: Path, data_dir: Path, *, md5: str | None = CIFAR10_MD5) -> int:
    """Verify (``md5=None`` skips it) and extract a user-supplied tarball;
    0 when the extracted layout is complete."""
    if not tarball.is_file():
        print(f"{tarball}: not a file", file=sys.stderr)
        return 1
    if md5 is not None:
        digest = _md5(tarball)
        if digest != md5:
            print(f"md5 mismatch: got {digest}, want {md5}", file=sys.stderr)
            return 1
    data_dir.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tarball, "r:*") as tar:
        try:
            tar.extractall(data_dir, filter="data")
        except tarfile.FilterError as e:
            print(f"refusing unsafe tar member: {e}", file=sys.stderr)
            return 1
        except TypeError:  # a Python without extraction filters
            bad = _unsafe_members(tar)
            if bad:
                print(f"refusing unsafe tar members: {bad[:3]}", file=sys.stderr)
                return 1
            tar.extractall(data_dir)  # noqa: S202 — members checked above
    return 0 if check_cifar10(data_dir) else 1


def check_carvana(data_dir: Path, *, mask_suffix: str = "") -> bool:
    """Every image in ``images/`` has exactly one mask ``<stem><suffix>.*`` in
    ``masks/`` with the same pixel size."""
    images, masks = data_dir / "images", data_dir / "masks"
    for d in (images, masks):
        if not d.is_dir():
            print(f"{d}: not found")
            return False
    image_files = sorted(p for p in images.iterdir() if p.is_file())
    if not image_files:
        print(f"{images}: empty")
        return False
    mask_by_stem = {p.stem: p for p in masks.iterdir() if p.is_file()}
    unpaired, mismatched = [], []
    for img in image_files:
        mask = mask_by_stem.get(img.stem + mask_suffix)
        if mask is None:
            unpaired.append(img.stem)
            continue
        from PIL import Image

        try:
            with Image.open(img) as im, Image.open(mask) as mk:
                if im.size != mk.size:
                    mismatched.append(f"{img.stem} {im.size} vs {mk.size}")
        except OSError as e:
            mismatched.append(f"{img.stem} unreadable: {e}")
    if unpaired:
        print(f"{len(unpaired)} image(s) without a mask, e.g. {unpaired[:3]}")
        return False
    if mismatched:
        print(f"{len(mismatched)} image/mask size mismatch(es), e.g. {mismatched[:3]}")
        return False
    print(f"{data_dir}: {len(image_files)} image/mask pairs, all paired, sizes match")
    return True


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="download", description=__doc__.split("\n")[0])
    ap.add_argument("dataset", choices=("cifar10", "carvana"))
    ap.add_argument("--data_dir", default="data", help="destination / directory to check")
    ap.add_argument("--check", action="store_true", help="validate existing data only")
    ap.add_argument("--from_file", default=None,
                    help="cifar10: ingest this cifar-10-python.tar.gz")
    ap.add_argument("--md5", default=CIFAR10_MD5,
                    help="expected md5 of --from_file ('none' to skip; default: the official "
                    "CIFAR-10 digest)")
    ap.add_argument("--mask_suffix", default="", help="carvana: mask filename suffix")
    args = ap.parse_args(argv)
    data_dir = Path(args.data_dir)
    if args.from_file and args.dataset != "cifar10":
        ap.error("--from_file applies to cifar10 only")
    if args.from_file and args.check:
        ap.error("--check validates existing data; it never reads --from_file — drop one")
    if args.md5 != CIFAR10_MD5 and not args.from_file:
        ap.error("--md5 only applies to --from_file")
    if args.dataset == "cifar10":
        if args.from_file:
            md5 = None if args.md5.lower() == "none" else args.md5.lower()
            return ingest_cifar10(Path(args.from_file), data_dir, md5=md5)
        if args.check:
            return 0 if check_cifar10(data_dir) else 1
    elif args.check:
        return 0 if check_carvana(data_dir, mask_suffix=args.mask_suffix) else 1
    print("the port does not download: bring the files in and use --from_file (cifar10), or "
          "place images/ and masks/ by hand and use --check (carvana); --synthetic trains "
          "without data", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
