"""Checkpoint integrity: checksum manifests, atomic writes, corruption.

Port of ``deeplearning_mpi_tpu/resilience/integrity.py``. A rename that
landed is not proof that the bytes are the ones computed: bit-rot, a torn
network write or a mutation after the save all leave a checkpoint that
loads cleanly into wrong weights. :func:`dir_digests` hashes every file of
a committed step at save time; a restore re-hashes and compares BEFORE any
byte reaches ``torch.load`` (``Checkpointer.restore_verified``).
:func:`tree_digests` hashes live tensors (dtype, shape, raw bytes) the way
the reference hashes arrays, so one array gets one hex digest in both
packages. :func:`corrupt_checkpoint` flips bytes inside a saved step, so
the verify-and-roll-back path is tested against real damage.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

__all__ = [
    "CheckpointCorruption",
    "atomic_write_json",
    "corrupt_checkpoint",
    "dir_digests",
    "file_digest",
    "manifest_path",
    "read_manifest",
    "tree_digests",
    "write_manifest",
]


class CheckpointCorruption(RuntimeError):
    """No checkpoint survived verification — every candidate failed
    restore or digest comparison."""


def atomic_write_json(path: str | Path, obj: Any) -> None:
    """Write JSON so readers see the old file or the new one, never a
    partial: tmp sibling, flush + fsync, then rename over the target."""
    path = Path(path)
    tmp = path.parent / f"tmp-{path.name}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """``(key string, leaf)`` in ``jax.tree_util.keystr`` form for nested
    dicts (``"['a']['b']"``), keys sorted as a pytree flattens a dict."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    else:
        yield path, tree


def _numpy_view(value: Any) -> tuple[str, np.ndarray]:
    """The tensor's host bytes as the numpy array the reference hashes:
    bf16 as its 16-bit pattern under the name ``bfloat16``, and through
    ``np.ascontiguousarray``, which makes a 0-d array 1-d (a scalar hashes
    shape ``(1,)`` in both packages)."""
    if not isinstance(value, torch.Tensor):
        arr = np.ascontiguousarray(np.asarray(value))
        return str(arr.dtype), arr
    t = value.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return "bfloat16", np.ascontiguousarray(t.view(torch.int16).numpy())
    arr = np.ascontiguousarray(t.numpy())
    return str(arr.dtype), arr


def tree_digests(tree: Any) -> dict[str, str]:
    """sha256 per tensor leaf of nested dicts, keyed by tree path.

    The digest covers the numpy dtype name, the numpy shape string and the
    raw bytes, so a silent cast or reshape fails verification the same way
    flipped bytes do, and an array hashes to the reference's hex digest.
    """
    out: dict[str, str] = {}
    for key, value in _leaves(tree):
        dtype, arr = _numpy_view(value)
        h = hashlib.sha256()
        h.update(dtype.encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(arr.tobytes())
        out[key] = h.hexdigest()
    return out


def file_digest(path: str | Path) -> str:
    """sha256 of one file's bytes, hex."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 23), b""):
            h.update(chunk)
    return h.hexdigest()


def dir_digests(step_dir: str | Path) -> dict[str, str]:
    """sha256 per regular file under ``step_dir``, keyed by relative path:
    the manifest of a committed step, covering every byte written. The
    files hash on threads side by side (``hashlib`` releases the GIL), so a
    step costs its largest file's hash, not the sum."""
    from concurrent.futures import ThreadPoolExecutor

    step_dir = Path(step_dir)
    files = sorted(p for p in step_dir.rglob("*") if p.is_file())
    with ThreadPoolExecutor(max_workers=max(1, min(8, len(files)))) as pool:
        digests = list(pool.map(file_digest, files))
    return {str(f.relative_to(step_dir)): d for f, d in zip(files, digests)}


def manifest_path(directory: str | Path, epoch: int) -> Path:
    """Manifests live BESIDE the step directories, which retention deletes
    whole."""
    return Path(directory) / f"manifest-{epoch}.json"


def write_manifest(directory: str | Path, epoch: int, digests: dict[str, str]) -> None:
    atomic_write_json(manifest_path(directory, epoch), {"epoch": epoch, "digests": digests})


def read_manifest(directory: str | Path, epoch: int) -> dict[str, str] | None:
    """``None`` for missing OR unreadable — both mean "no verification
    available", which the restore treats as accept-unverified."""
    try:
        payload = json.loads(manifest_path(directory, epoch).read_text())
        return dict(payload["digests"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def corrupt_checkpoint(step_dir: str | Path, *, span: int = 1024) -> Path:
    """Flip a span of bytes in the largest file under ``step_dir`` (the
    tensor data, in practice) at an interior offset: damage that loads
    cleanly and that only the digest comparison can tell."""
    step_dir = Path(step_dir)
    files = [p for p in step_dir.rglob("*") if p.is_file()]
    if not files:
        raise FileNotFoundError(f"no files to corrupt under {step_dir}")
    target = max(files, key=lambda p: p.stat().st_size)
    size = target.stat().st_size
    offset = size // 4
    span = max(1, min(span, size - offset))
    with open(target, "r+b") as f:
        f.seek(offset)
        chunk = f.read(span)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))
        f.flush()
        os.fsync(f.fileno())
    return target
