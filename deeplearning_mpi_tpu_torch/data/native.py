"""ctypes bindings for the native (C++) data-loader core.

Port of ``deeplearning_mpi_tpu/data/native.py``. ``csrc/fastloader.cc``
holds fused, multithreaded pad + crop + flip + normalize kernels over whole
uint8 batches; this module builds it with ``g++`` on first use into
``build/native/`` through the port's ``compiler/cache.py`` (its content key
over the source, the command line and ``g++ --version``, and its
per-library file lock, so processes starting together build once), and
exposes batch transforms that draw the same random numbers in the same
order as the numpy transforms in ``data/cifar10.py`` and return bitwise
the same arrays (the C++ repeats the numpy arithmetic in float32).

Where it runs: ``DLMPI_TPU_NO_NATIVE`` set (the reference's switch), or no
``g++`` on ``PATH``, keeps the numpy transforms, and
:func:`native_available` says so. A ``g++`` that is present and fails to
build raises: the reference swallows that failure, which would hide a
broken toolchain behind a slower run.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any

import numpy as np

from deeplearning_mpi_tpu_torch.data.cifar10 import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from deeplearning_mpi_tpu_torch.data.cifar10 import eval_transform as _np_eval_transform
from deeplearning_mpi_tpu_torch.data.cifar10 import train_transform as _np_train_transform

#: where the host library is built (beside the kernels' ``build/torch_kernels``)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
NAME = "fastloader"
ABI_VERSION = 2

_lib: Any = None
_tried = False
_lock = threading.Lock()


def gxx_command(source: Path, out: Path) -> list[str]:
    """The build of ``csrc/fastloader.cc``: a shared library, no fast math
    and no contraction (the float32 arithmetic must be numpy's)."""
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off",
            str(source), "-o", str(out)]


def gxx_version() -> str:
    return subprocess.run(["g++", "--version"], capture_output=True, text=True,
                          check=True).stdout


def _build_library() -> Any:
    from deeplearning_mpi_tpu_torch.compiler.cache import CSRC_DIR, CompileCache

    cache = CompileCache(BUILD_DIR, csrc=CSRC_DIR, command=gxx_command, toolchain=gxx_version,
                         suffix=".cc")
    lib = cache.load(NAME)
    u8, i32, f32, c_int = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
                           ctypes.POINTER(ctypes.c_float), ctypes.c_int)
    lib.fl_crop_flip_normalize.argtypes = [u8, c_int, c_int, c_int, c_int, i32, i32, u8, c_int,
                                           f32, f32, f32, c_int]
    lib.fl_crop_flip_normalize.restype = None
    lib.fl_normalize.argtypes = [u8, c_int, c_int, c_int, c_int, f32, f32, f32, c_int]
    lib.fl_normalize.restype = None
    lib.fl_version.argtypes = []
    lib.fl_version.restype = ctypes.c_int
    if lib.fl_version() != ABI_VERSION:
        raise RuntimeError(f"fastloader ABI version {lib.fl_version()} != {ABI_VERSION}")
    return lib


def get_library() -> Any:
    """The loaded native library, or None when the numpy path is chosen
    (``DLMPI_TPU_NO_NATIVE``, or no ``g++``); a failed build raises."""
    global _lib, _tried
    with _lock:
        if not _tried:
            if not os.environ.get("DLMPI_TPU_NO_NATIVE") and shutil.which("g++"):
                _lib = _build_library()
            _tried = True
    return _lib


def native_available() -> bool:
    return get_library() is not None


def pipeline_description(num_workers: int) -> str:
    """The CLIs' log line naming the input path and the fetch threads."""
    if native_available():
        path = "native C++ transforms (csrc/fastloader.cc)"
    elif os.environ.get("DLMPI_TPU_NO_NATIVE"):
        path = "numpy transforms (DLMPI_TPU_NO_NATIVE is set)"
    else:
        path = "numpy transforms (no g++ on PATH)"
    return f"input pipeline: {path}, {num_workers} fetch thread(s)"


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _stats(mean: Any, std: Any) -> tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(mean, np.float32), np.ascontiguousarray(std, np.float32))


def crop_flip_normalize(images: np.ndarray, ys: np.ndarray, xs: np.ndarray, flips: np.ndarray,
                        *, pad: int = 4, mean: np.ndarray = CIFAR10_MEAN,
                        std: np.ndarray = CIFAR10_STD, max_threads: int | None = None
                        ) -> np.ndarray:
    """Fused RandomCrop(pad) + flip + normalize over a uint8 NHWC batch."""
    lib = get_library()
    if lib is None:
        raise RuntimeError("native library unavailable (DLMPI_TPU_NO_NATIVE, or no g++)")
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    ys, xs = np.ascontiguousarray(ys, np.int32), np.ascontiguousarray(xs, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    mean, std = _stats(mean, std)
    if not (ys.shape == xs.shape == flips.shape == (n,)) or mean.shape != (c,) \
            or std.shape != (c,):
        raise ValueError(f"crop_flip_normalize: offsets/flips must be [{n}] and mean/std [{c}]")
    if ys.min(initial=0) < 0 or xs.min(initial=0) < 0 or max(
            ys.max(initial=0), xs.max(initial=0)) > 2 * pad:
        raise ValueError(f"crop offsets must lie in [0, {2 * pad}]")
    out = np.empty((n, h, w, c), np.float32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.fl_crop_flip_normalize(
        images.ctypes.data_as(u8), n, h, w, c, ys.ctypes.data_as(i32), xs.ctypes.data_as(i32),
        flips.ctypes.data_as(u8), pad, _f32ptr(mean), _f32ptr(std), _f32ptr(out),
        max_threads or os.cpu_count() or 1,
    )
    return out


def normalize(images: np.ndarray, *, mean: np.ndarray = CIFAR10_MEAN,
              std: np.ndarray = CIFAR10_STD, max_threads: int | None = None) -> np.ndarray:
    """Per-channel uint8 -> normalized float32 (the eval transform)."""
    lib = get_library()
    if lib is None:
        raise RuntimeError("native library unavailable (DLMPI_TPU_NO_NATIVE, or no g++)")
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    out = np.empty((n, h, w, c), np.float32)
    mean, std = _stats(mean, std)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"normalize: mean/std must be [{c}]")
    lib.fl_normalize(images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, c,
                     _f32ptr(mean), _f32ptr(std), _f32ptr(out), max_threads or os.cpu_count() or 1)
    return out


def train_transform(batch: dict[str, np.ndarray], rng: np.random.Generator, *,
                    flip: bool = True) -> dict[str, np.ndarray]:
    """``data.cifar10.train_transform`` through the native core: the same
    draws in the same order (offsets, then flips), the same array. The
    numpy transform where the library is not built."""
    if get_library() is None:
        return _np_train_transform(batch, rng, flip=flip)
    images = batch["image"]
    n = images.shape[0]
    ys = rng.integers(0, 9, size=n)
    xs = rng.integers(0, 9, size=n)
    flips = rng.random(n) < 0.5 if flip else np.zeros(n, bool)
    return {"image": crop_flip_normalize(images, ys, xs, flips), "label": batch["label"]}


def eval_transform(batch: dict[str, np.ndarray],
                   rng: np.random.Generator | None = None) -> dict[str, np.ndarray]:
    """``data.cifar10.eval_transform`` through the native core (numpy where
    the library is not built)."""
    if get_library() is None:
        return _np_eval_transform(batch, rng)
    return {"image": normalize(batch["image"]), "label": batch["label"]}
