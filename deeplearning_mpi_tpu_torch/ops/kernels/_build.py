"""Build the hand-written CUDA kernels and load them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>.so csrc/<name>.cu

The libraries go to ``build/torch_kernels/`` beside the package (listed in
``.gitignore``) at first use, and are rebuilt when a source is newer than
its library. :func:`build_all` starts one ``nvcc`` per source at once.
Nothing here runs at import time: the CPU tests import every module.

Every C entry returns ``cudaGetLastError()`` after its launch; the caller
raises through :func:`check` when that is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

#: kernel library name -> the C entry points it exports, with their
#: ctypes argument types (every pointer and the stream as ``c_void_p``).
_EXPORTS: dict[str, dict[str, list]] = {
    "flash_attention_fwd": {"flash_attention_fwd": [ctypes.c_void_p, ctypes.c_void_p]},
    "flash_attention_bwd": {
        "flash_attention_bwd_dq": [ctypes.c_void_p, ctypes.c_void_p],
        "flash_attention_bwd_dkv": [ctypes.c_void_p, ctypes.c_void_p],
    },
    "flash_decode": {"flash_decode": [ctypes.c_void_p, ctypes.c_void_p]},
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _library(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC_DIR.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def _command(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", str(CSRC_DIR), "-o", str(out), str(CSRC_DIR / f"{name}.cu"),
    ]


def build_all(names: list[str] | None = None, *, force: bool = False) -> dict[str, str]:
    """Compile the named kernels (default: all), one ``nvcc`` each, all
    started together. Returns each build's compiler output (``-Xptxas -v``:
    registers, shared memory, spills); raises on the first failed build."""
    names = list(_EXPORTS) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    logs = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, _library(name))
    if failed:
        detail = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if missing or
    stale, with ``argtypes``/``restype`` declared for every export."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all([name])
    lib = ctypes.CDLL(str(_library(name)))
    for fn_name, argtypes in _EXPORTS[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry's ``cudaGetLastError()`` was not ``cudaSuccess``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")
