"""Build the hand-written CUDA kernels and load them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<key>.so csrc/<name>.cu

The libraries go to ``build/torch_kernels/`` beside the package (listed in
``.gitignore``) at first use, through ``compiler.cache.CompileCache``: each
is keyed by the content of its sources, its command line and the
compiler, digested into a manifest, and quarantined and rebuilt when its
bytes or ``dlopen`` fail. :func:`build_all` starts one ``nvcc`` per source
at once. Nothing here runs at import time: the CPU tests import every
module.

Every C entry returns ``cudaGetLastError()`` after its launch; the caller
raises through :func:`check` when that is not 0.
"""

from __future__ import annotations

import ctypes

from deeplearning_mpi_tpu_torch.compiler.cache import BUILD_DIR, CSRC_DIR, kernel_cache

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_all", "check", "load"]

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


def build_all(names: list[str] | None = None, *, force: bool = False) -> dict[str, str]:
    """Compile the named kernels (default: all) whose library the cache
    misses (every one with ``force``), one ``nvcc`` each, all started
    together. Returns each build's compiler output (``-Xptxas -v``:
    registers, shared memory, spills); raises on the first failed build."""
    return kernel_cache().build(list(_EXPORTS) if names is None else names, force=force)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first on a cache
    miss, with ``argtypes``/``restype`` declared for every export."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    lib = kernel_cache().load(name)
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
