"""The kernel build cache: the owner of ``build/torch_kernels/``.

Port of ``deeplearning_mpi_tpu/compiler/cache.py``. The reference owns
JAX's persistent compilation cache; the port's compiled artefacts are the
``nvcc``-built kernel libraries (``ops/kernels/_build.py``), and this
module is their owner:

- **Content key.** A library is keyed by the sha256 of its ``.cu`` source,
  every ``.cuh`` it includes (transitively, from ``csrc/``), the ``nvcc``
  command line (checkout and output paths left out) and ``nvcc
  --version``. It is stored as ``lib<name>-<key[:16]>.so``: a source
  change is a new key, so a miss, whatever the files' mtimes say (a tree
  unpacked over an old ``build/`` keeps older mtimes).
- **Manifest.** ``cache-manifest.json`` holds the sha256 of every library
  built here (``resilience/integrity.py``); a lookup and :meth:`verify`
  compare against it. A library whose bytes differ, or that ``dlopen``
  refuses, moves to ``quarantine/`` (kept as evidence, never deleted) and
  is rebuilt.
- **Many processes.** A build holds the kernel's own file lock
  (``.lock-<name>``) across its ``nvcc``, the ``os.replace`` of the
  library and the manifest write, and a lookup holds it too: a process
  that waited finds the other's library and its digest together (a hit),
  never one without the other (a false mismatch that would quarantine a
  good library).
- **LRU.** A hit touches the library; :meth:`evict` removes the least
  recently used libraries until the cache fits a size; :meth:`stats`.
- **Counters.** ``compile_cache_{hit,miss,evicted,quarantined}_total``
  (``telemetry/schema.py``) on the cache (``hits``, ``misses``,
  ``evicted``, ``quarantined``; ``builds`` counts ``nvcc`` runs) and in a
  ``MetricsRegistry`` when one is given.

**n/a here.** The reference's ``donation_safe`` vetoes ``jit`` buffer
donation where XLA:CPU executes a cache-deserialized program; PyTorch
donates no buffers, so there is no veto to own, and
``runtime/compat.py`` (whose ``buffer_donation_supported`` delegates to
it) has no counterpart in the port either. ``enable`` / ``cache_dir``
(pointing JAX at a cache directory) have none: the build directory is
fixed beside the package.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable

from deeplearning_mpi_tpu_torch.resilience.integrity import atomic_write_json, file_digest

__all__ = [
    "BUILD_DIR",
    "CSRC_DIR",
    "CacheEntry",
    "CompileCache",
    "kernel_cache",
    "nvcc_command",
]

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
#: digest manifest of the built libraries (inside the cache directory)
MANIFEST_NAME = "cache-manifest.json"
#: where a corrupt library is moved (never deleted: evidence)
QUARANTINE_DIR = "quarantine"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc() -> str:
    """The ``nvcc`` to build with."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit "
                       "is installed")


def nvcc_command(source: Path, out: Path) -> list[str]:
    """The build of one ``csrc/<name>.cu``: a shared library for
    ``sm_90a`` with a plain C interface (``-Xptxas -v``: registers, shared
    memory and spills in the log)."""
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", str(source.parent), "-o", str(out), str(source),
    ]


def nvcc_version() -> str:
    """``nvcc --version``: a new toolchain is a new key."""
    return subprocess.run([nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    """One built library in the cache directory."""

    name: str
    path: Path
    size_bytes: int
    #: LRU signal: the library's mtime, touched on every hit
    last_used: float


class CompileCache:
    """The build directory ``path`` of the kernels in ``csrc`` (module
    docstring). ``command(source, out)`` is the build's argv and
    ``toolchain()`` the compiler's identity (``nvcc`` and ``nvcc --version``
    by default); ``loader`` opens a library (``ctypes.CDLL``). Tests give a
    build command that writes files, with no ``nvcc``. ``registry`` (a
    ``telemetry.MetricsRegistry``) receives the ``compile_cache_*``
    counters. ``suffix`` is the sources' extension (``.cu`` for the
    kernels; the host loader's ``data/native.py`` builds a ``.cc`` with
    ``g++`` through its own cache)."""

    def __init__(self, path: str | Path = BUILD_DIR, *, csrc: str | Path = CSRC_DIR,
                 command: Callable[[Path, Path], list[str]] = nvcc_command,
                 toolchain: Callable[[], str] = nvcc_version,
                 loader: Callable[[str], Any] = ctypes.CDLL, registry: Any = None,
                 suffix: str = ".cu") -> None:
        self.path = Path(path)
        self.suffix = suffix
        self.csrc = Path(csrc)
        self.command = command
        self.toolchain = toolchain
        self.loader = loader
        self.registry = registry
        self.hits = self.misses = self.builds = self.evicted = self.quarantined = 0
        self._toolchain: str | None = None
        self._lock = threading.Lock()  # builds may run in several threads
        if registry is not None:
            for kind in ("hit", "miss", "evicted", "quarantined"):
                registry.counter(f"compile_cache_{kind}_total")

    # -- keys ------------------------------------------------------------------
    def sources(self, name: str) -> list[Path]:
        """``csrc/<name><suffix>`` and every header it includes from
        ``csrc``, transitively, sorted."""
        seen: dict[str, Path] = {}
        todo = [self.csrc / f"{name}{self.suffix}"]
        while todo:
            src = todo.pop()
            if src.name in seen or not src.is_file():
                continue
            seen[src.name] = src
            todo.extend(self.csrc / inc for inc in _INCLUDE.findall(src.read_text()))
        if f"{name}{self.suffix}" not in seen:
            raise FileNotFoundError(f"no kernel source {self.csrc / f'{name}{self.suffix}'}")
        return [seen[n] for n in sorted(seen)]

    def key(self, name: str) -> str:
        """sha256 of the sources, the command line and the toolchain."""
        if self._toolchain is None:
            self._toolchain = self.toolchain()
        h = hashlib.sha256()
        for src in self.sources(name):
            h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
        argv = self.command(self.csrc / f"{name}{self.suffix}", Path("<out>"))
        h.update(" ".join(argv).replace(str(self.csrc), "<csrc>").encode() + b"\0")
        h.update(self._toolchain.encode())
        return h.hexdigest()

    def library(self, name: str, key: str | None = None) -> Path:
        """Where the library of ``name`` at ``key`` (default: the sources'
        current key) lives."""
        return self.path / f"lib{name}-{(key or self.key(name))[:16]}.so"

    # -- manifest ---------------------------------------------------------------
    @contextlib.contextmanager
    def _manifest(self):
        """The manifest's digests, read and written back under a file lock
        (several processes may build at once)."""
        self.path.mkdir(parents=True, exist_ok=True)
        with open(self.path / ".lock", "w") as lock:  # dmt-lint: disable=DMT004 — an flock target, no bytes written
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                digests = json.loads((self.path / MANIFEST_NAME).read_text())["digests"]
            except (OSError, ValueError, KeyError, TypeError):
                digests = {}
            before = dict(digests)
            yield digests
            if digests != before:
                atomic_write_json(self.path / MANIFEST_NAME, {"digests": digests})

    def recorded(self) -> dict[str, str]:
        """The manifest's digests by library file name."""
        try:
            return dict(json.loads((self.path / MANIFEST_NAME).read_text())["digests"])
        except (OSError, ValueError, KeyError, TypeError):
            return {}

    def write_manifest(self) -> dict[str, str]:
        """Digest every library into the manifest; returns the digests."""
        with self._manifest() as digests:
            digests.clear()
            digests.update({e.path.name: file_digest(e.path) for e in self.entries()})
            return dict(digests)

    def verify(self, *, quarantine: bool = True) -> list[str]:
        """Compare every recorded library with its digest; returns the file
        names that differ, moved to ``quarantine/`` unless ``quarantine``
        is False. A library with no record passes (built elsewhere, not
        yet digested), as the reference accepts an unrecorded entry."""
        recorded = self.recorded()
        bad = [e.path.name for e in self.entries()
               if e.path.name in recorded and file_digest(e.path) != recorded[e.path.name]]
        if quarantine and bad:
            self.quarantine(bad)
        return bad

    def quarantine(self, names: list[str]) -> None:
        """Move the named library files to ``quarantine/`` and drop their
        records."""
        qdir = self.path / QUARANTINE_DIR
        qdir.mkdir(parents=True, exist_ok=True)
        with self._manifest() as digests:
            for name in names:
                with contextlib.suppress(FileNotFoundError):
                    os.replace(self.path / name, qdir / name)
                digests.pop(name, None)
        self._count("quarantined", len(names))

    # -- lookups and builds -------------------------------------------------------
    def _count(self, kind: str, n: int = 1) -> None:
        """Add ``n`` to the ``kind`` count (``hits``, ``misses``, ``builds``,
        ``evicted``, ``quarantined``) and to its registry counter."""
        with self._lock:
            setattr(self, kind, getattr(self, kind) + n)
        counter = {"hits": "hit", "misses": "miss"}.get(kind, kind)
        if self.registry is not None and n and kind != "builds":
            self.registry.counter(f"compile_cache_{counter}_total").inc(n)

    @contextlib.contextmanager
    def _kernel_lock(self, names: list[str]):
        """Hold the file lock of each named kernel (sorted: two processes
        locking overlapping sets cannot deadlock)."""
        self.path.mkdir(parents=True, exist_ok=True)
        with contextlib.ExitStack() as stack:
            for name in sorted(set(names)):
                f = stack.enter_context(open(self.path / f".lock-{name}", "w"))  # dmt-lint: disable=DMT004 — an flock target, no bytes written
                fcntl.flock(f, fcntl.LOCK_EX)
            yield

    def lookup(self, name: str) -> Path | None:
        """The library of ``name`` at its current key, or None: a hit
        (counted, the library touched) when it exists and matches its
        recorded digest; a miss (counted) otherwise. A library that fails
        its digest is quarantined first. Waits while another process builds
        the kernel."""
        with self._kernel_lock([name]):
            return self._lookup(name)

    def _lookup(self, name: str) -> Path | None:
        lib = self.library(name)
        if lib.is_file():
            want = self.recorded().get(lib.name)
            if want is None or file_digest(lib) == want:
                os.utime(lib)
                self._count("hits")
                return lib
            self.quarantine([lib.name])
        self._count("misses")
        return None

    def build(self, names: list[str], *, force: bool = False) -> dict[str, str]:
        """Build the named kernels whose library misses (every one with
        ``force``), one build each, all started together; each library is
        digested into the manifest, each under its kernel's lock from the
        lookup to the manifest write. Returns each build's output; raises on
        a failed build."""
        with self._kernel_lock(names):
            return self._build(names, force=force)

    def _build(self, names: list[str], *, force: bool) -> dict[str, str]:
        procs = {}
        for name in names:
            if not force and self._lookup(name) is not None:
                continue
            key = self.key(name)
            tmp = self.path / f"lib{name}-{key[:16]}.so.{os.getpid()}.tmp"
            procs[name] = (key, tmp, subprocess.Popen(
                self.command(self.csrc / f"{name}{self.suffix}", tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for name, (key, tmp, proc) in procs.items():
            logs[name], _ = proc.communicate()
            self._count("builds")
            if proc.returncode != 0 or not tmp.is_file():
                failed.append(name)
                continue
            lib = self.library(name, key)
            os.replace(tmp, lib)
            with self._manifest() as digests:
                digests[lib.name] = file_digest(lib)
        if failed:
            detail = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
            raise RuntimeError(f"kernel build failed for {failed}:\n{detail}")
        return logs

    def load(self, name: str) -> Any:
        """The opened library of ``name``: looked up by content key, built
        on a miss; a library the loader refuses is quarantined and rebuilt
        once. The lookup and a build on its miss hold the kernel's lock
        together: of processes starting at once, one builds and the rest
        hit."""
        with self._kernel_lock([name]):
            lib = self._lookup(name)
            if lib is None:
                self._build([name], force=True)
                lib = self.library(name)
        try:
            return self.loader(str(lib))
        except OSError:
            with self._kernel_lock([name]):
                self.quarantine([lib.name])
                self._build([name], force=True)
            return self.loader(str(self.library(name)))

    # -- size-bounded eviction ------------------------------------------------------
    def entries(self) -> list[CacheEntry]:
        """Every built library, least recently used first."""
        out = []
        for f in self.path.glob("lib*-*.so") if self.path.is_dir() else ():
            with contextlib.suppress(OSError):
                st = f.stat()
                out.append(CacheEntry(f.name, f, st.st_size, st.st_mtime))
        return sorted(out, key=lambda e: (e.last_used, e.name))

    def evict(self, max_bytes: int) -> list[CacheEntry]:
        """Delete the least recently used libraries until the cache holds
        at most ``max_bytes``; returns what was evicted."""
        entries = self.entries()
        total = sum(e.size_bytes for e in entries)
        evicted = []
        with self._manifest() as digests:
            for e in entries:
                if total <= max_bytes:
                    break
                with contextlib.suppress(FileNotFoundError):
                    e.path.unlink()
                digests.pop(e.name, None)
                total -= e.size_bytes
                evicted.append(e)
        self._count("evicted", len(evicted))
        return evicted

    def stats(self) -> dict[str, Any]:
        entries = self.entries()
        return {"path": str(self.path), "entries": len(entries),
                "size_bytes": sum(e.size_bytes for e in entries), "hits": self.hits,
                "misses": self.misses, "builds": self.builds, "evicted": self.evicted,
                "quarantined": self.quarantined}


_default: CompileCache | None = None


def kernel_cache() -> CompileCache:
    """The process's cache of ``build/torch_kernels/`` (what the kernel
    wrappers load through)."""
    global _default
    if _default is None:
        _default = CompileCache()
    return _default
