"""Opt-in runtime sanitizer (``DMT_SANITIZE=1``): the lint rules' contracts
enforced on live state the AST cannot see.

Port of ``deeplearning_mpi_tpu/analysis/sanitizer.py``. Three tripwires,
each the runtime half of a static rule:

- **KV-block poisoning** (``sanitize_kv_double_free_total`` /
  ``sanitize_kv_use_after_free_total``): :class:`KVPoolSanitizer` rides
  inside :class:`~deeplearning_mpi_tpu_torch.serving.kv_pool.PagedKVPool`
  and marks every freed block poisoned until it is allocated again. A
  second free of a poisoned block is a double free; a data or scale write
  recorded against one is a use after free. The prefix cache's refcounts
  add two classes on the same pool: a refcount below one on a block still
  in the used set (``sanitize_kv_refcount_underflow_total``) and a write
  recorded against a block whose refcount is > 1
  (``sanitize_kv_cow_violation_total``: a writer skipped copy-on-write).
- **Retrace tripwire** (``sanitize_retrace_trips_total``): once a serving
  engine's ``warmup()`` has run, a tick of ``serve_compile_total`` (the
  port counts a CUDA-graph capture there) raises unless it happens inside
  :func:`allow_compiles`. The port adds the case the reference cannot
  have: a decode or verify step at a gather width warmup did not capture
  runs eagerly (``compiler.aot.WarmProgram``'s fallback) and compiles
  nothing, which is the port's silent latency spike; the engine reports it
  through :func:`check_compile_tick` as well. The chunked prefill is eager
  by design and is not a trip.
- **Donation canary** (``sanitize_donation_canary_trips_total``):
  :func:`donation_canary` hashes the smallest tensor of a train state's
  ``arrays()`` before a checkpoint save and verifies it after the save's
  barrier: an in-place update that reaches the tensor while its bytes are
  being written flips it. The step counter is skipped: ``arrays()`` builds
  it fresh from a Python int, so no in-place update can reach it.

Costless when off: every hook is gated on :func:`enabled`, read once at
object construction (pools, engines and checkpointers built before the
variable is set stay unsanitized). Trips are counted module-globally
(:func:`trip_counts`) and mirrored into an attached ``MetricsRegistry``
under the ``sanitize_*`` counter names. A caller that turns the sanitizer
on for a while must :func:`reset_trips` first and ``attach_registry(None)``
afterwards, or later code counts its trips.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Any, Iterable

__all__ = [
    "KVPoolSanitizer",
    "SanitizerError",
    "allow_compiles",
    "attach_registry",
    "canary_tensor",
    "check_compile_tick",
    "donation_canary",
    "enabled",
    "reset_trips",
    "trip",
    "trip_counts",
]

KV_DOUBLE_FREE = "sanitize_kv_double_free_total"
KV_USE_AFTER_FREE = "sanitize_kv_use_after_free_total"
KV_REFCOUNT_UNDERFLOW = "sanitize_kv_refcount_underflow_total"
KV_COW_VIOLATION = "sanitize_kv_cow_violation_total"
RETRACE_TRIPS = "sanitize_retrace_trips_total"
DONATION_TRIPS = "sanitize_donation_canary_trips_total"
#: every trip class, in the reference's order
TRIP_CLASSES = (KV_DOUBLE_FREE, KV_USE_AFTER_FREE, KV_REFCOUNT_UNDERFLOW, KV_COW_VIOLATION,
                RETRACE_TRIPS, DONATION_TRIPS)


class SanitizerError(RuntimeError):
    """A sanitized contract was violated. Always fatal by design."""


_trips: dict[str, int] = {}
_registry: Any = None
_allow_compiles_depth = 0


def enabled() -> bool:
    """True when ``DMT_SANITIZE`` is set to anything but ''/'0'."""
    return os.environ.get("DMT_SANITIZE", "") not in ("", "0")


def attach_registry(registry: Any) -> None:
    """Mirror trip counters into a MetricsRegistry (``sanitize_*`` names);
    None detaches."""
    global _registry
    _registry = registry
    if registry is not None:
        for name in TRIP_CLASSES:
            registry.counter(name)


def trip(name: str, message: str) -> None:
    """Count a trip, dump every live span recorder's flight ring, and raise.
    The count lands before the raise, so a caller that catches still sees
    it in :func:`trip_counts` and in the attached registry."""
    _trips[name] = _trips.get(name, 0) + 1
    if _registry is not None:
        try:
            _registry.counter(name).inc()
        except Exception:
            pass
    try:
        from deeplearning_mpi_tpu_torch.telemetry import spans

        spans.dump_all(f"sanitizer-{name}")
    except Exception:
        pass  # a failed dump must never mask the trip itself
    raise SanitizerError(f"[{name}] {message}")


def trip_counts() -> dict[str, int]:
    return dict(_trips)


def reset_trips() -> None:
    _trips.clear()


# -- retrace tripwire --------------------------------------------------------

@contextlib.contextmanager
def allow_compiles():
    """Scope in which post-warmup compiles are sanctioned."""
    global _allow_compiles_depth
    _allow_compiles_depth += 1
    try:
        yield
    finally:
        _allow_compiles_depth -= 1


def check_compile_tick(*, post_warmup: bool, what: str = "serving program") -> None:
    """Called where ``serve_compile_total`` ticks (and where a warmed
    engine falls back to an eager program). After warmup it is a trip."""
    if not post_warmup or not enabled() or _allow_compiles_depth > 0:
        return
    trip(
        RETRACE_TRIPS,
        f"{what} AFTER warmup: the zero-capture contract is violated — a "
        "shape warmup never captured reached the serving step",
    )


# -- KV pool poisoning -------------------------------------------------------

class KVPoolSanitizer:
    """Freed-block poison set for one :class:`PagedKVPool` (accounting
    level: the marker lives on the block id, where every KV bug class
    lives: a block-table entry pointing at a block the free list already
    handed to someone else)."""

    def __init__(self) -> None:
        self.poisoned: set[int] = set()

    def on_alloc(self, blocks: Iterable[int]) -> None:
        self.poisoned.difference_update(blocks)

    def check_free(self, blocks: Iterable[int], used: set[int]) -> None:
        for b in blocks:
            if b in self.poisoned and b not in used:
                trip(KV_DOUBLE_FREE,
                     f"double free of KV block {b}: it was already freed and is poisoned — "
                     "a second owner would have corrupted its pages")

    def on_free(self, blocks: Iterable[int]) -> None:
        self.poisoned.update(blocks)

    def check_touch(self, blocks: Iterable[int], used: set[int], kind: str) -> None:
        for b in blocks:
            if b in self.poisoned and b not in used:
                trip(KV_USE_AFTER_FREE,
                     f"{kind} write recorded against freed KV block {b}: a stale block-table "
                     "entry is scattering into poisoned pages (use-after-free)")


# -- donation canary ---------------------------------------------------------

def _leaves(tree: Any, path: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def canary_tensor(state: Any) -> tuple[str, Any] | None:
    """The tensor the canary hashes: the smallest of ``state.arrays()`` (a
    dict of tensors is taken as is; the step counter skipped, module
    docstring), with its key path there; None without tensors."""
    import torch

    arrays = state.arrays() if hasattr(state, "arrays") else state
    tensors = [(p, t) for p, t in _leaves({k: v for k, v in arrays.items() if k != "step"}, "")
               if isinstance(t, torch.Tensor)]
    # Smallest tensor: the canary must be cheap enough to run on every save.
    return min(tensors, key=lambda pt: pt[1].numel()) if tensors else None


def _canary_digest(state: Any) -> tuple[str, str]:
    """sha256 of :func:`canary_tensor` and its key path."""
    import torch

    picked = canary_tensor(state)
    if picked is None:
        return "", ""
    path, leaf = picked
    host = leaf.detach().to("cpu").contiguous().reshape(-1)
    h = hashlib.sha256()
    h.update(str(host.dtype).encode())
    h.update(str(tuple(leaf.shape)).encode())
    h.update(host.view(torch.uint8).numpy().tobytes())
    return h.hexdigest(), path


class _DonationCanary:
    def __init__(self, digest: str, leaf_path: str) -> None:
        self._digest = digest
        self.leaf_path = leaf_path

    def verify(self, state: Any) -> None:
        digest, _ = _canary_digest(state)
        if digest != self._digest:
            trip(DONATION_TRIPS,
                 f"state tensor {self.leaf_path} changed across checkpoint save: an in-place "
                 "update reached the live tensor while its bytes were being written — the "
                 "saved bytes are not the state that was passed in")


def donation_canary(state: Any) -> _DonationCanary:
    """Hash one (small) state tensor; ``verify`` after the save barrier."""
    return _DonationCanary(*_canary_digest(state))
