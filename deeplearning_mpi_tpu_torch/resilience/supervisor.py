"""Failure detection and recovery: auto-resume, the heartbeat, preflight.

Port of ``deeplearning_mpi_tpu/resilience/supervisor.py``:

- :func:`run_with_auto_resume`: supervised training. On a crash ``fit``
  is called again with the epoch after the latest checkpoint (``fit``
  itself restores); after ``max_restarts`` failures it re-raises wrapped in
  :class:`TrainingFailure`, so an orchestrator sees a real non-zero exit.
  :class:`Preempted` and ``KeyboardInterrupt`` are never retried.
- :class:`Heartbeat`: a thread that rewrites a JSON file every few seconds
  with the loop's progress and a ``progress_seq`` that only the training
  loop advances: a hung collective leaves the file fresh and the sequence
  frozen, which is what pod-level liveness reads.
- :func:`preflight`: early, specific failures (directories, the global
  batch against the data-parallel degree of the port's mesh).

Restart delays follow :func:`restart_delay`: exponential from the base,
capped, with a jitter drawn from ``random.Random((attempt << 16) ^ rank)``,
the reference's exact draw, so a run replays its delays.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from pathlib import Path
from typing import Any, Callable

from deeplearning_mpi_tpu_torch.resilience.preemption import Preempted

__all__ = [
    "Heartbeat",
    "TRAIN_RESTARTS",
    "TrainingFailure",
    "preflight",
    "restart_delay",
    "run_with_auto_resume",
]

#: counter of in-process restarts (the pod supervisor's is
#: ``pod_restarts_total``).
TRAIN_RESTARTS = "train_restarts_total"


class TrainingFailure(RuntimeError):
    """Raised when training exhausted its restart budget."""


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def restart_delay(attempt: int, base_s: float, *, backoff: float = 2.0,
                  max_delay_s: float = 300.0, jitter: float = 0.25) -> float:
    """Delay before restart ``attempt`` (1-based):
    ``min(base * backoff**(attempt-1), max) * U(1±jitter)``, the jitter
    seeded by ``(attempt, this process's rank)``: ranks decorrelate, and a
    run replays to the same delays. ``base_s <= 0``: no delay."""
    if base_s <= 0:
        return 0.0
    delay = min(base_s * backoff ** (attempt - 1), max_delay_s)
    rng = random.Random((attempt << 16) ^ _rank())
    return delay * rng.uniform(1.0 - jitter, 1.0 + jitter)


def run_with_auto_resume(fit: Callable[[int], Any], checkpointer: Any, *,
                         max_restarts: int = 2, logger: Any = None,
                         restart_delay_s: float = 5.0, backoff: float = 2.0,
                         max_delay_s: float = 300.0, registry: Any = None) -> Any:
    """Run ``fit(start_epoch)``, calling it again after a failure with the
    epoch after ``checkpointer``'s latest (``fit`` restores). Restart ``k``
    sleeps :func:`restart_delay` and adds one to ``train_restarts_total``
    in ``registry``. After ``max_restarts`` retries the last exception
    propagates wrapped in :class:`TrainingFailure`."""
    log = logger.log if logger is not None else print
    attempt = 0
    while True:
        start_epoch = 0
        if attempt > 0:
            latest = checkpointer.latest_epoch()
            start_epoch = latest + 1 if latest is not None else 0
            log(f"auto-resume: restart {attempt}/{max_restarts} from epoch {start_epoch} "
                f"(checkpoint epoch {latest})")
        try:
            return fit(start_epoch)
        except (KeyboardInterrupt, Preempted):
            raise
        except Exception as err:  # noqa: BLE001 — this IS the failure handler
            attempt += 1
            log(f"training failed (attempt {attempt}): {type(err).__name__}: {err}")
            if attempt > max_restarts:
                raise TrainingFailure(f"training failed after {max_restarts} restarts") from err
            if registry is not None:
                registry.counter(TRAIN_RESTARTS).inc()
            delay = restart_delay(attempt, restart_delay_s, backoff=backoff,
                                  max_delay_s=max_delay_s)
            if delay > 0:
                log(f"auto-resume: backing off {delay:.1f}s before restart {attempt}")
                time.sleep(delay)


class Heartbeat:
    """Liveness probe: a JSON file rewritten every ``interval_s`` by a
    daemon thread, atomically (temp file + ``os.replace``). Assigning
    :attr:`progress` (a JSON-able dict) bumps ``progress_seq``; each beat
    carries it, the seconds since it last moved (``progress_age_s``, this
    process's monotonic clock) and the spawning supervisor's incarnation
    when ``$DMT_SUPERVISOR_INCARNATION`` is set."""

    def __init__(self, path: str | Path, *, interval_s: float = 10.0) -> None:
        self.path = Path(path)
        self.interval_s = interval_s
        self._progress: dict[str, Any] = {}
        self._progress_seq = 0
        self._progress_mono = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def progress(self) -> dict[str, Any]:
        return self._progress

    @progress.setter
    def progress(self, value: dict[str, Any]) -> None:
        # Seq first, then the dict: a racing beat may pair the new seq with
        # the old dict once, harmless (the seq is what liveness reads).
        self._progress_seq += 1
        self._progress_mono = time.monotonic()
        self._progress = dict(value)

    def start(self) -> "Heartbeat":
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def beat(self) -> None:
        """Write one beat now (the thread writes the rest)."""
        now = time.monotonic()
        inc = os.environ.get("DMT_SUPERVISOR_INCARNATION")
        payload = {
            "time": time.time(),
            "monotonic": now,
            "pid": os.getpid(),
            "process_index": _rank(),
            "interval_s": self.interval_s,
            "progress_seq": self._progress_seq,
            "progress_age_s": now - self._progress_mono,
            **({"incarnation": int(inc)} if inc is not None and inc.isdigit() else {}),
            **self._progress,
        }
        tmp = self.path.with_suffix(".tmp")
        try:
            tmp.write_text(json.dumps(payload))  # dmt-lint: disable=DMT004 — hand-rolled tmp+rename; fsync skipped on purpose at heartbeat cadence
            os.replace(tmp, self.path)  # atomic: a reader never sees partial JSON
        except OSError:
            pass  # disk hiccups must not kill the training process

    @staticmethod
    def read(path: str | Path) -> dict[str, Any] | None:
        """The beat at ``path``, or None when it is missing or unreadable
        (never let a racy read kill a watchdog)."""
        try:
            return json.loads(Path(path).read_text())
        except (OSError, ValueError):
            return None

    def _run(self) -> None:
        while not self._stop.is_set():
            self.beat()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        """Stop the thread, then write a last beat: the file holds the final
        progress."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=self.interval_s + 1)
            self._thread = None
            self.beat()

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def preflight(*, data_dir: str | None = None, model_dir: str | None = None,
              log_dir: str | None = None, global_batch_size: int | None = None,
              mesh: Any = None, grad_accum: int = 1) -> None:
    """Fail fast with specific messages before anything is built:
    directories (created where they should be), and the global batch against
    the data-parallel degree of ``mesh`` (the port's ``DeviceMesh``; None:
    one process) and ``grad_accum``. Raises ``SystemExit`` with every
    problem listed."""
    problems: list[str] = []
    if data_dir is not None and not Path(data_dir).is_dir():
        problems.append(f"data directory '{data_dir}' does not exist")
    for name, d in (("model", model_dir), ("log", log_dir)):
        if d is not None:
            try:
                Path(d).mkdir(parents=True, exist_ok=True)
            except OSError as err:
                problems.append(f"cannot create {name} dir '{d}': {err}")
    if global_batch_size is not None:
        from deeplearning_mpi_tpu_torch.runtime.mesh import data_size

        dp = data_size(mesh)
        if global_batch_size % dp:
            problems.append(f"global batch {global_batch_size} not divisible by "
                            f"data-parallel degree {dp}")
        if grad_accum > 1:
            if global_batch_size % grad_accum:
                problems.append(f"global batch {global_batch_size} not divisible by "
                                f"grad_accum {grad_accum}")
            elif (global_batch_size // grad_accum) % dp:
                problems.append(
                    f"per-chunk batch {global_batch_size // grad_accum} (global "
                    f"{global_batch_size} / grad_accum {grad_accum}) not divisible by "
                    f"data-parallel degree {dp}")
    if problems:
        raise SystemExit("preflight failed:\n  - " + "\n  - ".join(problems))
