"""Graceful preemption: SIGTERM → final checkpoint → clean exit.

The port's copy of ``deeplearning_mpi_tpu/resilience/preemption.py``
(plain Python). A preempted machine gets SIGTERM and, after a grace
window, SIGKILL. :class:`GracefulShutdown` turns the signal into a *flag*;
the trainer checks it at epoch boundaries (never inside a step), takes one
final checkpoint and raises :class:`Preempted`, so the exit is clean AND
distinguishable from a crash: an orchestrator can treat it as a reschedule.
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Iterable

__all__ = ["GracefulShutdown", "Preempted"]


class Preempted(RuntimeError):
    """Training stopped cleanly at a batch boundary after a shutdown
    request; a final checkpoint for ``epoch`` was taken first."""

    def __init__(self, epoch: int) -> None:
        super().__init__(f"preempted: final checkpoint saved at epoch {epoch}")
        self.epoch = epoch


class GracefulShutdown:
    """Latched shutdown request, signal-driven or manual.

    ``install()`` registers handlers for ``signals`` (default SIGTERM);
    handlers only set a :class:`threading.Event` — all real work happens
    at the trainer's next epoch boundary, on the main thread. ``signal.signal`` only works on the main
    thread; off it (pytest-xdist workers, notebook executors) install
    degrades to manual :meth:`request` rather than failing.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)) -> None:
        self.signals = tuple(signals)
        self.installed = False
        self._event = threading.Event()
        self._previous: dict[int, Any] = {}

    def install(self) -> "GracefulShutdown":
        try:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._handler)
            self.installed = True
        except ValueError:  # not on the main thread
            self._previous.clear()
            self.installed = False
        return self

    def _handler(self, signum: int, frame: Any) -> None:
        self._event.set()

    def request(self) -> None:
        """Manual trigger — tests and in-process orchestration."""
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()

    def uninstall(self) -> None:
        if self.installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            self.installed = False

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()
