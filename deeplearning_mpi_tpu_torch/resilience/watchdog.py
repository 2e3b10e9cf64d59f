"""Loader stall watchdog: bounded retry with backoff, poison-batch quarantine.

Port of ``deeplearning_mpi_tpu/resilience/watchdog.py``. A wedged input
pipeline idles the card without crashing anything. :class:`ResilientLoader`
wraps the port's ``data.loader.Loader`` and assembles every batch on a
disposable worker thread with a deadline:

- a batch that exceeds ``batch_timeout_s`` (a stall) is assembled again
  from scratch after a backoff, up to ``max_retries`` times; the stalled
  worker is abandoned (a daemon), never joined;
- a batch that fails every attempt (a poison batch) is quarantined:
  logged, counted and skipped, the recovery booked for an injected
  ``loader_die``.

Assembly is host numpy only (``Loader.local_batch``); the copy to the
device runs on the consumer thread after a successful fetch. A retry calls
``local_batch(order, start, epoch)`` with the same arguments, whose
transform generator is seeded by ``(seed, epoch, start)``, so a retried
batch is bitwise the unstalled one and the batch order is the wrapped
loader's. Assembly is serialised (no lookahead): wrap the loader only
under chaos.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterator

import torch

__all__ = ["ResilientLoader"]


class ResilientLoader:
    """Watchdog over a ``Loader`` with the same ``epoch()`` surface.

    ``chaos``: a :class:`~.faults.ChaosInjector` that injects planned
    ``loader_stall`` / ``loader_die`` faults in the worker and takes the
    books. ``batch_timeout_s``: the stall deadline an attempt;
    ``max_retries``: attempts after the first; ``backoff_s``: the sleep
    before attempt ``k`` is ``backoff_s * k``; ``logger``: ``.log(str)``
    (default ``print``)."""

    def __init__(self, loader: Any, *, chaos: Any = None, batch_timeout_s: float = 30.0,
                 max_retries: int = 2, backoff_s: float = 0.25, logger: Any = None) -> None:
        self.loader = loader
        self.chaos = chaos
        self.batch_timeout_s = batch_timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._log = logger.log if logger is not None else print
        self.stalls = 0
        self.retries = 0
        self.quarantined: list[int] = []

    def __getattr__(self, name: str) -> Any:
        # Transparent delegation (steps_per_epoch, batch_size, dataset, ...).
        return getattr(self.loader, name)

    def epoch(self, epoch: int) -> Iterator[dict[str, torch.Tensor]]:
        order = self.loader.epoch_order(epoch)
        bsz = self.loader.batch_size
        if len(order) == 0:
            raise ValueError(f"dataset of {len(self.loader.dataset)} examples yields no full "
                             f"batch of {bsz}; lower the batch size or use drop_last=False")
        device = self.loader.device
        for bi, start in enumerate(range(0, len(order), bsz)):
            stacked = self._fetch(order, start, epoch, batch_index=bi)
            if stacked is None:
                continue  # quarantined
            yield {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        return self.epoch(0)

    def _fetch(self, order: Any, start: int, epoch: int, *, batch_index: int) -> Any | None:
        """One batch through the deadline / retry / quarantine machine: the
        host batch, or None when quarantined."""
        t0 = time.monotonic()
        last_error: BaseException | None = None
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                self.retries += 1
                time.sleep(self.backoff_s * attempt)
            result: list[Any] = []
            failure: list[BaseException] = []
            done = threading.Event()

            def worker() -> None:
                try:
                    if self.chaos is not None:
                        self.chaos.loader_fault(batch=batch_index)
                    result.append(self.loader.local_batch(order, start, epoch))
                except BaseException as e:  # noqa: BLE001 — judged by the retry loop
                    failure.append(e)
                finally:
                    done.set()

            threading.Thread(target=worker, daemon=True,
                             name=f"loader-watchdog-{batch_index}").start()
            if not done.wait(self.batch_timeout_s):
                # A stall: abandon the worker (its late result lands in this
                # attempt's list, which nobody reads) and retry afresh.
                self.stalls += 1
                self._log(f"loader watchdog: batch {batch_index} stalled "
                          f"(> {self.batch_timeout_s:.1f}s), attempt {attempt + 1}/"
                          f"{self.max_retries + 1}")
                last_error = TimeoutError(
                    f"batch {batch_index} assembly exceeded {self.batch_timeout_s}s")
                continue
            if failure:
                last_error = failure[0]
                self._log(f"loader watchdog: batch {batch_index} failed "
                          f"({type(last_error).__name__}: {last_error}), attempt "
                          f"{attempt + 1}/{self.max_retries + 1}")
                continue
            if self.chaos is not None:
                # A delivery closes a pending stall fault (a no-op when none
                # fired).
                self.chaos.record_recovery("loader_stall", at=batch_index,
                                           latency_s=time.monotonic() - t0)
            return result[0]
        # Every attempt stalled or raised: skip the batch (one lost batch
        # beats a lost run) and book it as the loader_die recovery.
        self.quarantined.append(batch_index)
        self._log(f"loader watchdog: QUARANTINED batch {batch_index} after "
                  f"{self.max_retries + 1} attempts (last: {type(last_error).__name__}: "
                  f"{last_error})")
        if self.chaos is not None:
            self.chaos.record_recovery("loader_die", at=batch_index,
                                       latency_s=time.monotonic() - t0)
        return None
