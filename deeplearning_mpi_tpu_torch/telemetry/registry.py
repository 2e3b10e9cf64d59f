"""Metrics registry: counters, gauges and histograms with pluggable sinks.

Port of the reference's ``telemetry/registry.py``, with its constraints, in
order:

1. **Never add a device sync.** The train step's scalars stay tensors on
   the card: :meth:`MetricsRegistry.record_step` buffers them unread, and
   :meth:`MetricsRegistry.flush_steps` reads everything buffered in ONE
   device-to-host copy (one ``torch.stack(...).cpu()`` a device, where the
   reference makes one ``jax.device_get``), at epoch end, when the host was
   going to block anyway. In eager PyTorch a stray ``float(t)``,
   ``.item()``, ``.tolist()`` or ``bool(t)`` on a card tensor is such a
   sync; none is made before the flush.
2. **One canonical record shape.** Every emission (step, epoch, eval,
   serving summary) is a flat JSON-serializable dict ``{"ts": float,
   "kind": str, **values}``: ``RunLogger.log_metrics`` takes it through
   :class:`LoggerSink`, and the reference's ``tools/metrics_report.py``
   renders it.
3. **Sinks are dumb.** A sink implements ``write(record)`` and optionally
   ``close()``; a sink that raises never reaches the training loop (a
   failed write is a dropped record, not a dead run).

The instruments follow the Prometheus taxonomy: ``Counter`` (monotonic),
``Gauge`` (set to the current value), ``Histogram`` (observations and a
nearest-rank percentile summary).
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Iterable, Mapping

import torch


def _jsonable(v: Any) -> Any:
    """Plain floats for numpy scalars and host tensors; JSON types as they are."""
    if isinstance(v, (str, bool, int, type(None))):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    try:
        f = float(v)
    except (TypeError, ValueError, RuntimeError):
        return str(v)
    return f if math.isfinite(f) else None


def labeled(name: str, **labels: str) -> str:
    """Prometheus-style labeled instrument name ``name{k="v",...}``, keys
    sorted, so one label set always names one instrument. The unlabeled
    base instrument is kept by the callers beside it."""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (steps run, tokens seen, bytes moved)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        self.value += amount


class Gauge:
    """Point-in-time value (bytes in use, learning rate, MFU)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: float | None = None

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Observation stream with percentile summaries (step latency, TTFT)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.observations: list[float] = []

    def observe(self, value: float) -> None:
        self.observations.append(float(value))

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over everything observed; ``q`` in [0, 1]."""
        if not self.observations:
            return None
        d = sorted(self.observations)
        return d[int(q * (len(d) - 1))]

    def summary(self) -> dict[str, float]:
        if not self.observations:
            return {}
        return {
            "count": float(len(self.observations)),
            "mean": sum(self.observations) / len(self.observations),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "max": max(self.observations),
        }


class InMemorySink:
    """Keeps every record in a list (tests, ad-hoc inspection)."""

    def __init__(self) -> None:
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object a line, flushed a record, so a crashed run still has
    its telemetry."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("a")

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class LoggerSink:
    """Adapter onto ``RunLogger.log_metrics``: the canonical record is the
    run log's sidecar record."""

    def __init__(self, logger: Any) -> None:
        self._logger = logger

    def write(self, record: dict) -> None:
        self._logger.log_metrics(record)

    def close(self) -> None:
        pass


class TensorBoardSink:
    """Optional scalar export through ``torch.utils.tensorboard``. A soft
    dependency: without the ``tensorboard`` package it raises ImportError,
    as the reference does; nothing else here imports it."""

    def __init__(self, log_dir: str | Path) -> None:
        try:
            from torch.utils import tensorboard as _tb
        except ImportError as e:
            raise ImportError("TensorBoardSink needs torch.utils.tensorboard "
                              "(the tensorboard package)") from e
        self._writer = _tb.SummaryWriter(str(log_dir))

    def write(self, record: dict) -> None:
        step = int(record.get("step", record.get("epoch", 0)) or 0)
        for key, value in record.items():
            if key in ("ts", "kind", "step", "epoch"):
                continue
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                self._writer.add_scalar(f"{record.get('kind', 'run')}/{key}", value, step)

    def close(self) -> None:
        self._writer.flush()


def _fetch(pending: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """``pending`` with every tensor value read to a Python float: the
    tensors of one device go through ONE ``torch.stack(...).cpu()`` (cast
    to float32 first, so scalars of mixed dtypes stack); other values pass
    through as they are."""
    by_device: dict[torch.device, list[tuple[int, str, torch.Tensor]]] = {}
    for i, scalars in enumerate(pending):
        for k, v in scalars.items():
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append((i, k, v))
    out = [dict(s) for s in pending]
    for entries in by_device.values():
        host = torch.stack([v.detach().reshape(()).float() for _, _, v in entries]).cpu()
        for (i, k, _), value in zip(entries, host.tolist()):
            out[i][k] = value
    return out


class MetricsRegistry:
    """Named instruments, record emission and step-scalar buffering.

    ``emit(kind, values)`` is the only path a record takes to the sinks,
    so the canonical shape is enforced in one place; ``record_step`` /
    ``flush_steps`` keep the no-extra-syncs contract of the module
    docstring.
    """

    def __init__(self, sinks: Iterable[Any] = ()) -> None:
        self.sinks: list[Any] = list(sinks)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        #: [(step, {name: device tensor or host value})] awaiting one read
        self._pending_steps: list[tuple[int, dict[str, Any]]] = []

    # -- instruments (get-or-create, Prometheus style) ---------------------
    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram(name))

    # -- sinks -------------------------------------------------------------
    def add_sink(self, sink: Any) -> None:
        self.sinks.append(sink)

    def emit(self, kind: str, values: Mapping[str, Any]) -> dict:
        """Fan one canonical record out to every sink; returns the record."""
        record = {"ts": time.time(), "kind": kind}
        record.update({k: _jsonable(v) for k, v in values.items()})
        for sink in self.sinks:
            try:
                sink.write(record)
            except Exception:
                pass  # a sink must never kill the training loop
        return record

    # -- per-step scalars out of the train step ----------------------------
    def record_step(self, step: int, scalars: Mapping[str, Any]) -> None:
        """Buffer one step's scalars WITHOUT reading them: card tensors stay
        on the card and the loop keeps running ahead of it."""
        self._pending_steps.append((step, dict(scalars)))

    def flush_steps(self, extra: Mapping[str, Any] | None = None) -> list[dict]:
        """One device-to-host read of everything buffered, then one
        ``"step"`` record a step; ``extra`` keys are merged into every
        record of the flush."""
        if not self._pending_steps:
            return []
        pending, self._pending_steps = self._pending_steps, []
        fetched = _fetch([s for _, s in pending])
        extra = dict(extra or {})
        return [self.emit("step", {"step": step, **scalars, **extra})
                for (step, _), scalars in zip(pending, fetched)]

    def drop_pending_steps(self) -> int:
        """Discard the buffered (unread) step scalars; returns the count.
        A rolled-back episode's steps never happened: their records must
        not reach the sinks. Dropping tensor references reads nothing."""
        n = len(self._pending_steps)
        self._pending_steps.clear()
        return n

    def snapshot(self) -> dict[str, Any]:
        """Current instrument values as one flat dict."""
        snap: dict[str, Any] = {}
        for c in self._counters.values():
            snap[c.name] = c.value
        for g in self._gauges.values():
            if g.value is not None:
                snap[g.name] = g.value
        for h in self._histograms.values():
            for stat, v in h.summary().items():
                snap[f"{h.name}_{stat}"] = v
        return snap

    def close(self) -> None:
        try:
            self.flush_steps()  # a crashed or short run still keeps its buffer
        except Exception:
            pass
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass
