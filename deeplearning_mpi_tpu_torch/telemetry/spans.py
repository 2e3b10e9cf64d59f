"""Distributed request tracing + crash flight recorder.

The port's copy of the reference's ``telemetry/spans.py`` (it reads and
writes only the stdlib), so the reference's readers — its
``load_trace_file`` and ``tools/trace_report.py`` — merge the port's
span files unchanged.

Three pieces, in order of dependency:

1. :class:`Span` — an explicit span model: id, parent id, a *trace*
   correlation key (request id or ``step:N``), monotonic start/end, and a
   small label dict. Spans are plain records, not context-manager magic,
   because the serving spans we care about (queue dwell, prefill, the
   prefill→decode handoff, decode) are NOT lexical scopes — they open in
   one engine step and close many steps later, sometimes in a different
   process.
2. :class:`SpanRecorder` — the per-process writer. One recorder owns one
   JSONL file for its whole life (the single-writer contract, DMT005):
   newline-terminated ``json.dumps`` per record, flushed immediately, so a
   crashed process still leaves every completed span on disk and a torn
   final line is the only damage possible. The FIRST line of every trace
   file is a ``trace_meta`` record carrying the process's
   monotonic-vs-epoch clock offset (``time.time() - time.monotonic()``,
   sampled once): CLOCK_MONOTONIC is system-wide on Linux but has an
   arbitrary epoch, so the offset is what lets ``tools/trace_report.py``
   merge a fleet of per-process files onto one wall-clock timeline — and
   detect genuinely skewed recorders (tests inject skew through the
   ``epoch_clock`` hook).
3. The **flight recorder** — every recorder keeps a bounded in-memory ring
   of its most recent records. :meth:`SpanRecorder.dump_flight` writes the
   ring atomically (tmp + rename) and the module-level :func:`dump_all`
   dumps every live recorder in the process: the sanitizer calls it on a
   trip, the chaos injector calls it before a ``replica_kill``/``rank_kill``
   detonates or a hang wedges the thread, and supervisors call it on
   watchdog timeouts — so "the last moments before the wedge" survive even
   when the JSONL trail was cut mid-line.

Costless-off contract (the ``DMT_SANITIZE`` pattern): nothing here is a
global switch. Hot paths hold ``tracer = None`` unless a trace dir was
configured and guard every hook with ``if tracer is not None`` — one
pointer test, no allocation, when tracing is off. The
reference's allocation-counting micro-test pins that.

Recording never raises into the caller: a failed write degrades to a
``span_dropped_total`` count, mirroring the metrics-sink contract.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Iterable, Optional

__all__ = [
    "SCHEMA_VERSION",
    "Span",
    "SpanRecorder",
    "dump_all",
    "load_trace_file",
    "span_tree",
]

#: bumped when the on-disk record shape changes; readers check it.
SCHEMA_VERSION = 1

#: live recorders in this process, in creation order — what :func:`dump_all`
#: walks. A recorder leaves on :meth:`SpanRecorder.close`.
_RECORDERS: list["SpanRecorder"] = []
_RECORDERS_LOCK = threading.Lock()


class Span:
    """One timed interval. ``t0``/``t1`` are process-monotonic seconds;
    ``t1 is None`` while the span is open. ``trace`` is the correlation
    key that stitches spans across processes (a fleet rid like ``"r5"``,
    or ``"step:12"`` for a training step)."""

    __slots__ = ("name", "sid", "parent", "trace", "t0", "t1", "labels")

    def __init__(
        self,
        name: str,
        sid: str,
        *,
        parent: Optional[str] = None,
        trace: Optional[str] = None,
        t0: float = 0.0,
        t1: Optional[float] = None,
        labels: Optional[dict[str, Any]] = None,
    ) -> None:
        self.name = name
        self.sid = sid
        self.parent = parent
        self.trace = trace
        self.t0 = t0
        self.t1 = t1
        self.labels = labels or {}

    @property
    def duration(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_record(self) -> dict[str, Any]:
        rec: dict[str, Any] = {
            "kind": "span",
            "name": self.name,
            "sid": self.sid,
            "t0": self.t0,
            "t1": self.t1,
        }
        if self.parent is not None:
            rec["parent"] = self.parent
        if self.trace is not None:
            rec["trace"] = self.trace
        if self.labels:
            rec["labels"] = self.labels
        return rec

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"Span({self.name!r}, sid={self.sid!r}, trace={self.trace!r}, "
            f"t0={self.t0:.6f}, t1={self.t1})"
        )


class SpanRecorder:
    """Per-process span writer + bounded flight ring.

    Parameters
    ----------
    path:
        The JSONL trace file. Opened append-mode once and held for the
        recorder's life (single writer per file — fleet workers encode
        their pid into the filename so respawned attempts never share).
    proc:
        Human-readable process name (``"supervisor"``, ``"replica0"``,
        ``"trainer"``) — goes into the meta line and every span id.
    clock / epoch_clock:
        Monotonic and wall clocks, injectable for deterministic tests and
        for the clock-skew regression test (skew the ``epoch_clock`` of
        one recorder and assert the merged timeline still lines up).
    ring:
        Flight-recorder depth: how many recent records survive to a dump.
    registry:
        Optional :class:`~..registry.MetricsRegistry` to mirror counts
        into (``span_recorded_total`` etc.) so ``metrics_report`` can
        render a Tracing table from an ordinary snapshot.
    """

    def __init__(
        self,
        path: str | Path,
        *,
        proc: str = "proc",
        clock: Callable[[], float] = time.monotonic,
        epoch_clock: Callable[[], float] = time.time,
        ring: int = 256,
        registry: Any = None,
        flight_dir: str | Path | None = None,
    ) -> None:
        self.path = Path(path)
        self.proc = proc
        self.pid = os.getpid()
        self._clock = clock
        # Sampled ONCE: the offset is a constant property of this process's
        # monotonic epoch; re-sampling per record would smear real wall-clock
        # adjustments (NTP steps) across the trace.
        self.mono_offset = epoch_clock() - clock()
        self.flight_dir = Path(flight_dir) if flight_dir else self.path.parent
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(1, int(ring)))
        self._lock = threading.Lock()
        self._next_sid = 0
        self._registry = registry
        self.spans_total = 0
        self.events_total = 0
        self.dropped_total = 0
        self.dumps_total = 0
        self._closed = False
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("a")
        if registry is not None:
            registry.counter("span_recorded_total")
            registry.counter("span_dropped_total")
            registry.counter("flight_dump_total")
            registry.gauge("trace_clock_offset_s").set(self.mono_offset)
        self._write(
            {
                "kind": "trace_meta",
                "schema": SCHEMA_VERSION,
                "proc": proc,
                "pid": self.pid,
                "mono_offset": self.mono_offset,
                "ts": self.mono_offset + clock(),
            }
        )
        with _RECORDERS_LOCK:
            _RECORDERS.append(self)

    # -- span lifecycle ----------------------------------------------------
    def begin(
        self,
        name: str,
        *,
        trace: Optional[str] = None,
        parent: Optional[str] = None,
        t0: Optional[float] = None,
        **labels: Any,
    ) -> Span:
        """Open a span. Nothing is written until :meth:`end` — an open
        span that dies with the process is reconstructable only from the
        flight ring of whoever dumped, which is exactly the semantics a
        crash report wants."""
        with self._lock:
            sid = f"{self.proc}/{self.pid}:{self._next_sid}"
            self._next_sid += 1
        return Span(
            name,
            sid,
            parent=parent,
            trace=trace,
            t0=self._clock() if t0 is None else t0,
            labels=dict(labels) if labels else None,
        )

    def end(self, span: Span, *, t1: Optional[float] = None) -> Span:
        """Close ``span`` and write it."""
        span.t1 = self._clock() if t1 is None else t1
        self._emit_span(span)
        return span

    def record_span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        trace: Optional[str] = None,
        parent: Optional[str] = None,
        **labels: Any,
    ) -> Span:
        """Write a complete span retroactively from existing timestamps.

        This is the serving hot path's preferred form: the engine already
        stamps ``arrival`` / ``t_admitted`` / ``t_first_token`` /
        ``t_finished`` on every request, so the queue/prefill/decode spans
        are derived in one call at finish time instead of tracking open
        span objects through the scheduler."""
        span = self.begin(name, trace=trace, parent=parent, t0=t0, **labels)
        span.t1 = t1
        self._emit_span(span)
        return span

    def event(
        self,
        name: str,
        *,
        trace: Optional[str] = None,
        t: Optional[float] = None,
        **labels: Any,
    ) -> None:
        """Instantaneous marker (a dispatch, a hedge, a failover)."""
        rec: dict[str, Any] = {
            "kind": "event",
            "name": name,
            "t": self._clock() if t is None else t,
        }
        if trace is not None:
            rec["trace"] = trace
        if labels:
            rec["labels"] = labels
        self.events_total += 1
        self._write(rec)

    def _emit_span(self, span: Span) -> None:
        self.spans_total += 1
        if self._registry is not None:
            self._registry.counter("span_recorded_total").inc()
        self._write(span.to_record())

    # -- plumbing ----------------------------------------------------------
    def _write(self, rec: dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(rec)
            if self._closed:
                return
            try:
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()
            except Exception:
                self.dropped_total += 1
                if self._registry is not None:
                    self._registry.counter("span_dropped_total").inc()

    # -- flight recorder ---------------------------------------------------
    def dump_flight(self, reason: str) -> Optional[Path]:
        """Atomically write the ring to ``flight_dir`` and return the path
        (``None`` on failure — a dump must never mask the original fault).
        The filename encodes proc, pid, and reason so every dump of a
        multi-process incident lands side by side."""
        safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)
        out = self.flight_dir / f"flight-{self.proc}-{self.pid}-{safe}.json"
        payload = {
            "kind": "flight_dump",
            "schema": SCHEMA_VERSION,
            "reason": reason,
            "proc": self.proc,
            "pid": self.pid,
            "mono_offset": self.mono_offset,
            "t_dump": self._clock(),
            "spans_total": self.spans_total,
            "events_total": self.events_total,
            "dropped_total": self.dropped_total,
            "ring": list(self._ring),
        }
        try:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".tmp.{self.pid}")
            # tmp + rename by hand (not resilience.integrity.atomic_write_json)
            # to keep telemetry import-free of resilience.
            with tmp.open("w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, out)
        except Exception:
            return None
        self.dumps_total += 1
        if self._registry is not None:
            self._registry.counter("flight_dump_total").inc()
        return out

    def close(self) -> None:
        with _RECORDERS_LOCK:
            if self in _RECORDERS:
                _RECORDERS.remove(self)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.close()
            except Exception:
                pass


def dump_all(reason: str) -> list[Path]:
    """Dump every live recorder's flight ring — the one call sanitizer
    trips, chaos detonations, and watchdog timeouts make. Best-effort by
    construction: a failed dump is skipped, never raised."""
    with _RECORDERS_LOCK:
        recorders = list(_RECORDERS)
    paths = []
    for rec in recorders:
        p = rec.dump_flight(reason)
        if p is not None:
            paths.append(p)
    return paths


# -- readers (shared by tools/trace_report.py and the tests) ---------------

def load_trace_file(path: str | Path) -> tuple[Optional[dict], list[dict]]:
    """Parse one trace JSONL file into ``(meta, records)``.

    Tolerates the single-writer failure mode: a torn (unterminated or
    half-written) final line is dropped, everything before it is kept —
    the mirror of ``tail_jsonl``'s newline-delimited read contract."""
    raw = Path(path).read_bytes()
    meta: Optional[dict] = None
    records: list[dict] = []
    lines = raw.split(b"\n")
    if lines and lines[-1] != b"":
        lines = lines[:-1]  # torn final line: no newline ⇒ maybe no JSON
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # half-flushed garbage; keep reading (defensive)
        if rec.get("kind") == "trace_meta" and meta is None:
            meta = rec
        else:
            records.append(rec)
    return meta, records


def span_tree(
    spans: Iterable[dict],
) -> tuple[dict[str, dict], dict[str, list[dict]], list[dict]]:
    """Index span records into ``(by_sid, children_by_parent, orphans)``.

    An *orphan* names a parent sid that is not present in ``spans`` —
    either its process died before flushing the parent or the correlation
    key was mangled in transit; both are bugs the smoke asserts against."""
    by_sid = {s["sid"]: s for s in spans if s.get("kind") == "span"}
    children: dict[str, list[dict]] = {}
    orphans: list[dict] = []
    for s in by_sid.values():
        parent = s.get("parent")
        if parent is None:
            continue
        if parent in by_sid:
            children.setdefault(parent, []).append(s)
        else:
            orphans.append(s)
    return by_sid, children, orphans
