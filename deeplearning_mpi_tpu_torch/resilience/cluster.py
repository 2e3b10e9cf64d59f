"""The supervision core the pod supervisor stands on.

Port of the parts of ``deeplearning_mpi_tpu/resilience/cluster.py`` that
:mod:`.pod` needs (the serving fleet's supervisor, ROADMAP Queue 1 item
10's serving half, will stand on the same core):

- :class:`LivenessTracker`: progress-seq liveness over heartbeat payloads,
  on the supervisor's own monotonic clock;
- :func:`tail_jsonl`: an offset-tailing reader of append-only JSONL that
  consumes only newline-terminated records;
- :func:`sigkill_group` / :func:`reap` / :func:`kill_and_reap`: the
  teardown of workers spawned with ``start_new_session=True``;
- :func:`scrub_rendezvous_env`: a lone process must never inherit a
  coordinator address and wait for peers;
- :class:`SupervisorJournal` / :func:`replay_journal` /
  :func:`next_incarnation`: the write-ahead journal of supervisor
  transitions, stamped with a monotonic incarnation id (the re-adoption of
  a dead supervisor's workers from it is the serving fleet's, item 10's
  serving half);
- :class:`ClusterSupervisor`: chaos spec and injector, the registry, the
  heartbeat cadence and the JSONL metrics sink.

Nothing here touches a device: it is plain processes and files.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping, MutableMapping, Optional

from deeplearning_mpi_tpu_torch.resilience.faults import ENV_SPEC, ChaosInjector, FaultPlan
from deeplearning_mpi_tpu_torch.resilience.integrity import atomic_write_json
from deeplearning_mpi_tpu_torch.telemetry.registry import JsonlSink, MetricsRegistry

__all__ = [
    "ENV_HEARTBEAT_DIR",
    "ENV_HEARTBEAT_INTERVAL",
    "ENV_INCARNATION",
    "INCARNATION_FILE",
    "JOURNAL_FILE",
    "RENDEZVOUS_VARS",
    "SUP_INCARNATION",
    "ClusterSupervisor",
    "LivenessTracker",
    "SupervisorJournal",
    "kill_and_reap",
    "next_incarnation",
    "reap",
    "replay_journal",
    "scrub_rendezvous_env",
    "sigkill_group",
    "tail_jsonl",
]

#: directory the workers write ``heartbeat-{rank}.json`` into (the
#: supervisor ↔ worker contract; ``utils.config.build_observability``).
ENV_HEARTBEAT_DIR = "DMT_HEARTBEAT_DIR"
#: heartbeat interval override (seconds).
ENV_HEARTBEAT_INTERVAL = "DMT_HEARTBEAT_INTERVAL_S"
#: the rendezvous variables ``runtime/bootstrap.py`` reads.
RENDEZVOUS_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
#: the supervisor's incarnation, echoed in every worker heartbeat.
ENV_INCARNATION = "DMT_SUPERVISOR_INCARNATION"
#: the persisted monotonic incarnation counter.
INCARNATION_FILE = "incarnation.json"
#: the write-ahead journal under the supervisor's run directory.
JOURNAL_FILE = "journal.jsonl"

SUP_INCARNATION = "supervisor_incarnation"


def next_incarnation(root_dir: Path | str) -> int:
    """Read, bump and persist (atomically) the supervisor incarnation
    counter of ``root_dir``: every start owns a larger id than every
    predecessor."""
    root = Path(root_dir)
    root.mkdir(parents=True, exist_ok=True)
    path = root / INCARNATION_FILE
    try:
        prev = int(json.loads(path.read_text()).get("incarnation", 0))
    except (OSError, ValueError, TypeError, AttributeError):
        prev = 0
    inc = prev + 1
    atomic_write_json(path, {"incarnation": inc, "pid": os.getpid()})
    return inc


class SupervisorJournal:
    """Append-only write-ahead journal of supervisor transitions: one
    newline-terminated JSON record each, flushed before the action it
    describes, stamped with the writer's incarnation."""

    def __init__(self, root_dir: Path | str, *, incarnation: int,
                 clock: Callable[[], float] = time.monotonic) -> None:
        root = Path(root_dir)
        root.mkdir(parents=True, exist_ok=True)
        self.path = root / JOURNAL_FILE
        self.incarnation = incarnation
        self._clock = clock
        self._f = self.path.open("a", encoding="utf-8")

    def record(self, ev: str, **fields: Any) -> None:
        rec = {"inc": self.incarnation, "t": self._clock(), "ev": ev, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def tail_jsonl(path: Path, offset: int) -> tuple[list[dict], int]:
    """The complete JSONL records appended past ``offset`` and the new
    offset; a partial trailing line stays unread until its newline lands."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read()
    except OSError:
        return [], offset
    end = data.rfind(b"\n")
    if end < 0:
        return [], offset
    chunk = data[: end + 1]
    return [json.loads(line) for line in chunk.splitlines() if line.strip()], offset + len(chunk)


def replay_journal(path: Path | str) -> list[dict]:
    """Every complete record of a journal, oldest first (a torn final line
    is dropped)."""
    return tail_jsonl(Path(path), 0)[0]


def sigkill_group(proc: subprocess.Popen) -> None:
    """SIGKILL ``proc``'s process group (it is a session leader); the
    process alone when the group is gone or not ours."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        proc.kill()


def reap(proc: subprocess.Popen, timeout_s: float = 10.0) -> None:
    """Wait for ``proc`` to exit, bounded."""
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        pass


def kill_and_reap(proc: subprocess.Popen, timeout_s: float = 10.0) -> None:
    """SIGKILL the group iff still running, then reap."""
    if proc.poll() is None:
        sigkill_group(proc)
        reap(proc, timeout_s)


def scrub_rendezvous_env(env: MutableMapping[str, str]) -> None:
    """Remove the rendezvous variables from a child's env in place."""
    for k in RENDEZVOUS_VARS:
        env.pop(k, None)


class LivenessTracker:
    """Pod-level liveness over per-rank heartbeat payloads, on THIS
    process's ``clock`` and the times it observed ``progress_seq`` change
    (never the payload's own clock fields, which belong to another
    process). Verdicts per rank: **stalled** (no progress within
    ``grace_s`` of the tracker's start, or none within ``deadline_s`` after
    progressing once), **straggler** (progressing, but its progress age
    exceeds ``straggler_factor`` × the median inter-progress interval while
    still under the deadline), healthy otherwise. With ``incarnation`` set,
    beats stamped with another incarnation are ignored."""

    def __init__(self, ranks: Iterable[int], *, deadline_s: float, grace_s: float,
                 straggler_factor: float = 4.0, clock: Callable[[], float] = time.monotonic,
                 incarnation: int | None = None) -> None:
        self.deadline_s = deadline_s
        self.grace_s = grace_s
        self.straggler_factor = straggler_factor
        self.incarnation = incarnation
        self._clock = clock
        self._start = clock()
        self._ranks = list(ranks)
        self._last_seq: dict[int, Any] = {}
        self._last_change: dict[int, float] = {}
        self._last_step: dict[int, float] = {}
        self._interval_ema: dict[int, float] = {}
        self._seen_progress: set[int] = set()

    def observe(self, rank: int, payload: Mapping[str, Any] | None) -> None:
        """Feed one heartbeat read (None: missing or unreadable)."""
        if payload is None:
            return
        if self.incarnation is not None:
            inc = payload.get("incarnation")
            if inc is not None and inc != self.incarnation:
                return  # a dead control plane's worker
        now = self._clock()
        if isinstance(payload.get("step"), (int, float)):
            self._last_step[rank] = float(payload["step"])
        seq = payload.get("progress_seq", payload.get("time"))
        prev = self._last_seq.get(rank)
        if prev is None:
            self._last_seq[rank] = seq
            self._last_change[rank] = now
            if isinstance(seq, (int, float)) and seq and seq > 0:
                # The first read already shows the loop's progress.
                self._seen_progress.add(rank)
            return
        if seq != prev:
            interval = now - self._last_change[rank]
            if rank in self._seen_progress:
                ema = self._interval_ema.get(rank)
                self._interval_ema[rank] = interval if ema is None else 0.5 * ema + 0.5 * interval
            self._seen_progress.add(rank)
            self._last_seq[rank] = seq
            self._last_change[rank] = now

    def any_progress(self) -> bool:
        """True once ANY rank's loop has advanced."""
        return bool(self._seen_progress)

    def progress_age_s(self, rank: int) -> float:
        """Seconds (this clock) since ``rank`` last changed state."""
        return self._clock() - self._last_change.get(rank, self._start)

    def stalled(self, rank: int) -> bool:
        if rank not in self._seen_progress:
            return self._clock() - self._start > self.grace_s
        return self.progress_age_s(rank) > self.deadline_s

    def hang_culprits(self, stalled: Iterable[int]) -> list[int]:
        """The rank(s) that CAUSED a stall: the stalled rank(s) with the
        lowest last reported ``step`` (its peers ran ahead until they
        blocked in a collective); a rank that never reported a step always
        counts. Ties return every tied rank."""
        stalled = list(stalled)
        if not stalled:
            return []
        steps = {r: self._last_step.get(r, float("-inf")) for r in stalled}
        lowest = min(steps.values())
        return [r for r in stalled if steps[r] == lowest]

    def stragglers(self, active: Iterable[int]) -> list[int]:
        known = [v for v in self._interval_ema.values() if v > 0]
        if not known:
            return []
        threshold = self.straggler_factor * statistics.median(known)
        return [r for r in active if r in self._seen_progress
                and threshold < self.progress_age_s(r) <= self.deadline_s]


class ClusterSupervisor:
    """Shared supervisor bones: the chaos spec and injector, the registry,
    the heartbeat cadence and the run directory's JSONL metrics sink.
    Subclasses own the domain semantics; ``log_name`` prefixes each log
    line."""

    log_name = "cluster"

    def __init__(self, root_dir: str | Path, *, chaos: str | None = None,
                 heartbeat_deadline_s: float, heartbeat_interval_s: float,
                 spawn_grace_s: float, poll_interval_s: float,
                 registry: MetricsRegistry | None = None,
                 env: Mapping[str, str] | None = None) -> None:
        self.dir = Path(root_dir)
        self.chaos_spec = chaos or os.environ.get(ENV_SPEC) or ""
        self.heartbeat_deadline_s = heartbeat_deadline_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.spawn_grace_s = spawn_grace_s
        self.poll_interval_s = poll_interval_s
        self.extra_env = dict(env or {})
        self._own_registry = registry is None
        self.registry = registry or MetricsRegistry()
        self.incarnation: int | None = None
        self.journal: SupervisorJournal | None = None

    def _log(self, msg: str) -> None:
        print(f"{self.log_name}: {msg}", flush=True)

    def _open_books(self, sink_name: str) -> Optional[ChaosInjector]:
        """The run directory, its JSONL metrics sink, and the chaos injector
        when a spec is set."""
        self.dir.mkdir(parents=True, exist_ok=True)
        self.registry.add_sink(JsonlSink(self.dir / sink_name))
        if self.chaos_spec.strip():
            return ChaosInjector(FaultPlan.parse(self.chaos_spec), registry=self.registry)
        return None

    @staticmethod
    def _kill_orphan(pid: int) -> None:
        """SIGKILL a journaled orphan by pid (group first)."""
        if pid <= 0:
            return
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def _open_journal(self) -> tuple[SupervisorJournal, list[dict]]:
        """Bump the incarnation, replay a dead predecessor's journal and open
        it for appending; returns ``(journal, prior records)``."""
        self.dir.mkdir(parents=True, exist_ok=True)
        prior = replay_journal(self.dir / JOURNAL_FILE)
        self.incarnation = next_incarnation(self.dir)
        self.journal = SupervisorJournal(self.dir, incarnation=self.incarnation)
        self.journal.record("supervisor_start", pid=os.getpid(), prior_records=len(prior),
                            prior_incarnations=sorted({r.get("inc") for r in prior
                                                       if r.get("inc") is not None}))
        return self.journal, prior

    def new_tracker(self, ranks: Iterable[int], *,
                    straggler_factor: float = 4.0) -> LivenessTracker:
        """A :class:`LivenessTracker` on this supervisor's cadence and
        incarnation."""
        return LivenessTracker(ranks, deadline_s=self.heartbeat_deadline_s,
                               grace_s=self.spawn_grace_s, straggler_factor=straggler_factor,
                               incarnation=self.incarnation)

    def _close_registry(self) -> None:
        if self._own_registry:
            self.registry.close()
