"""Pod supervisor: elastic multi-process training with failure re-form.

Port of ``deeplearning_mpi_tpu/resilience/pod.py``, the framework's
``torchrun --max-restarts`` grown two capabilities:

1. **Hang detection.** A wedged collective never returns to Python, so
   exit codes miss it, and the worker's :class:`~.supervisor.Heartbeat`
   thread keeps beating through it. The supervisor watches
   ``progress_seq``, which only the training loop advances, on its own
   monotonic clock: no change past ``heartbeat_deadline_s`` is a hang.
2. **Elastic re-form.** The survivors re-rendezvous as a SMALLER world
   (a fresh file store, ``NUM_PROCESSES`` the survivor count, contiguous
   ``PROCESS_ID``s; ``runtime/bootstrap.py`` reads them) and resume from the
   newest checkpoint that verifies (``Checkpointer.restore_elastic``: no
   saved tensor depends on the world size), and the loader's ``(seed,
   epoch)`` order makes the resumed run bitwise a clean from-checkpoint run
   at the surviving size.

The books of ``rank_kill`` / ``rank_hang`` / ``bitflip`` are the
supervisor's: it marks the spec fired when it observes the failure
(``ChaosInjector.fire_observed``), books the recovery when the re-formed
world first makes progress, and strips the fired entry before the respawn.
``pod_metrics.jsonl`` carries the reconciliation.

**Silent data corruption.** Workers run with ``--guardrails
--digest_every N`` carry a ``{step: digest}`` ring on every heartbeat; the
supervisor feeds the rings into a :class:`~.guardrails.DigestVote` each
poll, and the first step where live ranks disagree convicts the minority.
A step that agrees is settled only once every rank of the world holds it
(``DigestVote.tally(quorum=)``): the reference settles it on any two
agreeing rings, so a rank whose ring lands a poll later than its peers'
never gets its vote on that step.
The blamed HOST is booked in a :class:`~.guardrails.QuarantineLedger` read
before every spawn, checkpoints saved after the divergence are pruned, and
the survivors re-form without it.

Where the port differs: a gloo survivor's collective RAISES when a peer's
socket closes (the reference's CPU collectives block), so a rank that
exits with an ordinary error code while a peer died by a signal or by
``RANK_KILL_EXIT`` is collateral, not a failure: it stays in the
re-formed world. When every rank exits 0, the heartbeats are read once
more before the final vote, so a worker's last beat (``Heartbeat.stop``
writes one) is seen. A rank that finished (exit 0) before the vote
convicted it is still blamed. Each re-form starts a fresh vote and a fresh
checkpoint ring: the resumed workers count their steps from 0 again, and
the reference's carried-over rings re-convict (or falsely convict) on the
old attempt's steps.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

from deeplearning_mpi_tpu_torch.resilience.cluster import (
    ENV_HEARTBEAT_DIR,
    ENV_HEARTBEAT_INTERVAL,
    ENV_INCARNATION,
    JOURNAL_FILE,
    SUP_INCARNATION,
    ClusterSupervisor,
    LivenessTracker,
    reap,
    replay_journal,
    scrub_rendezvous_env,
    sigkill_group,
)
from deeplearning_mpi_tpu_torch.resilience.faults import (
    ENV_RANK,
    ENV_SPEC,
    POD_KINDS,
    RANK_KILL_EXIT,
    ChaosInjector,
    pod_entries,
    strip_entries,
)
from deeplearning_mpi_tpu_torch.resilience.guardrails import DigestVote, QuarantineLedger
from deeplearning_mpi_tpu_torch.resilience.supervisor import Heartbeat
from deeplearning_mpi_tpu_torch.telemetry.registry import MetricsRegistry, labeled

__all__ = [
    "ENV_HEARTBEAT_DIR",
    "ENV_HEARTBEAT_INTERVAL",
    "LivenessTracker",
    "POD_DIGEST_MISMATCHES",
    "POD_QUARANTINES",
    "POD_RANK_FAILURES",
    "POD_RESTARTS",
    "POD_STRAGGLERS",
    "POD_WORLD_SIZE",
    "PodFailure",
    "PodResult",
    "PodSupervisor",
    "collateral_deaths",
]

POD_RANK_FAILURES = "pod_rank_failures_total"
POD_RESTARTS = "pod_restarts_total"
POD_WORLD_SIZE = "pod_world_size"
POD_STRAGGLERS = "pod_straggler_flags_total"
POD_DIGEST_MISMATCHES = "guard_digest_mismatch_total"
POD_QUARANTINES = "guard_quarantine_total"


def collateral_deaths(rcs: Mapping[int, Optional[int]]) -> list[int]:
    """The dead ranks of ``rcs`` (rank -> exit code, None while running)
    that died of a peer's death: an ordinary non-zero exit while another
    rank died by a signal (a negative code) or by ``RANK_KILL_EXIT``."""
    dead = {r: rc for r, rc in rcs.items() if rc not in (None, 0)}
    primary = [r for r, rc in dead.items() if rc < 0 or rc == RANK_KILL_EXIT]
    if not primary:
        return []
    return sorted(r for r in dead if r not in primary)


class PodFailure(RuntimeError):
    """The pod cannot continue: survivors below ``min_world_size`` or the
    restart budget is spent. Mirrors ``TrainingFailure`` one level up."""


@dataclasses.dataclass
class PodResult:
    """What a :meth:`PodSupervisor.run` accomplished."""

    ok: bool
    world_sizes: list[int]  # world size of each attempt, in order
    restarts: int
    rank_failures: int
    snapshot: dict[str, Any]  # final registry snapshot (all pod counters)
    chaos_balanced: Optional[bool]  # None when no chaos spec was given


class PodSupervisor(ClusterSupervisor):
    """Spawn one worker per simulated host, watch liveness, re-form on loss.

    ``worker_cmd`` is the full training command (e.g. ``[sys.executable,
    "-m", "deeplearning_mpi_tpu_torch.cli.train_lm", ...]``); it MUST pass
    ``--resume`` so a respawned world restores from the latest checkpoint.
    Per-rank env gets the ``runtime.bootstrap`` rendezvous contract
    (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID`` — a fresh
    file store every attempt), the heartbeat contract (:data:`ENV_HEARTBEAT_DIR`,
    per-attempt subdir), and the current chaos spec via ``$DMT_CHAOS``.

    On a detected failure the remaining world is torn down immediately with
    SIGKILL — with a peer dead, every pending collective hangs or fails, so a
    graceful drain is impossible by construction; recovery is the previous
    checkpoint, which is exactly what the elastic restore path replays.
    """

    log_name = "pod"

    def __init__(
        self,
        worker_cmd: Sequence[str],
        num_processes: int,
        pod_dir: str | Path,
        *,
        chaos: str | None = None,
        heartbeat_deadline_s: float = 60.0,
        heartbeat_interval_s: float = 1.0,
        spawn_grace_s: float = 120.0,
        poll_interval_s: float = 0.5,
        min_world_size: int = 1,
        max_pod_restarts: int = 2,
        straggler_factor: float = 4.0,
        ckpt_dir: str | Path | None = None,
        registry: MetricsRegistry | None = None,
        env: Mapping[str, str] | None = None,
    ) -> None:
        super().__init__(
            pod_dir,
            chaos=chaos,
            heartbeat_deadline_s=heartbeat_deadline_s,
            heartbeat_interval_s=heartbeat_interval_s,
            spawn_grace_s=spawn_grace_s,
            poll_interval_s=poll_interval_s,
            registry=registry,
            env=env,
        )
        self.worker_cmd = list(worker_cmd)
        self.num_processes = num_processes
        self.pod_dir = self.dir
        self.min_world_size = min_world_size
        self.max_pod_restarts = max_pod_restarts
        self.straggler_factor = straggler_factor
        # The workers' checkpoint directory (the Checkpointer root). Only
        # needed for SDC recovery: a digest-blamed corruption poisons every
        # checkpoint saved after the divergence step, and the supervisor —
        # not the (possibly corrupt) workers — must prune them before the
        # survivors resume. None disables the prune.
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir is not None else None

    def _chaos_target(self, spec: str, world: int) -> Optional[int]:
        """Rank a planned pod-level fault detonates on, or None.

        Drills wedge a KNOWN rank (``faults.py``: last rank unless
        ``$DMT_CHAOS_RANK`` overrides). When culprit analysis ties — every
        peer froze at the same last step because it blocked inside its very
        next dispatch instead of running ahead — the plan is the one signal
        that can still break the tie, and the supervisor owns the plan.
        Real incidents have no plan and get ``None``.
        """
        if not pod_entries(spec):
            return None
        raw = self.extra_env.get(ENV_RANK, os.environ.get(ENV_RANK))
        try:
            return int(raw) if raw is not None else world - 1
        except ValueError:
            return None

    # -- spawning ------------------------------------------------------------
    def _spawn(
        self, attempt: int, world: int, spec: str
    ) -> tuple[dict[int, subprocess.Popen], list[Any], Path]:
        hb_dir = self.pod_dir / f"attempt{attempt}" / "heartbeats"
        hb_dir.mkdir(parents=True, exist_ok=True)
        base = dict(os.environ)
        base.update(self.extra_env)
        base[ENV_HEARTBEAT_DIR] = str(hb_dir)
        base[ENV_HEARTBEAT_INTERVAL] = str(self.heartbeat_interval_s)
        # Workers echo this incarnation in every heartbeat so a restarted
        # supervisor's tracker rejects a dead incarnation's beat files.
        base[ENV_INCARNATION] = str(self.incarnation or 0)
        if spec:
            base[ENV_SPEC] = spec
        else:
            base.pop(ENV_SPEC, None)
        if world > 1:
            # A fresh file store an attempt: no port to race for.
            base["COORDINATOR_ADDRESS"] = f"file://{hb_dir.parent.absolute()}/rdzv"
            base["NUM_PROCESSES"] = str(world)
        else:
            # A world of one needs no rendezvous — and leftover coordinator
            # vars would make the lone survivor wait for peers forever.
            scrub_rendezvous_env(base)
        procs: dict[int, subprocess.Popen] = {}
        handles: list[Any] = []
        for rank in range(world):
            env = dict(base)
            if world > 1:
                env["PROCESS_ID"] = str(rank)
            log_path = self.pod_dir / f"attempt{attempt}-rank{rank}.log"
            f = log_path.open("w")  # dmt-lint: disable=DMT004 — per-attempt stdout capture, not a consumed JSON artifact
            handles.append(f)
            procs[rank] = subprocess.Popen(
                self.worker_cmd,
                env=env,
                stdout=f,
                stderr=subprocess.STDOUT,
                start_new_session=True,  # isolate signals from the supervisor
            )
        self._log(
            f"attempt {attempt}: spawned world of {world} "
            f"(pids {[p.pid for p in procs.values()]}, chaos={spec or 'none'})"
        )
        if self.journal is not None:
            self.journal.record(
                "spawn", attempt=attempt, world=world,
                pids=[p.pid for p in procs.values()], chaos=spec,
            )
        return procs, handles, hb_dir

    def _blame_corrupt(
        self,
        divergence: Any,
        hosts: list[int],
        candidates: list[int],
        spec: str,
        world: int,
    ) -> list[int]:
        """Map a :class:`~.guardrails.VoteResult` to guilty rank(s).

        The vote speaks host ids; the minority maps back through ``hosts``
        to current ranks. A tie (two ranks, two digests) falls back to the
        planned chaos target — the one signal left that can break it; no
        target means nobody is blamed and the caller restarts the whole
        world instead.
        """
        self.registry.counter(POD_DIGEST_MISMATCHES).inc()
        self._log(
            f"digest vote: mismatch at step {divergence.step} — "
            + ", ".join(
                f"host {h}: {d[:12]}…"
                for h, d in divergence.digests.items()
            )
        )
        corrupt = [r for r in candidates if hosts[r] in divergence.minority]
        if not corrupt:
            target = self._chaos_target(spec, world)
            if target in candidates:
                self._log(
                    f"digest vote: tied — blaming planned chaos target "
                    f"rank {target}"
                )
                corrupt = [target]
        return corrupt

    def _prune_poisoned_ckpts(
        self, divergence_step: int, ckpt_ring: Mapping[int, int]
    ) -> None:
        """Delete checkpoints captured after the first diverged step.

        Under data parallelism a bit-flipped replica's gradients mix into
        every all-reduce, so a checkpoint whose recorded save step exceeds
        the divergence step froze the poisoned trajectory — restoring it
        would resume the corruption with the corrupter already evicted.
        ``ckpt_ring`` is the ``{epoch: global step at save}`` ring the
        workers ride on their heartbeats (``Trainer._save_checkpoint``);
        the world is already torn down when this runs, so the deletes race
        nobody. No-op without a ``ckpt_dir``.
        """
        if self.ckpt_dir is None or not ckpt_ring:
            return
        for epoch, saved_step in sorted(ckpt_ring.items()):
            if saved_step <= divergence_step:
                continue
            step_dir = self.ckpt_dir / str(epoch)
            if step_dir.exists():
                shutil.rmtree(step_dir, ignore_errors=True)
            (self.ckpt_dir / f"manifest-{epoch}.json").unlink(missing_ok=True)
            self._log(
                f"pruned checkpoint epoch {epoch} (saved at step "
                f"{saved_step} > divergence step {divergence_step})"
            )

    @staticmethod
    def _kill_all(procs: dict[int, subprocess.Popen]) -> None:
        for proc in procs.values():
            if proc.poll() is None:
                sigkill_group(proc)
        for proc in procs.values():
            reap(proc)

    # -- start-up hygiene -----------------------------------------------------
    def _scrub_dead_pod(self) -> None:
        """A journal in the pod dir that does not end in ``supervisor_stop``
        means a previous supervisor died here: SIGKILL every rank it
        journaled (still mid-collective, unrecoverable without its books),
        then drop the journal so this run starts clean. (Resuming a dead
        supervisor's books, the reference's ``resume=True``, belongs with
        the control-plane kinds: ROADMAP Queue 1 item 10's serving half.)"""
        path = self.dir / JOURNAL_FILE
        if not path.exists():
            return
        records = replay_journal(path)
        if not records or records[-1].get("ev") != "supervisor_stop":
            for r in records:
                if r.get("ev") == "spawn":
                    for pid in r.get("pids", ()):
                        self._kill_orphan(int(pid))
        try:
            path.unlink()
        except OSError:
            pass

    # -- the supervision loop ------------------------------------------------
    def run(self) -> PodResult:
        self._scrub_dead_pod()
        injector = self._open_books("pod_metrics.jsonl")
        journal, _ = self._open_journal()
        self.registry.gauge(SUP_INCARNATION).set(float(self.incarnation))
        for name in (POD_RANK_FAILURES, POD_RESTARTS, POD_STRAGGLERS,
                     POD_DIGEST_MISMATCHES, POD_QUARANTINES):
            self.registry.counter(name)
        # SDC machinery. Host identity survives rank re-numbering: attempt
        # 0's rank i is host i, and after a re-form the new rank j is the
        # j-th surviving host — `hosts[rank]` is the stable name the vote
        # and the ledger speak. A host quarantined by this run OR a prior
        # run sharing the pod dir is never spawned at all.
        ledger = QuarantineLedger(self.pod_dir / "quarantine.json")
        vote = DigestVote()
        hosts: list[int] = [
            h for h in range(self.num_processes) if h not in ledger
        ]
        if len(hosts) < self.num_processes:
            self._log(
                f"quarantine: host(s) "
                f"{sorted(set(range(self.num_processes)) - set(hosts))} "
                f"barred by {ledger.path} — spawning {len(hosts)} of "
                f"{self.num_processes}"
            )
        ckpt_ring: dict[int, int] = {}  # epoch -> global step at its save
        world = len(hosts)
        spec = self.chaos_spec
        self.registry.gauge(POD_WORLD_SIZE).set(world)
        world_sizes: list[int] = []
        restarts = 0
        rank_failures = 0
        # (kind, detection time) pairs awaiting the re-formed world's first
        # progress — that observation closes the chaos recovery.
        pending_recoveries: list[tuple[str, float]] = []
        ok = False
        try:
            if world < self.min_world_size:
                raise PodFailure(
                    f"{world} admissible host(s) after quarantine — below "
                    f"min_world_size={self.min_world_size}"
                )
            attempt = 0
            while True:
                world_sizes.append(world)
                procs, handles, hb_dir = self._spawn(attempt, world, spec)
                tracker = self.new_tracker(
                    procs, straggler_factor=self.straggler_factor
                )
                flagged: set[int] = set()
                dead: list[int] = []
                hung: list[int] = []
                corrupt: list[int] = []
                divergence = None  # VoteResult of the first digest mismatch
                running: list[int] = list(procs)
                stall_settle_until: float | None = None
                try:
                    while True:
                        time.sleep(self.poll_interval_s)
                        for rank in procs:
                            hb = Heartbeat.read(
                                hb_dir / f"heartbeat-{rank}.json"
                            )
                            tracker.observe(rank, hb)
                            if hb:
                                vote.observe(hosts[rank], hb.get("digests"))
                                for e, s in (hb.get("ckpts") or {}).items():
                                    ckpt_ring[int(e)] = int(s)
                        if pending_recoveries and tracker.any_progress():
                            now = time.monotonic()
                            for kind, detected in pending_recoveries:
                                assert injector is not None
                                injector.record_recovery(
                                    kind, latency_s=now - detected
                                )
                                journal.record("chaos_recovery", kind=kind)
                                self._log(
                                    f"recovery: {kind} closed — re-formed "
                                    f"world progressing "
                                    f"({now - detected:.1f}s after detection)"
                                )
                            pending_recoveries.clear()
                        rcs = {r: p.poll() for r, p in procs.items()}
                        collateral = collateral_deaths(rcs)
                        if collateral:
                            self._log(f"rank(s) {collateral} exited after a peer's death "
                                      f"(exit codes {[rcs[r] for r in collateral]}): "
                                      "collateral, kept for the re-formed world")
                        dead = [r for r, rc in rcs.items()
                                if rc not in (None, 0) and r not in collateral]
                        if not dead and all(rc == 0 for rc in rcs.values()):
                            for rank in procs:  # each worker's last beat
                                hb = Heartbeat.read(hb_dir / f"heartbeat-{rank}.json")
                                if hb:
                                    vote.observe(hosts[rank], hb.get("digests"))
                            divergence = vote.tally(quorum=len(procs))
                            if divergence is None:
                                ok = True
                                return self._result(
                                    True, world_sizes, restarts,
                                    rank_failures, injector,
                                )
                            # Every worker exited 0, but their final
                            # heartbeat rings disagree: the run COMPLETED on
                            # a poisoned trajectory. Exit codes are not a
                            # verdict on numerics — fall through to the SDC
                            # recovery with every (exited) rank eligible.
                            running = list(procs)
                            corrupt = self._blame_corrupt(
                                divergence, hosts, running, spec, world
                            )
                            break
                        running = [r for r, rc in rcs.items() if rc is None or r in collateral]
                        if not dead:
                            stalled = [r for r in running if tracker.stalled(r)]
                            if stalled:
                                # One wedged rank cascades into a world-wide
                                # stall within milliseconds, but OBSERVING it
                                # is beat+poll granular: peers' deadlines
                                # expire up to one beat interval apart, so
                                # blaming at first expiry can pin the rank
                                # whose final file write merely landed
                                # earliest. Let the stall set settle for the
                                # observation lag bound, THEN blame the
                                # culprit(s) — not the peers blocked behind
                                # them (live hosts that belong in the
                                # re-formed world).
                                now = time.monotonic()
                                settle = 2.0 * (
                                    self.heartbeat_interval_s
                                    + self.poll_interval_s
                                )
                                if stall_settle_until is None:
                                    stall_settle_until = now + settle
                                    self._log(
                                        f"stall: rank(s) {stalled} past "
                                        f"deadline — settling {settle:.1f}s "
                                        f"before blame"
                                    )
                                if now >= stall_settle_until:
                                    hung = tracker.hang_culprits(stalled)
                                    if len(hung) > 1:
                                        target = self._chaos_target(
                                            spec, world
                                        )
                                        if target in hung:
                                            self._log(
                                                f"stall: ranks {hung} tied "
                                                f"at the same last step — "
                                                f"blaming planned chaos "
                                                f"target rank {target}"
                                            )
                                            hung = [target]
                            else:
                                stall_settle_until = None
                        for rank in tracker.stragglers(running):
                            if rank not in flagged and rank not in hung:
                                flagged.add(rank)
                                self.registry.counter(POD_STRAGGLERS).inc()
                                self._log(
                                    f"straggler: rank {rank} progress age "
                                    f"{tracker.progress_age_s(rank):.1f}s "
                                    f"(flagged, not failed)"
                                )
                        if not dead and not hung:
                            divergence = vote.tally(quorum=len(procs))
                            if divergence is not None:
                                # A rank that already finished (exit 0) can
                                # still be the corrupt one: every live or
                                # finished rank is a candidate.
                                running = [r for r, rc in rcs.items()
                                           if rc in (None, 0) or r in collateral]
                                corrupt = self._blame_corrupt(
                                    divergence, hosts, running, spec, world
                                )
                        if dead or hung or divergence is not None:
                            break
                finally:
                    if not ok:
                        # A dead peer wedges every pending collective; the
                        # only safe teardown is immediate.
                        self._kill_all(procs)
                    for f in handles:
                        f.close()

                whole_world_hang = (
                    not dead and len(hung) > 1 and set(hung) == set(running)
                )
                if whole_world_hang:
                    # Every running rank stalled at the same last step and no
                    # chaos plan could break the tie: the culprit is
                    # unknowable from the outside. A hang is a wedge, not a
                    # host loss — every process was alive until the teardown
                    # SIGKILL — so the safe recovery is the torchrun one:
                    # restart the WHOLE world at the same size. Account the
                    # collective hang once.
                    self._log(
                        f"stall: ranks {sorted(hung)} tied at the same last "
                        f"step — culprit unknowable, restarting the whole "
                        f"world of {world}"
                    )
                    hung = [min(hung)]
                failures = (
                    [(r, "rank_kill") for r in dead]
                    + [(r, "rank_hang") for r in hung]
                    + [(r, "bitflip") for r in corrupt]
                )
                detected = time.monotonic()
                for rank, kind in failures:
                    rank_failures += 1
                    self.registry.counter(POD_RANK_FAILURES).inc()
                    self.registry.counter(
                        labeled(POD_RANK_FAILURES, kind=kind)
                    ).inc()
                    rc = rcs[rank]
                    if kind == "rank_kill":
                        why = f"exit {rc}"
                    elif kind == "rank_hang":
                        why = (
                            f"progress stalled "
                            f"{tracker.progress_age_s(rank):.1f}s"
                        )
                    else:
                        why = (
                            f"digest vote minority at step "
                            f"{divergence.step}"
                        )
                    hit = injector.fire_observed(kind) if injector else None
                    journal.record(
                        "rank_failure", rank=rank, kind=kind, why=why,
                        unit=hit.unit if hit is not None else None,
                        at=hit.at if hit is not None else None,
                    )
                    if hit is not None:
                        pending_recoveries.append((kind, detected))
                        self._log(
                            f"rank {rank} failed ({why}) — matches planned "
                            f"{hit.kind}@{hit.unit}:{hit.at}"
                        )
                    else:
                        self._log(f"rank {rank} failed ({why}) — unplanned")
                if divergence is not None and not corrupt:
                    # Mismatch seen but unattributable (tie, no planned
                    # target): nobody is quarantined — the whole world
                    # restarts at the same size and the checkpoint restore
                    # clears whichever replica's memory was corrupt. Still
                    # book the observed fault so the chaos ledger balances.
                    self._log(
                        f"digest vote: mismatch at step {divergence.step} "
                        f"unattributable — restarting the whole world of "
                        f"{world}"
                    )
                    hit = injector.fire_observed("bitflip") if injector else None
                    if hit is not None:
                        journal.record(
                            "rank_failure", rank=-1, kind="bitflip",
                            why="digest mismatch, unattributable",
                            unit=hit.unit, at=hit.at,
                        )
                        pending_recoveries.append(("bitflip", detected))
                for rank in corrupt:
                    host = hosts[rank]
                    ledger.quarantine(
                        host,
                        reason="digest vote minority",
                        step=divergence.step,
                        digest=divergence.digests.get(host),
                    )
                    self.registry.counter(POD_QUARANTINES).inc()
                    self._log(
                        f"quarantine: host {host} (rank {rank}) booked in "
                        f"{ledger.path.name} — barred from every future "
                        f"spawn"
                    )
                if divergence is not None:
                    self._prune_poisoned_ckpts(divergence.step, ckpt_ring)
                for rank in dead + hung + corrupt:
                    # A departed rank's stale digests must not out-vote the
                    # survivors at steps they have yet to (re)play.
                    vote.drop_rank(hosts[rank])

                # Survivors = ranks still alive at DETECTION time, minus the
                # culprits. The teardown SIGKILL that just ran does not
                # disqualify them — those are live hosts, killed only because
                # a world with a dead peer cannot drain its collectives.
                survivors = [
                    r for r in running
                    if r not in dead and r not in hung and r not in corrupt
                ]
                if whole_world_hang or (divergence is not None and not corrupt):
                    # Blame was unknowable, so nobody is excluded: the
                    # blamed rank is a live process like its peers and
                    # rejoins the same-size world.
                    survivors = list(running)
                new_world = len(survivors)
                if new_world < self.min_world_size:
                    raise PodFailure(
                        f"{new_world} survivor(s) after "
                        f"{[r for r, _ in failures]} failed — below "
                        f"min_world_size={self.min_world_size}"
                    )
                if restarts >= self.max_pod_restarts:
                    raise PodFailure(
                        f"restart budget spent ({self.max_pod_restarts}) — "
                        f"not re-forming"
                    )
                if injector is not None:
                    # Remove faults this attempt consumed: respawned workers
                    # restart their step count at zero and would re-detonate.
                    fired = [
                        f"{s.kind}@{s.unit}:{s.at}"
                        for s in injector.plan.specs
                        if s.kind in POD_KINDS and s.fired
                    ]
                    spec = strip_entries(spec, fired)
                restarts += 1
                attempt += 1
                journal.record(
                    "reform", old_world=world, new_world=new_world,
                    restarts=restarts,
                )
                self.registry.counter(POD_RESTARTS).inc()
                self.registry.gauge(POD_WORLD_SIZE).set(new_world)
                self._log(
                    f"re-forming: world {world} -> {new_world} "
                    f"(restart {restarts}/{self.max_pod_restarts})"
                )
                hosts = [hosts[r] for r in sorted(survivors)]
                world = new_world
                # The re-formed world counts its steps anew from the
                # checkpoint: the old attempt's rings would be compared
                # against steps of another numbering.
                vote = DigestVote()
                ckpt_ring = {}
        except PodFailure as err:
            self._log(f"FAILED: {err}")
            self._result(False, world_sizes, restarts, rank_failures, injector)
            raise
        finally:
            journal.record("supervisor_stop", pid=os.getpid())
            journal.close()
            self.journal = None
            self._close_registry()

    def _result(
        self,
        ok: bool,
        world_sizes: list[int],
        restarts: int,
        rank_failures: int,
        injector: ChaosInjector | None,
    ) -> PodResult:
        values: dict[str, Any] = {
            **self.registry.snapshot(),
            "ok": ok,
            "world_sizes": "->".join(str(w) for w in world_sizes),
        }
        if injector is not None:
            values["chaos_balanced"] = injector.balanced()
            self._log(injector.summary())
        self.registry.emit("pod_summary", values)
        return PodResult(
            ok=ok,
            world_sizes=world_sizes,
            restarts=restarts,
            rank_failures=rank_failures,
            snapshot=self.registry.snapshot(),
            chaos_balanced=injector.balanced() if injector else None,
        )
