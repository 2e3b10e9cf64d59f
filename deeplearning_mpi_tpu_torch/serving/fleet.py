"""Fault-tolerant serving fleet: supervised replica processes behind a router.

Port of ``deeplearning_mpi_tpu/serving/fleet.py``. Each replica is a
supervised OS process running the port's paged
:class:`~deeplearning_mpi_tpu_torch.serving.engine.ServingEngine` (or a
:class:`~deeplearning_mpi_tpu_torch.serving.disagg.DisaggregatedEngine`)
on its own device: ``cuda:(i mod device_count)`` for replica ``i``, or the
CPU when the caller asks for it. The supervisor stands on the supervision
core of :mod:`~deeplearning_mpi_tpu_torch.resilience.cluster` (liveness by
``progress_seq``, SIGKILL-and-reap teardown, the chaos books, the
write-ahead journal) and fronts the replicas with the
:class:`~deeplearning_mpi_tpu_torch.serving.router.Router`.

The contract, as the reference's:

- **Failover re-dispatch.** A replica that dies (exit observed) or wedges
  (heartbeat fresh, ``progress_seq`` frozen) has its in-flight requests
  re-dispatched from their prompts to a survivor, with their ORIGINAL
  arrival and deadline (``ServingEngine.submit(arrival=...)``): failover
  never mints fresh SLO budget, and restarting from the prompt keeps every
  stream token-identical to offline greedy.
- **Hedged retries.** A request outstanding past ``hedge_ms`` with budget
  left is duplicated on a second replica; the first completion wins, the
  loser is cancelled, exactly one stream per rid reaches the client.
- **Hot weight swap.** A rolling swap drains one replica (router
  exclusion), copies the new weights into its live parameter storages
  (``TransformerLM.init_weights`` writes in place, so the warmed CUDA
  graphs replay the new weights; the worker checks that no storage moved
  and the ack says so), re-includes it, and goes on to the next.
- **Autoscaling.** Supervised spawn, warmup and a ready-ack before the
  router includes a replica; a zero-drop drain on scale-down.
- **Control plane.** A write-ahead journal stamped with an incarnation id;
  a restarted supervisor (``resume=True``) replays it, probes the dead
  incarnation's workers and re-adopts the live ones by a handshake
  (:class:`_AdoptedProc`, :meth:`FleetSupervisor._try_adopt`).

The kernels are built once, by the supervisor, before the first spawn
(``ops.kernels._build.build_all``): N replicas starting cold would each run
``nvcc``. A worker's launch counts (K1, K4) and its captured-graph count
ride its final ``stopped`` message.

Chaos: ``replica_kill`` / ``replica_hang`` / ``replica_slow`` detonate in a
worker (:meth:`ChaosInjector.check_replica_fault`); the supervisor keeps
their books. ``load_spike`` / ``scale_during_failure`` are the
supervisor's own with an autoscaler; ``supervisor_kill`` /
``supervisor_hang`` detonate against the supervisor itself.

Wire protocol: per-replica append-only JSONL files (``inbox.jsonl``
supervisor -> worker, ``outbox.jsonl`` worker -> supervisor), one writer
each, tailed by byte offset, only newline-terminated lines consumed.
Arrival and deadline stamps are absolute ``time.monotonic()`` values
(CLOCK_MONOTONIC is system-wide on Linux).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from collections import Counter, deque
from pathlib import Path
from typing import Any, Mapping, Optional

from deeplearning_mpi_tpu_torch.resilience.cluster import (
    JOURNAL_FILE,
    SUP_INCARNATION,
    SUP_READOPTED,
    SUP_REPLAY_S,
    SUP_RESPAWNED,
    ClusterSupervisor,
    kill_and_reap,
    pid_alive,
    replay_journal,
    scrub_rendezvous_env,
    tail_jsonl,
)

__all__ = ["FleetFailure", "FleetResult", "FleetSupervisor", "TP_REPLICA_REASON",
           "worker_main"]

FLEET_RESTARTS = "fleet_replica_restarts_total"
FLEET_FAILURES = "fleet_replica_failures_total"
FLEET_REDISPATCH = "fleet_redispatch_total"

#: why a tensor-parallel replica is refused: the reference's is its engine
#: under GSPMD; the port's paged engine has no tensor-parallel form yet.
TP_REPLICA_REASON = (
    "tensor-parallel replicas (--tp > 1 with --replicas) need a tensor-parallel paged "
    "serving engine, which the port does not have yet (ROADMAP Queue 1 item 8.6: "
    "serve_lm under the composed layouts)"
)

#: the kernels a replica launches: K1 (prefill chunks) and K4 (decode)
REPLICA_KERNELS = ("flash_attention_fwd", "flash_decode")

_tail_jsonl = tail_jsonl


class FleetFailure(RuntimeError):
    """The fleet cannot meet its contract (restart budget spent, run
    timeout, every replica gone)."""


# ---------------------------------------------------------------------------
# worker (one process per replica)
# ---------------------------------------------------------------------------

def _param_storages(model) -> list[int]:
    return [p.data_ptr() for p in model.parameters()]


def worker_main(argv: list[str] | None = None) -> int:
    """Replica worker: an engine wrapped in the fleet wire protocol.

    Builds the port's ``TransformerLM`` from the spec's ``(config, seed)``
    with ``init_weights(seed)``, exactly as ``serve_lm --selftest`` does
    (replicas of one (seed, version) are bit-identical, which makes a
    cross-replica re-dispatch parity-safe), on the spec's device (``cuda``
    unless it says ``cpu``; asked for ``cuda`` without a card it raises),
    warms the engine, then loops: drain inbox ops, step the engine when
    busy, report completions, and publish liveness and the snapshot the
    router scores on through the heartbeat."""
    import argparse

    parser = argparse.ArgumentParser(prog="fleet-worker")
    parser.add_argument("--replica", type=int, required=True)
    parser.add_argument("--dir", required=True)
    parser.add_argument("--spec", required=True)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from deeplearning_mpi_tpu_torch import resolve_device
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_cuda
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_decode import flash_decode_cuda
    from deeplearning_mpi_tpu_torch.resilience.cluster import ENV_HEARTBEAT_INTERVAL
    from deeplearning_mpi_tpu_torch.resilience.faults import ChaosInjector, InjectedFault
    from deeplearning_mpi_tpu_torch.resilience.supervisor import Heartbeat
    from deeplearning_mpi_tpu_torch.serving.engine import EngineConfig, ServingEngine
    from deeplearning_mpi_tpu_torch.serving.scheduler import RequestState
    from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry

    # Start-up, split by stage for the ready ack (what precedes this line,
    # the interpreter and the imports, is the supervisor's spawn -> ready
    # less their sum).
    stamps = [time.monotonic()]
    rdir = Path(args.dir)
    spec = json.loads(Path(args.spec).read_text())
    if int(spec.get("tp", 1)) > 1:
        raise SystemExit(TP_REPLICA_REASON)
    disagg = bool(spec.get("disagg", False))
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    device = resolve_device(spec.get("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", args.replica % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # The offline-greedy oracle runs with TF32 off; so must a replica,
        # or the fleet's bit-exact bar measures TF32, not the fleet.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.synchronize(device)  # the CUDA context
    stamps.append(time.monotonic())
    cfg = TransformerConfig(**spec["model"])
    model = TransformerLM(cfg, dtype=torch.float32, device=device).init_weights(int(spec["seed"]))
    stamps.append(time.monotonic())
    storages = _param_storages(model)
    version = int(spec.get("version", 0))
    # The supervisor incarnation that owns this worker: on every beat, and
    # updated in place by the adopt handshake.
    incarnation = int(spec.get("incarnation", 0))
    registry = MetricsRegistry()
    chaos = ChaosInjector.from_spec(None, registry=registry)  # $DMT_CHAOS
    tracer = None
    if spec.get("trace_dir"):
        from deeplearning_mpi_tpu_torch.telemetry import SpanRecorder

        trace_dir = Path(spec["trace_dir"])
        tracer = SpanRecorder(
            trace_dir / f"trace_replica{args.replica}-{os.getpid()}.jsonl",
            proc=f"replica{args.replica}", registry=registry, flight_dir=trace_dir / "flight",
        )
    engine_cls: Any = ServingEngine
    if disagg:
        from deeplearning_mpi_tpu_torch.serving.disagg import DisaggregatedEngine

        engine_cls = DisaggregatedEngine
    engine = engine_cls(
        model, EngineConfig(**spec["engine"]), eos_id=spec.get("eos_id"),
        registry=registry, chaos=chaos, tenants=spec.get("tenants") or None, tracer=tracer,
    )
    if disagg:
        eng_idle = engine.idle
        q_depth = engine.prefill.scheduler.queue_depth

        def slots_active() -> int:
            return engine.prefill.scheduler.slots_active() + engine.decode.scheduler.slots_active()

        def handoff_depth() -> int:
            return engine.handoff_depth
    else:
        eng_idle = engine.scheduler.idle
        q_depth = engine.scheduler.queue_depth
        slots_active = engine.scheduler.slots_active

        def handoff_depth() -> int:
            return 0
    stamps.append(time.monotonic())
    if spec.get("warmup", True):
        engine.warmup()
    stamps.append(time.monotonic())
    startup_s = dict(zip(("device", "model", "engine", "warmup"),
                         (b - a for a, b in zip(stamps, stamps[1:]))))
    # The stop message reports the launches of serving alone, not warmup's.
    flash_attention_cuda.launches = flash_decode_cuda.launches = 0
    compile_counter = registry.counter("serve_compile_total")
    ttft_hist = registry.histogram("serve_ttft_s")

    outbox = (rdir / "outbox.jsonl").open("a")

    def emit(obj: dict) -> None:
        outbox.write(json.dumps(obj) + "\n")
        outbox.flush()

    served = 0

    def launches() -> dict[str, int]:
        return {"K1": flash_attention_cuda.launches, "K4": flash_decode_cuda.launches,
                "captures": engine.captures, "served": served}

    mono_offset = tracer.mono_offset if tracer is not None else time.time() - time.monotonic()
    emit({"op": "ready", "replica": args.replica, "pid": os.getpid(), "version": version,
          "compile_total": compile_counter.value, "mono_offset": mono_offset,
          "incarnation": incarnation, "device": str(device), "startup_s": startup_s})

    inbox = rdir / "inbox.jsonl"
    offset = 0
    live: dict[int, Any] = {}  # fleet rid -> engine Request
    cancelled: set[int] = set()
    slow_reported = False
    stop = False
    hb = Heartbeat(rdir / "heartbeat.json",
                   interval_s=float(os.environ.get(ENV_HEARTBEAT_INTERVAL, "0.5")))
    hb.start()
    try:
        while not stop:
            msgs, offset = tail_jsonl(inbox, offset)
            for m in msgs:
                op = m["op"]
                if op == "req":
                    rid = int(m["rid"])
                    if rid in cancelled or rid in live:
                        continue  # a cancel raced ahead, or a duplicate copy
                    req = engine.submit(
                        np.asarray(m["prompt"], np.int32), int(m["max_new"]),
                        deadline=m.get("deadline"), arrival=m.get("arrival"),
                        tenant=m.get("tenant", "default"), trace=m.get("trace"),
                    )
                    if req.state is RequestState.SHED:
                        emit({"op": "shed", "rid": rid, "reason": req.shed_reason})
                    else:
                        live[rid] = req
                elif op == "cancel":
                    rid = int(m["rid"])
                    cancelled.add(rid)
                    req = live.pop(rid, None)
                    if req is not None:
                        engine.cancel(req)
                elif op == "adopt":
                    # A restarted supervisor claims this worker: nothing is
                    # reset (warm graphs, KV pools, in-flight decodes); the
                    # ack lists the rids held so it rebuilds its books.
                    incarnation = int(m["incarnation"])
                    emit({"op": "adopted", "replica": args.replica, "pid": os.getpid(),
                          "incarnation": incarnation, "version": version,
                          "compile_total": compile_counter.value,
                          "mono_offset": mono_offset, "rids": sorted(live)})
                elif op == "swap":
                    # In place: the warmed graphs keep reading these storages.
                    model.init_weights(int(m["seed"]))
                    cache = getattr(engine, "prefix_cache", None)
                    if cache is not None:
                        cache.flush()  # its KV was computed under the old weights
                    version = int(m["version"])
                    emit({"op": "swapped", "version": version,
                          "compile_total": compile_counter.value,
                          "in_place": _param_storages(model) == storages})
                elif op == "brownout":
                    engine.set_brownout(int(m["stage"]))
                elif op == "stop":
                    stop = True

            if not stop and not eng_idle():
                if chaos is not None:
                    slow_s = chaos.check_replica_fault(step=engine.steps)
                    if slow_s > 0.0:
                        if not slow_reported:
                            # Alive but degraded: the one fleet fault the
                            # worker can report itself (the supervisor books it).
                            emit({"op": "fault", "kind": "replica_slow", "step": engine.steps})
                            slow_reported = True
                        time.sleep(slow_s)
                try:
                    engine.step()
                except InjectedFault:
                    engine.recover()
                for rid, req in list(live.items()):
                    if req.state is RequestState.FINISHED:
                        emit({"op": "done", "rid": rid,
                              "tokens": [int(t) for t in req.generated], "version": version,
                              "ttft": req.ttft, "tpot": req.tpot,
                              "t_finished": req.t_finished})
                        served += 1
                        del live[rid]
                    elif req.state is RequestState.SHED:
                        emit({"op": "shed", "rid": rid, "reason": req.shed_reason})
                        del live[rid]
            elif not stop:
                time.sleep(0.002)

            # Every iteration bumps progress_seq: an idle replica is alive;
            # only a wedged loop (the heartbeat thread beats on) freezes it.
            hb.progress = {
                "step": engine.steps, "queue_depth": q_depth(),
                "slots_active": slots_active(), "handoff_depth": handoff_depth(),
                "ttft_p50": ttft_hist.percentile(0.5) or 0.0, "version": version,
                "mono_offset": mono_offset, "incarnation": incarnation,
            }
    except BaseException:
        if tracer is not None:
            tracer.dump_flight("worker-unclean-exit")
        raise
    finally:
        hb.stop()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    emit({"op": "stopped", "version": version, "compile_total": compile_counter.value,
          "launches": launches(), "snapshot": registry.snapshot()})
    outbox.close()
    if tracer is not None:
        tracer.close()
    return 0


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

class _AdoptedProc:
    """Popen-shaped handle for a re-adopted orphan.

    An adopted worker is NOT this supervisor's child — it was forked by a
    dead incarnation and reparented to init — so there is no waitable
    handle and no exit status to observe. Liveness is pid probing
    (:func:`~..resilience.cluster.pid_alive`), teardown is a best-effort
    group SIGKILL, and "reaping" is waiting for the pid to vanish (init
    does the actual reap). Implements exactly the ``poll``/``wait``/
    ``kill`` surface ``kill_and_reap`` and the supervision loop use.
    """

    def __init__(self, pid: int) -> None:
        self.pid = pid
        self._rc: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self._rc is None and not pid_alive(self.pid):
            # The true status died with the old incarnation; report the
            # conventional SIGKILL code so failure handling reads sanely.
            self._rc = -9
        return self._rc

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("adopted-orphan", timeout)
            time.sleep(0.05)
        return self._rc  # type: ignore[return-value]

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


@dataclasses.dataclass
class _Replica:
    """Supervisor-side state for one replica slot."""

    idx: int
    seed: int
    version: int = 0
    chaos_spec: str = ""
    attempt: int = 0
    dir: Optional[Path] = None
    proc: Optional[subprocess.Popen] = None
    log: Any = None
    tracker: Any = None
    outbox_offset: int = 0
    inbox: Any = None
    ready: bool = False
    compile_at_ready: Optional[float] = None
    compile_flat: bool = True
    stopped: Optional[dict] = None
    #: True when this slot's process was inherited from a dead incarnation
    #: via the re-adoption handshake rather than spawned by this one.
    adopted: bool = False
    #: last heartbeat payload observed — the autoscaler's load signal
    #: (queue_depth et al.) reads it without re-parsing the file.
    last_hb: Optional[dict] = None


@dataclasses.dataclass
class _Req:
    """Supervisor-side ledger entry for one client request."""

    rid: int
    prompt: list[int]
    max_new: int
    arrival_abs: float
    deadline_abs: Optional[float]
    tenant: str = "default"
    holders: set[int] = dataclasses.field(default_factory=set)
    tokens: Optional[list[int]] = None
    version: Optional[int] = None
    ttft: Optional[float] = None
    shed_reason: Optional[str] = None
    redispatched: bool = False

    @property
    def resolved(self) -> bool:
        return self.tokens is not None or self.shed_reason is not None


@dataclasses.dataclass
class FleetResult:
    """What a :meth:`FleetSupervisor.run` accomplished."""

    ok: bool
    completed: int
    shed: dict[str, int]
    dropped: int  # accepted requests that vanished — the zero-downtime bar
    restarts: int
    failures: dict[str, int]
    redispatched: int
    compile_flat: bool  # serve_compile_total flat after warmup, all workers
    chaos_balanced: Optional[bool]
    ttft: dict[str, Optional[float]]  # {before,during,after}_{p50,p99}
    swap: dict[str, Any]
    requests: dict[int, dict]  # rid -> {"tokens", "version", ...} (wins only)
    snapshot: dict[str, Any]
    #: autoscaler accounting (empty when autoscaling is off):
    #: {"events", "spawned", "retired", "vetoed", "brownout_stage_max",
    #:  "replicas_final"} — events == spawned + retired + vetoed is a
    #: reconciliation invariant checked into ``ok``.
    scale: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: tenant -> {shed_reason -> count} over the supervisor's ledger — the
    #: brownout acceptance check reads it (only the lowest-priority tier
    #: may shed with reason "brownout").
    shed_by_tenant: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict
    )
    #: control-plane crash safety: this run's incarnation id and what the
    #: journal-replay recovery did (all zero for a first-boot run).
    incarnation: int = 0
    readopted: int = 0
    respawned: int = 0
    #: "replica{i}-a{attempt}" -> the counts its worker reported at its
    #: clean stop ({"K1", "K4", "captures", "served"}: kernel launches
    #: since its ready ack, captured graphs, completions sent); a killed
    #: or hung worker reports none.
    workers: dict[str, dict[str, int]] = dataclasses.field(default_factory=dict)


class FleetSupervisor(ClusterSupervisor):
    """Spawn N replica workers, route a trace through them, survive
    replica loss, and prove the books balance.

    ``model_spec`` / ``engine_spec`` are kwargs dicts for
    ``TransformerConfig`` / ``EngineConfig`` — shipped to workers as JSON,
    so replicas are constructed from *specs*, never pickled tensors
    (weights rebuild from ``(config, seed, version)``; a weight swap ships
    a new seed the same way). ``device`` is where the replicas run
    (``cuda``: replica ``i`` on ``cuda:(i mod device_count)``; ``cpu`` only
    when asked); ``threads`` sets each worker's torch thread count.

    The supervision bones — liveness tracking, SIGKILL+reap teardown,
    chaos books, JSONL IPC tailing — come from the unified core
    (:class:`~deeplearning_mpi_tpu_torch.resilience.cluster.ClusterSupervisor`),
    shared with the training pod supervisor; this class owns the
    mailbox/router/ledger semantics.
    """

    log_name = "fleet"

    def __init__(
        self,
        model_spec: dict,
        engine_spec: dict,
        num_replicas: int,
        fleet_dir: str | Path,
        *,
        seed: int = 0,
        eos_id: int | None = None,
        warmup: bool = True,
        chaos: str | None = None,
        hedge_ms: float = 0.0,
        heartbeat_deadline_s: float = 2.0,
        heartbeat_interval_s: float = 0.2,
        spawn_grace_s: float = 120.0,
        poll_interval_s: float = 0.02,
        exclusion_s: float = 0.5,
        max_replica_restarts: int = 4,
        timeout_s: float = 600.0,
        registry: Any = None,
        env: Mapping[str, str] | None = None,
        disagg: bool = False,
        tp: int = 1,
        tenants: dict[str, dict[str, Any]] | None = None,
        autoscale: Any = None,
        trace_dir: str | Path | None = None,
        resume: bool = False,
        adopt_grace_s: float = 6.0,
        device: str = "cuda",
        threads: int | None = None,
    ) -> None:
        from deeplearning_mpi_tpu_torch.resilience.faults import (
            AUTOSCALE_KINDS,
            CONTROLPLANE_KINDS,
            FLEET_KINDS,
            validate_plan_kinds,
        )

        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        super().__init__(
            fleet_dir,
            chaos=chaos,
            heartbeat_deadline_s=heartbeat_deadline_s,
            heartbeat_interval_s=heartbeat_interval_s,
            spawn_grace_s=spawn_grace_s,
            poll_interval_s=poll_interval_s,
            registry=registry,
            env=env,
        )
        self.model_spec = dict(model_spec)
        self.engine_spec = dict(engine_spec)
        self.num_replicas = num_replicas
        self.fleet_dir = self.dir
        self.seed = seed
        self.eos_id = eos_id
        self.warmup = warmup
        #: topology knobs, shipped to workers inside spec.json. ``disagg``
        #: replicas run a DisaggregatedEngine (prefill/decode split).
        self.disagg = bool(disagg)
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if tp > 1:
            raise NotImplementedError(TP_REPLICA_REASON)
        self.tp = int(tp)
        self.device = str(device)
        self.threads = threads
        #: per-tenant admission policy shipped to every worker — the
        #: scheduler enforces budgets replica-locally (no global ledger;
        #: the trace's tenant labels ride along with each dispatch).
        self.tenants = dict(tenants) if tenants else None
        #: AutoscalerConfig enabling closed-loop fleet sizing; None keeps
        #: the fixed-size fleet bit-identical to its pre-autoscaler self.
        self.autoscale = autoscale
        if autoscale is not None and not (
            autoscale.min_replicas <= num_replicas <= autoscale.max_replicas
        ):
            raise ValueError(
                f"num_replicas ({num_replicas}) outside the autoscale band "
                f"[{autoscale.min_replicas}, {autoscale.max_replicas}]"
            )
        if self.chaos_spec.strip():
            # CONTROLPLANE_KINDS are valid on any supervised fleet: the
            # supervisor detonates ITSELF and a `resume=True` restart on
            # the same fleet_dir is the recovery path. (serve_lm still
            # rejects them — its CLI run has no restart harness.)
            supported = FLEET_KINDS | CONTROLPLANE_KINDS
            workload = "serving fleet"
            if autoscale is not None:
                # The autoscaler drill kinds are only meaningful with the
                # control loop running.
                supported = supported | AUTOSCALE_KINDS
                workload = "autoscaled serving fleet"
            validate_plan_kinds(self.chaos_spec, supported, workload=workload)
        self.hedge_ms = hedge_ms
        self.exclusion_s = exclusion_s
        self.max_replica_restarts = max_replica_restarts
        self.timeout_s = timeout_s
        #: crash recovery: with ``resume=True``, :meth:`run` replays the
        #: dead incarnation's write-ahead journal, probes its journaled
        #: pids, re-adopts the live orphans, and re-dispatches the rest.
        #: Default False treats a dirty fleet_dir as stale state: any
        #: journaled orphans are SIGKILLed and the journal retired.
        self.resume = bool(resume)
        self.adopt_grace_s = float(adopt_grace_s)
        #: distributed tracing: when set, the supervisor and every worker
        #: each write a SpanRecorder JSONL into this dir (workers get the
        #: path via spec.json) and ``tools/trace_report.py`` merges them.
        #: None keeps the whole fleet tracing-free (costless-off).
        self.trace_dir = Path(trace_dir) if trace_dir else None
        self.tracer: Any = None
        if self.trace_dir is not None:
            from deeplearning_mpi_tpu_torch.telemetry import SpanRecorder

            self.tracer = SpanRecorder(
                self.trace_dir / "trace_supervisor.jsonl",
                proc="supervisor",
                registry=self.registry,
                flight_dir=self.trace_dir / "flight",
            )

    # -- spawning ------------------------------------------------------------
    def _replica_chaos(self) -> dict[int, str]:
        """Distribute fleet chaos entries round-robin across replicas:
        entry i detonates on replica i % N (the drill's 'kill one, hang
        the other' shape with two replicas and two entries)."""
        from deeplearning_mpi_tpu_torch.resilience.faults import fleet_entries

        per: dict[int, list[str]] = {k: [] for k in range(self.num_replicas)}
        for i, entry in enumerate(fleet_entries(self.chaos_spec)):
            per[i % self.num_replicas].append(entry)
        return {k: ",".join(v) for k, v in per.items()}

    def _build_kernels(self) -> None:
        """Build the replicas' kernels once, here, before the first spawn
        (replicas then only load them): N workers starting on a cold cache
        would each run ``nvcc``."""
        if self.device.startswith("cuda"):
            from deeplearning_mpi_tpu_torch.ops.kernels import _build

            t0 = time.monotonic()
            _build.build_all(list(REPLICA_KERNELS))
            self._log(f"kernels {', '.join(REPLICA_KERNELS)} ready in "
                      f"{time.monotonic() - t0:.1f}s")

    def _spawn(self, rep: _Replica) -> None:
        from deeplearning_mpi_tpu_torch.resilience.cluster import (
            ENV_HEARTBEAT_INTERVAL,
        )

        rdir = self.fleet_dir / f"replica{rep.idx}-a{rep.attempt}"
        rdir.mkdir(parents=True, exist_ok=True)
        spec_path = rdir / "spec.json"
        # Atomic: the replica reads spec.json immediately after spawn, and a
        # supervisor kill mid-write must never hand it a torn spec.
        from deeplearning_mpi_tpu_torch.resilience.integrity import atomic_write_json

        atomic_write_json(spec_path, {
            "model": self.model_spec,
            "engine": self.engine_spec,
            "seed": rep.seed,
            "version": rep.version,
            "eos_id": self.eos_id,
            "warmup": self.warmup,
            "disagg": self.disagg,
            "tp": self.tp,
            "tenants": self.tenants,
            "trace_dir": str(self.trace_dir) if self.trace_dir else None,
            "incarnation": int(self.incarnation or 0),
            "device": self.device,
            "threads": self.threads,
        })
        (rdir / "inbox.jsonl").touch()
        env = dict(os.environ)
        env.update(self.extra_env)
        env[ENV_HEARTBEAT_INTERVAL] = str(self.heartbeat_interval_s)
        if rep.chaos_spec:
            env["DMT_CHAOS"] = rep.chaos_spec
        else:
            env.pop("DMT_CHAOS", None)
        # A replica is a lone process: leftover rendezvous vars from a
        # surrounding pod run would make it wait for peers.
        scrub_rendezvous_env(env)
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p)
        log_path = self.fleet_dir / f"replica{rep.idx}-a{rep.attempt}.log"
        rep.log = log_path.open("w")  # dmt-lint: disable=DMT004 — the worker's stdout and stderr, not a consumed JSON artifact
        rep.proc = subprocess.Popen(
            [
                sys.executable, "-m", "deeplearning_mpi_tpu_torch.serving.fleet",
                "--replica", str(rep.idx), "--dir", str(rdir),
                "--spec", str(spec_path),
            ],
            env=env,
            stdout=rep.log,
            stderr=subprocess.STDOUT,
            start_new_session=True,  # isolate signals; killpg on teardown
        )
        rep.dir = rdir
        rep.outbox_offset = 0
        rep.ready = False
        rep.compile_at_ready = None
        rep.inbox = (rdir / "inbox.jsonl").open("a")
        rep.tracker = self.new_tracker([0])
        rep.adopted = False
        rep.stopped = None
        if self.journal is not None:
            # Journaled right after the fork so a successor can find (and
            # probe or kill) this pid. The one-Popen-call window where a
            # crash leaks an unjournaled child is closed by the heartbeat
            # file: the worker stamps its own pid there too.
            self.journal.record(
                "spawn", idx=rep.idx, attempt=rep.attempt,
                pid=rep.proc.pid, seed=rep.seed, version=rep.version,
                dir=rdir.name, chaos=rep.chaos_spec,
            )
        self._log(
            f"replica {rep.idx} attempt {rep.attempt}: spawned pid "
            f"{rep.proc.pid} (version {rep.version}, "
            f"chaos={rep.chaos_spec or 'none'})"
        )

    def _send(self, rep: _Replica, obj: dict) -> None:
        rep.inbox.write(json.dumps(obj) + "\n")
        rep.inbox.flush()

    @staticmethod
    def _kill(rep: _Replica) -> None:
        if rep.proc is not None:
            kill_and_reap(rep.proc)
        if rep.log is not None:
            rep.log.close()
            rep.log = None
        if rep.inbox is not None:
            rep.inbox.close()
            rep.inbox = None

    # -- crash recovery (control-plane crash safety) --------------------------
    # (`_kill_orphan` lives on ClusterSupervisor — shared with the pod.)

    def _scrub_dead_fleet(self) -> None:
        """Fresh-start hygiene (``resume=False``) on a dirty fleet dir: a
        dead incarnation's journal may name live orphans that would fight
        this run's workers for the per-replica IPC files — SIGKILL them
        and retire the journal before opening a new one. (Recovery is an
        explicit opt-in; the default must never silently inherit another
        run's ledger.)"""
        path = self.dir / JOURNAL_FILE
        if not path.exists():
            return
        for r in replay_journal(path):
            if r.get("ev") in ("spawn", "adopt") and r.get("pid"):
                self._kill_orphan(int(r["pid"]))
        try:
            path.unlink()
        except OSError:
            pass

    def _try_adopt(
        self, rep: _Replica, pid: int
    ) -> tuple[Optional[dict], list[dict]]:
        """Probe one journaled orphan and try to re-adopt it alive.

        Three independent proofs of life: (1) the pid exists and is not a
        zombie; (2) its heartbeat ``progress_seq`` advances during the
        probe window (the heartbeat daemon beats through a wedge, so a
        fresh file with a frozen seq is a hung worker — kill, don't
        adopt); (3) it answers the incarnation handshake — an ``adopt``
        op appended to its inbox, acked by ``adopted`` (stamped with OUR
        incarnation) on its outbox, carrying the rids it still holds.

        Returns ``(ack, history)`` on success, where ``history`` is every
        outbox record that landed before the ack — completions that
        finished while the fleet ran unsupervised are in there and count,
        sparing a re-decode. Returns ``(None, [])`` when the orphan is
        dead, wedged, or deaf; the caller respawns the slot.
        """
        from deeplearning_mpi_tpu_torch.resilience.supervisor import Heartbeat

        if rep.dir is None or not pid_alive(pid):
            return None, []
        hb0 = Heartbeat.read(rep.dir / "heartbeat.json")
        seq0 = hb0.get("progress_seq") if hb0 else None
        rep.inbox = (rep.dir / "inbox.jsonl").open("a")
        self._send(rep, {"op": "adopt", "incarnation": self.incarnation})
        history: list[dict] = []
        seq_advanced = False
        deadline = time.monotonic() + self.adopt_grace_s
        while time.monotonic() < deadline:
            hb = Heartbeat.read(rep.dir / "heartbeat.json")
            if (
                hb is not None and seq0 is not None
                and hb.get("progress_seq", 0) > seq0
            ):
                seq_advanced = True
            msgs, rep.outbox_offset = tail_jsonl(
                rep.dir / "outbox.jsonl", rep.outbox_offset
            )
            for m in msgs:
                if (
                    m.get("op") == "adopted"
                    and int(m.get("incarnation", -1)) == self.incarnation
                ):
                    return m, history
                history.append(m)
            if not pid_alive(pid):
                break
            time.sleep(self.poll_interval_s)
        self._log(
            f"replica {rep.idx}: orphan pid {pid} not adoptable "
            f"(alive={pid_alive(pid)}, progress_advanced={seq_advanced}, "
            "no handshake ack) — respawning"
        )
        if rep.inbox is not None:
            rep.inbox.close()
            rep.inbox = None
        rep.outbox_offset = 0
        return None, []

    @staticmethod
    def _replay_fleet_state(prior: list[dict]) -> dict:
        """Fold a dead predecessor's journal into the bookkeeping a
        restarted supervisor starts from: live replica slots (to probe),
        the request ledger (resolved + orphaned), scale/brownout/chaos
        books, and the trace clock. Pure function of the records — no
        clock, no IO — so the fake-clock unit tests drive it directly.
        """
        slots: dict[int, dict] = {}
        ledger: dict[int, dict] = {}
        fires: list[dict] = []
        recovery_kinds: list[str] = []
        scale_records: list[tuple[str, str]] = []
        brownout_records: list[int] = []
        failures: dict[str, int] = {}
        t0: Optional[float] = None
        restarts = 0
        redispatched = 0
        brownout_stage = 0
        brownout_stage_max = 0
        max_idx = -1
        swap_done_version = 0
        retire_begun: list[int] = []
        retired_done: list[int] = []
        for r in prior:
            ev = r.get("ev")
            if ev == "clock_start":
                t0 = float(r["t0"])
            elif ev == "spawn":
                idx = int(r["idx"])
                max_idx = max(max_idx, idx)
                slots[idx] = {
                    "attempt": int(r["attempt"]), "pid": int(r["pid"]),
                    "seed": int(r["seed"]), "version": int(r["version"]),
                    "dir": r["dir"], "compile_ready": None,
                }
            elif ev == "adopt":
                slot = slots.get(int(r["idx"]))
                if slot is not None:
                    slot["pid"] = int(r["pid"])
                    slot["compile_ready"] = r.get("compile_total")
            elif ev == "ready":
                slot = slots.get(int(r["idx"]))
                if slot is not None and slot["attempt"] == int(r["attempt"]):
                    slot["compile_ready"] = r.get("compile_total")
            elif ev == "retire_begin":
                retire_begun.append(int(r["idx"]))
            elif ev == "retired":
                slots.pop(int(r["idx"]), None)
                retired_done.append(int(r["idx"]))
            elif ev == "failure":
                restarts += 1
                kind = str(r.get("kind", "replica_kill"))
                failures[kind] = failures.get(kind, 0) + 1
            elif ev == "admit":
                ledger[int(r["rid"])] = dict(r)
            elif ev == "redispatch":
                redispatched += 1
                jr = ledger.get(int(r["rid"]))
                if jr is not None:
                    jr["redispatched"] = True
            elif ev == "done":
                jr = ledger.get(int(r["rid"]))
                if jr is not None and jr.get("tokens") is None:
                    jr.update(
                        tokens=r["tokens"], version=r.get("version"),
                        ttft=r.get("ttft"), phase=r.get("phase"),
                    )
            elif ev == "shed":
                jr = ledger.get(int(r["rid"]))
                if jr is not None and jr.get("tokens") is None:
                    jr["shed"] = r.get("reason")
            elif ev == "swapped":
                slot = slots.get(int(r["idx"]))
                if slot is not None:
                    slot["version"] = int(r["version"])
            elif ev == "scale":
                scale_records.append((str(r["direction"]), str(r["outcome"])))
            elif ev == "brownout":
                stage = int(r["stage"])
                brownout_records.append(stage)
                brownout_stage = stage
                brownout_stage_max = max(brownout_stage_max, stage)
            elif ev == "chaos_fire":
                fires.append(r)
            elif ev == "chaos_recovery":
                recovery_kinds.append(str(r["kind"]))
            elif ev == "swap_done":
                swap_done_version = int(r["version"])
        # A retire that began but never completed resumes in the new
        # incarnation — its slot is still live (maybe adoptably so), and
        # the scale books only balance once the drain finishes.
        unfinished = [
            i for i in retire_begun
            if i not in retired_done and i in slots
        ]
        return {
            "slots": slots,
            "ledger": ledger,
            "next_rid": (max(ledger) + 1) if ledger else 0,
            "next_idx": max_idx + 1,
            "t0": t0,
            "restarts": restarts,
            "failures": failures,
            "redispatched": redispatched,
            "fires": fires,
            "recovery_kinds": recovery_kinds,
            "scale_records": scale_records,
            "retired_count": len(retired_done),
            "brownout_records": brownout_records,
            "brownout_stage": brownout_stage,
            "brownout_stage_max": brownout_stage_max,
            "swap_done_version": swap_done_version,
            "retiring": unfinished[0] if unfinished else None,
        }

    # -- the supervision loop ------------------------------------------------
    def run(
        self,
        entries: list[dict],
        *,
        swap_at: int | None = None,
        swap_seed: int | None = None,
    ) -> FleetResult:
        """Replay ``entries`` (serve_lm trace format: ``arrival`` seconds
        from start, ``prompt`` int sequence, ``max_new``, optional
        ``deadline`` seconds after arrival) through the fleet. With
        ``swap_seed`` set, a rolling :meth:`swap_weights` begins once
        ``swap_at`` requests have completed — under live load, by design.
        """
        from deeplearning_mpi_tpu_torch.resilience.supervisor import Heartbeat
        from deeplearning_mpi_tpu_torch.serving.router import Router
        from deeplearning_mpi_tpu_torch.telemetry.registry import labeled

        injector = self._open_books("fleet_metrics.jsonl")
        for name in (FLEET_RESTARTS, FLEET_FAILURES, FLEET_REDISPATCH,
                     SUP_READOPTED, SUP_RESPAWNED):
            self.registry.counter(name)
        # -- write-ahead journal + crash recovery ---------------------------
        replay_wall0 = time.monotonic()
        if not self.resume:
            self._scrub_dead_fleet()
        journal, prior = self._open_journal()
        recovered = (
            self._replay_fleet_state(prior)
            if (self.resume and prior) else None
        )
        self.registry.gauge(SUP_INCARNATION).set(float(self.incarnation))
        policy = None
        if self.autoscale is not None:
            from deeplearning_mpi_tpu_torch.serving.autoscaler import (
                AutoscalerPolicy,
                ReplicaView,
                build_load_signal,
            )

            policy = AutoscalerPolicy(self.autoscale)
            # Explicit zeros so a scale-free autoscaled run still reports.
            self.registry.counter("fleet_scale_total")
            self.registry.counter("fleet_brownout_total")
        slot_ids = (
            sorted(recovered["slots"]) if recovered is not None
            else list(range(self.num_replicas))
        )
        router = Router(
            slot_ids,
            hedge_ms=self.hedge_ms,
            exclusion_s=self.exclusion_s,
            registry=self.registry,
            roles=(
                {r: "disagg" for r in slot_ids}
                if self.disagg else None
            ),
        )
        per_chaos = self._replica_chaos()
        self._build_kernels()
        adopted_n = respawned_n = 0
        #: idx -> (adopt ack, pre-ack outbox history) for re-adopted slots;
        #: folded into the ledger once it is rebuilt below.
        adopt_histories: dict[int, tuple[dict, list[dict]]] = {}
        if recovered is None:
            replicas = {
                k: _Replica(idx=k, seed=self.seed,
                            chaos_spec=per_chaos.get(k, ""))
                for k in slot_ids
            }
            for rep in replicas.values():
                router.exclude(rep.idx)  # ineligible until its ready lands
                self._spawn(rep)
        else:
            # Orphan re-adoption: probe every slot the corpse journaled.
            # Live + progressing + handshake-acked ⇒ inherit the process
            # (warmed engine, KV pools, in-flight decodes — no new capture);
            # anything else ⇒ SIGKILL the pid and respawn the slot.
            replicas = {}
            for idx in slot_ids:
                slot = recovered["slots"][idx]
                rep = _Replica(
                    idx=idx, seed=int(slot["seed"]),
                    version=int(slot.get("version", 0)),
                    # The corpse's worker-side chaos died (or detonated)
                    # with it; a recovered fleet does not re-arm it.
                    chaos_spec="",
                    attempt=int(slot["attempt"]),
                )
                rep.dir = self.fleet_dir / slot["dir"]
                replicas[idx] = rep
                router.exclude(idx)
                ack, history = self._try_adopt(rep, int(slot["pid"]))
                if ack is not None:
                    rep.proc = _AdoptedProc(int(slot["pid"]))
                    rep.adopted = True
                    rep.ready = True
                    rep.version = int(ack.get("version", rep.version))
                    rep.compile_at_ready = float(ack["compile_total"])
                    if (
                        slot.get("compile_ready") is not None
                        and rep.compile_at_ready
                        != float(slot["compile_ready"])
                    ):
                        # The orphan captured a program while unsupervised
                        # — adoption must not launder it.
                        rep.compile_flat = False
                    rep.tracker = self.new_tracker([0])
                    router.mark_alive(idx, time.monotonic())
                    router.include(idx)
                    journal.record(
                        "adopt", idx=idx, attempt=rep.attempt,
                        pid=int(ack["pid"]),
                        compile_total=rep.compile_at_ready,
                        rids=[int(x) for x in ack.get("rids", [])],
                    )
                    adopt_histories[idx] = (ack, history)
                    adopted_n += 1
                    self.registry.counter(SUP_READOPTED).inc()
                    self._log(
                        f"replica {idx}: RE-ADOPTED live orphan pid "
                        f"{ack['pid']} (attempt {rep.attempt}, "
                        f"{len(ack.get('rids', []))} in flight, "
                        f"compile_total {rep.compile_at_ready})"
                    )
                else:
                    self._kill_orphan(int(slot["pid"]))
                    rep.attempt += 1
                    self._spawn(rep)
                    respawned_n += 1
                    self.registry.counter(SUP_RESPAWNED).inc()

        start = time.monotonic()
        # The trace clock starts at the fleet's first ready-ack, not at
        # spawn: arrival offsets time SERVING traffic, and a cold-cache
        # warmup that outlasted the trickle window would collapse every
        # trace into one undifferentiated burst (and hand the autoscaler
        # a huge "backlog" on a fleet that cannot serve anything yet).
        t0: Optional[float] = None
        pending = deque(sorted(entries, key=lambda e: e["arrival"]))
        ledger: dict[int, _Req] = {}
        next_rid = 0
        redispatch_queue: deque[int] = deque()
        # kill/hang recoveries close when every re-dispatched rid resolves
        # (or, for an idle-replica loss, when the respawn reaches ready);
        # slow recoveries close when a hedged request on the slow replica
        # completes — the hedge machinery demonstrably covered the fault.
        pending_recoveries: list[dict] = []
        hedged_primary: dict[int, int] = {}  # rid -> primary at hedge time
        restarts = 0
        failures: dict[str, int] = {}
        redispatched = 0
        completed = 0
        phase = "before"
        ttft_by_phase: dict[str, list[float]] = {
            "before": [], "during": [], "after": [],
        }
        swap: dict[str, Any] = {
            "requested": swap_seed is not None,
            "performed": False, "drain_s": None,
            "completions_during": 0, "compile_flat": True,
            # every swapped worker kept its parameter storages (a rebinding
            # swap would leave its captured graphs on the old weights)
            "in_place": True,
        }
        #: "replica{i}-a{attempt}" -> the worker's launch counts at its stop
        workers: dict[str, dict[str, int]] = {}
        swap_queue: list[int] = []
        swap_stage: Optional[str] = None  # None | "drain" | "await"
        swap_t0: Optional[float] = None
        swap_mark = 0
        target_version = 0
        stopping = False
        # -- autoscaler state (all inert when policy is None) --
        next_idx = self.num_replicas  # replica ids are never reused
        scale_events = spawned = retired = vetoed = 0
        scale_ups = 0  # ordinal for the scale_during_failure trigger
        #: trace-clock stamps (now - t0) of each scale-up spawn — the
        #: predictive drill asserts the first lands BEFORE the flash
        #: crowd's peak arrival.
        up_times: list[float] = []
        brownout_stage = 0
        brownout_stage_max = 0
        retiring: Optional[int] = None  # replica mid-drain, at most one
        retire_stop_sent = False

        def close_recovery(pr: dict, now: float) -> None:
            if injector is not None:
                injector.record_recovery(
                    pr["kind"], latency_s=now - pr["detected"]
                )
            journal.record("chaos_recovery", kind=pr["kind"])
            pending_recoveries.remove(pr)
            self._log(
                f"recovery: {pr['kind']} on replica {pr['replica']} closed "
                f"({now - pr['detected']:.2f}s after detection)"
            )

        def handle_failure(rep: _Replica, kind: str, why: str) -> None:
            nonlocal restarts, redispatched, phase
            now = time.monotonic()
            failures[kind] = failures.get(kind, 0) + 1
            self.registry.counter(FLEET_FAILURES).inc()
            self.registry.counter(labeled(FLEET_FAILURES, kind=kind)).inc()
            if self.tracer is not None:
                # The supervisor's own black box: ring state at the moment
                # the watchdog (or a dead pid) declared the replica lost.
                self.tracer.event(
                    "replica_failure", t=now, replica=rep.idx, kind=kind,
                )
                self.tracer.dump_flight(f"fleet-{kind}-replica{rep.idx}")
            self._kill(rep)
            orphans = router.mark_dead(rep.idx, now)
            hit = injector.fire_observed(kind) if injector else None
            tag = (
                f"matches planned {hit.kind}@{hit.unit}:{hit.at}"
                if hit is not None else "unplanned"
            )
            self._log(
                f"replica {rep.idx} failed ({why}) — {tag}; "
                f"re-dispatching {len(orphans)} in-flight request(s)"
            )
            if hit is not None:
                journal.record("chaos_fire", kind=kind, replica=rep.idx)
                pending_recoveries.append({
                    "kind": kind, "replica": rep.idx, "detected": now,
                    "rids": set(orphans),
                })
            phase = "during"
            for rid in orphans:
                ledger[rid].holders.discard(rep.idx)
                ledger[rid].redispatched = True
                redispatch_queue.append(rid)
                redispatched += 1
                self.registry.counter(FLEET_REDISPATCH).inc()
                journal.record("redispatch", rid=rid)
            # Hedge losers that lived on the dead replica are already
            # forgotten by mark_dead; their primaries carry on elsewhere.
            for rec in ledger.values():
                rec.holders.discard(rep.idx)
            if restarts >= self.max_replica_restarts:
                raise FleetFailure(
                    f"replica restart budget spent "
                    f"({self.max_replica_restarts})"
                )
            restarts += 1
            self.registry.counter(FLEET_RESTARTS).inc()
            journal.record("failure", idx=rep.idx, kind=kind,
                           chaos=hit is not None)
            if injector is not None:
                from deeplearning_mpi_tpu_torch.resilience.faults import (
                    strip_entries,
                )

                fired = [
                    f"{s.kind}@{s.unit}:{s.at}"
                    for s in injector.plan.specs
                    if s.fired and s.kind in ("replica_kill", "replica_hang")
                ]
                rep.chaos_spec = strip_entries(rep.chaos_spec, fired)
            rep.attempt += 1
            self._spawn(rep)
            if policy is not None:
                # Capacity is already in flux from the respawn: hold scale
                # decisions for one cooldown so failover can't thrash the
                # autoscaler (and vice versa).
                policy.note_respawn(now)

        from deeplearning_mpi_tpu_torch.serving.prefix_cache import prefix_signature

        block_size = int(self.engine_spec.get("block_size", 16))

        def req_sig(rec: _Req) -> Optional[int]:
            # The supervisor computes the same leading-block signature the
            # workers' radix caches key their first trie level by, so
            # affinity routing and cache contents agree cross-process.
            return prefix_signature(rec.prompt, block_size)

        def dispatch(rid: int, target: int, now: float) -> None:
            rec = ledger[rid]
            # Write-ahead: the journal record lands before the wire op, so
            # a crash can journal a dispatch the worker never saw (the
            # probe re-discovers it) but never ship one it didn't journal.
            journal.record("dispatch", rid=rid, target=target)
            self._send(replicas[target], {
                "op": "req", "rid": rid, "prompt": rec.prompt,
                "max_new": rec.max_new, "arrival": rec.arrival_abs,
                "deadline": rec.deadline_abs, "tenant": rec.tenant,
                # Trace context rides the wire: every span the worker emits
                # for this request carries the fleet-global key, not its
                # engine-local rid, so the merged timeline stitches.
                "trace": f"r{rid}",
            })
            rec.holders.add(target)
            router.dispatch(
                rid, target, now,
                deadline=rec.deadline_abs, prefix_sig=req_sig(rec),
            )
            if self.tracer is not None:
                self.tracer.event(
                    "dispatch", trace=f"r{rid}", t=now,
                    replica=target,
                    kind="redispatch" if rec.redispatched else "primary",
                )

        def handle_msg(rep: _Replica, m: dict) -> None:
            nonlocal completed, phase, swap_stage
            now = time.monotonic()
            op = m["op"]
            if op == "ready":
                rep.ready = True
                rep.compile_at_ready = float(m["compile_total"])
                journal.record(
                    "ready", idx=rep.idx, attempt=rep.attempt,
                    compile_total=rep.compile_at_ready, startup_s=m.get("startup_s"),
                )
                router.mark_alive(rep.idx, now)
                router.include(rep.idx)
                for pr in list(pending_recoveries):
                    if pr["replica"] == rep.idx and not pr["rids"]:
                        close_recovery(pr, now)
            elif op == "done":
                rid = int(m["rid"])
                verdict, loser = router.on_complete(
                    rid, rep.idx, now, ttft=m.get("ttft")
                )
                if verdict != "win":
                    return
                rec = ledger[rid]
                rec.tokens = [int(t) for t in m["tokens"]]
                rec.version = int(m["version"])
                rec.ttft = m.get("ttft")
                rec.holders.discard(rep.idx)
                completed += 1
                # Tokens ride the journal so a successor's result (and the
                # offline-greedy parity check) spans both incarnations.
                journal.record(
                    "done", rid=rid, tokens=rec.tokens,
                    version=rec.version, ttft=rec.ttft, phase=phase,
                )
                if self.tracer is not None and m.get("t_finished") is not None:
                    # The stream leg: worker finish → supervisor receipt.
                    # Both stamps are system-wide CLOCK_MONOTONIC, so the
                    # span is valid without any clock translation.
                    self.tracer.record_span(
                        "stream", float(m["t_finished"]), now,
                        trace=f"r{rid}", replica=rep.idx,
                    )
                if rec.ttft is not None:
                    ttft_by_phase[phase].append(float(rec.ttft))
                if loser is not None:
                    self._send(replicas[loser], {"op": "cancel", "rid": rid})
                    ledger[rid].holders.discard(loser)
                for pr in list(pending_recoveries):
                    if pr["rids"] and rid in pr["rids"]:
                        pr["rids"].discard(rid)
                        # load_spike recoveries also wait for every spike
                        # entry to be ADMITTED ("awaiting"), not just for
                        # the already-admitted rids to resolve.
                        if not pr["rids"] and not pr.get("awaiting"):
                            close_recovery(pr, now)
                    elif (
                        pr["kind"] == "replica_slow"
                        and hedged_primary.get(rid) == pr["replica"]
                    ):
                        close_recovery(pr, now)
            elif op == "shed":
                rid = int(m["rid"])
                reason = m["reason"]
                rec = ledger.get(rid)
                if rec is None or reason == "cancelled":
                    return
                rec.holders.discard(rep.idx)
                if rec.tokens is None and not rec.holders:
                    rec.shed_reason = reason
                    router.forget(rid)
                    journal.record("shed", rid=rid, reason=reason)
                for pr in list(pending_recoveries):
                    if pr["rids"] and rid in pr["rids"] and rec.resolved:
                        pr["rids"].discard(rid)
                        if not pr["rids"] and not pr.get("awaiting"):
                            close_recovery(pr, now)
            elif op == "fault":
                hit = (
                    injector.fire_observed(m["kind"]) if injector else None
                )
                self._log(
                    f"replica {rep.idx} reported {m['kind']}@step:"
                    f"{m.get('step')} ("
                    f"{'planned' if hit is not None else 'unplanned'})"
                )
                if hit is not None:
                    journal.record(
                        "chaos_fire", kind=m["kind"], replica=rep.idx
                    )
                    pending_recoveries.append({
                        "kind": m["kind"], "replica": rep.idx,
                        "detected": now, "rids": set(),
                    })
                phase = "during"
            elif op == "swapped":
                rep.version = int(m["version"])
                journal.record("swapped", idx=rep.idx, version=rep.version)
                if not m.get("in_place", True):
                    swap["in_place"] = False
                    self._log(f"replica {rep.idx}: the swap REBOUND parameter storages")
                if float(m["compile_total"]) != rep.compile_at_ready:
                    rep.compile_flat = False
                    swap["compile_flat"] = False
                    self._log(
                        f"replica {rep.idx}: CAPTURE during swap "
                        f"({rep.compile_at_ready} -> {m['compile_total']})"
                    )
                router.include(rep.idx)
                self._log(
                    f"swap: replica {rep.idx} now serving version "
                    f"{rep.version}"
                )
                if swap_queue and swap_queue[0] == rep.idx:
                    swap_queue.pop(0)
                    swap_stage = "drain" if swap_queue else None
            elif op == "stopped":
                rep.stopped = m
                if m.get("launches") is not None:
                    workers[f"replica{rep.idx}-a{rep.attempt}"] = dict(m["launches"])
                if (
                    rep.compile_at_ready is not None
                    and float(m["compile_total"]) != rep.compile_at_ready
                ):
                    rep.compile_flat = False

        # -- fold the dead incarnation's books into this run's state --------
        if recovered is not None:
            t0 = recovered["t0"]
            next_rid = recovered["next_rid"]
            next_idx = max(next_idx, recovered["next_idx"])
            restarts = recovered["restarts"]
            redispatched = recovered["redispatched"]
            failures.update(recovered["failures"])
            brownout_stage = recovered["brownout_stage"]
            brownout_stage_max = recovered["brownout_stage_max"]
            scale_events = len(recovered["scale_records"])
            spawned = sum(
                1 for d, o in recovered["scale_records"]
                if d == "up" and o == "ok"
            )
            vetoed = sum(
                1 for _, o in recovered["scale_records"] if o != "ok"
            )
            retired = recovered["retired_count"]
            scale_ups = spawned
            if recovered["swap_done_version"]:
                target_version = recovered["swap_done_version"]
                swap["performed"] = swap["requested"]
            # Seed this incarnation's counters with the corpse's books so
            # fleet_summary reconciles ACROSS incarnations, not per-process.
            if restarts:
                self.registry.counter(FLEET_RESTARTS).inc(restarts)
            for kind, n in recovered["failures"].items():
                self.registry.counter(FLEET_FAILURES).inc(n)
                self.registry.counter(
                    labeled(FLEET_FAILURES, kind=kind)
                ).inc(n)
            if redispatched:
                self.registry.counter(FLEET_REDISPATCH).inc(redispatched)
            for direction, outcome in recovered["scale_records"]:
                self.registry.counter("fleet_scale_total").inc()
                self.registry.counter(labeled(
                    "fleet_scale_total",
                    direction=direction, outcome=outcome,
                )).inc()
            for stage in recovered["brownout_records"]:
                self.registry.counter("fleet_brownout_total").inc()
                self.registry.counter(labeled(
                    "fleet_brownout_total", stage=str(stage)
                )).inc()
            # Ledger: resolved entries carry over (their tokens are part of
            # this run's result and parity bar); unresolved ones become
            # re-adopted in-flight work or re-dispatch orphans below.
            for rid, jr in sorted(recovered["ledger"].items()):
                rec = _Req(
                    rid=rid,
                    prompt=[int(t) for t in jr["prompt"]],
                    max_new=int(jr["max_new"]),
                    arrival_abs=float(jr["arrival_abs"]),
                    deadline_abs=jr.get("deadline_abs"),
                    tenant=str(jr.get("tenant", "default")),
                )
                rec.redispatched = bool(jr.get("redispatched"))
                if jr.get("tokens") is not None:
                    rec.tokens = [int(t) for t in jr["tokens"]]
                    rec.version = jr.get("version")
                    rec.ttft = jr.get("ttft")
                    completed += 1
                    if rec.ttft is not None:
                        ttft_by_phase[jr.get("phase") or "before"].append(
                            float(rec.ttft)
                        )
                elif jr.get("shed") is not None:
                    rec.shed_reason = str(jr["shed"])
                ledger[rid] = rec
            now0 = time.monotonic()
            for idx, (ack, history) in adopt_histories.items():
                # Completions that landed while the fleet ran unsupervised
                # (after the crash, before this restart) still count — the
                # work happened; only the supervisor that asked for it died.
                for m in history:
                    mop = m.get("op")
                    if mop == "done":
                        rec = ledger.get(int(m["rid"]))
                        if rec is None or rec.resolved:
                            continue
                        rec.tokens = [int(t) for t in m["tokens"]]
                        rec.version = int(m["version"])
                        rec.ttft = m.get("ttft")
                        completed += 1
                        if rec.ttft is not None:
                            ttft_by_phase["during"].append(float(rec.ttft))
                        journal.record(
                            "done", rid=rec.rid, tokens=rec.tokens,
                            version=rec.version, ttft=rec.ttft,
                            phase="during",
                        )
                    elif mop == "shed":
                        rec = ledger.get(int(m["rid"]))
                        if (
                            rec is None or rec.resolved
                            or m["reason"] == "cancelled"
                        ):
                            continue
                        rec.shed_reason = str(m["reason"])
                        journal.record(
                            "shed", rid=rec.rid, reason=rec.shed_reason
                        )
                    elif mop == "swapped":
                        replicas[idx].version = int(m["version"])
                # Rids the adopted worker still holds: rebuild the router's
                # outstanding books in place — no re-dispatch, no re-decode.
                for rid in ack.get("rids", []):
                    rec = ledger.get(int(rid))
                    if rec is None or rec.resolved:
                        continue
                    rec.holders.add(idx)
                    router.dispatch(
                        rec.rid, idx, now0,
                        deadline=rec.deadline_abs, prefix_sig=req_sig(rec),
                    )
            # Orphaned in-flight work (admitted, unresolved, held by no
            # adopted replica) re-dispatches from the prompt with its
            # ORIGINAL arrival/deadline — the failover bar.
            for rid, rec in sorted(ledger.items()):
                if rec.resolved or rec.holders:
                    continue
                rec.redispatched = True
                redispatch_queue.append(rid)
                redispatched += 1
                self.registry.counter(FLEET_REDISPATCH).inc()
                journal.record("redispatch", rid=rid)
            # Trace entries the corpse already admitted must not be
            # admitted twice: multiset-match on (arrival, prompt, max_new,
            # tenant) — exact floats, JSON round-trips losslessly.
            admitted: Counter = Counter(
                (jr.get("arrival_rel"), tuple(jr["prompt"]),
                 int(jr["max_new"]), str(jr.get("tenant", "default")))
                for jr in recovered["ledger"].values()
                if not jr.get("spike")
            )
            kept = []
            for e in pending:
                key = (
                    float(e["arrival"]),
                    tuple(int(t) for t in e["prompt"]),
                    int(e["max_new"]), str(e.get("tenant", "default")),
                )
                if admitted.get(key, 0) > 0:
                    admitted[key] -= 1
                    continue
                kept.append(e)
            # A load_spike burst is synthetic: its un-admitted tail exists
            # only in the journal and must be re-injected for the spike
            # recovery to ever close.
            spike_admits: Counter = Counter(
                (jr.get("arrival_rel"), tuple(jr["prompt"]))
                for jr in recovered["ledger"].values() if jr.get("spike")
            )
            spike_backlog: list[dict] = []
            for fire in recovered["fires"]:
                for e in fire.get("burst") or []:
                    key = (
                        float(e["arrival"]),
                        tuple(int(t) for t in e["prompt"]),
                    )
                    if spike_admits.get(key, 0) > 0:
                        spike_admits[key] -= 1
                        continue
                    spike_backlog.append(e)
            pending = deque(sorted(
                kept + spike_backlog, key=lambda e: e["arrival"]
            ))
            # Chaos books replay: re-mark every journaled fire, pair the
            # journaled recoveries, and take ownership of what the corpse
            # left open. The supervisor kinds close HERE — re-adoption is
            # their recovery, with latency spanning the crash itself
            # (CLOCK_MONOTONIC is system-wide, so the corpse's fire stamp
            # is directly comparable).
            if injector is not None:
                recov_left: Counter = Counter(recovered["recovery_kinds"])
                for fire in recovered["fires"]:
                    kind = str(fire["kind"])
                    injector.fire_observed(kind)
                    if recov_left.get(kind, 0) > 0:
                        recov_left[kind] -= 1
                        injector.record_recovery(kind, latency_s=0.0)
                        continue
                    if kind in ("supervisor_kill", "supervisor_hang"):
                        injector.record_recovery(
                            kind,
                            latency_s=time.monotonic() - float(fire["t"]),
                        )
                        journal.record("chaos_recovery", kind=kind)
                    elif kind == "load_spike":
                        open_rids = {
                            rid for rid, jr in recovered["ledger"].items()
                            if jr.get("spike") and not ledger[rid].resolved
                        }
                        if not open_rids and not spike_backlog:
                            injector.record_recovery(kind, latency_s=0.0)
                            journal.record("chaos_recovery", kind=kind)
                        else:
                            pending_recoveries.append({
                                "kind": kind, "replica": -1,
                                "detected": now0,
                                "rids": set(open_rids),
                                "awaiting": len(spike_backlog),
                            })
                    else:
                        pending_recoveries.append({
                            "kind": kind,
                            "replica": int(fire.get("replica", -1)),
                            "detected": now0, "rids": set(),
                        })
            phase = (
                "during" if pending_recoveries
                else ("after" if recovered["fires"] else "before")
            )
            # An unfinished scale-down resumes its drain here.
            if recovered["retiring"] is not None:
                retiring = recovered["retiring"]
                retire_stop_sent = False
                router.mark_retired(retiring)
            # Adopted workers kept their brownout stage; respawned ones
            # booted at 0 — re-broadcast so the ladder is uniform again.
            if brownout_stage > 0:
                for r in replicas.values():
                    self._send(r, {"op": "brownout", "stage": brownout_stage})
            replay_s = time.monotonic() - replay_wall0
            self.registry.gauge(SUP_REPLAY_S).set(replay_s)
            journal.record(
                "recovered", readopted=adopted_n, respawned=respawned_n,
                redispatched=len(redispatch_queue), replay_s=replay_s,
            )
            self._log(
                f"incarnation {self.incarnation}: journal replay + orphan "
                f"probe took {replay_s:.2f}s — re-adopted {adopted_n}, "
                f"respawned {respawned_n}, re-dispatching "
                f"{len(redispatch_queue)} orphaned request(s), "
                f"{completed} completion(s) carried over"
            )

        try:
            while True:
                now = time.monotonic()
                if t0 is None and any(
                    r.ready for r in replicas.values()
                ):
                    t0 = now
                    journal.record("clock_start", t0=t0)
                if now - start > self.timeout_s:
                    raise FleetFailure(
                        f"run exceeded timeout_s={self.timeout_s}"
                    )

                # 1. liveness + telemetry in.
                for rep in replicas.values():
                    payload = Heartbeat.read(rep.dir / "heartbeat.json")
                    rep.tracker.observe(0, payload)
                    if payload is not None:
                        router.observe(rep.idx, payload)
                        rep.last_hb = payload

                # 2. worker messages.
                for rep in replicas.values():
                    msgs, rep.outbox_offset = _tail_jsonl(
                        rep.dir / "outbox.jsonl", rep.outbox_offset
                    )
                    for m in msgs:
                        handle_msg(rep, m)

                # 2.5 supervisor-level chaos: the control plane detonates
                # ITSELF (SIGKILL mid-surge / wedge forever), orphaning
                # every live worker. The fire is journaled write-ahead —
                # the dying incarnation's registry is lost, and the journal
                # is how the next incarnation inherits the fire into its
                # books (and closes it by re-adopting the fleet).
                if injector is not None:
                    injector.check_supervisor_fault(
                        step=completed,
                        on_fire=lambda kind: journal.record(
                            "chaos_fire", kind=kind, replica=-1
                        ),
                    )

                # 3. dead replicas (exit observed).
                for rep in replicas.values():
                    if rep.proc is not None and rep.proc.poll() is not None:
                        if rep.stopped is not None:
                            continue  # clean shutdown we asked for
                        handle_failure(
                            rep, "replica_kill",
                            f"exit {rep.proc.poll()}",
                        )

                # 4. hung replicas (alive, progress frozen past deadline).
                for rep in replicas.values():
                    if (
                        rep.proc is not None
                        and rep.proc.poll() is None
                        and rep.tracker.stalled(0)
                    ):
                        handle_failure(
                            rep, "replica_hang",
                            "progress stalled "
                            f"{rep.tracker.progress_age_s(0):.1f}s "
                            "(heartbeat daemon still beating)",
                        )

                # 5. re-dispatch orphans of the dead (original arrival AND
                # deadline ride along — failover never refreshes a budget).
                while redispatch_queue:
                    rid = redispatch_queue[0]
                    target = router.select(
                        now, prefix_sig=req_sig(ledger[rid])
                    )
                    if target is None:
                        break  # whole fleet cold; retry next tick
                    redispatch_queue.popleft()
                    dispatch(rid, target, now)

                # 6. hedged retries for the slow.
                for rid, target in router.maybe_hedge(now):
                    rec = ledger[rid]
                    hedged_primary.setdefault(
                        rid,
                        next(iter(rec.holders)) if rec.holders else -1,
                    )
                    journal.record(
                        "dispatch", rid=rid, target=target, hedge=True
                    )
                    self._send(replicas[target], {
                        "op": "req", "rid": rid, "prompt": rec.prompt,
                        "max_new": rec.max_new, "arrival": rec.arrival_abs,
                        "deadline": rec.deadline_abs, "tenant": rec.tenant,
                        "trace": f"r{rid}",
                    })
                    rec.holders.add(target)
                    if self.tracer is not None:
                        self.tracer.event(
                            "dispatch", trace=f"r{rid}", t=now,
                            replica=target, kind="hedge",
                        )
                    self._log(
                        f"hedge: rid {rid} duplicated onto replica {target}"
                    )

                # 7. rolling weight swap, under load.
                if (
                    swap_seed is not None
                    and not swap["performed"]
                    and swap_t0 is None
                    and completed >= (swap_at or 0)
                ):
                    swap_queue = sorted(replicas)
                    swap_stage = "drain"
                    swap_t0 = now
                    swap_mark = completed
                    target_version += 1
                    self._log(
                        f"swap: rolling weight swap to seed {swap_seed} "
                        f"(version {target_version}) across "
                        f"{len(swap_queue)} replicas"
                    )
                if swap_stage == "drain" and swap_queue:
                    cur = replicas[swap_queue[0]]
                    router.exclude(cur.idx)
                    if (
                        cur.ready
                        and cur.proc is not None
                        and cur.proc.poll() is None
                        and not router.outstanding_on(cur.idx)
                    ):
                        cur.seed = swap_seed
                        cur.version = target_version
                        self._send(cur, {
                            "op": "swap", "seed": swap_seed,
                            "version": target_version,
                        })
                        swap_stage = "await"
                if swap_t0 is not None and not swap_queue and not swap[
                    "performed"
                ]:
                    swap["performed"] = True
                    swap["drain_s"] = now - swap_t0
                    swap["completions_during"] = completed - swap_mark
                    journal.record("swap_done", version=target_version)
                    self._log(
                        f"swap: fleet at version {target_version} in "
                        f"{swap['drain_s']:.2f}s "
                        f"({swap['completions_during']} requests completed "
                        "mid-swap)"
                    )

                # 7.5 autoscale control tick (inert without a policy, and
                # held until the trace clock starts — scaling a fleet that
                # has never served would react to warmup, not load).
                if policy is not None and t0 is not None:
                    # load_spike chaos: a planned synthetic burst detonates
                    # once `at` requests have completed — the scale-up path
                    # must absorb it (recovery closes when every spike
                    # request resolves).
                    if injector is not None:
                        for s in injector.plan.specs:
                            if (
                                s.kind == "load_spike"
                                and not s.fired
                                and completed >= s.at
                            ):
                                injector.fire_observed("load_spike")
                                hi = max(
                                    int(
                                        self.model_spec.get(
                                            "vocab_size", 256
                                        )
                                    )
                                    - 1,
                                    2,
                                )
                                burst = [
                                    {
                                        "arrival": now - t0,
                                        "prompt": [
                                            (13 * i + j) % hi
                                            for j in range(8)
                                        ],
                                        "max_new": 4,
                                        "spike": True,
                                    }
                                    for i in range(8)
                                ]
                                # The burst is synthetic — it exists only
                                # in memory, so the journal must carry the
                                # entries themselves or a successor could
                                # never finish absorbing the spike.
                                journal.record(
                                    "chaos_fire", kind="load_spike",
                                    replica=-1, burst=burst,
                                )
                                pending = deque(sorted(
                                    list(pending) + burst,
                                    key=lambda e: e["arrival"],
                                ))
                                pending_recoveries.append({
                                    "kind": "load_spike", "replica": -1,
                                    "detected": now, "rids": set(),
                                    "awaiting": len(burst),
                                })
                                phase = "during"
                                self._log(
                                    f"chaos: load_spike — injected "
                                    f"{len(burst)} synthetic request(s)"
                                )

                    # Retire drain progression (at most one in flight).
                    if retiring is not None:
                        vrep = replicas[retiring]
                        if vrep.stopped is not None:
                            journal.record("retired", idx=retiring)
                            self._kill(vrep)
                            del replicas[retiring]
                            router.remove_replica(retiring)
                            retired += 1
                            self._log(
                                f"autoscale: replica {retiring} retired "
                                f"(fleet now {len(replicas)})"
                            )
                            retiring = None
                            retire_stop_sent = False
                        elif not vrep.ready:
                            # Died mid-drain and was respawned by the
                            # failure path: re-drain once it's back.
                            retire_stop_sent = False
                        elif (
                            not retire_stop_sent
                            and not router.outstanding_on(retiring)
                        ):
                            # Zero-drop drain complete: ask it to stop.
                            self._send(vrep, {"op": "stop"})
                            retire_stop_sent = True

                    # Assemble this tick's load signal through the shared
                    # helper (autoscaler.build_load_signal) — the
                    # simulator builds its signal through the SAME code,
                    # so sim and production cannot drift on how load is
                    # measured.
                    due = sum(
                        1 for e in pending if t0 + e["arrival"] <= now
                    )
                    slots_cap = int(self.engine_spec.get("max_slots", 1))
                    sig = build_load_signal(
                        (
                            ReplicaView(
                                idx=r.idx,
                                ready=r.ready,
                                alive=(
                                    r.proc is not None
                                    and r.proc.poll() is None
                                ),
                                retiring=r.idx == retiring,
                                queue_depth=(
                                    int(r.last_hb.get("queue_depth", 0))
                                    if r.last_hb is not None else 0
                                ),
                                outstanding=len(
                                    router.outstanding_on(r.idx)
                                ),
                                ttft_p50=(
                                    float(r.last_hb.get("ttft_p50") or 0.0)
                                    if r.last_hb is not None else 0.0
                                ),
                            )
                            for r in replicas.values()
                        ),
                        backlog=due + len(redispatch_queue),
                        slots_cap=slots_cap,
                        shed_total=sum(
                            1
                            for rec in ledger.values()
                            if rec.shed_reason is not None
                        ),
                        tokens_in_flight=sum(
                            len(rec.prompt) + rec.max_new
                            for rec in ledger.values()
                            if not rec.resolved
                        ),
                    )
                    self.registry.gauge("fleet_replicas").set(len(replicas))

                    decision = (
                        policy.decide(now, sig)
                        if retiring is None and sig.ready > 0
                        else None
                    )
                    if decision is not None:
                        direction, outcome = decision
                        victim: Optional[int] = None
                        if direction == "down" and outcome == "ok":
                            cand = {
                                r.idx: (
                                    router.prefix_ledger_size(r.idx),
                                    len(router.outstanding_on(r.idx)),
                                )
                                for r in replicas.values()
                                if r.ready
                                and r.proc is not None
                                and r.proc.poll() is None
                            }
                            if cand:
                                victim = policy.pick_retire(cand)
                            else:
                                outcome = "vetoed:no_ready_candidate"
                                policy.note_scale_event(now)
                        scale_events += 1
                        self.registry.counter("fleet_scale_total").inc()
                        self.registry.counter(labeled(
                            "fleet_scale_total",
                            direction=direction,
                            outcome="ok" if outcome == "ok" else "vetoed",
                        )).inc()
                        journal.record(
                            "scale", direction=direction,
                            outcome="ok" if outcome == "ok" else "vetoed",
                        )
                        if outcome != "ok":
                            vetoed += 1
                            self._log(
                                f"autoscale: {direction} {outcome} "
                                f"(load/replica "
                                f"{sig.load_per_replica:.2f})"
                            )
                        elif direction == "up":
                            policy.note_scale_event(now)
                            newr = _Replica(
                                idx=next_idx,
                                # Spawn at the fleet's CURRENT weights —
                                # a scale-up during/after a rolling swap
                                # must serve the target version.
                                seed=(
                                    swap_seed
                                    if target_version > 0 else self.seed
                                ),
                                version=target_version,
                            )
                            next_idx += 1
                            replicas[newr.idx] = newr
                            router.add_replica(
                                newr.idx,
                                role="disagg" if self.disagg else None,
                            )
                            # A cold replica never eats live traffic:
                            # excluded until its ready-ack lands (the
                            # ready handler includes it).
                            router.exclude(newr.idx)
                            self._spawn(newr)
                            spawned += 1
                            scale_ups += 1
                            up_times.append(now - t0)
                            forecast_note = (
                                f", forecast {policy.last_forecast:.2f}"
                                if policy.last_forecast is not None else ""
                            )
                            self._log(
                                f"autoscale: scale-up -> replica "
                                f"{newr.idx} warming (load/replica "
                                f"{sig.load_per_replica:.2f}"
                                f"{forecast_note}, fleet "
                                f"{len(replicas)})"
                            )
                            # scale_during_failure chaos: SIGKILL a live
                            # replica during the `at`-th scale-up, while
                            # the new replica is still warming.
                            if injector is not None:
                                for s in injector.plan.specs:
                                    if (
                                        s.kind == "scale_during_failure"
                                        and not s.fired
                                        and s.at <= scale_ups
                                    ):
                                        live = [
                                            r
                                            for r in replicas.values()
                                            if r.idx != newr.idx
                                            and r.idx != retiring
                                            and r.ready
                                            and r.proc is not None
                                            and r.proc.poll() is None
                                        ]
                                        if live:
                                            handle_failure(
                                                min(
                                                    live,
                                                    key=lambda r: r.idx,
                                                ),
                                                "scale_during_failure",
                                                "chaos SIGKILL "
                                                "mid-scale-up",
                                            )
                                        break
                        else:
                            policy.note_scale_event(now)
                            retiring = victim
                            retire_stop_sent = False
                            journal.record("retire_begin", idx=victim)
                            router.mark_retired(victim)
                            self._log(
                                f"autoscale: scale-down — retiring "
                                f"replica {victim} (prefix ledger "
                                f"{cand[victim][0]}, outstanding "
                                f"{cand[victim][1]})"
                            )

                    # Brownout ladder: escalate/clear + broadcast changes
                    # (held while nothing is ready — a fleet that cannot
                    # serve is cold, not saturated).
                    stage = (
                        policy.brownout(now, sig)
                        if sig.ready > 0 else brownout_stage
                    )
                    if stage != brownout_stage:
                        self.registry.counter("fleet_brownout_total").inc()
                        self.registry.counter(labeled(
                            "fleet_brownout_total", stage=str(stage)
                        )).inc()
                        journal.record("brownout", stage=stage)
                        self._log(
                            f"brownout: stage {brownout_stage} -> {stage} "
                            f"(load/replica {sig.load_per_replica:.2f})"
                        )
                        for r in replicas.values():
                            if (
                                r.proc is not None
                                and r.proc.poll() is None
                            ):
                                self._send(
                                    r,
                                    {"op": "brownout", "stage": stage},
                                )
                        brownout_stage = stage
                        brownout_stage_max = max(brownout_stage_max, stage)

                # 8. admit due trace entries (held until the trace clock
                # starts at first ready).
                while (
                    t0 is not None
                    and pending
                    and t0 + pending[0]["arrival"] <= now
                ):
                    target = router.select(
                        now,
                        prefix_sig=prefix_signature(
                            [int(t) for t in pending[0]["prompt"]],
                            block_size,
                        ),
                    )
                    if target is None:
                        break  # fleet saturated/cold — hold at the door
                    e = pending.popleft()
                    rid = next_rid
                    next_rid += 1
                    deadline = e.get("deadline") or 0
                    ledger[rid] = _Req(
                        rid=rid,
                        prompt=[int(t) for t in e["prompt"]],
                        max_new=int(e["max_new"]),
                        arrival_abs=t0 + float(e["arrival"]),
                        deadline_abs=(
                            t0 + float(e["arrival"]) + float(deadline)
                            if deadline > 0 else None
                        ),
                        tenant=str(e.get("tenant", "default")),
                    )
                    # Admission is journaled with both clocks: the absolute
                    # stamps let a successor re-dispatch with the ORIGINAL
                    # arrival/deadline, the relative one lets it match this
                    # entry against its own copy of the trace.
                    journal.record(
                        "admit", rid=rid, prompt=ledger[rid].prompt,
                        max_new=ledger[rid].max_new,
                        arrival_rel=float(e["arrival"]),
                        arrival_abs=ledger[rid].arrival_abs,
                        deadline_abs=ledger[rid].deadline_abs,
                        tenant=ledger[rid].tenant,
                        spike=bool(e.get("spike")),
                    )
                    if e.get("spike"):
                        # Tie the admitted spike request back to its open
                        # load_spike recovery.
                        for pr in pending_recoveries:
                            if (
                                pr["kind"] == "load_spike"
                                and pr.get("awaiting")
                            ):
                                pr["awaiting"] -= 1
                                pr["rids"].add(rid)
                                break
                    dispatch(rid, target, now)

                # 9. done?
                if (
                    not pending
                    and not redispatch_queue
                    and swap_stage is None
                    and retiring is None
                    and all(r.resolved for r in ledger.values())
                    and (swap["performed"] or swap_seed is None)
                ):
                    break
                if phase == "during" and not pending_recoveries:
                    phase = "after"
                time.sleep(self.poll_interval_s)

            if phase == "during" and not pending_recoveries:
                phase = "after"
            stopping = True
            for rep in replicas.values():
                if rep.proc is not None and rep.proc.poll() is None:
                    self._send(rep, {"op": "stop"})
            stop_deadline = time.monotonic() + 15.0
            while time.monotonic() < stop_deadline and any(
                rep.stopped is None
                and rep.proc is not None
                and rep.proc.poll() is None
                for rep in replicas.values()
            ):
                for rep in replicas.values():
                    msgs, rep.outbox_offset = _tail_jsonl(
                        rep.dir / "outbox.jsonl", rep.outbox_offset
                    )
                    for m in msgs:
                        handle_msg(rep, m)
                time.sleep(self.poll_interval_s)
        except BaseException as err:
            # Watchdog timeout, spent restart budget, operator interrupt —
            # whatever aborts the run dumps the supervisor's ring first.
            if self.tracer is not None:
                self.tracer.dump_flight(
                    f"fleet-abort-{type(err).__name__}"
                )
            raise
        finally:
            for rep in replicas.values():
                self._kill(rep)
            journal.record("supervisor_stop", pid=os.getpid())
            journal.close()
            self.journal = None

        # -- accounting out ---------------------------------------------------
        def pct(vals: list[float], q: float) -> Optional[float]:
            if not vals:
                return None
            d = sorted(vals)
            return d[int(q * (len(d) - 1))]

        shed: dict[str, int] = {}
        shed_by_tenant: dict[str, dict[str, int]] = {}
        for rec in ledger.values():
            if rec.shed_reason is not None:
                shed[rec.shed_reason] = shed.get(rec.shed_reason, 0) + 1
                per = shed_by_tenant.setdefault(rec.tenant, {})
                per[rec.shed_reason] = per.get(rec.shed_reason, 0) + 1
        dropped = sum(1 for rec in ledger.values() if not rec.resolved)
        compile_flat = all(r.compile_flat for r in replicas.values())
        chaos_balanced = injector.balanced() if injector else None
        if injector is not None:
            self._log(injector.summary())
        ttft_summary = {
            f"{ph}_{name}": pct(vals, q)
            for ph, vals in ttft_by_phase.items()
            for name, q in (("p50", 0.50), ("p99", 0.99))
        }
        scale_balanced = scale_events == spawned + retired + vetoed
        ok = (
            dropped == 0
            and compile_flat
            and (chaos_balanced is not False)
            and (swap["performed"] or swap_seed is None)
            and swap["in_place"]
            and scale_balanced
        )
        values: dict[str, Any] = {
            **self.registry.snapshot(),
            "ok": ok,
            "replicas": self.num_replicas,
            "completed_total": completed,
            "shed_total": sum(shed.values()),
            "dropped_total": dropped,
            "redispatched_total": redispatched,
            "swap_performed": swap["performed"],
            "swap_drain_s": swap["drain_s"],
            "swap_completions_during": swap["completions_during"],
            "compile_flat": compile_flat,
        }
        # snapshot() already carries supervisor_incarnation and the
        # readopted/respawned counters; these flat copies make the
        # cross-incarnation reconciliation greppable in fleet_summary.
        values["supervisor_readopted"] = adopted_n
        values["supervisor_respawned"] = respawned_n
        scale_summary: dict[str, Any] = {}
        if self.autoscale is not None:
            scale_summary = {
                "events": scale_events,
                "spawned": spawned,
                "retired": retired,
                "vetoed": vetoed,
                "brownout_stage_max": brownout_stage_max,
                "replicas_final": len(replicas),
                #: trace-clock seconds of each scale-up spawn (the
                #: predictive drill checks these against the crowd peak).
                "up_times": [round(t, 3) for t in up_times],
            }
            values.update({
                "scale_events": scale_events,
                "scale_spawned": spawned,
                "scale_retired": retired,
                "scale_vetoed": vetoed,
                "scale_balanced": scale_balanced,
                "brownout_stage_max": brownout_stage_max,
                "replicas_final": len(replicas),
            })
        if chaos_balanced is not None:
            values["chaos_balanced"] = chaos_balanced
        for key, v in ttft_summary.items():
            if v is not None:
                values[f"ttft_{key}"] = v
        self.registry.emit("fleet_summary", values)
        result = FleetResult(
            ok=ok,
            completed=completed,
            shed=shed,
            dropped=dropped,
            restarts=restarts,
            failures=failures,
            redispatched=redispatched,
            compile_flat=compile_flat,
            chaos_balanced=chaos_balanced,
            ttft=ttft_summary,
            swap=swap,
            requests={
                rid: {
                    "tokens": rec.tokens,
                    "version": rec.version,
                    "prompt": rec.prompt,
                    "max_new": rec.max_new,
                    "redispatched": rec.redispatched,
                    "ttft": rec.ttft,
                    "tenant": rec.tenant,
                }
                for rid, rec in ledger.items()
                if rec.tokens is not None
            },
            snapshot=self.registry.snapshot(),
            scale=scale_summary,
            shed_by_tenant=shed_by_tenant,
            incarnation=int(self.incarnation or 0),
            readopted=adopted_n,
            respawned=respawned_n,
            workers=workers,
        )
        if self.tracer is not None:
            self.tracer.close()
        if self._own_registry:
            self.registry.close()
        return result

    def swap_weights(self, entries: list[dict], *, seed: int,
                     swap_at: int = 0) -> FleetResult:
        """Convenience wrapper: :meth:`run` with a rolling weight swap —
        drain each replica (in-flight requests finish, new ones route to
        peers), copy the weights of ``seed`` into place with no capture,
        re-include, next replica. The drill calls :meth:`run` directly to
        compose the swap with chaos; this entry exists for callers that
        only want the zero-downtime deploy."""
        return self.run(entries, swap_at=swap_at, swap_seed=seed)


if __name__ == "__main__":
    sys.exit(worker_main())
