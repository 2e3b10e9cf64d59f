"""Fake-clock fleet simulator over the *real* serving policy objects.

Port of ``deeplearning_mpi_tpu/sim/simulator.py`` over the port's
``Router``, ``Scheduler``, ``PagedKVPool``, ``prefix_signature``,
``AutoscalerPolicy`` and ``build_load_signal``; the same trace and config
give the reference's summary.

The serving policy stack (``serving/router.py`` selection + hedging,
``serving/autoscaler.py`` decide loop + brownout ladder, the scheduler's
tenant-budget / priority / deadline admission, the prefix-affinity
ledger) is clock-pure by construction — every decision is a function of
(config, injected clock, telemetry). This module exploits that contract:
it instantiates the SAME classes the live fleet runs, injects a
discrete-event fake clock, and replaces only the engine compute with an
analytic :class:`ServiceModel` calibrated from measured TTFT/TPOT
telemetry. No processes spawn, no device work happens, and a whole-day
trace (10^5..10^6 requests) simulates in seconds — which is what makes
the ``sim/search.py`` parameter sweep and the predictive-autoscaler A/B
affordable.

What is real (bit-identical objects and code paths to production):
:class:`~..serving.router.Router` scoring/affinity/hedging/dedup,
:class:`~..serving.scheduler.Scheduler` + :class:`~..serving.kv_pool.
PagedKVPool` admission (queue bound, length gate, tenant budgets,
priorities, deadline shed, brownout door), and
:class:`~..serving.autoscaler.AutoscalerPolicy` with the shared
:func:`~..serving.autoscaler.build_load_signal` aggregation.

What is modeled analytically (the documented fidelity limits —
the reference's ``docs/SIMULATION.md``): prefill/decode service times, batch-size
interference, prefix-cache hit payoff (a flat prefill discount when the
router's affinity ledger says the replica recently served this prefix),
and spawn-to-ready warmup. Per-token KV growth, eviction under OOM, and
speculative decoding are not simulated.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Any, Optional

import numpy as np

from deeplearning_mpi_tpu_torch.serving.autoscaler import (
    AutoscalerConfig,
    AutoscalerPolicy,
    ReplicaView,
    build_load_signal,
)
from deeplearning_mpi_tpu_torch.serving.kv_pool import PagedKVPool
from deeplearning_mpi_tpu_torch.serving.prefix_cache import prefix_signature
from deeplearning_mpi_tpu_torch.serving.router import Router
from deeplearning_mpi_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["FleetSimulator", "ServiceModel", "SimConfig", "SimResult"]


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Analytic replica service model — the one piece of the fleet the
    simulator replaces. Calibrate from measured telemetry with
    :meth:`from_telemetry` (the calibration test pins sim output against
    a real fleet run; on the card, phase 23b of ``chip_smoke.py`` calibrates
    it from phase 22c's autoscaled fleet)."""

    #: fixed per-request overhead before the first token (dispatch, queue
    #: pickup, sampling) — the prompt-independent part of TTFT.
    ttft_base_s: float = 0.03
    #: prefill seconds per prompt token at batch size 1.
    prefill_s_per_token: float = 0.0005
    #: decode seconds per output token at batch size 1.
    tpot_s: float = 0.01
    #: batch interference: service times stretch by
    #: ``1 + decode_penalty * (active-1)/(max_slots-1)`` — batch of 2
    #: costs nearly what batch of ``max_slots`` does (weight streaming
    #: dominates), so the penalty is sublinear in practice; one linear
    #: knob captures the first-order effect.
    decode_penalty: float = 0.8
    #: prefill cost multiplier when the router's affinity ledger says the
    #: target replica recently served this prefix signature (radix-cache
    #: hit: only the private tail prefills).
    prefix_hit_factor: float = 0.35
    #: spawn-to-ready warmup for scale-up replicas (compile + weight
    #: load); predictive scale-up exists to hide exactly this latency.
    warmup_s: float = 1.0

    @classmethod
    def from_telemetry(
        cls,
        *,
        ttft_p50_s: float,
        tpot_p50_s: float,
        mean_prompt_len: float,
        warmup_s: float = 1.0,
        **overrides: Any,
    ) -> "ServiceModel":
        """Calibrate from measured medians: split observed TTFT evenly
        between fixed overhead and prompt-proportional prefill at the
        measured mean prompt length (the split is a modeling choice; the
        sum — what SLO attainment depends on — matches the measurement
        exactly at the calibration point)."""
        base = 0.5 * ttft_p50_s
        per_tok = 0.5 * ttft_p50_s / max(mean_prompt_len, 1.0)
        return cls(
            ttft_base_s=base,
            prefill_s_per_token=per_tok,
            tpot_s=tpot_p50_s,
            warmup_s=warmup_s,
            **overrides,
        )

    def batch_factor(self, active: int, max_slots: int) -> float:
        return 1.0 + self.decode_penalty * (
            max(active - 1, 0) / max(max_slots - 1, 1)
        )

    def ttft_s(self, prompt_len: int, *, active: int, max_slots: int,
               prefix_hit: bool) -> float:
        prefill = self.prefill_s_per_token * prompt_len
        if prefix_hit:
            prefill *= self.prefix_hit_factor
        return (self.ttft_base_s + prefill) * self.batch_factor(
            active, max_slots
        )

    def decode_s(self, max_new: int, *, active: int, max_slots: int) -> float:
        return (
            max(max_new - 1, 0)
            * self.tpot_s
            * self.batch_factor(active, max_slots)
        )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Fleet + clock shape for one simulation run. Defaults mirror the
    compressed-clock drills; the sweep varies the policy knobs."""

    #: tick resolution — policy decisions quantize to this.
    dt_s: float = 0.05
    #: autoscaler control-tick cadence (the fleet's phase 7.5).
    control_interval_s: float = 0.25
    #: heartbeat cadence: how often replica snapshots reach the router
    #: (models the one-beat staleness the live scorer sees).
    heartbeat_s: float = 0.1
    initial_replicas: int = 2
    max_slots: int = 8
    max_seq_len: int = 2048
    max_queue: int = 64
    kv_blocks: int = 1024
    kv_block_size: int = 16
    decode_buckets: tuple[int, ...] = ()
    autoscale: AutoscalerConfig = dataclasses.field(
        default_factory=AutoscalerConfig
    )
    #: router knobs (0 disables hedging, as in the live fleet).
    hedge_ms: float = 0.0
    exclusion_s: float = 1.0
    #: per-tenant scheduler policy: name -> {"budget_tokens", "priority"}
    #: (use ``traces.tenant_policies`` so sim and replay agree).
    tenants: dict[str, dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    service: ServiceModel = dataclasses.field(default_factory=ServiceModel)
    #: TTFT SLO bound a completion must meet to count as attained.
    slo_ttft_s: float = 2.0
    #: SLO/utilization curve resolution.
    curve_window_s: float = 60.0
    #: after the last arrival, how long the sim drains before declaring
    #: leftovers shed (bounds runaway configs; generous by default).
    drain_grace_s: float = 60.0


@dataclasses.dataclass
class SimResult:
    """Aggregates + time-series curves from one simulated trace."""

    requests: int = 0
    completed: int = 0
    slo_ok: int = 0
    #: terminal sheds by reason (hedge-dedup "cancelled" excluded — the
    #: client got its answer from the winning copy).
    shed: dict[str, int] = dataclasses.field(default_factory=dict)
    hedges_fired: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    scale_vetoed: int = 0
    #: sim-clock stamps of scale-up spawns (predictive drills assert the
    #: first one lands BEFORE the flash-crowd peak).
    up_times: list[float] = dataclasses.field(default_factory=list)
    brownout_max_stage: int = 0
    #: integral of ready replicas over time — the "chips" denominator.
    replica_seconds: float = 0.0
    sim_seconds: float = 0.0
    #: per-window curves: arrivals/completions/sheds/ready/load/slo_ok.
    curves: list[dict[str, float]] = dataclasses.field(default_factory=list)
    #: winning copies' time-to-first-token samples (sim clock) — the
    #: calibration observable compared against measured drill TTFT.
    ttfts: list[float] = dataclasses.field(default_factory=list)

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())

    def ttft_quantile(self, q: float) -> Optional[float]:
        if not self.ttfts:
            return None
        xs = sorted(self.ttfts)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    @property
    def slo_attainment(self) -> float:
        return self.slo_ok / max(self.requests, 1)

    @property
    def slo_per_chip(self) -> float:
        """SLO-attained completions per replica-second — the sweep's
        scoring objective (serving MORE within SLO on FEWER chips wins;
        overscaling buys attainment but pays here)."""
        return self.slo_ok / max(self.replica_seconds, 1e-9)

    def summary(self) -> dict[str, Any]:
        return {
            "sim_requests_total": self.requests,
            "sim_completed_total": self.completed,
            "sim_slo_ok_total": self.slo_ok,
            "sim_shed_total": self.shed_total,
            "sim_shed_by_reason": dict(sorted(self.shed.items())),
            "sim_hedge_fired_total": self.hedges_fired,
            "sim_scale_ups": self.scale_ups,
            "sim_scale_downs": self.scale_downs,
            "sim_scale_vetoed": self.scale_vetoed,
            "sim_up_times": [round(t, 3) for t in self.up_times],
            "sim_brownout_max_stage": self.brownout_max_stage,
            "sim_replica_seconds": round(self.replica_seconds, 3),
            "sim_clock_seconds": round(self.sim_seconds, 3),
            "sim_slo_attainment": round(self.slo_attainment, 6),
            "sim_slo_per_chip": round(self.slo_per_chip, 6),
            "sim_ttft_p50_s": (
                round(self.ttft_quantile(0.5), 4) if self.ttfts else None
            ),
            "sim_ttft_p95_s": (
                round(self.ttft_quantile(0.95), 4) if self.ttfts else None
            ),
        }


@dataclasses.dataclass
class _SimReplica:
    """The simulator's stand-in for one worker process: a REAL scheduler
    over a real KV pool, plus the analytic service state."""

    idx: int
    sched: Scheduler
    #: sim time this replica acks ready (spawn warmup); initial fleet
    #: members are ready at t=0.
    ready_at: float = 0.0
    retiring: bool = False
    #: per-replica TTFT EWMA — what the heartbeat reports as ttft_p50.
    ttft_ewma: float = 0.0

    def ready(self, now: float) -> bool:
        return now >= self.ready_at


class FleetSimulator:
    """Discrete-event replay of a trace against the real policy stack.

    One :meth:`run` call consumes entries in the ``FleetSupervisor.run``
    schema (``traces.to_fleet_entries`` output: prompt as token-id list,
    ``arrival``/``max_new``/optional ``deadline``/``tenant``) and returns
    a :class:`SimResult`. Deterministic: same (config, entries) ->
    identical result, always — no wall clock, no randomness.
    """

    def __init__(self, config: SimConfig,
                 registry: Optional[Any] = None) -> None:
        self.cfg = config
        self.registry = registry
        self._t = 0.0
        self.router = Router(
            range(config.initial_replicas),
            clock=lambda: self._t,
            hedge_ms=config.hedge_ms,
            exclusion_s=config.exclusion_s,
        )
        self.policy = AutoscalerPolicy(config.autoscale)
        self.replicas: dict[int, _SimReplica] = {
            i: self._make_replica(i) for i in range(config.initial_replicas)
        }
        self._next_idx = config.initial_replicas
        #: rid -> {replica: Request} — every live copy (primary + hedge)
        #: of each in-flight request, for hedge-loser cancellation.
        self._copies: dict[int, dict[int, Request]] = {}
        #: rid -> entry (for re-dispatch bookkeeping / prefix sigs).
        self._prompts: dict[int, np.ndarray] = {}
        self._deadlines: dict[int, Optional[float]] = {}
        #: completion events: (t_fin, seq, rid, replica).
        self._events: list[tuple[float, int, int, int]] = []
        self._seq = 0
        self._backlog: deque[tuple[int, dict]] = deque()
        self._last_door_reason = "queue_full"
        self._last_load = 0.0
        self.result = SimResult()

    def _make_replica(self, idx: int, *, ready_at: float = 0.0
                      ) -> _SimReplica:
        cfg = self.cfg
        return _SimReplica(
            idx=idx,
            sched=Scheduler(
                PagedKVPool(
                    num_blocks=cfg.kv_blocks, block_size=cfg.kv_block_size
                ),
                max_slots=cfg.max_slots,
                max_seq_len=cfg.max_seq_len,
                max_queue=cfg.max_queue,
                decode_buckets=cfg.decode_buckets,
                tenants=cfg.tenants,
            ),
            ready_at=ready_at,
        )

    # -- request lifecycle ---------------------------------------------------
    def _record_shed(self, reason: str) -> None:
        self.result.shed[reason] = self.result.shed.get(reason, 0) + 1

    def _copy_gone(self, rid: int, replica: int, reason: str) -> None:
        """A copy of ``rid`` on ``replica`` died (deadline/door/evict).
        The request only becomes a terminal shed when NO copy remains."""
        copies = self._copies.get(rid)
        if copies is not None:
            copies.pop(replica, None)
            if copies:
                return  # the other copy (hedge or primary) still runs
            del self._copies[rid]
        self.router.forget(rid)
        self._prompts.pop(rid, None)
        self._deadlines.pop(rid, None)
        self._record_shed(reason)
        self._window["sheds"] += 1

    def _submit_copy(self, rid: int, replica: int, entry: dict,
                     prompt: np.ndarray) -> Optional[Request]:
        """Build a fresh Request object for one copy and push it through
        the replica's REAL admission stack. Returns the accepted Request,
        or None on a door shed (the reason was already accounted via
        :meth:`_copy_gone` by the caller reading ``req.shed_reason``)."""
        req = Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=int(entry["max_new"]),
            arrival=float(entry["arrival"]),
            deadline=self._deadlines[rid],
            tenant=str(entry.get("tenant", "default")),
        )
        if not self.replicas[replica].sched.submit(req):
            self._last_door_reason = req.shed_reason or "queue_full"
            return None
        self._copies.setdefault(rid, {})[replica] = req
        return req

    def _dispatch_backlog(self) -> None:
        cfg = self.cfg
        while self._backlog:
            rid, entry = self._backlog[0]
            prompt = self._prompts.get(rid)
            if prompt is None:
                prompt = np.asarray(entry["prompt"], dtype=np.int32)
                self._prompts[rid] = prompt
                dl = entry.get("deadline")
                self._deadlines[rid] = (
                    float(entry["arrival"]) + float(dl)
                    if dl is not None else None
                )
            sig = prefix_signature(prompt, cfg.kv_block_size)
            target = self.router.select(self._t, prefix_sig=sig)
            if target is None:
                return  # whole fleet warming/excluded: retry next tick
            self._backlog.popleft()
            self.router.dispatch(
                rid, target, self._t,
                deadline=self._deadlines[rid], prefix_sig=sig,
            )
            if self._submit_copy(rid, target, entry, prompt) is None:
                self._copy_gone(rid, target, self._last_door_reason)

    def _schedule_completions(self, replica: int,
                              admitted: list[Request]) -> None:
        """Stamp analytic service times on just-admitted requests and
        queue their completion events."""
        cfg = self.cfg
        sim_r = self.replicas[replica]
        active = sim_r.sched.slots_active()
        for req in admitted:
            sig = prefix_signature(req.prompt, cfg.kv_block_size)
            hit = self.router.has_prefix_affinity(replica, sig)
            ttft_service = cfg.service.ttft_s(
                req.prompt_len, active=active, max_slots=cfg.max_slots,
                prefix_hit=hit,
            )
            t_first = self._t + ttft_service
            req.t_first_token = t_first
            fin = t_first + cfg.service.decode_s(
                req.max_new_tokens, active=active, max_slots=cfg.max_slots
            )
            self._seq += 1
            heapq.heappush(
                self._events, (fin, self._seq, req.rid, replica)
            )

    def _complete(self, t_fin: float, rid: int, replica: int) -> None:
        sim_r = self.replicas.get(replica)
        copies = self._copies.get(rid)
        req = copies.get(replica) if copies else None
        if sim_r is None or req is None or req.state.value in (
            "shed", "finished"
        ):
            return  # copy was cancelled/evicted/replica removed meanwhile
        sim_r.sched.finish(req, t_fin)
        copies.pop(replica, None)
        ttft = req.ttft or 0.0
        a = 0.3
        sim_r.ttft_ewma += a * (ttft - sim_r.ttft_ewma)
        verdict, loser = self.router.on_complete(
            rid, replica, t_fin, ttft=ttft
        )
        if verdict != "win":
            return  # duplicate: client already has the stream
        if loser is not None and copies:
            lose_req = copies.pop(loser, None)
            lose_rep = self.replicas.get(loser)
            if lose_req is not None and lose_rep is not None:
                lose_rep.sched.cancel(lose_req)
        self._copies.pop(rid, None)
        self._prompts.pop(rid, None)
        deadline = self._deadlines.pop(rid, None)
        res = self.result
        res.completed += 1
        ok = (deadline is None or t_fin <= deadline) and (
            ttft <= self.cfg.slo_ttft_s
        )
        if ok:
            res.slo_ok += 1
        res.ttfts.append(ttft)
        self._window["completions"] += 1
        self._window["slo_ok"] += 1 if ok else 0

    # -- control tick --------------------------------------------------------
    def _control_tick(self) -> None:
        cfg, res = self.cfg, self.result
        views = [
            ReplicaView(
                idx=r.idx,
                ready=r.ready(self._t),
                alive=True,
                retiring=r.retiring,
                queue_depth=r.sched.queue_depth(),
                outstanding=len(self.router.outstanding_on(r.idx)),
                ttft_p50=r.ttft_ewma,
            )
            for r in self.replicas.values()
        ]
        sig = build_load_signal(
            views,
            backlog=len(self._backlog),
            slots_cap=cfg.max_slots,
            shed_total=res.shed_total,
        )
        self._last_load = sig.load_per_replica
        decision = self.policy.decide(self._t, sig)
        if decision is not None:
            direction, outcome = decision
            if outcome != "ok":
                res.scale_vetoed += 1
            elif direction == "up":
                idx = self._next_idx
                self._next_idx += 1
                self.router.add_replica(idx)
                self.router.exclude(idx)  # cold until ready-ack
                self.replicas[idx] = self._make_replica(
                    idx, ready_at=self._t + cfg.service.warmup_s
                )
                res.scale_ups += 1
                res.up_times.append(self._t)
                self.policy.note_scale_event(self._t)
            else:
                candidates = {
                    r.idx: (
                        self.router.prefix_ledger_size(r.idx),
                        len(self.router.outstanding_on(r.idx)),
                    )
                    for r in self.replicas.values()
                    if r.ready(self._t) and not r.retiring
                }
                if candidates:
                    victim = self.policy.pick_retire(candidates)
                    self.router.mark_retired(victim)
                    self.replicas[victim].retiring = True
                    res.scale_downs += 1
                    self.policy.note_scale_event(self._t)
        stage = self.policy.brownout(self._t, sig)
        res.brownout_max_stage = max(res.brownout_max_stage, stage)
        for r in self.replicas.values():
            if r.sched.brownout_stage != stage:
                r.sched.set_brownout(stage)
        # Reap fully drained retirees.
        for idx in [
            r.idx for r in self.replicas.values()
            if r.retiring
            and r.sched.idle()
            and not self.router.outstanding_on(r.idx)
        ]:
            self.router.remove_replica(idx)
            del self.replicas[idx]

    def _flush_window(self, t_end: float) -> None:
        w = self._window
        w["t"] = round(t_end, 3)
        w["ready"] = sum(
            1 for r in self.replicas.values()
            if r.ready(t_end) and not r.retiring
        )
        w["load"] = round(self._last_load, 4)
        self.result.curves.append(dict(w))
        self._window = {
            "t": 0.0, "arrivals": 0, "completions": 0, "sheds": 0,
            "slo_ok": 0, "ready": 0, "load": 0.0,
        }

    # -- main loop -----------------------------------------------------------
    def run(self, entries: list[dict]) -> SimResult:
        cfg, res = self.cfg, self.result
        res.requests = len(entries)
        arrivals = sorted(
            range(len(entries)), key=lambda i: float(entries[i]["arrival"])
        )
        last_arrival = (
            float(entries[arrivals[-1]]["arrival"]) if entries else 0.0
        )
        ai = 0
        self._window = {
            "t": 0.0, "arrivals": 0, "completions": 0, "sheds": 0,
            "slo_ok": 0, "ready": 0, "load": 0.0,
        }
        self._last_load = 0.0
        next_control = 0.0
        next_heartbeat = 0.0
        next_window = cfg.curve_window_s
        deadline_t = last_arrival + cfg.drain_grace_s
        while True:
            t = self._t
            # 1. arrivals due this tick enter the dispatch backlog.
            while ai < len(arrivals) and (
                float(entries[arrivals[ai]]["arrival"]) <= t
            ):
                i = arrivals[ai]
                self._backlog.append((i, entries[i]))
                self._window["arrivals"] += 1
                ai += 1
            # 2. warming replicas that reached ready join the fleet.
            for r in self.replicas.values():
                if 0.0 < r.ready_at <= t:
                    self.router.include(r.idx)
                    r.ready_at = 0.0  # ready from now on
            # 3. dispatch + per-replica step (deadline shed, admission).
            self._dispatch_backlog()
            for r in list(self.replicas.values()):
                if not r.ready(t):
                    continue
                if r.sched.queue_depth():
                    for req in r.sched.shed_expired(t):
                        self._copy_gone(req.rid, r.idx, "deadline")
                    admitted = r.sched.admit(t)
                    if admitted:
                        self._schedule_completions(r.idx, admitted)
            # 4. completions due this tick (in event order).
            while self._events and self._events[0][0] <= t:
                t_fin, _, rid, replica = heapq.heappop(self._events)
                self._complete(t_fin, rid, replica)
            # 5. hedged retries.
            if cfg.hedge_ms > 0:
                for rid, target in self.router.maybe_hedge(t):
                    prompt = self._prompts.get(rid)
                    primary = self._copies.get(rid)
                    if prompt is None or not primary:
                        continue
                    entry = {
                        "arrival": next(iter(primary.values())).arrival,
                        "max_new": next(
                            iter(primary.values())
                        ).max_new_tokens,
                        "tenant": next(iter(primary.values())).tenant,
                    }
                    if self._submit_copy(
                        rid, target, entry, prompt
                    ) is not None:
                        res.hedges_fired += 1
            # 6. heartbeats: snapshots reach the router at their cadence.
            if t >= next_heartbeat:
                for r in self.replicas.values():
                    self.router.observe(r.idx, {
                        "queue_depth": r.sched.queue_depth(),
                        "slots_active": r.sched.slots_active(),
                        "ttft_p50": r.ttft_ewma,
                    })
                next_heartbeat = t + cfg.heartbeat_s
            # 7. autoscaler control tick.
            if t >= next_control:
                self._control_tick()
                next_control = t + cfg.control_interval_s
            # 8. curves + chip-seconds integral.
            res.replica_seconds += cfg.dt_s * sum(
                1 for r in self.replicas.values()
                if r.ready(t) and not r.retiring
            )
            if t >= next_window:
                self._flush_window(t)
                next_window = t + cfg.curve_window_s
            # 9. done?
            drained = (
                ai >= len(arrivals)
                and not self._backlog
                and not self._events
                and not self._copies
            )
            if drained or t > deadline_t:
                break
            self._t = t + cfg.dt_s
        # Anything still in flight past the grace window is a truncation
        # shed — NEVER silently dropped (the curves and totals must add
        # up to the trace size).
        for rid in list(self._copies):
            for replica in list(self._copies[rid]):
                self._copy_gone(rid, replica, "sim_truncated")
        for rid, _entry in self._backlog:
            self._record_shed("sim_truncated")
        self._backlog.clear()
        self._flush_window(self._t)
        res.sim_seconds = self._t
        if self.registry is not None:
            self._emit_metrics()
        return res

    # -- telemetry out -------------------------------------------------------
    def _emit_metrics(self) -> None:
        """Mirror the result into a telemetry registry under the ``sim_*``
        namespace so drill summaries and ``tools/metrics_report.py`` read
        simulator output through the same
        pipeline as live serving metrics."""
        from deeplearning_mpi_tpu_torch.telemetry.registry import labeled

        reg = self.registry
        res = self.result
        reg.counter("sim_requests_total").inc(res.requests)
        reg.counter("sim_completed_total").inc(res.completed)
        reg.counter("sim_slo_ok_total").inc(res.slo_ok)
        reg.counter("sim_shed_total").inc(res.shed_total)
        for reason, n in sorted(res.shed.items()):
            reg.counter(labeled("sim_shed_total", reason=reason)).inc(n)
        reg.counter("sim_hedge_fired_total").inc(res.hedges_fired)
        reg.gauge("sim_replica_seconds").set(res.replica_seconds)
        reg.gauge("sim_slo_attainment").set(res.slo_attainment)
        reg.gauge("sim_brownout_max_stage").set(res.brownout_max_stage)
