"""The port's fleet router and serving fault hooks against the reference's.

Each of the reference's router and replica-fault-kind tests
(``tests/test_fleet.py``) runs on both packages' copies (``pkg``: the JAX
package's and the port's) under a fake clock. Then one seeded sequence of
snapshots, dispatches, deaths, hedges and completions drives both routers
side by side: every selection, exclusion window, hedge fired, verdict and
loser, and the hedge counters, are equal. The serving ``ChaosInjector``
hooks fire at the same steps under the same plans, and the kind sets give
``serve_lm``'s workloads the same verdicts.
"""

import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning_mpi_tpu.cli import serve_lm as ref_serve_lm
from deeplearning_mpi_tpu.resilience import faults as ref_faults
from deeplearning_mpi_tpu.serving.router import Router as RefRouter
from deeplearning_mpi_tpu.telemetry import MetricsRegistry as RefRegistry
from deeplearning_mpi_tpu_torch.cli import serve_lm as port_serve_lm
from deeplearning_mpi_tpu_torch.resilience import faults as port_faults
from deeplearning_mpi_tpu_torch.serving.router import Router as PortRouter
from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry as PortRegistry


def _ns(faults, router, registry, serve_lm):
    return types.SimpleNamespace(
        faults=faults, Router=router, MetricsRegistry=registry, serve_lm=serve_lm,
        **{n: getattr(faults, n) for n in ("ChaosInjector", "FaultPlan", "fleet_entries",
                                           "validate_plan_kinds", "FLEET_KINDS",
                                           "SERVE_KINDS", "FAULT_UNITS")})


PKGS = {
    "jax": _ns(ref_faults, RefRouter, RefRegistry, ref_serve_lm),
    "torch": _ns(port_faults, PortRouter, PortRegistry, port_serve_lm),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float = 1.0) -> None:
        self.t += dt


def _router(pkg, n=2, **kw):
    clock = FakeClock()
    return pkg.Router(range(n), clock=clock, **kw), clock


class TestRouterSelection:
    def test_select_prefers_lowest_reported_load(self, pkg):
        router, _ = _router(pkg, )
        router.observe(0, {"queue_depth": 5, "slots_active": 3})
        router.observe(1, {"queue_depth": 1, "slots_active": 1})
        assert router.select() == 1

    def test_outstanding_ledger_beats_stale_snapshot(self, pkg):
        """The snapshot lags by a heartbeat; the router's own dispatch
        ledger does not — a burst must spread instead of piling onto the
        replica whose stale snapshot still says 'idle'."""
        router, _ = _router(pkg, )
        targets = []
        for rid in range(4):
            t = router.select()
            router.dispatch(rid, t)
            targets.append(t)
        assert targets == [0, 1, 0, 1]

    def test_ties_break_to_lowest_id(self, pkg):
        router, _ = _router(pkg, n=3)
        assert router.select() == 0

    def test_ttft_in_score(self, pkg):
        router, _ = _router(pkg, )
        router.observe(0, {"ttft_p50": 2.0})
        router.observe(1, {"ttft_p50": 0.1})
        assert router.select() == 1

    def test_select_none_when_fleet_unavailable(self, pkg):
        router, clock = _router(pkg, )
        router.mark_dead(0, clock())
        router.exclude(1)
        assert router.select() is None


class TestRouterExclusion:
    def test_mark_dead_orphans_primaries_and_opens_window(self, pkg):
        router, clock = _router(pkg, exclusion_s=1.0)
        router.dispatch(0, 0, clock())
        router.dispatch(1, 0, clock())
        router.dispatch(2, 1, clock())
        orphans = router.mark_dead(0, clock())
        assert sorted(orphans) == [0, 1]
        assert router.eligible(clock()) == [1]
        # ready alone is not enough: the exclusion window must also pass
        # (a cold respawn would win every selection on an empty queue).
        router.mark_alive(0, clock())
        assert router.eligible(clock()) == [1]
        clock.advance(1.01)
        assert router.eligible(clock()) == [0, 1]

    def test_window_alone_is_not_enough_either(self, pkg):
        router, clock = _router(pkg, exclusion_s=0.5)
        router.mark_dead(0, clock())
        clock.advance(5.0)
        assert router.eligible(clock()) == [1]  # never marked alive
        router.mark_alive(0, clock())
        assert router.eligible(clock()) == [0, 1]

    def test_surviving_hedge_is_promoted_to_primary(self, pkg):
        """Primary's replica dies while a hedge copy runs elsewhere: the
        request is NOT orphaned — the hedge copy becomes the primary and
        its completion is a plain win (no phantom loser to cancel)."""
        router, clock = _router(pkg, hedge_ms=100.0, registry=pkg.MetricsRegistry())
        router.dispatch(0, 0, clock())
        clock.advance(0.2)
        assert router.maybe_hedge(clock()) == [(0, 1)]
        assert router.mark_dead(0, clock()) == []
        verdict, loser = router.on_complete(0, 1, clock())
        assert (verdict, loser) == ("win", None)


class TestPrefixAffinity:
    def test_affinity_steers_an_otherwise_tied_selection(self, pkg):
        """After replica 1 served a request with this leading-block
        signature, a later same-signature request breaks the idle tie
        toward it (instead of the lowest-id default) — and an unrelated
        signature still falls back to the default."""
        router, clock = _router(pkg, )
        router.dispatch(0, 1, clock(), prefix_sig=42)
        assert router.on_complete(0, 1, clock())[0] == "win"
        assert router.select(clock()) == 0  # no signature: lowest id
        assert router.select(clock(), prefix_sig=42) == 1
        assert router.select(clock(), prefix_sig=7) == 0  # unknown sig

    def test_affinity_is_weaker_than_real_load(self, pkg):
        """The bonus is half a request: a probable cache hit must steer
        ties, not funnel a hot shared prefix's whole traffic onto one
        busy replica."""
        router, clock = _router(pkg, )
        router.dispatch(0, 1, clock(), prefix_sig=42)  # still outstanding
        assert router.select(clock(), prefix_sig=42) == 0

    def test_mark_dead_clears_affinity(self, pkg):
        """The radix cache died with the process — a respawn starts cold,
        so its old signatures must not attract same-prefix traffic."""
        router, clock = _router(pkg, exclusion_s=0.5)
        router.dispatch(0, 1, clock(), prefix_sig=42)
        assert router.on_complete(0, 1, clock())[0] == "win"
        router.mark_dead(1, clock())
        router.mark_alive(1, clock())
        clock.advance(1.0)
        assert router.eligible(clock()) == [0, 1]
        assert router.select(clock(), prefix_sig=42) == 0

    def test_signature_history_is_bounded(self, pkg):
        router, clock = _router(pkg, n=1)
        for i in range(200):
            router.dispatch(i, 0, clock(), prefix_sig=i)
            clock.advance(0.01)
        sigs = router._replicas[0].prefix_sigs
        assert len(sigs) == 128
        assert 199 in sigs and 0 not in sigs  # oldest evicted first


class TestHedging:
    def test_fires_only_past_threshold(self, pkg):
        registry = pkg.MetricsRegistry()
        router, clock = _router(pkg, hedge_ms=50.0, registry=registry)
        router.dispatch(0, 0, clock())
        clock.advance(0.02)
        assert router.maybe_hedge(clock()) == []
        clock.advance(0.04)  # 60ms outstanding
        assert router.maybe_hedge(clock()) == [(0, 1)]
        # already hedged: never a third copy
        clock.advance(1.0)
        assert router.maybe_hedge(clock()) == []
        snap = registry.snapshot()
        assert snap['serve_hedge_total{outcome="fired"}'] == 1

    def test_deadline_budget_gates_hedging(self, pkg):
        """Hedging a request the client already gave up on is pure waste:
        past the absolute deadline, no duplicate fires."""
        router, clock = _router(pkg, hedge_ms=50.0)
        router.dispatch(0, 0, clock(), deadline=0.04)
        clock.advance(0.06)  # past hedge threshold AND past deadline
        assert router.maybe_hedge(clock()) == []

    def test_no_hedge_without_a_second_eligible_replica(self, pkg):
        router, clock = _router(pkg, hedge_ms=50.0)
        router.exclude(1)
        router.dispatch(0, 0, clock())
        clock.advance(0.1)
        assert router.maybe_hedge(clock()) == []

    def test_hedging_disabled_at_zero(self, pkg):
        router, clock = _router(pkg, hedge_ms=0.0)
        router.dispatch(0, 0, clock())
        clock.advance(100.0)
        assert router.maybe_hedge(clock()) == []

    def test_first_winner_cancels_loser_exactly_one_stream(self, pkg):
        registry = pkg.MetricsRegistry()
        router, clock = _router(pkg, hedge_ms=50.0, registry=registry)
        router.dispatch(7, 0, clock())
        clock.advance(0.06)
        assert router.maybe_hedge(clock()) == [(7, 1)]
        # hedge copy lands first: it wins, the primary is the loser...
        verdict, loser = router.on_complete(7, 1, clock(), ttft=0.08)
        assert (verdict, loser) == ("win", 0)
        # ...and the primary's late completion is a dropped duplicate.
        verdict, loser = router.on_complete(7, 0, clock(), ttft=0.09)
        assert (verdict, loser) == ("duplicate", None)
        snap = registry.snapshot()
        assert snap['serve_hedge_total{outcome="fired"}'] == 1
        assert snap['serve_hedge_total{outcome="hedge_win"}'] == 1
        assert snap['serve_hedge_total{outcome="duplicate"}'] == 1
        assert snap["serve_hedge_total"] == 3  # base counter sums outcomes
        # per-replica TTFT aggregation: each completion labeled by server
        assert any(k.startswith('serve_ttft_s{replica="1"}') for k in snap)

    def test_primary_win_cancels_hedge(self, pkg):
        registry = pkg.MetricsRegistry()
        router, clock = _router(pkg, hedge_ms=50.0, registry=registry)
        router.dispatch(3, 0, clock())
        clock.advance(0.06)
        router.maybe_hedge(clock())
        verdict, loser = router.on_complete(3, 0, clock())
        assert (verdict, loser) == ("win", 1)
        snap = registry.snapshot()
        assert snap['serve_hedge_total{outcome="primary_win"}'] == 1

    def test_unknown_rid_is_duplicate(self, pkg):
        router, clock = _router(pkg, registry=pkg.MetricsRegistry())
        assert router.on_complete(99, 0, clock()) == ("duplicate", None)


class TestReplicaFaultKinds:
    def test_fleet_entries_filters_to_fleet_kinds(self, pkg):
        spec = "replica_kill@step:4,serve_crash@step:2, replica_hang@step:6"
        assert pkg.fleet_entries(spec) == [
            "replica_kill@step:4", "replica_hang@step:6",
        ]
        assert pkg.fleet_entries("") == []

    def test_replica_kinds_registered_step_unit(self, pkg):
        assert pkg.FLEET_KINDS == {"replica_kill", "replica_hang", "replica_slow"}
        for kind in pkg.FLEET_KINDS:
            assert pkg.FAULT_UNITS[kind] == "step"
        pkg.FaultPlan.parse("replica_kill@step:4,replica_slow@step:2")  # parses

    def test_validate_plan_kinds_accepts_supported(self, pkg):
        pkg.validate_plan_kinds(
            "replica_kill@step:4,replica_hang@step:6", pkg.FLEET_KINDS,
            workload="serving fleet",
        )
        pkg.validate_plan_kinds("serve_crash@step:2", pkg.SERVE_KINDS,
                            workload="single-replica serving")

    def test_validate_plan_kinds_fails_loud_on_hookless_kind(self, pkg):
        with pytest.raises(ValueError, match="rank_kill.*no injection hook"):
            pkg.validate_plan_kinds("rank_kill@step:1", pkg.FLEET_KINDS,
                                workload="serving fleet")
        with pytest.raises(ValueError, match="replica_kill"):
            pkg.validate_plan_kinds("replica_kill@step:1", pkg.SERVE_KINDS,
                                workload="single-replica serving")

    def test_replica_kill_and_hang_detonate_at_step(self, pkg, monkeypatch):
        fired = []
        monkeypatch.setattr(pkg.faults, "_exit_rank",
                            lambda step: fired.append(("kill", step)))
        monkeypatch.setattr(pkg.faults, "_hang_rank",
                            lambda step: fired.append(("hang", step)))
        inj = pkg.ChaosInjector(
            pkg.FaultPlan.parse("replica_kill@step:4,replica_hang@step:6")
        )
        inj.check_replica_fault(step=3)
        assert fired == []
        inj.check_replica_fault(step=4)
        assert fired == [("kill", 4)]
        inj.check_replica_fault(step=6)
        assert fired == [("kill", 4), ("hang", 6)]

    def test_replica_slow_fires_once_then_persists(self, pkg):
        """The slowdown is a degraded replica, not a one-step blip — it
        persists after its trigger, but the fault is COUNTED exactly once
        so one supervisor-side recovery balances the books."""
        inj = pkg.ChaosInjector(pkg.FaultPlan.parse("replica_slow@step:2"),
                            stall_s=0.5)
        assert inj.check_replica_fault(step=1) == 0.0
        assert inj.check_replica_fault(step=2) == 0.5
        assert inj.check_replica_fault(step=3) == 0.5  # persists
        assert inj.counts().get("fault_injected_total") == 1
        inj.record_recovery("replica_slow")
        assert inj.balanced()


class TestServeLmChaosValidation:
    """``serve_lm --chaos`` refuses kinds with no serving hook at start-up:
    they could never fire and the books could never balance."""

    def test_rejects_pod_kind_in_single_replica_mode(self, pkg, capsys):
        rc = pkg.serve_lm.main(["--selftest", "--chaos", "rank_kill@step:1"])
        assert rc == 1
        err = capsys.readouterr().err
        assert "rank_kill" in err and "no injection hook" in err

    def test_rejects_fleet_kind_without_replicas(self, pkg, capsys):
        rc = pkg.serve_lm.main(["--selftest", "--chaos", "replica_kill@step:1"])
        assert rc == 1
        assert "replica_kill" in capsys.readouterr().err


# -- the serving hooks side by side ------------------------------------------------
@pytest.mark.parametrize("plan,steps", [
    ("serve_crash@step:3,serve_crash@step:9", range(12)),
    ("handoff_stall@step:4", range(8)),
    ("replica_slow@step:2", range(6)),
])
def test_serving_hooks_fire_at_the_same_steps(plan, steps):
    """``check_serve_crash`` / ``check_handoff_stall`` /
    ``check_replica_fault`` answer alike step by step, and the books move
    alike (a stall holds until its recovery is booked)."""
    trails = []
    for pkg in (PKGS["jax"], PKGS["torch"]):
        inj = pkg.ChaosInjector(pkg.FaultPlan.parse(plan), stall_s=0.25)
        trail = []
        for step in steps:
            try:
                inj.check_serve_crash(step=step)
                crash = None
            except pkg.faults.InjectedFault as err:
                crash = str(err)
            stall = inj.check_handoff_stall(step=step)
            if stall and step == 6:
                inj.record_recovery("handoff_stall")
            trail.append((crash, stall, inj.check_replica_fault(step=step),
                          dict(inj.counts())))
        trails.append((trail, inj.balanced(), len(inj.unrecovered())))
    assert trails[0] == trails[1]


@pytest.mark.parametrize("kind", ["supervisor_kill", "supervisor_hang"])
def test_supervisor_fault_fires_at_or_past_its_step(kind, monkeypatch):
    """``step >= at`` triggers (the completed count can jump past it), the
    journal hook runs first, then the detonation; each package alike."""
    for pkg in (PKGS["jax"], PKGS["torch"]):
        seen = []

        class Detonated(Exception):
            pass

        def kill(pid, sig):
            seen.append(("kill", sig))
            raise Detonated

        def sleep(s):
            seen.append(("sleep",))
            raise Detonated

        monkeypatch.setattr(pkg.faults.os, "kill", kill)
        monkeypatch.setattr(pkg.faults.time, "sleep", sleep)
        inj = pkg.ChaosInjector(pkg.FaultPlan.parse(f"{kind}@step:20"))
        inj.check_supervisor_fault(step=19, on_fire=lambda k: seen.append(("journal", k)))
        assert seen == []
        with pytest.raises(Detonated):
            inj.check_supervisor_fault(step=23, on_fire=lambda k: seen.append(("journal", k)))
        assert seen[0] == ("journal", kind) and seen[1][0] == (
            "kill" if kind == "supervisor_kill" else "sleep")
        assert inj.counts()["fault_injected_total"] == 1
        monkeypatch.undo()


WORKLOAD_FLAGS = {
    "single-replica serving": [],
    "disaggregated serving": ["--disagg"],
    "serving fleet": ["--replicas", "2"],
    "autoscaled serving fleet": ["--autoscale"],
}


@pytest.mark.parametrize("workload", sorted(WORKLOAD_FLAGS))
def test_serve_lm_chaos_verdicts_equal_the_reference(workload, capsys):
    """For each workload every kind gets the reference's verdict: the ones
    it refuses, both CLIs refuse at start-up naming the workload; the port
    supports exactly the rest (the supervisor kinds in none)."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import build_parser, chaos_workload

    args = build_parser().parse_args(WORKLOAD_FLAGS[workload] + ["--selftest"])
    if args.autoscale_predictive:
        args.autoscale = True
    supported, name = chaos_workload(args)
    assert name == workload
    assert not supported & port_faults.CONTROLPLANE_KINDS
    refused = sorted(set(port_faults.FAULT_UNITS) - supported)
    for kind in refused:
        argv = ["--selftest", *WORKLOAD_FLAGS[workload], "--chaos",
                f"{kind}@{port_faults.FAULT_UNITS[kind]}:1"]
        for cli in (ref_serve_lm, port_serve_lm):
            assert cli.main(argv) == 1, (cli.__name__, kind)
            err = capsys.readouterr().err
            assert kind in err and workload in err and "no injection hook" in err
    for kind in supported:
        ref_faults.validate_plan_kinds(f"{kind}@step:1", supported, workload=workload)


# -- one sequence through both routers -------------------------------------------------
OPS = st.lists(st.one_of(
    st.tuples(st.just("observe"), st.integers(0, 2), st.integers(0, 6), st.integers(0, 3),
              st.sampled_from([0.0, 0.05, 0.3])),
    st.tuples(st.just("dispatch"), st.sampled_from([None, 0.05, 0.5, 3.0]),
              st.sampled_from([None, 1, 2, 3])),
    st.tuples(st.just("advance"), st.sampled_from([0.01, 0.04, 0.2, 0.7])),
    st.tuples(st.just("hedge")),
    st.tuples(st.just("complete"), st.integers(0, 7), st.booleans()),
    st.tuples(st.just("dead"), st.integers(0, 2)),
    st.tuples(st.just("alive"), st.integers(0, 2)),
    st.tuples(st.just("exclude"), st.integers(0, 2)),
    st.tuples(st.just("include"), st.integers(0, 2)),
    st.tuples(st.just("forget"), st.integers(0, 7)),
    st.tuples(st.just("late"), st.integers(0, 7), st.integers(0, 2)),
), min_size=5, max_size=60)


def _drive(pkg, ops):
    registry = pkg.MetricsRegistry()
    router, clock = _router(pkg, n=3, hedge_ms=50.0, exclusion_s=0.3, registry=registry)
    out, next_rid, finished = [], 0, []
    for op in ops:
        kind = op[0]
        if kind == "observe":
            _, r, qd, sa, ttft = op
            router.observe(r, {"queue_depth": qd, "slots_active": sa, "ttft_p50": ttft})
        elif kind == "dispatch":
            _, budget, sig = op
            target = router.select(clock(), prefix_sig=sig)
            out.append(("select", target))
            if target is not None:
                deadline = None if budget is None else clock() + budget
                router.dispatch(next_rid, target, clock(), deadline=deadline, prefix_sig=sig)
                next_rid += 1
        elif kind == "advance":
            clock.advance(op[1])
        elif kind == "hedge":
            out.append(("hedge", router.maybe_hedge(clock())))
        elif kind == "complete":
            live = sorted(router._requests)
            if live:
                t = router._requests[live[op[1] % len(live)]]
                holder = t.hedge if (op[2] and t.hedge is not None) else t.primary
                out.append(("complete", t.rid, holder,
                            router.on_complete(t.rid, holder, clock(), ttft=0.01)))
                finished.append(t.rid)
        elif kind == "late":
            # A copy finishing after its rid was won (or forgotten): a duplicate.
            if finished:
                rid = finished[op[1] % len(finished)]
                out.append(("late", rid, router.on_complete(rid, op[2], clock())))
        elif kind == "dead":
            out.append(("dead", op[1], sorted(router.mark_dead(op[1], clock()))))
        elif kind == "alive":
            router.mark_alive(op[1], clock())
        elif kind == "exclude":
            router.exclude(op[1])
        elif kind == "include":
            router.include(op[1])
        elif kind == "forget":
            router.forget(op[1])
        out.append(("eligible", router.eligible(clock()),
                    [router.outstanding_on(r) for r in range(3)]))
    snap = {k: v for k, v in registry.snapshot().items() if k.startswith("serve_hedge_total")}
    return out, snap


@settings(max_examples=150, deadline=None)
@given(OPS)
def test_router_decisions_equal_the_reference(ops):
    assert _drive(PKGS["torch"], ops) == _drive(PKGS["jax"], ops)
