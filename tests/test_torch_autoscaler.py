"""The port's autoscaler policy against the reference's.

Each of the reference's autoscaler, retire-routing and scheduler-brownout
tests (``tests/test_autoscaler.py``) runs on both packages' copies
(``pkg``) under fake clocks. Then one seeded sequence of load signals
drives both policies side by side, reactive and predictive: every scale
decision and veto, brownout stage and forecast is equal, the forecasts
exactly (float64). ``build_load_signal`` folds the same replica views alike.
"""

import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning_mpi_tpu.resilience import faults as ref_faults
from deeplearning_mpi_tpu.serving import autoscaler as ref_autoscaler
from deeplearning_mpi_tpu.serving import kv_pool as ref_kv_pool
from deeplearning_mpi_tpu.serving import router as ref_router
from deeplearning_mpi_tpu.serving import scheduler as ref_scheduler
from deeplearning_mpi_tpu.telemetry import registry as ref_registry
from deeplearning_mpi_tpu_torch.resilience import faults as port_faults
from deeplearning_mpi_tpu_torch.serving import autoscaler as port_autoscaler
from deeplearning_mpi_tpu_torch.serving import kv_pool as port_kv_pool
from deeplearning_mpi_tpu_torch.serving import router as port_router
from deeplearning_mpi_tpu_torch.serving import scheduler as port_scheduler
from deeplearning_mpi_tpu_torch.telemetry import registry as port_registry


def _ns(autoscaler, faults, router, scheduler, kv_pool, registry):
    return types.SimpleNamespace(
        AutoscalerConfig=autoscaler.AutoscalerConfig,
        AutoscalerPolicy=autoscaler.AutoscalerPolicy, LoadSignal=autoscaler.LoadSignal,
        LoadForecaster=autoscaler.LoadForecaster, ReplicaView=autoscaler.ReplicaView,
        build_load_signal=autoscaler.build_load_signal,
        AUTOSCALE_KINDS=faults.AUTOSCALE_KINDS, FLEET_KINDS=faults.FLEET_KINDS,
        FAULT_UNITS=faults.FAULT_UNITS, Router=router.Router, Scheduler=scheduler.Scheduler,
        Request=scheduler.Request, PagedKVPool=kv_pool.PagedKVPool,
        MetricsRegistry=registry.MetricsRegistry, labeled=registry.labeled)


PKGS = {
    "jax": _ns(ref_autoscaler, ref_faults, ref_router, ref_scheduler, ref_kv_pool, ref_registry),
    "torch": _ns(port_autoscaler, port_faults, port_router, port_scheduler, port_kv_pool,
                 port_registry),
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


def _cfg(pkg, **kw):
    base = dict(
        min_replicas=1,
        max_replicas=4,
        up_load_per_replica=3.0,
        down_load_per_replica=0.25,
        hysteresis_s=1.0,
        cooldown_s=5.0,
        brownout_load_per_replica=6.0,
        brownout_hold_s=1.0,
        brownout_clear_s=2.0,
    )
    base.update(kw)
    return pkg.AutoscalerConfig(**base)


def _sig(pkg, load, *, ready=2, total=None, warming=0, backlog=None):
    """pkg.LoadSignal with load_per_replica == ``load`` (expressed entirely
    as worker queue depth unless ``backlog`` is forced)."""
    qd = int(load * ready) if backlog is None else 0
    return pkg.LoadSignal(
        backlog=backlog or 0,
        queue_depth=qd,
        ready=ready,
        warming=warming,
        total=total if total is not None else ready + warming,
    )


class TestConfigValidation:
    def test_rejects_zero_floor(self, pkg):
        with pytest.raises(ValueError):
            _cfg(pkg, min_replicas=0)

    def test_rejects_ceiling_below_floor(self, pkg):
        with pytest.raises(ValueError):
            _cfg(pkg, min_replicas=3, max_replicas=2)

    def test_rejects_inverted_thresholds(self, pkg):
        with pytest.raises(ValueError):
            _cfg(pkg, down_load_per_replica=3.0, up_load_per_replica=3.0)


class TestHysteresis:
    def test_one_hot_tick_is_not_a_trend(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        assert p.decide(0.0, _sig(pkg, 10.0)) is None  # arms
        assert p.decide(0.5, _sig(pkg, 10.0)) is None  # still inside the window

    def test_sustained_signal_fires_after_window(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        p.decide(0.0, _sig(pkg, 10.0))
        assert p.decide(1.0, _sig(pkg, 10.0)) == ("up", "ok")

    def test_signal_dropout_rearms_from_scratch(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        p.decide(0.0, _sig(pkg, 10.0))
        p.decide(0.9, _sig(pkg, 0.5))  # dipped below: window resets
        assert p.decide(1.0, _sig(pkg, 10.0)) is None  # re-armed at t=1.0
        assert p.decide(1.9, _sig(pkg, 10.0)) is None
        assert p.decide(2.0, _sig(pkg, 10.0)) == ("up", "ok")

    def test_decision_rearms_the_window(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, cooldown_s=0.0))
        p.decide(0.0, _sig(pkg, 10.0))
        assert p.decide(1.0, _sig(pkg, 10.0)) == ("up", "ok")
        # Even with no cooldown, the very next tick must re-persist.
        assert p.decide(1.01, _sig(pkg, 10.0)) is None
        assert p.decide(2.5, _sig(pkg, 10.0)) == ("up", "ok")


class TestCooldown:
    def test_cooldown_after_scale_event(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        p.decide(0.0, _sig(pkg, 10.0))
        assert p.decide(1.0, _sig(pkg, 10.0)) == ("up", "ok")
        p.note_scale_event(1.0)
        # Armed again at 1.01, window met at 2.01 — but cooldown runs to
        # 6.0 and delays the DECISION, not the measurement.
        for t in (1.01, 2.01, 5.9):
            assert p.decide(t, _sig(pkg, 10.0)) is None
        assert p.decide(6.0, _sig(pkg, 10.0)) == ("up", "ok")

    def test_failover_respawn_holds_scaling(self, pkg):
        """A chaos kill already changes capacity — the supervisor's
        failure handler must be able to pause the autoscaler so the two
        loops don't fight."""
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        p.decide(0.0, _sig(pkg, 10.0))
        p.note_respawn(0.5)  # cooldown until 5.5
        assert p.decide(1.0, _sig(pkg, 10.0)) is None
        assert p.decide(5.4, _sig(pkg, 10.0)) is None
        assert p.decide(5.5, _sig(pkg, 10.0)) == ("up", "ok")

    def test_standing_veto_is_recorded_once_per_cooldown(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        p.decide(0.0, _sig(pkg, 10.0, ready=4, total=4))
        assert p.decide(1.0, _sig(pkg, 10.0, ready=4, total=4)) == (
            "up", "vetoed:max_replicas",
        )
        # The veto started a cooldown: no per-tick veto spam.
        assert p.decide(1.01, _sig(pkg, 10.0, ready=4, total=4)) is None
        assert p.decide(5.9, _sig(pkg, 10.0, ready=4, total=4)) is None
        assert p.decide(7.0, _sig(pkg, 10.0, ready=4, total=4)) == (
            "up", "vetoed:max_replicas",
        )


class TestClamps:
    def test_up_vetoed_at_ceiling_counts_warming_spawns(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, max_replicas=3))
        p.decide(0.0, _sig(pkg, 10.0, ready=3, total=3))
        assert p.decide(1.0, _sig(pkg, 10.0, ready=3, total=3)) == (
            "up", "vetoed:max_replicas",
        )

    def test_down_vetoed_at_floor(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, min_replicas=2))
        p.decide(0.0, _sig(pkg, 0.0, ready=2, total=2))
        assert p.decide(1.0, _sig(pkg, 0.0, ready=2, total=2)) == (
            "down", "vetoed:min_replicas",
        )

    def test_down_vetoed_against_ready_when_a_replica_is_dead(self, pkg):
        """total=3 sits above the floor, but only 2 are actually serving:
        retiring one more could race a concurrent death to zero."""
        p = pkg.AutoscalerPolicy(_cfg(pkg, min_replicas=2))
        sig = pkg.LoadSignal(backlog=0, queue_depth=0, ready=2, warming=1,
                         total=3)
        p.decide(0.0, sig)
        assert p.decide(1.0, sig) == ("down", "vetoed:min_replicas")

    def test_down_requires_empty_backlog(self, pkg):
        """Supervisor-side backlog is work no replica holds yet — load
        may read near zero while it exists, but retiring then would
        shrink the fleet into known pending work."""
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        sig = _sig(pkg, 0.0, ready=8, backlog=1)
        for t in (0.0, 1.0, 2.0, 3.0):
            assert p.decide(t, sig) is None

    def test_warming_capacity_holds_up_decisions_without_veto(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        hot_warming = _sig(pkg, 10.0, ready=2, warming=1)
        p.decide(0.0, hot_warming)
        # Window elapsed, but a spawn is mid-warmup: hold (no veto, no
        # re-arm) — load divides by ready only, so firing again would
        # double-count the same overload.
        assert p.decide(1.0, hot_warming) is None
        assert p.decide(2.0, hot_warming) is None
        # The instant the spawn reaches ready, the held signal fires.
        assert p.decide(2.1, _sig(pkg, 10.0, ready=3)) == ("up", "ok")


class TestPickRetire:
    def test_coldest_prefix_ledger_wins(self, pkg):
        assert pkg.AutoscalerPolicy.pick_retire(
            {0: (5, 0), 1: (0, 9), 2: (3, 0)}
        ) == 1

    def test_ties_break_on_outstanding_then_id(self, pkg):
        assert pkg.AutoscalerPolicy.pick_retire(
            {0: (2, 4), 1: (2, 1), 2: (2, 4)}
        ) == 1
        assert pkg.AutoscalerPolicy.pick_retire(
            {2: (2, 4), 0: (2, 4)}
        ) == 0

    def test_no_candidates_raises(self, pkg):
        with pytest.raises(ValueError):
            pkg.AutoscalerPolicy.pick_retire({})


class TestBrownoutLadder:
    def _pinned(self, pkg, load=10.0, warming=0):
        return _sig(pkg, load, ready=4, warming=warming,
                    total=4 + warming)

    def test_climbs_one_rung_per_hold_period(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        assert p.brownout(0.0, self._pinned(pkg, )) == 0
        assert p.brownout(0.5, self._pinned(pkg, )) == 0
        assert p.brownout(1.0, self._pinned(pkg, )) == 1
        assert p.brownout(1.5, self._pinned(pkg, )) == 1  # each rung re-holds
        assert p.brownout(2.0, self._pinned(pkg, )) == 2
        assert p.brownout(3.0, self._pinned(pkg, )) == 3
        assert p.brownout(9.0, self._pinned(pkg, )) == 3  # ladder tops out

    def test_only_saturation_at_the_ceiling_escalates(self, pkg):
        """If the fleet can still scale up, scaling is the answer, not
        degradation."""
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        roomy = _sig(pkg, 10.0, ready=2, total=2)  # below max_replicas=4
        for t in (0.0, 1.0, 2.0, 5.0):
            assert p.brownout(t, roomy) == 0

    def test_warming_capacity_blocks_escalation(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, max_replicas=4))
        for t in (0.0, 1.0, 2.0):
            assert p.brownout(t, self._pinned(pkg, warming=1)) == 0

    def test_clears_only_after_sustained_calm(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        p.brownout(0.0, self._pinned(pkg, ))
        assert p.brownout(1.0, self._pinned(pkg, )) == 1
        calm = self._pinned(pkg, load=0.0)
        assert p.brownout(1.5, calm) == 1  # calm begins
        assert p.brownout(3.0, calm) == 1  # 1.5s calm < clear_s=2.0
        assert p.brownout(3.5, calm) == 0  # 2.0s calm: cleared

    def test_calm_interrupted_restarts_the_clear_clock(self, pkg):
        p = pkg.AutoscalerPolicy(_cfg(pkg, ))
        p.brownout(0.0, self._pinned(pkg, ))
        assert p.brownout(1.0, self._pinned(pkg, )) == 1
        p.brownout(1.5, self._pinned(pkg, load=0.0))
        p.brownout(2.5, self._pinned(pkg, ))  # hot again: calm resets
        assert p.brownout(3.6, self._pinned(pkg, load=0.0)) == 1
        assert p.brownout(5.5, self._pinned(pkg, load=0.0)) == 1
        assert p.brownout(5.7, self._pinned(pkg, load=0.0)) == 0


class TestRouterRetire:
    def _router(self, pkg, n=2):
        clock = FakeClock()
        return pkg.Router(range(n), clock=clock), clock

    def test_mark_retired_returns_outstanding_for_drain(self, pkg):
        router, _ = self._router(pkg)
        router.dispatch(7, 0)
        router.dispatch(8, 1)
        assert router.mark_retired(0) == [7]
        assert router.outstanding_on(0) == [7]  # still draining

    def test_retired_replica_leaves_eligibility_and_stays_out(self, pkg):
        router, _ = self._router(pkg)
        router.mark_retired(0)
        assert router.eligible() == [1]
        # include() (the ready-ack path) must NOT resurrect a retiring
        # replica — only remove_replica ends the retirement.
        router.include(0)
        assert router.eligible() == [1]

    def test_mark_retired_clears_prefix_ledger(self, pkg):
        """A drained replica's radix cache is about to be freed — leaving
        its prefix signatures in the affinity ledger would steer requests
        at a replica mid-drain."""
        router, _ = self._router(pkg)
        router.dispatch(1, 0, prefix_sig=0xBEEF)
        router.on_complete(1, 0, ttft=0.01)
        assert router.prefix_ledger_size(0) == 1
        # Affinity currently steers sig 0xBEEF to replica 0.
        assert router.select(prefix_sig=0xBEEF) == 0
        router.mark_retired(0)
        assert router.prefix_ledger_size(0) == 0
        assert router.select(prefix_sig=0xBEEF) == 1

    def test_add_replica_joins_cold_and_excluded_callers_gate_ready(self, pkg):
        router, _ = self._router(pkg)
        router.add_replica(2)
        router.exclude(2)  # supervisor excludes until ready-ack
        assert router.eligible() == [0, 1]
        router.include(2)
        assert router.eligible() == [0, 1, 2]

    def test_add_replica_rejects_duplicate_ids(self, pkg):
        router, _ = self._router(pkg)
        with pytest.raises(ValueError):
            router.add_replica(1)

    def test_remove_replica_completes_the_retirement(self, pkg):
        router, _ = self._router(pkg)
        router.mark_retired(0)
        router.remove_replica(0)
        assert router.eligible() == [1]
        router.add_replica(2)
        assert router.eligible() == [1, 2]


def _req(pkg, rid, prompt_len=4, max_new=4, arrival=0.0, deadline=None,
         tenant="default"):
    import numpy as np

    return pkg.Request(
        rid=rid,
        prompt=np.arange(1, prompt_len + 1, dtype=np.int32),
        max_new_tokens=max_new,
        arrival=arrival,
        deadline=deadline,
        tenant=tenant,
    )


class TestSchedulerBrownout:
    def _sched(self, pkg, tenants=None, **kw):
        pool = pkg.PagedKVPool(16, 4)
        return pkg.Scheduler(pool, max_slots=2, max_seq_len=32, max_queue=64,
                         tenants=tenants, **kw)

    TIERS = {
        "gold": {"budget_tokens": 0, "priority": 1.0},
        "free": {"budget_tokens": 0, "priority": 0.0},
    }

    def test_stage1_sheds_only_below_top_priority(self, pkg):
        sched = self._sched(pkg, tenants=self.TIERS)
        sched.set_brownout(1)
        free = _req(pkg, 0, tenant="free")
        assert not sched.submit(free)
        assert free.shed_reason == "brownout"
        gold = _req(pkg, 1, tenant="gold")
        assert sched.submit(gold)

    def test_stage1_sheds_unconfigured_tenants_below_a_paying_tier(self, pkg):
        sched = self._sched(pkg, tenants=self.TIERS)
        sched.set_brownout(1)
        anon = _req(pkg, 0, tenant="default")  # unconfigured => priority 0
        assert not sched.submit(anon)
        assert anon.shed_reason == "brownout"

    def test_stage1_is_inert_without_priority_tiers(self, pkg):
        """No tenants configured => there is no 'lowest tier' to
        sacrifice; brownout must not turn into shed-everything (stages
        2-3 still act via the draft kill-switch and deadline floor)."""
        sched = self._sched(pkg, tenants=None)
        sched.set_brownout(3)
        assert sched.submit(_req(pkg, 0))

    def test_stage1_is_inert_when_all_tiers_are_equal(self, pkg):
        sched = self._sched(pkg, tenants={
            "a": {"priority": 0.5}, "b": {"priority": 0.5},
        })
        sched.set_brownout(1)
        assert sched.submit(_req(pkg, 0, tenant="a"))
        assert sched.submit(_req(pkg, 1, tenant="b"))

    def test_stage3_raises_the_deadline_floor_for_everyone(self, pkg):
        sched = self._sched(pkg, tenants=self.TIERS,
                            brownout_min_deadline_s=0.25)
        sched.set_brownout(3)
        tight = _req(pkg, 0, arrival=0.0, deadline=0.1, tenant="gold")
        assert not sched.submit(tight)
        assert tight.shed_reason == "brownout"
        roomy = _req(pkg, 1, arrival=0.0, deadline=1.0, tenant="gold")
        assert sched.submit(roomy)

    def test_stage1_does_not_apply_the_deadline_floor(self, pkg):
        sched = self._sched(pkg, tenants=self.TIERS,
                            brownout_min_deadline_s=0.25)
        sched.set_brownout(1)
        tight = _req(pkg, 0, arrival=0.0, deadline=0.1, tenant="gold")
        assert sched.submit(tight)

    def test_per_tenant_shed_counters(self, pkg):
        registry = pkg.MetricsRegistry()
        labeled = pkg.labeled
        sched = self._sched(pkg, tenants=self.TIERS, registry=registry)
        sched.set_brownout(1)
        for rid in range(3):
            sched.submit(_req(pkg, rid, tenant="free"))
        sched.submit(_req(pkg, 3, tenant="gold"))
        snap = registry.snapshot()
        assert snap[labeled("serve_tenant_shed_total", tenant="free")] == 3
        assert labeled(
            "serve_tenant_shed_total", tenant="gold"
        ) not in snap

    def test_clearing_brownout_reopens_the_door(self, pkg):
        sched = self._sched(pkg, tenants=self.TIERS)
        sched.set_brownout(1)
        assert not sched.submit(_req(pkg, 0, tenant="free"))
        sched.set_brownout(0)
        assert sched.submit(_req(pkg, 1, tenant="free"))


class TestAutoscaleFaultKinds:
    def test_kinds_registered_with_step_unit(self, pkg):
        assert pkg.AUTOSCALE_KINDS == {"load_spike", "scale_during_failure"}
        for kind in pkg.AUTOSCALE_KINDS:
            assert pkg.FAULT_UNITS[kind] == "step"

    def test_disjoint_from_fleet_kinds(self, pkg):
        """pkg.AUTOSCALE_KINDS detonate in the supervisor itself;
        ``fleet_entries`` filters per-replica chaos to pkg.FLEET_KINDS, so
        the sets must stay disjoint or a spec would detonate twice."""
        assert not (pkg.AUTOSCALE_KINDS & pkg.FLEET_KINDS)


# -- one signal sequence through both policies -----------------------------------------
SIGNALS = st.lists(st.tuples(
    st.sampled_from([0.02, 0.1, 0.3, 0.7, 1.5]),  # dt
    st.integers(0, 40),   # queue depth
    st.integers(0, 6),    # backlog
    st.integers(1, 4),    # ready
    st.integers(0, 1),    # warming
    st.booleans(),        # a scale event noted after this tick
    st.booleans(),        # a failover respawn noted after this tick
), min_size=3, max_size=80)


def _policy_trail(pkg, ticks, predictive, seasonal):
    cfg = pkg.AutoscalerConfig(
        min_replicas=1, max_replicas=4, up_load_per_replica=3.0, down_load_per_replica=0.25,
        hysteresis_s=0.3, cooldown_s=0.8, brownout_load_per_replica=6.0, brownout_hold_s=0.4,
        brownout_clear_s=1.0, predictive=predictive, forecast_horizon_s=1.5,
        forecast_tau_s=0.5, forecast_trend_tau_s=0.7,
        forecast_seasonal_period_s=4.0 if seasonal else 0.0)
    policy = pkg.AutoscalerPolicy(cfg)
    now, trail = 0.0, []
    for dt, qd, backlog, ready, warming, scaled, respawned in ticks:
        now += dt
        sig = pkg.LoadSignal(backlog=backlog, queue_depth=qd, ready=ready, warming=warming,
                             total=ready + warming)
        trail.append((policy.decide(now, sig), policy.brownout(now, sig),
                      policy.last_forecast, policy.in_cooldown(now)))
        if scaled:
            policy.note_scale_event(now)
        if respawned:
            policy.note_respawn(now)
    return trail


@settings(max_examples=120, deadline=None)
@given(SIGNALS, st.booleans(), st.booleans())
def test_policy_decisions_equal_the_reference(ticks, predictive, seasonal):
    assert (_policy_trail(PKGS["torch"], ticks, predictive, seasonal)
            == _policy_trail(PKGS["jax"], ticks, predictive, seasonal))


@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(st.sampled_from([0.01, 0.1, 0.5, 2.0]),
                          st.floats(0.0, 50.0, allow_nan=False)), min_size=1, max_size=60),
       st.sampled_from([0.0, 3.0]))
def test_forecasts_equal_the_reference_exactly(points, period):
    outs = []
    for pkg in (PKGS["jax"], PKGS["torch"]):
        f = pkg.LoadForecaster(tau_s=0.5, trend_tau_s=0.8, seasonal_period_s=period)
        now, out = 0.0, []
        for dt, value in points:
            now += dt
            f.observe(now, value)
            out.append((f.forecast(now, 1.0), f.forecast(now, 3.0)))
        outs.append(out)
    assert outs[0] == outs[1]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.booleans(), st.booleans(), st.integers(0, 9),
                          st.integers(0, 5), st.sampled_from([0.0, 0.05, 0.4])),
                min_size=1, max_size=5),
       st.integers(0, 12), st.integers(0, 3), st.integers(0, 200))
def test_load_signal_equals_the_reference(views, backlog, shed, tokens):
    sigs = []
    for pkg in (PKGS["jax"], PKGS["torch"]):
        sig = pkg.build_load_signal(
            (pkg.ReplicaView(idx=i, ready=r, alive=a, retiring=t, queue_depth=q,
                             outstanding=o, ttft_p50=ttft)
             for i, (r, a, t, q, o, ttft) in enumerate(views)),
            backlog=backlog, slots_cap=3, shed_total=shed, tokens_in_flight=tokens)
        sigs.append((vars(sig), sig.load_per_replica))
    assert sigs[0] == sigs[1]
