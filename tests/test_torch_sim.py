"""The port's load harness (``deeplearning_mpi_tpu_torch.sim``) against the
reference's (``deeplearning_mpi_tpu.sim``), on the same seeds and configs.

- Traces: ``generate_entries`` entries, ``write_jsonl`` bytes and
  ``trace_digest`` equal the reference's for 3 seeds of the reference
  test's config and for a flash-crowd / adversarial-tenant config.
- ``FleetSimulator(...).run(entries).summary()`` (and the curves) equal
  the reference's, dict for dict, on the reference test's configs: the
  books, the scale-up, tenant budgets, hedging, the predictive A/B arms
  and a config that climbs the brownout ladder. Each simulator runs over
  its own package's Router, Scheduler, PagedKVPool and AutoscalerPolicy,
  so the comparison holds the port's policy objects to the reference's.
- ``run_sweep``'s trials, winner and DB key equal the reference's.
- The reference's calibration case passes on the port.
- Tightened first: a router that picks the second-best replica once makes
  the summary comparison fail.

Pure host Python on a fake clock: no card, no subprocess.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu import sim as ref
from deeplearning_mpi_tpu.serving.autoscaler import AutoscalerConfig as RefAutoscalerConfig
from deeplearning_mpi_tpu_torch import sim as port
from deeplearning_mpi_tpu_torch.serving.autoscaler import AutoscalerConfig

torch.set_num_threads(1)


def _trace_cfg(pkg, **kw):
    """The reference test's ``_small_cfg`` in ``pkg``'s classes."""
    base = dict(
        duration_s=120.0, base_rps=5.0, diurnal_period_s=120.0, diurnal_amplitude=0.3,
        burst_rate_per_s=0.01,
        flash_crowds=(pkg.FlashCrowd(at_s=60.0, amplitude=5.0, ramp_s=8.0, decay_s=5.0),),
        tenants=(pkg.TenantSpec("free", share=2.0, priority=0.0),
                 pkg.TenantSpec("pro", share=1.0, priority=2.0, budget_tokens=4096)),
    )
    base.update(kw)
    return pkg.TraceConfig(**base)


def _crowd_adversary_cfg(pkg):
    """A flash crowd plus an adversarial storm tenant with tight deadlines."""
    return _trace_cfg(
        pkg, duration_s=90.0, burst_rate_per_s=0.0,
        flash_crowds=(pkg.FlashCrowd(at_s=45.0, amplitude=8.0, ramp_s=6.0, decay_s=4.0),),
        tenants=(pkg.TenantSpec("good", share=1.0, deadline_s=8.0, deadline_jitter=0.0),
                 pkg.TenantSpec("bot", share=1.0, deadline_s=8.0, deadline_jitter=0.0,
                                adversarial=True, storm_window_s=10.0, prefix_pool=3)))


def _both(fn):
    return fn(ref), fn(port)


def _to_port(cfg: "ref.SimConfig") -> "port.SimConfig":
    """A reference SimConfig as the port's (field for field)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["autoscale"] = AutoscalerConfig(**dataclasses.asdict(cfg.autoscale))
    fields["service"] = port.ServiceModel(**dataclasses.asdict(cfg.service))
    return port.SimConfig(**fields)


def _sim_cfg(**kw) -> "ref.SimConfig":
    """The reference test's ``_sim_cfg`` (reference classes)."""
    base = dict(
        initial_replicas=2, max_slots=8,
        autoscale=RefAutoscalerConfig(min_replicas=1, max_replicas=4, up_load_per_replica=4.0,
                                      down_load_per_replica=0.5, hysteresis_s=0.4,
                                      cooldown_s=1.5),
    )
    base.update(kw)
    return ref.SimConfig(**base)


@pytest.fixture(scope="module")
def entries():
    ref_e, port_e = _both(lambda pkg: pkg.to_fleet_entries(
        pkg.generate_entries(_trace_cfg(pkg), seed=0)))
    assert ref_e == port_e
    return ref_e


def _run_both(cfg: "ref.SimConfig", entries):
    a = ref.FleetSimulator(cfg).run(entries)
    b = port.FleetSimulator(_to_port(cfg)).run(entries)
    return a, b


# -- traces --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 11])
def test_trace_entries_bytes_and_digest_equal(seed, tmp_path):
    ref_e, port_e = _both(lambda pkg: pkg.generate_entries(_trace_cfg(pkg), seed=seed))
    assert ref_e == port_e and len(port_e) > 100
    assert ref.trace_digest(ref_e) == port.trace_digest(port_e)
    a = ref.write_jsonl(ref_e, tmp_path / "ref.jsonl").read_bytes()
    b = port.write_jsonl(port_e, tmp_path / "port.jsonl").read_bytes()
    assert a == b
    assert ref.to_fleet_entries(ref_e) == port.to_fleet_entries(port_e)


def test_crowd_and_adversary_trace_equal(tmp_path):
    ref_e, port_e = _both(lambda pkg: pkg.generate_entries(_crowd_adversary_cfg(pkg), seed=3))
    assert ref_e == port_e
    assert {e["tenant"] for e in port_e} == {"good", "bot"}
    assert ref.trace_digest(ref_e) == port.trace_digest(port_e)
    assert (ref.write_jsonl(ref_e, tmp_path / "a.jsonl").read_bytes()
            == port.write_jsonl(port_e, tmp_path / "b.jsonl").read_bytes())
    assert ref.tenant_policies(_crowd_adversary_cfg(ref)) == port.tenant_policies(
        _crowd_adversary_cfg(port))


# -- the simulator ---------------------------------------------------------------

SIM_CASES = {
    "books": {},
    "tenant_budgets": {"tenants": {"free": {"budget_tokens": 64, "priority": 0.0},
                                   "pro": {"budget_tokens": 0, "priority": 2.0}}},
    "hedging": {"hedge_ms": 200.0},
    "brownout": {"max_slots": 2, "max_queue": 16, "autoscale": RefAutoscalerConfig(
        min_replicas=1, max_replicas=2, up_load_per_replica=2.0, down_load_per_replica=0.25,
        hysteresis_s=0.2, cooldown_s=0.5, brownout_load_per_replica=2.5,
        brownout_hold_s=0.2, brownout_clear_s=0.5)},
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_summary_equals_reference(case, entries):
    a, b = _run_both(_sim_cfg(**SIM_CASES[case]), entries)
    assert b.summary() == a.summary()
    assert b.curves == a.curves
    assert b.ttfts == a.ttfts
    s = b.summary()
    assert b.completed + b.shed_total == b.requests == len(entries)
    if case == "books":
        assert b.scale_ups >= 1
    if case == "tenant_budgets":
        assert b.shed.get("tenant_budget", 0) > 0
    if case == "brownout":
        assert s["sim_brownout_max_stage"] >= 1


def test_metrics_emitted_through_the_port_registry(entries):
    from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry
    from deeplearning_mpi_tpu_torch.telemetry.schema import METRICS

    reg = MetricsRegistry()
    res = port.FleetSimulator(_to_port(_sim_cfg()), registry=reg).run(entries)
    assert reg.counter("sim_completed_total").value == res.completed
    assert reg.counter("sim_requests_total").value == res.requests
    assert reg.gauge("sim_slo_attainment").value == res.slo_attainment
    for name in ("sim_requests_total", "sim_completed_total", "sim_shed_total",
                 "sim_slo_ok_total", "sim_replica_seconds", "sim_slo_attainment",
                 "sim_hedge_fired_total", "sim_brownout_max_stage"):
        assert name in res.summary() and name in METRICS


def test_predictive_ab_equals_reference():
    """The reference's A/B: same trace, same fleet, only ``predictive``
    differs; both arms equal the reference's, and the forecast arm wins."""
    def trace(pkg):
        return pkg.to_fleet_entries(pkg.generate_entries(pkg.TraceConfig(
            duration_s=180.0, base_rps=6.0, diurnal_period_s=180.0, diurnal_amplitude=0.3,
            burst_rate_per_s=0.0,
            flash_crowds=(pkg.FlashCrowd(at_s=108.0, amplitude=6.0, ramp_s=12.0, decay_s=8.0),),
            tenants=(pkg.TenantSpec("default", output_mean=32, deadline_s=10.0),)), seed=0))

    ref_e, port_e = _both(trace)
    assert ref_e == port_e
    arms = {}
    for predictive in (False, True):
        cfg = ref.SimConfig(
            initial_replicas=3, max_slots=4, service=ref.ServiceModel(tpot_s=0.05),
            autoscale=RefAutoscalerConfig(
                min_replicas=2, max_replicas=8, up_load_per_replica=6.0,
                down_load_per_replica=1.0, hysteresis_s=0.4, cooldown_s=2.0,
                predictive=predictive, forecast_horizon_s=3.0, forecast_tau_s=1.0,
                forecast_trend_tau_s=2.0))
        a, b = _run_both(cfg, ref_e)
        assert b.summary() == a.summary()
        arms[predictive] = b
    assert arms[True].slo_ok > arms[False].slo_ok
    assert arms[True].up_times[0] <= arms[False].up_times[0]


def test_sweep_winner_and_key_equal_reference(entries, tmp_path):
    from deeplearning_mpi_tpu.compiler.autotune import TuningDB as RefDB
    from deeplearning_mpi_tpu_torch.compiler.autotune import TuningDB

    short = ref.to_fleet_entries(ref.generate_entries(_trace_cfg(ref, duration_s=60.0), seed=0))
    grid = [{}, {"hysteresis_s": 0.2}, {"predictive": True, "forecast_horizon_s": 2.0},
            {"hedge_ms": 400.0}]
    key = port.trace_digest(short)
    assert key == ref.trace_digest(short)
    a = ref.run_sweep(short, _sim_cfg(), grid, trace_key=key, db=tmp_path / "ref.json")
    b = port.run_sweep(short, _to_port(_sim_cfg()), grid, trace_key=key,
                       db=tmp_path / "port.json")
    assert b.trials == a.trials
    assert (b.key, b.winner, b.winner_score, b.baseline_score) == (
        a.key, a.winner, a.winner_score, a.baseline_score)
    assert b.summary() == a.summary()
    assert TuningDB.load(tmp_path / "port.json").lookup_key(b.key) == b.winner
    assert (TuningDB.load(tmp_path / "port.json").entries[b.key]
            == RefDB.load(tmp_path / "ref.json").entries[a.key])


def test_apply_params_routes_and_refuses():
    base = _to_port(_sim_cfg())
    out = port.apply_params(base, {"hysteresis_s": 0.9, "hedge_ms": 50.0,
                                   "decode_buckets": [2, 4]})
    assert (out.autoscale.hysteresis_s, out.hedge_ms, out.decode_buckets) == (0.9, 50.0, (2, 4))
    assert base.autoscale.hysteresis_s == 0.4
    with pytest.raises(ValueError, match="unknown sweep parameter"):
        port.apply_params(base, {"no_such_knob": 1})
    assert port.default_grid() == ref.default_grid()


def test_calibrated_sim_matches_measured_surge_drill():
    """The reference's calibration case (``tests/test_sim.py``) on the port:
    the surge trace (32-deep burst + 20-trickle, max_new 12) through a
    ServiceModel calibrated from its drill's telemetry lands in the same
    regime: 0 sheds, every request completed, a scale-up, TTFT p50 in the
    band around the measured burst p50 (~10.5 s)."""
    rng = np.random.default_rng(7)
    entries = []
    for i in range(52):
        n_prompt = int(rng.integers(3, 21))
        entries.append({"arrival": 0.0 if i < 32 else (i - 32 + 1) * 0.8,
                        "prompt": [int(t) for t in rng.integers(1, 256, size=n_prompt)],
                        "max_new": 12})
    service = port.ServiceModel.from_telemetry(ttft_p50_s=0.078, tpot_p50_s=0.05,
                                               mean_prompt_len=12, warmup_s=8.0)
    cfg = port.SimConfig(
        initial_replicas=1, max_slots=3, max_queue=64, kv_blocks=32, kv_block_size=8,
        service=service, slo_ttft_s=30.0,
        autoscale=AutoscalerConfig(min_replicas=1, max_replicas=3, up_load_per_replica=3.0,
                                   down_load_per_replica=0.25, hysteresis_s=0.2,
                                   cooldown_s=0.8))
    res = port.FleetSimulator(cfg).run(entries)
    assert res.shed_total == 0, res.shed
    assert res.completed == 52
    assert res.scale_ups >= 1
    assert 1.5 < res.ttft_quantile(0.5) < 21.0, res.ttft_quantile(0.5)
    assert res.ttft_quantile(0.95) < 25.0, res.ttfts
    assert port.ServiceModel.from_telemetry(
        ttft_p50_s=0.08, tpot_p50_s=0.02, mean_prompt_len=40).ttft_s(
        40, active=1, max_slots=8, prefix_hit=False) == pytest.approx(0.08, rel=0.01)


def test_a_router_that_picks_second_best_once_is_caught(entries, monkeypatch):
    """The bar rejects the wrong copy it is meant to catch: the port's
    Router choosing the second-best replica on one dispatch changes the
    summary (or the curves), so the reference comparison fails."""
    from deeplearning_mpi_tpu_torch.serving.router import Router

    select = Router.select
    state = {"calls": 0, "wrong": 0}

    def second_best(self, now, *, prefix_sig=None, **kw):
        best = select(self, now, prefix_sig=prefix_sig, **kw)
        state["calls"] += 1
        if state["calls"] >= 40 and not state["wrong"] and best is not None:
            others = sorted((r for r in self.eligible(now) if r != best),
                            key=lambda r: self.score(r, prefix_sig=prefix_sig))
            if others:
                state["wrong"] += 1
                return others[0]
        return best

    monkeypatch.setattr(Router, "select", second_best)
    a, b = _run_both(_sim_cfg(), entries)
    assert state["wrong"] == 1
    assert (b.summary(), b.curves, b.ttfts) != (a.summary(), a.curves, a.ttfts)
