"""Simulator drill: the load harness's acceptance gate, over the port.

    python -m deeplearning_mpi_tpu_torch.cli.sim_drill --phase scale --root /tmp/sim
    python -m deeplearning_mpi_tpu_torch.cli.sim_drill --phase all --device cpu --root /tmp/sim

Port of the reference's ``tools/sim_drill.py``. Phases:

- ``scale``: a >=100k-request multi-tenant day (diurnal cycle, Poisson
  bursts, a flash crowd, an adversarial tenant) through
  ``sim.FleetSimulator`` over the port's real policy objects under the fake
  clock, in under 60 s of wall time, with books that add up (completed +
  shed == requests), the same trace digest from the same seed, and the
  same summary from two runs.
- ``sweep``: a deterministic policy-parameter search, scored on
  SLO-attained completions per replica-second; the winner is recorded in,
  and read back from, the port's tuning DB under its
  ``simpolicy|<digest>|band:..`` key.
- ``predictive``: real processes. The port's ``FleetSupervisor`` with
  ``AutoscalerConfig(predictive=True)`` replays a generated flash-crowd
  trace; the forecaster must fire the first scale-up before the crowd's
  peak, with zero dropped requests and reconciled scale books. Workers run
  on ``--device`` (the card by default).
- ``all`` runs the three, then merges the scale and sweep summaries into one
  ``sim_summary`` record through the port's telemetry registry and renders
  it with ``tools/metrics_report.py``.

Exits 0 iff every phase run passed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

MODEL_SPEC = {"vocab_size": 256, "num_layers": 2, "num_heads": 2, "num_kv_heads": None,
              "head_dim": 16, "d_model": 64, "d_ff": 128, "attention_window": 0}
ENGINE_SPEC = {"max_slots": 3, "block_size": 8, "num_blocks": 32, "max_blocks_per_seq": 6,
               "prefill_chunk": 8, "max_queue": 64}
SEED = 0


def _day_trace_config():
    """The scale-phase workload: a compressed 30-minute 'day' at 60 rps
    base (>=100k requests in expectation) with every regime on."""
    from deeplearning_mpi_tpu_torch.sim import FlashCrowd, TenantSpec, TraceConfig

    return TraceConfig(
        duration_s=1800.0, base_rps=60.0, diurnal_period_s=1800.0, diurnal_amplitude=0.4,
        burst_rate_per_s=0.004,
        flash_crowds=(FlashCrowd(at_s=900.0, amplitude=4.0, ramp_s=20.0, decay_s=15.0),),
        tenants=(TenantSpec("free", share=3.0, priority=0.0),
                 TenantSpec("pro", share=1.0, priority=2.0),
                 TenantSpec("bot", share=0.3, adversarial=True, storm_window_s=30.0)),
    )


def run_scale(root: Path) -> None:
    """>=100k requests simulated in <60 s, deterministic, books balanced,
    the trace round-tripping through the serve_lm JSONL schema."""
    from deeplearning_mpi_tpu_torch.serving.autoscaler import AutoscalerConfig
    from deeplearning_mpi_tpu_torch.sim import (
        FleetSimulator,
        SimConfig,
        generate_entries,
        tenant_policies,
        to_fleet_entries,
        trace_digest,
        write_jsonl,
    )

    cfg = _day_trace_config()
    t0 = time.monotonic()
    entries = generate_entries(cfg, seed=SEED)
    gen_wall = time.monotonic() - t0
    digest = trace_digest(entries)
    assert len(entries) >= 100_000, f"scale trace too small: {len(entries)} < 100000"
    assert trace_digest(generate_entries(cfg, seed=SEED)) == digest, (
        "trace generation is not deterministic for a fixed seed")
    root.mkdir(parents=True, exist_ok=True)
    path = write_jsonl(entries[:2000], root / "trace_head.jsonl")
    back = [json.loads(line) for line in path.read_text().splitlines()]
    assert back == entries[:2000], "JSONL round-trip diverged"

    sim_cfg = SimConfig(
        initial_replicas=4, max_slots=16, kv_blocks=4096,
        autoscale=AutoscalerConfig(min_replicas=2, max_replicas=12, up_load_per_replica=8.0,
                                   down_load_per_replica=1.0, hysteresis_s=0.5, cooldown_s=2.0),
        tenants=tenant_policies(cfg), curve_window_s=120.0,
    )
    fleet_entries = to_fleet_entries(entries)
    t0 = time.monotonic()
    res = FleetSimulator(sim_cfg).run(fleet_entries)
    wall = time.monotonic() - t0
    assert wall < 60.0, f"simulation took {wall:.1f}s (budget 60s)"
    assert res.completed + res.shed_total == res.requests, (
        res.completed, res.shed_total, res.requests)
    assert res.curves, "no SLO/utilization curves emitted"
    assert res.shed.get("cancelled", 0) == 0, f"hedge-free run recorded cancels: {res.shed}"
    res2 = FleetSimulator(sim_cfg).run(fleet_entries)
    assert res.summary() == res2.summary(), "simulator is not deterministic for a fixed trace"

    summary = dict(res.summary())
    summary["sim_wall_seconds"] = round(wall, 2)
    summary["sim_trace_digest"] = digest
    (root / "sim_scale_summary.json").write_text(json.dumps(summary, indent=2, sort_keys=True))
    print(f"sim-drill OK (scale): {res.requests} requests ({gen_wall:.1f}s gen, digest "
          f"{digest}) simulated in {wall:.1f}s ({int(res.requests / wall)}/s), "
          f"slo={res.slo_attainment:.4f}, shed={res.shed_total}, ups={res.scale_ups} "
          f"downs={res.scale_downs}, deterministic twice")


def run_sweep_phase(root: Path) -> None:
    """A deterministic parameter sweep on a smaller trace; the winner beats
    or ties the baseline and lands in the tuning DB."""
    from deeplearning_mpi_tpu_torch.compiler.autotune import TuningDB
    from deeplearning_mpi_tpu_torch.serving.autoscaler import AutoscalerConfig
    from deeplearning_mpi_tpu_torch.sim import (
        FlashCrowd,
        SimConfig,
        TenantSpec,
        TraceConfig,
        generate_entries,
        run_sweep,
        tenant_policies,
        to_fleet_entries,
        trace_digest,
    )

    cfg = TraceConfig(
        duration_s=240.0, base_rps=10.0, diurnal_period_s=240.0, diurnal_amplitude=0.3,
        burst_rate_per_s=0.01,
        flash_crowds=(FlashCrowd(at_s=120.0, amplitude=6.0, ramp_s=10.0, decay_s=6.0),),
        tenants=(TenantSpec("free", share=3.0, priority=0.0),
                 TenantSpec("pro", share=1.0, priority=2.0)),
    )
    entries = to_fleet_entries(generate_entries(cfg, seed=SEED))
    digest = trace_digest(entries)
    base = SimConfig(
        initial_replicas=2, max_slots=8,
        autoscale=AutoscalerConfig(min_replicas=1, max_replicas=6, up_load_per_replica=4.0,
                                   down_load_per_replica=0.5, hysteresis_s=0.4, cooldown_s=1.5),
        tenants=tenant_policies(cfg),
    )
    grid = [
        {},  # baseline: defaults unchanged
        {"hysteresis_s": 0.2, "cooldown_s": 1.0},
        {"predictive": True, "forecast_horizon_s": 3.0, "forecast_tau_s": 1.0,
         "forecast_trend_tau_s": 2.0},
        {"hedge_ms": 400.0},
    ]
    root.mkdir(parents=True, exist_ok=True)
    db_path = root / "sim_tuning.json"
    t0 = time.monotonic()
    sweep = run_sweep(entries, base, grid, trace_key=digest, db=db_path)
    wall = time.monotonic() - t0
    assert len(sweep.trials) == len(grid), sweep.trials
    assert sweep.baseline_score is not None
    assert sweep.winner_score >= sweep.baseline_score, (sweep.winner_score, sweep.baseline_score)
    sweep2 = run_sweep(entries, base, grid, trace_key=digest)
    assert sweep2.winner == sweep.winner, "sweep winner is not deterministic"
    assert [t["score"] for t in sweep2.trials] == [t["score"] for t in sweep.trials], (
        "sweep scores are not deterministic")
    looked_up = TuningDB.load(db_path).lookup_key(sweep.key)
    assert looked_up == sweep.winner, (looked_up, sweep.winner)
    (root / "sim_sweep_summary.json").write_text(
        json.dumps(sweep.summary(), indent=2, sort_keys=True))
    print(f"sim-drill OK (sweep): {len(sweep.trials)} candidates on {len(entries)} requests in "
          f"{wall:.1f}s, winner {sweep.winner or 'baseline'} score={sweep.winner_score:.3f} "
          f"(baseline {sweep.baseline_score:.3f}), recorded + verified at key {sweep.key}")


def run_predictive(root: Path, device: str) -> None:
    """Real processes, a generated crowd: a predictive-autoscale fleet must
    warm capacity BEFORE the flash crowd peaks, with zero drops and the
    books balanced."""
    from deeplearning_mpi_tpu_torch.serving import AutoscalerConfig, FleetSupervisor
    from deeplearning_mpi_tpu_torch.sim import (
        FlashCrowd,
        TenantSpec,
        TraceConfig,
        generate_entries,
        to_fleet_entries,
    )

    crowd_peak_s = 12.0
    cfg = TraceConfig(
        duration_s=18.0, base_rps=3.0, diurnal_amplitude=0.0, burst_rate_per_s=0.0,
        # The ramp must outrun a warm engine's drain rate before the peak,
        # so backlog (the forecaster's trend input) builds during the onset.
        flash_crowds=(FlashCrowd(at_s=crowd_peak_s, amplitude=20.0, ramp_s=8.0, decay_s=2.0),),
        # Deadline-free (zero drops is the bar) and engine-sized: prompt
        # plus max_new must fit max_blocks_per_seq * block_size = 48.
        tenants=(TenantSpec("default", prompt_mean=12, prompt_jitter=0.0, output_mean=24,
                            output_jitter=0.0, deadline_s=0.0, prefix_pool=4, prefix_len=8),),
        bin_s=0.5,
    )
    entries = to_fleet_entries(generate_entries(cfg, seed=SEED))
    autoscale = AutoscalerConfig(
        min_replicas=1, max_replicas=3, up_load_per_replica=1.5, down_load_per_replica=0.25,
        hysteresis_s=0.2, cooldown_s=0.8, predictive=True, forecast_horizon_s=5.0,
        forecast_tau_s=1.0, forecast_trend_tau_s=2.0,
    )
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    sup = FleetSupervisor(
        MODEL_SPEC, ENGINE_SPEC, 1, root / "fleet", seed=SEED, autoscale=autoscale,
        heartbeat_interval_s=0.2, heartbeat_deadline_s=5.0, spawn_grace_s=600.0,
        max_replica_restarts=4, timeout_s=540.0, device=device,
        threads=1 if device == "cpu" else None,
    )
    t0 = time.monotonic()
    result = sup.run(entries)
    wall = time.monotonic() - t0
    s = result.scale
    assert s, "autoscale accounting missing from FleetResult"
    assert s["spawned"] >= 1, f"no scale-up observed: {s}"
    ups = s.get("up_times", [])
    assert ups, f"no scale-up timestamps recorded: {s}"
    assert ups[0] < crowd_peak_s, (
        f"first scale-up at t={ups[0]:.2f}s did not beat the flash-crowd peak at "
        f"t={crowd_peak_s:.1f}s — predictive warm-up never led")
    assert result.dropped == 0, f"dropped={result.dropped} (want 0)"
    assert s["events"] == s["spawned"] + s["retired"] + s["vetoed"], (
        f"scale books don't reconcile: {s}")
    print(f"sim-drill OK (predictive): first scale-up at t={ups[0]:.2f}s (crowd peak "
          f"t={crowd_peak_s:.1f}s), spawned={s['spawned']} retired={s['retired']} "
          f"vetoed={s['vetoed']} (events={s['events']} reconcile), {result.completed} "
          f"completed, 0 drops, {wall:.1f}s on {device}")


def emit_report(root: Path) -> None:
    """Merge the scale and sweep summaries into one ``sim_summary`` record
    through the port's telemetry pipeline, and require the report tool to
    render its Simulation table from it."""
    from deeplearning_mpi_tpu_torch.telemetry import JsonlSink, MetricsRegistry

    record = {}
    for rel in ("scale/sim_scale_summary.json", "sweep/sim_sweep_summary.json"):
        record.update(json.loads((root / rel).read_text()))
    metrics_path = root / "sim_metrics.jsonl"
    metrics_path.unlink(missing_ok=True)
    reg = MetricsRegistry([JsonlSink(metrics_path)])
    reg.emit("sim_summary", record)
    reg.close()
    out = subprocess.run([sys.executable, str(REPO / "tools" / "metrics_report.py"),
                          str(metrics_path)], capture_output=True, text=True, check=True).stdout
    for needle in ("simulated requests", "SLO-ok per replica-second", "sweep winner params"):
        assert needle in out, f"report missing {needle!r}:\n{out}"
    print(f"sim-drill OK (report): Simulation table rendered from {metrics_path}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="sim_drill", description=__doc__.split("\n")[0])
    parser.add_argument("--phase", choices=("scale", "sweep", "predictive", "all"),
                        default="all", help="which drill phase to run (default: all)")
    parser.add_argument("--root", type=Path, required=True,
                        help="scratch directory for traces, DBs and fleet state")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the predictive phase's workers run")
    args = parser.parse_args(argv)
    if args.phase in ("scale", "all"):
        run_scale(args.root / "scale")
    if args.phase in ("sweep", "all"):
        run_sweep_phase(args.root / "sweep")
    if args.phase in ("predictive", "all"):
        run_predictive(args.root / "predictive", args.device)
    if args.phase == "all":
        emit_report(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
