"""Deterministic policy-parameter sweep over the fake-clock simulator.

Port of ``deeplearning_mpi_tpu/sim/search.py``; winners land in the port's
``compiler.autotune.TuningDB`` under the reference's key.

Serving policy knobs (autoscaler hysteresis/cooldown, router hedge
threshold, brownout thresholds, decode-bucket sets, predictive-forecast
horizon) have always been hand-tuned against drills. The simulator makes
them *searchable*: every candidate runs the same trace through the real
policy objects in seconds, scored on **SLO-attained completions per
replica-second** (``SimResult.slo_per_chip``) — attainment alone rewards
overscaling; per-chip scoring charges for the capacity used to buy it.

Winners land in the existing autotune JSON DB
(:class:`~deeplearning_mpi_tpu_torch.compiler.autotune.TuningDB`) under
``simpolicy|<trace_digest>|band:<min>-<max>`` keys — the same
record/lookup/provenance machinery kernel tunings use, keyed by workload
digest so a tuning only applies to the traffic shape it was searched on.

Everything is deterministic: the grid order is the iteration order,
each sim is seedless (the trace carries all randomness), and ties break
toward the earliest candidate.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Iterable, Optional

from deeplearning_mpi_tpu_torch.compiler.autotune import TuningDB
from deeplearning_mpi_tpu_torch.serving.autoscaler import AutoscalerConfig
from deeplearning_mpi_tpu_torch.sim.simulator import FleetSimulator, SimConfig

__all__ = ["SweepResult", "apply_params", "default_grid", "run_sweep"]

_AUTOSCALE_FIELDS = frozenset(
    f.name for f in dataclasses.fields(AutoscalerConfig)
)
_SIM_FIELDS = frozenset(f.name for f in dataclasses.fields(SimConfig))


def apply_params(base: SimConfig, params: dict[str, Any]) -> SimConfig:
    """Overlay one candidate's flat param dict onto a base config.
    Autoscaler knobs route into the nested :class:`AutoscalerConfig`;
    fleet knobs (``hedge_ms``, ``decode_buckets``, ...) into
    :class:`SimConfig` itself. Unknown keys are an error — a typo'd sweep
    axis silently sweeping nothing would invalidate the whole search."""
    auto: dict[str, Any] = {}
    top: dict[str, Any] = {}
    for k, v in params.items():
        if k in _AUTOSCALE_FIELDS:
            auto[k] = v
        elif k in _SIM_FIELDS:
            top[k] = tuple(v) if k == "decode_buckets" else v
        else:
            raise ValueError(f"unknown sweep parameter: {k!r}")
    cfg = base
    if auto:
        cfg = dataclasses.replace(
            cfg, autoscale=dataclasses.replace(cfg.autoscale, **auto)
        )
    if top:
        cfg = dataclasses.replace(cfg, **top)
    return cfg


def default_grid() -> list[dict[str, Any]]:
    """A compact default search: the axes the drills showed matter most.
    The empty dict is the baseline (the base config unchanged) so every
    sweep reports whether tuning beat the defaults at all."""
    grid: list[dict[str, Any]] = [{}]
    for hysteresis_s in (0.2, 0.4):
        for cooldown_s in (0.5, 1.0):
            grid.append(
                {"hysteresis_s": hysteresis_s, "cooldown_s": cooldown_s}
            )
    grid.append({"predictive": True, "forecast_horizon_s": 2.0})
    grid.append({"hedge_ms": 400.0})
    return grid


@dataclasses.dataclass
class SweepResult:
    """Everything one sweep learned, in grid order."""

    key: str
    trials: list[dict[str, Any]]
    winner: dict[str, Any]
    winner_score: float
    baseline_score: Optional[float]
    db_path: Optional[str] = None

    def summary(self) -> dict[str, Any]:
        return {
            "sim_sweep_key": self.key,
            "sim_sweep_trials": len(self.trials),
            "sim_sweep_winner": dict(self.winner),
            "sim_sweep_winner_score": round(self.winner_score, 6),
            "sim_sweep_baseline_score": (
                round(self.baseline_score, 6)
                if self.baseline_score is not None else None
            ),
        }


def run_sweep(
    entries: list[dict],
    base: SimConfig,
    grid: Optional[Iterable[dict[str, Any]]] = None,
    *,
    trace_key: str,
    db: TuningDB | str | Path | None = None,
) -> SweepResult:
    """Run every grid candidate against ``entries`` and record the winner.

    ``trace_key`` is the workload identity — callers pass
    ``traces.trace_digest(entries)`` so the DB key binds the tuning to
    this exact traffic shape. ``db`` may be a :class:`TuningDB`, a path
    (loaded-or-created, then saved), or None (no persistence — tests).
    """
    candidates = list(default_grid() if grid is None else grid)
    if not candidates:
        raise ValueError("run_sweep needs at least one candidate")
    band = (base.autoscale.min_replicas, base.autoscale.max_replicas)
    key = f"simpolicy|{trace_key}|band:{band[0]}-{band[1]}"

    trials: list[dict[str, Any]] = []
    baseline_score: Optional[float] = None
    for params in candidates:
        cfg = apply_params(base, params)
        res = FleetSimulator(cfg).run(entries)
        trial = {
            "params": dict(params),
            "score": res.slo_per_chip,
            "slo_attainment": res.slo_attainment,
            "completed": res.completed,
            "shed_total": res.shed_total,
            "replica_seconds": round(res.replica_seconds, 3),
            "scale_ups": res.scale_ups,
            "brownout_max_stage": res.brownout_max_stage,
        }
        trials.append(trial)
        if not params and baseline_score is None:
            baseline_score = res.slo_per_chip

    best = max(
        range(len(trials)), key=lambda i: (trials[i]["score"], -i)
    )
    winner = dict(candidates[best])
    result = SweepResult(
        key=key,
        trials=trials,
        winner=winner,
        winner_score=trials[best]["score"],
        baseline_score=baseline_score,
    )

    if db is not None:
        tdb = db if isinstance(db, TuningDB) else TuningDB.load(db)
        tdb.record_key(
            key,
            winner,
            candidates=[
                {"params": t["params"], "score": t["score"]} for t in trials
            ],
            score=trials[best]["score"],
            slo_attainment=trials[best]["slo_attainment"],
            trace_requests=len(entries),
        )
        if tdb.path is not None:
            tdb.save()
            result.db_path = str(tdb.path)
    return result
