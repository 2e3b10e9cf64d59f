"""Load-adaptive fleet autoscaler policy: scale decisions + brownout ladder.

Port of ``deeplearning_mpi_tpu/serving/autoscaler.py``, host-only Python
with the same decisions (``tests/test_torch_autoscaler.py`` drives both
copies under one fake clock: scale events, vetoes, brownout stages and
forecasts equal, the forecasts exactly in float64).

The policy half of closed-loop fleet sizing (ROADMAP item 1). Like the
router and the scheduler, this module is pure host-side Python — every
decision is a deterministic function of (config, clock, load signal), so
the tests drive all of it under a fake clock. The
supervisor (:class:`~deeplearning_mpi_tpu_torch.serving.fleet.FleetSupervisor`
with ``autoscale=``) owns the mechanism: supervised spawn + warmup +
ready-ack before router inclusion on scale-up, and the zero-drop drain
path (borrowed from the rolling weight swap) on scale-down.

Three stabilizers keep the loop from thrashing:

- **Hysteresis**: a scale signal must PERSIST for ``hysteresis_s`` before
  a decision fires — one bursty heartbeat is not a trend. After any
  decision (including a veto) the signal must re-arm from scratch AND a
  cooldown starts, so a standing veto is recorded once per cooldown, not
  once per tick. While spawned capacity is still warming
  (``LoadSignal.warming``), up-decisions hold without firing at all —
  the load number divides by READY replicas only, so scaling again
  before the last spawn serves would double-count the same overload.
- **Cooldown**: after any scale event *or failover respawn*
  (:meth:`note_respawn` — the supervisor calls it from its failure
  handler), further decisions wait ``cooldown_s``. A chaos kill already
  changes fleet capacity; scaling on top of an in-flight respawn is how
  control loops oscillate.
- **Floor/ceiling clamps**: scale-down is vetoed at ``min_replicas``
  against *ready* capacity (so a concurrent replica death can never race
  the fleet to zero), scale-up at ``max_replicas`` against *total*
  membership including still-warming spawns.

When the fleet is pinned at ``max_replicas`` and overload persists, the
**brownout ladder** (:meth:`brownout`) escalates one stage per
``brownout_hold_s`` of sustained saturation: (1) shed lowest-priority
tenants at the admission door, (2) additionally disable speculative
drafts, (3) additionally raise the deadline floor. It resets to 0 only
after ``brownout_clear_s`` of calm — degrading is fast, un-degrading is
deliberately slow (docs/SERVING.md).

With ``AutoscalerConfig(predictive=True)`` the policy additionally runs a
:class:`LoadForecaster` (EWMA level + trend, optional seasonal residual)
over the LoadSignal history and arms the up-window on the *forecast* load
one horizon ahead — replicas start warming before a ramp lands instead of
after (ROADMAP item 3; parameters are picked by the ``sim/search.py``
sweep, and ``docs/SIMULATION.md`` describes the workflow).

This module is clock-pure by contract: every method takes ``now`` as an
argument and nothing here may read ``time.*`` directly (dmt-lint DMT008
``clock-injection``) — that purity is what lets ``sim/simulator.py`` run
the very same policy object under a fake clock at million-request scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Optional

__all__ = [
    "AutoscalerConfig",
    "AutoscalerPolicy",
    "LoadForecaster",
    "LoadSignal",
    "ReplicaView",
    "build_load_signal",
]


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Knobs for :class:`AutoscalerPolicy`. Defaults suit the drills'
    compressed clocks; production wants seconds-to-minutes values."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: scale up when load per ready replica exceeds this...
    up_load_per_replica: float = 3.0
    #: ...and down when it falls below this (the gap between the two IS
    #: the static half of the hysteresis).
    down_load_per_replica: float = 0.25
    #: how long a signal must persist before a decision fires.
    hysteresis_s: float = 0.3
    #: quiet period after any scale event or failover respawn.
    cooldown_s: float = 1.0
    #: load per ready replica that counts as saturation for the brownout
    #: ladder (only consulted while pinned at ``max_replicas``).
    brownout_load_per_replica: float = 6.0
    #: sustained saturation needed to climb one brownout stage.
    brownout_hold_s: float = 0.5
    #: sustained calm needed to clear the ladder back to stage 0.
    brownout_clear_s: float = 1.0
    #: -- predictive scale-up (ROADMAP item 3; parameters are meant to be
    #: picked by the sim sweep in ``sim/search.py``, not by hand) --
    #: when True, the up-signal arms on max(current load, forecast load at
    #: ``now + forecast_horizon_s``), so replicas start warming AHEAD of a
    #: ramp instead of after it lands. Down-decisions additionally hold
    #: while the forecast sits above the up threshold (don't retire
    #: capacity into a predicted wave). Reactive behavior is bit-identical
    #: with the default False.
    predictive: bool = False
    #: how far ahead the forecaster projects — should cover one
    #: spawn-to-ready warmup so predicted capacity arrives in time.
    forecast_horizon_s: float = 3.0
    #: EWMA time constant for the smoothed load level (seconds — the
    #: forecaster is cadence-independent, so fleet ticks at 20ms and sim
    #: ticks at 100ms smooth identically in wall-clock terms).
    forecast_tau_s: float = 1.0
    #: EWMA time constant for the load trend (d level / dt).
    forecast_trend_tau_s: float = 1.0
    #: optional seasonal period (diurnal analog); 0 disables the
    #: seasonal term entirely.
    forecast_seasonal_period_s: float = 0.0

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) < "
                f"min_replicas ({self.min_replicas})"
            )
        if self.down_load_per_replica >= self.up_load_per_replica:
            raise ValueError(
                "down_load_per_replica must sit strictly below "
                f"up_load_per_replica, got {self.down_load_per_replica} >= "
                f"{self.up_load_per_replica}"
            )
        if self.predictive and (
            self.forecast_horizon_s <= 0
            or self.forecast_tau_s <= 0
            or self.forecast_trend_tau_s <= 0
        ):
            raise ValueError(
                "predictive mode needs positive forecast_horizon_s/"
                "forecast_tau_s/forecast_trend_tau_s, got "
                f"{self.forecast_horizon_s}/{self.forecast_tau_s}/"
                f"{self.forecast_trend_tau_s}"
            )


@dataclasses.dataclass(frozen=True)
class LoadSignal:
    """One tick's measured load, assembled by the supervisor from its
    request ledger and the replicas' heartbeat telemetry snapshots."""

    #: supervisor-side backlog: due-but-unadmitted trace entries plus the
    #: re-dispatch queue (work that exists but no replica holds yet).
    backlog: int = 0
    #: sum of worker-reported queue depths (one heartbeat stale).
    queue_depth: int = 0
    #: replicas that are ready AND not retiring — real serving capacity.
    ready: int = 1
    #: replicas alive but not yet ready (warmup after spawn/respawn) —
    #: capacity that is already on its way.
    warming: int = 0
    #: total fleet membership including still-warming spawns and the
    #: retiring replica — what the max_replicas ceiling clamps.
    total: int = 1
    #: cumulative sheds observed (context for logs; not a decision input).
    shed_total: int = 0
    #: fleet-wide TTFT p50 seconds from worker heartbeats (0 = unknown).
    ttft_p50: float = 0.0
    #: committed tokens in flight across tenants (context for logs).
    tokens_in_flight: int = 0

    @property
    def load_per_replica(self) -> float:
        """Outstanding work per unit of actual capacity — the one number
        the thresholds compare against."""
        return (self.backlog + self.queue_depth) / max(self.ready, 1)


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """One replica's slice of the control tick's world state — the input
    row :func:`build_load_signal` aggregates. The live fleet fills these
    from heartbeats + the router's dispatch ledger; the simulator fills
    them from its fake-clock replica models. Keeping the aggregation in
    ONE place is what stops sim and production drifting on how load is
    measured (a drift there would invalidate every sweep result)."""

    idx: int
    #: worker acked ready (serving capacity once not retiring).
    ready: bool = False
    #: process (or simulated replica) still running.
    alive: bool = True
    #: mid-drain for scale-down — excluded from capacity and queue sums.
    retiring: bool = False
    #: worker-reported queue depth (one heartbeat stale in the fleet).
    queue_depth: int = 0
    #: router dispatch-ledger outstanding on this replica — fresh THIS
    #: tick, unlike the heartbeat.
    outstanding: int = 0
    #: per-replica TTFT p50 from the latest heartbeat (0 = unknown).
    ttft_p50: float = 0.0


def build_load_signal(
    views: Iterable[ReplicaView],
    *,
    backlog: int,
    slots_cap: int,
    shed_total: int = 0,
    tokens_in_flight: int = 0,
) -> LoadSignal:
    """Assemble one control tick's :class:`LoadSignal` from per-replica
    views. Queue pressure per replica is ``max(worker-reported depth,
    router outstanding minus slot capacity)``: heartbeats lag one
    interval, but the router's dispatch ledger is fresh this tick —
    without the floor, a just-dispatched burst reads as zero load until
    the next beat and a fast engine can drain before the up-signal ever
    persists. Shared by :class:`~.fleet.FleetSupervisor`'s control tick
    and the fake-clock simulator (``sim/simulator.py``)."""
    views = list(views)
    return LoadSignal(
        backlog=backlog,
        queue_depth=sum(
            max(v.queue_depth, v.outstanding - slots_cap)
            for v in views
            if v.ready and not v.retiring
        ),
        ready=sum(
            1 for v in views if v.ready and not v.retiring and v.alive
        ),
        warming=sum(1 for v in views if not v.ready and v.alive),
        total=len(views),
        shed_total=shed_total,
        ttft_p50=max([v.ttft_p50 for v in views] or [0.0]),
        tokens_in_flight=tokens_in_flight,
    )


class LoadForecaster:
    """Short-horizon load forecast over the LoadSignal history: an
    irregular-interval EWMA level plus an EWMA'd trend (Holt's linear
    method with time-aware gains), and an optional additive seasonal
    residual keyed by phase within ``seasonal_period_s``. Pure state
    machine — the caller injects ``now`` (dmt-lint DMT008), so the fleet
    drives it on the wall clock and the simulator on a fake one with
    identical arithmetic."""

    #: phase resolution of the seasonal residual table.
    SEASONAL_BUCKETS = 16

    def __init__(
        self,
        *,
        tau_s: float,
        trend_tau_s: float,
        seasonal_period_s: float = 0.0,
    ) -> None:
        self.tau_s = float(tau_s)
        self.trend_tau_s = float(trend_tau_s)
        self.seasonal_period_s = float(seasonal_period_s)
        self._t: Optional[float] = None
        self._level: Optional[float] = None
        self._trend = 0.0
        self._observed = 0
        self._season: list[Optional[float]] = (
            [None] * self.SEASONAL_BUCKETS
            if self.seasonal_period_s > 0 else []
        )

    def _bucket(self, t: float) -> int:
        phase = (t % self.seasonal_period_s) / self.seasonal_period_s
        return min(int(phase * self.SEASONAL_BUCKETS),
                   self.SEASONAL_BUCKETS - 1)

    def observe(self, now: float, value: float) -> None:
        """Fold one load measurement in. Gains scale with the elapsed
        interval (``1 - exp(-dt/tau)``) so the smoothing time constant is
        wall-clock seconds regardless of tick cadence."""
        self._observed += 1
        if self._t is None or self._level is None:
            self._t, self._level = now, float(value)
            return
        dt = max(now - self._t, 1e-9)
        a = 1.0 - math.exp(-dt / self.tau_s)
        prev = self._level
        self._level += a * (value - self._level)
        b = 1.0 - math.exp(-dt / self.trend_tau_s)
        self._trend += b * ((self._level - prev) / dt - self._trend)
        if self._season:
            i = self._bucket(now)
            resid = value - self._level
            cur = self._season[i]
            self._season[i] = resid if cur is None else cur + a * (resid - cur)
        self._t = now

    def forecast(self, now: float, horizon_s: float) -> Optional[float]:
        """Projected load at ``now + horizon_s`` (clamped at 0), or None
        until at least two observations have landed (a single point has
        no trend and would just echo the current load)."""
        if self._level is None or self._observed < 2:
            return None
        out = self._level + self._trend * horizon_s
        if self._season:
            s = self._season[self._bucket(now + horizon_s)]
            if s is not None:
                out += s
        return max(out, 0.0)


class AutoscalerPolicy:
    """The decision core. The supervisor feeds it one :class:`LoadSignal`
    per control tick; it answers "scale now?" and "what brownout stage?".
    Every decision — including vetoes — is returned so the supervisor can
    account it (``scale_events == spawned + retired + vetoed``)."""

    def __init__(self, config: AutoscalerConfig) -> None:
        self.config = config
        #: monotonic time scale signals became (and stayed) armed, or None.
        self._up_since: Optional[float] = None
        self._down_since: Optional[float] = None
        #: end of the current cooldown window.
        self._cooldown_until = float("-inf")
        #: brownout ladder state.
        self.stage = 0
        self._hot_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        #: predictive scale-up: forecast the load signal so capacity warms
        #: AHEAD of a ramp (None keeps the reactive path bit-identical).
        self._forecaster: Optional[LoadForecaster] = None
        if config.predictive:
            self._forecaster = LoadForecaster(
                tau_s=config.forecast_tau_s,
                trend_tau_s=config.forecast_trend_tau_s,
                seasonal_period_s=config.forecast_seasonal_period_s,
            )
        #: last forecast computed by :meth:`decide` (for logs/drills).
        self.last_forecast: Optional[float] = None

    # -- cooldown sources ----------------------------------------------------
    def note_scale_event(self, now: float) -> None:
        self._cooldown_until = now + self.config.cooldown_s

    def note_respawn(self, now: float) -> None:
        """A failover respawn just happened. Capacity is already in
        flux — hold further scale decisions for one cooldown so the
        recovery and the autoscaler don't fight."""
        self._cooldown_until = now + self.config.cooldown_s

    def in_cooldown(self, now: float) -> bool:
        return now < self._cooldown_until

    # -- scale decision ------------------------------------------------------
    def decide(
        self, now: float, sig: LoadSignal
    ) -> Optional[tuple[str, str]]:
        """One control tick. Returns ``None`` (no decision due) or
        ``(direction, outcome)`` with direction ``"up"``/``"down"`` and
        outcome ``"ok"`` or ``"vetoed:<why>"``. An ``"ok"`` means the
        caller MUST perform the scale action (and call
        :meth:`note_scale_event`); a veto is a decision that fired and
        was clamped — it re-arms the hysteresis window like any other."""
        cfg = self.config
        load = sig.load_per_replica
        # Predictive mode: fold this tick's measurement into the
        # forecaster and arm the UP window on max(current, forecast) —
        # a rising ramp arms before the load itself crosses the
        # threshold, buying one warmup of lead time. The forecast also
        # blocks DOWN-arming while it sits above the up threshold
        # (retiring capacity into a predicted wave is how you shed at
        # the peak). With predictive off, both signals are just `load`
        # and the policy is bit-identical to its reactive self.
        fc: Optional[float] = None
        if self._forecaster is not None:
            self._forecaster.observe(now, load)
            fc = self._forecaster.forecast(now, cfg.forecast_horizon_s)
            self.last_forecast = fc
        up_signal = load if fc is None else max(load, fc)
        # Arm/disarm the persistent-signal windows every tick, even during
        # cooldown — cooldown delays the decision, not the measurement.
        if up_signal > cfg.up_load_per_replica:
            self._up_since = now if self._up_since is None else self._up_since
        else:
            self._up_since = None
        if (
            load < cfg.down_load_per_replica
            and sig.backlog == 0
            and not (fc is not None and fc > cfg.up_load_per_replica)
        ):
            self._down_since = (
                now if self._down_since is None else self._down_since
            )
        else:
            self._down_since = None

        if self.in_cooldown(now):
            return None
        if (
            self._up_since is not None
            and now - self._up_since >= cfg.hysteresis_s
        ):
            if sig.warming > 0:
                # Capacity is already materializing: hold the armed signal
                # (no veto, no re-arm) until the spawn reaches ready —
                # load divides by ready replicas, so firing again now
                # would double-count the same overload.
                return None
            self._up_since = None  # decision fired: re-arm from scratch
            if sig.total >= cfg.max_replicas:
                self.note_scale_event(now)  # standing veto: once/cooldown
                return "up", "vetoed:max_replicas"
            return "up", "ok"
        if (
            self._down_since is not None
            and now - self._down_since >= cfg.hysteresis_s
        ):
            self._down_since = None
            # Clamp against READY capacity as well as total membership: if
            # a replica just died, total may still read above the floor
            # while actual capacity is already at (or below) it — retiring
            # another replica then could race the fleet to zero.
            if sig.ready <= cfg.min_replicas or sig.total <= cfg.min_replicas:
                self.note_scale_event(now)
                return "down", "vetoed:min_replicas"
            return "down", "ok"
        return None

    # -- retire victim selection ---------------------------------------------
    @staticmethod
    def pick_retire(costs: Mapping[int, tuple[int, int]]) -> int:
        """Choose the cheapest replica to retire. ``costs`` maps replica
        id -> (prefix_ledger_size, outstanding): the coldest radix cache
        loses the least locality, fewest outstanding drains fastest; ties
        break on lowest id (deterministic)."""
        if not costs:
            raise ValueError("pick_retire needs at least one candidate")
        return min(costs, key=lambda r: (costs[r][0], costs[r][1], r))

    # -- brownout ladder -----------------------------------------------------
    def brownout(self, now: float, sig: LoadSignal) -> int:
        """Advance/clear the overload ladder; returns the current stage.
        Only saturation WHILE PINNED at max_replicas escalates — if the
        fleet can still scale up, scaling is the answer, not degradation."""
        cfg = self.config
        hot = (
            sig.total >= cfg.max_replicas
            and sig.warming == 0  # pinned AND everything already serving
            and sig.load_per_replica > cfg.brownout_load_per_replica
        )
        if hot:
            self._calm_since = None
            if self._hot_since is None:
                self._hot_since = now
            if self.stage < 3 and now - self._hot_since >= cfg.brownout_hold_s:
                self.stage += 1
                self._hot_since = now  # each rung needs its own hold period
        else:
            self._hot_since = None
            if self.stage > 0:
                if self._calm_since is None:
                    self._calm_since = now
                if now - self._calm_since >= cfg.brownout_clear_s:
                    self.stage = 0
                    self._calm_since = None
        return self.stage
