"""SLO-aware request router for a multi-replica serving fleet.

Port of ``deeplearning_mpi_tpu/serving/router.py``, host-only Python with
the same decisions (``tests/test_torch_router.py`` drives both copies under
one fake clock and requires identical selections, hedges and winners).

The router is the fleet's policy half, deliberately built like the
scheduler (``serving/scheduler.py``): pure host-side Python, no device work,
every decision a deterministic function of (telemetry snapshots, clock) —
so the tests drive all of it under a fake clock. The
supervisor (`serving/fleet.py`) owns the processes and the wire; the
router owns three decisions:

- **Replica selection**: each dispatch goes to the eligible replica with
  the lowest load score, computed from the replica's last heartbeat
  telemetry snapshot (queue depth, active slots, TTFT p50 — the same
  ``serve_*`` instruments the single-replica engine already emits) plus
  the router's own count of outstanding dispatches (the snapshot lags by
  a heartbeat interval; the router's ledger does not).
- **Dead-replica exclusion**: a replica marked dead is ineligible until
  BOTH it has been marked alive again (respawn reached ready) and its
  exclusion window has elapsed — a freshly respawned replica has a cold
  queue and would otherwise win every selection while it is still the
  least-proven member of the fleet.
- **Deadline-budgeted hedged retries**: an outstanding request older than
  the hedge threshold with SLO budget left gets a duplicate dispatch on a
  different replica; the first completion wins and the loser is
  cancelled. Duplicates are deduplicated here — exactly one stream per
  rid reaches the client — and every hedge outcome is accounted in
  ``serve_hedge_total{outcome=fired|primary_win|hedge_win|duplicate}``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from deeplearning_mpi_tpu_torch.telemetry.registry import labeled

__all__ = ["Router"]

HEDGE_TOTAL = "serve_hedge_total"


@dataclasses.dataclass
class _Replica:
    """Router-side view of one replica."""

    snapshot: dict = dataclasses.field(default_factory=dict)
    dead: bool = False
    #: manual drain flag (rolling weight swap): excluded until include()d.
    draining: bool = False
    #: terminal drain flag (autoscaler scale-down): the replica is being
    #: retired and will be removed once its outstanding work finishes.
    #: Unlike ``draining``, retirement is one-way — ``include`` cannot
    #: resurrect a retired replica.
    retired: bool = False
    #: monotonic time before which a once-dead replica stays ineligible.
    excluded_until: float = 0.0
    #: prefix signature -> last dispatch time carrying it. A replica that
    #: recently served a prompt with this leading-block signature likely
    #: still holds the prefix in its radix cache, so routing the next
    #: same-signature request there turns a cold prefill into a hit.
    prefix_sigs: dict[int, float] = dataclasses.field(default_factory=dict)
    #: rids currently dispatched here (primary or hedge copy). An index
    #: over ``Router._requests``, maintained on dispatch/hedge/complete/
    #: death — scoring and the control tick read outstanding counts every
    #: tick, and scanning the whole request ledger per read made both
    #: O(requests-ever) (the fake-clock simulator replays 10^5..10^6
    #: requests through this very object).
    outstanding: set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _Tracked:
    """One in-flight request the router has dispatched."""

    rid: int
    primary: int
    dispatched_at: float
    deadline: Optional[float] = None
    hedge: Optional[int] = None
    hedged_at: Optional[float] = None
    done: bool = False


class Router:
    def __init__(
        self,
        replicas: list[int] | tuple[int, ...] | range,
        *,
        clock: Any = time.monotonic,
        hedge_ms: float = 0.0,
        exclusion_s: float = 1.0,
        registry: Any = None,
        roles: dict[int, str] | None = None,
    ) -> None:
        self._clock = clock
        self.hedge_s = hedge_ms / 1000.0
        self.exclusion_s = exclusion_s
        self._registry = registry
        self._replicas: dict[int, _Replica] = {
            int(r): _Replica() for r in replicas
        }
        #: replica id -> topology role ("colocated" when unmapped).
        #: Disaggregated replicas score differently (see :meth:`score`) and
        #: are selectable by role (:meth:`select` ``role=``).
        self._roles: dict[int, str] = {
            int(r): v for r, v in (roles or {}).items()
        }
        self._requests: dict[int, _Tracked] = {}
        if registry is not None:
            registry.counter(HEDGE_TOTAL)  # explicit 0 in a hedge-free run

    def role(self, replica: int) -> str:
        return self._roles.get(replica, "colocated")

    # -- membership (autoscaler) ---------------------------------------------
    def add_replica(self, replica: int, *, role: Optional[str] = None) -> None:
        """Register a scale-up replica. It starts cold — callers should
        :meth:`exclude` it until its ready-ack arrives."""
        replica = int(replica)
        if replica in self._replicas:
            raise ValueError(f"replica {replica} already registered")
        self._replicas[replica] = _Replica()
        if role is not None:
            self._roles[replica] = role

    def mark_retired(self, replica: int) -> list[int]:
        """Begin retiring ``replica`` (scale-down): no new dispatches, ever
        again — including via prefix affinity, so its signature ledger is
        cleared NOW, not at removal (affinity scoring must not steer new
        same-prefix requests at a replica mid-drain). Returns the rids
        still outstanding on it, which the caller drains to zero before
        :meth:`remove_replica`."""
        state = self._replicas[replica]
        state.retired = True
        state.prefix_sigs.clear()
        return self.outstanding_on(replica)

    def remove_replica(self, replica: int) -> None:
        """Drop a fully drained, retired replica from the fleet view."""
        self._replicas.pop(replica, None)
        self._roles.pop(replica, None)

    def prefix_ledger_size(self, replica: int) -> int:
        """How many prefix signatures this replica's affinity ledger holds
        — the autoscaler's retire-victim cost signal (fewest signatures =
        coldest radix cache = cheapest to lose)."""
        return len(self._replicas[replica].prefix_sigs)

    def has_prefix_affinity(self, replica: int, sig: Optional[int]) -> bool:
        """True when ``sig`` is in ``replica``'s affinity ledger — the
        replica has recently served this prefix, so its radix cache likely
        still holds it. The fake-clock simulator reads this to apply the
        service model's prefill discount off the SAME ledger the live
        scorer uses (sim/production parity)."""
        return (
            sig is not None
            and replica in self._replicas
            and sig in self._replicas[replica].prefix_sigs
        )

    # -- telemetry in --------------------------------------------------------
    def observe(self, replica: int, snapshot: dict) -> None:
        """Record a replica's latest heartbeat telemetry snapshot. Keys the
        scorer reads: ``queue_depth``, ``slots_active``, ``ttft_p50``."""
        self._replicas[replica].snapshot = dict(snapshot)

    # -- liveness ------------------------------------------------------------
    def mark_dead(self, replica: int, now: Optional[float] = None) -> list[int]:
        """Exclude ``replica`` and return the rids it was serving (primary
        or hedge) so the supervisor can re-dispatch them. Hedge copies on
        the dead replica are simply forgotten (the primary still runs)."""
        now = self._clock() if now is None else now
        state = self._replicas[replica]
        state.dead = True
        state.excluded_until = now + self.exclusion_s
        # The radix cache died with the process: a respawn starts cold, so
        # stale affinity would steer same-prefix traffic at a replica that
        # can no longer hit.
        state.prefix_sigs.clear()
        state.outstanding.clear()
        orphaned = []
        for t in self._requests.values():
            if t.done:
                continue
            if t.primary == replica:
                if t.hedge is not None and t.hedge != replica:
                    # The hedge copy survives — promote it to primary so
                    # completion accounting still sees one live owner.
                    t.primary, t.hedge = t.hedge, None
                    t.hedged_at = None
                else:
                    orphaned.append(t.rid)
            elif t.hedge == replica:
                t.hedge = None
                t.hedged_at = None
        for rid in orphaned:
            del self._requests[rid]
        return orphaned

    def mark_alive(self, replica: int, now: Optional[float] = None) -> None:
        """A respawned replica reached ready. It stays ineligible until its
        exclusion window (started at :meth:`mark_dead`) also elapses."""
        self._replicas[replica].dead = False

    def exclude(self, replica: int) -> None:
        """Manually drain ``replica`` (rolling swap): no new dispatches."""
        self._replicas[replica].draining = True

    def include(self, replica: int) -> None:
        self._replicas[replica].draining = False

    def eligible(self, now: Optional[float] = None) -> list[int]:
        now = self._clock() if now is None else now
        return [
            r
            for r, s in sorted(self._replicas.items())
            if not s.dead
            and not s.draining
            and not s.retired
            and now >= s.excluded_until
        ]

    # -- selection -----------------------------------------------------------
    def outstanding_on(self, replica: int) -> list[int]:
        state = self._replicas.get(replica)
        if state is None:
            return []
        return sorted(state.outstanding)

    def score(self, replica: int, *, prefix_sig: Optional[int] = None) -> float:
        """Load score — lower is better. Outstanding dispatches are the
        router's own ledger (fresh); queue depth / active slots / TTFT come
        from the replica's last snapshot (one heartbeat stale).

        Role-aware term: a disaggregated replica's ``queue_depth`` counts
        only its prefill door — work that has cleared prefill but not yet
        entered a decode slot sits in the handoff queue instead, invisible
        to the colocated scorer. ``handoff_depth`` (from the replica's
        heartbeat) re-surfaces that backlog at half weight: handed-off
        work no longer delays a NEW request's TTFT (prefill slots are
        free) but still competes for the decode slots it will eventually
        need.

        Prefix-affinity term: when ``prefix_sig`` (the request's leading-
        block signature, ``prefix_cache.prefix_signature``) matches one
        this replica recently served, the score drops by a half-request
        bonus — a probable radix-cache hit saves the prefill this term
        trades against. Affinity deliberately stays weaker than one whole
        outstanding request so it steers ties and near-ties without
        overriding real load imbalance (a hot shared prefix must not
        funnel the entire fleet's traffic onto one replica).
        """
        state = self._replicas[replica]
        snap = state.snapshot
        score = (
            len(self.outstanding_on(replica))
            + float(snap.get("queue_depth", 0))
            + 0.25 * float(snap.get("slots_active", 0))
            + float(snap.get("ttft_p50", 0.0))
        )
        if self.role(replica) == "disagg":
            score += 0.5 * float(snap.get("handoff_depth", 0))
        if prefix_sig is not None and prefix_sig in state.prefix_sigs:
            score -= 0.5
        return score

    def select(
        self,
        now: Optional[float] = None,
        *,
        exclude: tuple[int, ...] = (),
        role: Optional[str] = None,
        prefix_sig: Optional[int] = None,
    ) -> Optional[int]:
        """The eligible replica with the lowest score (ties → lowest id),
        or None when the whole fleet is dead/draining/excluded. ``role``
        restricts selection to replicas of one topology role (a mixed
        fleet can pin long-prompt traffic to disaggregated replicas);
        ``prefix_sig`` enables the prefix-affinity bonus in the scorer."""
        now = self._clock() if now is None else now
        candidates = [
            r
            for r in self.eligible(now)
            if r not in exclude and (role is None or self.role(r) == role)
        ]
        if not candidates:
            return None
        return min(
            candidates, key=lambda r: (self.score(r, prefix_sig=prefix_sig), r)
        )

    def dispatch(
        self,
        rid: int,
        replica: int,
        now: Optional[float] = None,
        *,
        deadline: Optional[float] = None,
        prefix_sig: Optional[int] = None,
    ) -> None:
        """Record that ``rid`` was sent to ``replica`` (primary copy). A
        re-dispatch after :meth:`mark_dead` lands here again — the original
        dispatch record died with the replica — and MUST carry the original
        deadline so hedging still sees the true remaining budget.
        ``prefix_sig`` (when the request has one) is remembered against the
        replica so later same-prefix requests score it with the affinity
        bonus; the history is bounded — oldest signature evicted past 128.
        """
        t = self._clock() if now is None else now
        self._requests[rid] = _Tracked(
            rid=rid,
            primary=replica,
            dispatched_at=t,
            deadline=deadline,
        )
        self._replicas[replica].outstanding.add(rid)
        if prefix_sig is not None:
            sigs = self._replicas[replica].prefix_sigs
            sigs[prefix_sig] = t
            if len(sigs) > 128:
                del sigs[min(sigs, key=sigs.get)]

    # -- hedging -------------------------------------------------------------
    def maybe_hedge(
        self, now: Optional[float] = None
    ) -> list[tuple[int, int]]:
        """The (rid, replica) duplicate dispatches due now: outstanding
        longer than the hedge threshold, not yet hedged, still inside the
        request's deadline budget (hedging work the client already gave up
        on is pure waste), with a different eligible replica to run on.
        Each fired hedge counts ``serve_hedge_total{outcome="fired"}``;
        the supervisor must actually send the duplicate."""
        if self.hedge_s <= 0.0:
            return []
        now = self._clock() if now is None else now
        fired = []
        for t in self._requests.values():
            if t.done or t.hedge is not None:
                continue
            if now - t.dispatched_at < self.hedge_s:
                continue
            if t.deadline is not None and now >= t.deadline:
                continue
            target = self.select(now, exclude=(t.primary,))
            if target is None:
                continue
            t.hedge = target
            t.hedged_at = now
            self._replicas[target].outstanding.add(t.rid)
            self._count_hedge("fired")
            fired.append((t.rid, target))
        return fired

    def on_complete(
        self,
        rid: int,
        replica: int,
        now: Optional[float] = None,
        *,
        ttft: Optional[float] = None,
    ) -> tuple[str, Optional[int]]:
        """A completion arrived from ``replica``. Returns
        ``(verdict, loser)``: verdict ``"win"`` means this stream goes to
        the client and ``loser`` (a replica id, or None) still holds a
        copy the supervisor must cancel; ``"duplicate"`` means the client
        already has this stream — drop it. Exactly one win per rid, ever.
        ``ttft`` feeds the per-replica ``serve_ttft_s{replica=...}``
        histogram the router aggregates for the fleet."""
        if ttft is not None and self._registry is not None:
            self._registry.histogram(
                labeled("serve_ttft_s", replica=str(replica))
            ).observe(ttft)
        # Won rids leave the ledger entirely (a late duplicate completion
        # then sees no record — same "duplicate" verdict the done-flag
        # used to produce); keeping every finished record made
        # maybe_hedge/outstanding scans O(requests-ever), which the
        # simulator's million-request replays cannot afford.
        t = self._requests.pop(rid, None)
        if t is None or t.done:
            self._count_hedge("duplicate")
            return "duplicate", None
        t.done = True
        self._drop_outstanding(t)
        loser: Optional[int] = None
        if t.hedge is not None:
            if replica == t.primary:
                loser = t.hedge
                self._count_hedge("primary_win")
            else:
                loser = t.primary
                self._count_hedge("hedge_win")
        return "win", loser

    def forget(self, rid: int) -> None:
        """Drop a rid the fleet permanently shed (deadline, queue_full):
        nothing outstanding remains to hedge or re-dispatch."""
        t = self._requests.pop(rid, None)
        if t is not None:
            self._drop_outstanding(t)

    def _drop_outstanding(self, t: _Tracked) -> None:
        for holder in (t.primary, t.hedge):
            if holder is not None and holder in self._replicas:
                self._replicas[holder].outstanding.discard(t.rid)

    # -- internals -----------------------------------------------------------
    def _count_hedge(self, outcome: str) -> None:
        if self._registry is None:
            return
        self._registry.counter(HEDGE_TOTAL).inc()
        self._registry.counter(labeled(HEDGE_TOTAL, outcome=outcome)).inc()
