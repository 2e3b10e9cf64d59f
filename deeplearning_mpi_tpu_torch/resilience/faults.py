"""Deterministic fault injection: the chaos plan and its injector.

Port of ``deeplearning_mpi_tpu/resilience/faults.py``: the same grammar,
kind sets, firing rules and books, with the tensor hooks on torch tensors.
A chaos spec is a comma-separated list of ``kind@unit:value`` entries::

    nan_grad@step:7,loader_stall@batch:3,kill@step:12,corrupt_ckpt@epoch:1

Each entry names a fault *kind*, the trigger *unit* it counts in (fixed per
kind: a mismatch is a parse error, not a silent no-op) and the trigger
value. Every fault fires exactly once at its planned trigger, so a chaos
run is reproducible and a recovered run can be held bitwise to an unfaulted
one.

===============  ======  =====================================================
kind             unit    injection site
===============  ======  =====================================================
``nan_grad``     step    the batch is poisoned (the LM's loss mask, a CNN's
                         image) → NaN loss → the step's NaN guard skips the
                         update
``kill``         step    the trainer raises :class:`InjectedKill` before the
                         step: a crash the supervisor must survive
``corrupt_ckpt``  epoch  the checkpointer flips bytes in the step it just
                         committed: restore must detect it and roll back
``loader_stall``  batch  the loader's worker sleeps ``stall_s``: the
                         watchdog's timeout and retry path
``loader_die``    batch  the loader's worker raises every attempt (a poison
                         batch): the watchdog must quarantine it
``rank_kill``     step   the TARGET RANK hard-exits (``os._exit``): a host
                         loss only the pod supervisor survives
``rank_hang``     step   the target rank's training thread blocks forever
                         while its heartbeat keeps beating: liveness must
                         watch progress, not file freshness
``loss_spike``    step   the batch gains ``__loss_scale__``, multiplied into
                         the reported AND the differentiated loss
``grad_spike``    step   the batch gains ``__grad_scale__``, multiplied into
                         the differentiated loss only
``nan_grads``     step   a NaN ``__grad_scale__``: non-finite gradients under
                         a finite loss, the extended finite guard's case
``bitflip``       step   the target rank flips one bit of a digest-sampled
                         parameter of its own replica after the update:
                         silent corruption only the digest vote attributes
===============  ======  =====================================================

The serving kinds (``serve_crash``, ``handoff_stall``, ``replica_*``,
``load_spike``, ``scale_during_failure``, ``supervisor_*``) parse; their
hooks belong to the serving half (ROADMAP Queue 1 item 10), and a trainer
refuses them at validation (:data:`TRAIN_KINDS`), as the reference does.

``rank_kill`` / ``rank_hang`` / ``bitflip`` are pod-level
(:data:`POD_KINDS`): the faulted process cannot account for its own fault,
so the pod supervisor (:mod:`.pod`) marks the spec fired when it observes
the failure (:meth:`ChaosInjector.fire_observed`) and books the recovery
when the re-formed world makes progress. The target rank is the last
(``world size - 1``) unless ``$DMT_CHAOS_RANK`` names another.

The books: every fault adds one to ``fault_injected_total`` when it first
fires, and the layer that handles it adds one ``recovery_total`` (work kept
or redone) or ``rollback_total`` (state discarded) against the same spec.
A balanced run has ``fault_injected_total == recovery_total +
rollback_total``. Recovery latency (fire → recovery) feeds the
``recovery_latency_s`` histogram. The injector counts internally and
mirrors into a telemetry registry once bound; :meth:`ChaosInjector.bind_registry`
backfills what was counted before.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Optional

import torch

from deeplearning_mpi_tpu_torch.telemetry.registry import labeled

__all__ = [
    "AUTOSCALE_KINDS",
    "CONTROLPLANE_KINDS",
    "ChaosInjector",
    "DISAGG_KINDS",
    "ENV_RANK",
    "ENV_SPEC",
    "ENV_STALL",
    "FAULT_INJECTED",
    "FAULT_UNITS",
    "FLEET_KINDS",
    "FaultPlan",
    "FaultSpec",
    "GUARD_KINDS",
    "InjectedFault",
    "InjectedKill",
    "POD_KINDS",
    "RANK_KILL_EXIT",
    "RECOVERY",
    "RECOVERY_LATENCY",
    "ROLLBACK",
    "SERVE_KINDS",
    "TRAIN_KINDS",
    "fleet_entries",
    "pod_entries",
    "strip_entries",
    "validate_plan_kinds",
]

#: trigger unit per fault kind: the grammar's validity table.
FAULT_UNITS = {
    "nan_grad": "step",
    "kill": "step",
    "corrupt_ckpt": "epoch",
    "loader_stall": "batch",
    "loader_die": "batch",
    "serve_crash": "step",
    "rank_kill": "step",
    "rank_hang": "step",
    "replica_kill": "step",
    "replica_hang": "step",
    "replica_slow": "step",
    "handoff_stall": "step",
    "load_spike": "step",
    "scale_during_failure": "step",
    "supervisor_kill": "step",
    "supervisor_hang": "step",
    "loss_spike": "step",
    "grad_spike": "step",
    "nan_grads": "step",
    "bitflip": "step",
}

#: kinds whose books the pod supervisor keeps, not the worker.
POD_KINDS = frozenset({"rank_kill", "rank_hang", "bitflip"})

#: numerics kinds: detected by the guardrail policy or the digest vote.
GUARD_KINDS = frozenset({"loss_spike", "grad_spike", "nan_grads", "bitflip"})

#: every kind the training CLIs have a hook for (``validate_plan_kinds``'s
#: supported set for a trainer).
TRAIN_KINDS = frozenset(
    {"nan_grad", "kill", "corrupt_ckpt", "loader_stall", "loader_die"}
) | POD_KINDS | GUARD_KINDS

#: serving-fleet kinds (the fleet supervisor keeps their books).
FLEET_KINDS = frozenset({"replica_kill", "replica_hang", "replica_slow"})

#: kinds a single serving engine detonates in-process.
SERVE_KINDS = frozenset({"serve_crash"})

#: kinds a disaggregated (prefill / decode) engine detonates in-process.
DISAGG_KINDS = SERVE_KINDS | frozenset({"handoff_stall"})

#: autoscaler drill kinds, detonated by the fleet supervisor itself.
AUTOSCALE_KINDS = frozenset({"load_spike", "scale_during_failure"})

#: control-plane kinds, detonated against the supervisor process.
CONTROLPLANE_KINDS = frozenset({"supervisor_kill", "supervisor_hang"})

#: exit code of a ``rank_kill``'d worker: told apart from collateral crashes.
RANK_KILL_EXIT = 23

#: kinds that keep firing on retries of the same trigger (a poison batch is
#: poison every attempt), counted once.
_PERSISTENT = frozenset({"loader_die"})

FAULT_INJECTED = "fault_injected_total"
RECOVERY = "recovery_total"
ROLLBACK = "rollback_total"
RECOVERY_LATENCY = "recovery_latency_s"

#: env fallback for the spec.
ENV_SPEC = "DMT_CHAOS"
#: env override for the stall sleep (seconds).
ENV_STALL = "DMT_CHAOS_STALL_S"
#: env override for the rank a pod-level fault targets (default: the last).
ENV_RANK = "DMT_CHAOS_RANK"

_ENTRY = re.compile(r"(\w+)@(\w+):(\d+)")


def _tokens(spec: str) -> list[str]:
    return [e.strip() for e in spec.split(",") if e.strip()]


def pod_entries(spec: str) -> list[str]:
    """The ``kind@unit:at`` tokens of ``spec`` whose kind is pod-level."""
    return [e for e in _tokens(spec) if e.split("@", 1)[0] in POD_KINDS]


def fleet_entries(spec: str) -> list[str]:
    """The ``kind@unit:at`` tokens of ``spec`` whose kind is fleet-level."""
    return [e for e in _tokens(spec) if e.split("@", 1)[0] in FLEET_KINDS]


def validate_plan_kinds(spec: str, supported: frozenset[str] | set[str],
                        *, workload: str) -> None:
    """Reject chaos entries whose kind the workload has no hook for: such a
    fault would never fire and the books could never balance."""
    unsupported = sorted({e.split("@", 1)[0] for e in _tokens(spec)} - set(supported))
    if unsupported:
        raise ValueError(
            f"chaos kind(s) {', '.join(unsupported)} have no injection hook "
            f"in the {workload} workload (supported: "
            f"{', '.join(sorted(supported))}) — they would never fire and "
            "the reconciliation invariant could never balance"
        )


def strip_entries(spec: str, entries: list[str]) -> str:
    """Remove each token in ``entries`` from ``spec`` once (first match):
    the supervisor strips a pod fault it booked as fired before it respawns
    the world, whose step count restarts at 0."""
    remaining = list(entries)
    kept = []
    for token in _tokens(spec):
        if token in remaining:
            remaining.remove(token)
            continue
        kept.append(token)
    return ",".join(kept)


def _process() -> tuple[int, int]:
    """``(rank, world size)`` of this process (``(0, 1)`` without a group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _target_rank() -> int:
    return int(os.environ.get(ENV_RANK, str(_process()[1] - 1)))


def _dump_flight(reason: str) -> None:
    """Best-effort flight-recorder dump before a detonation (``os._exit``
    skips atexit and a hang never returns)."""
    try:
        from deeplearning_mpi_tpu_torch.telemetry import spans

        spans.dump_all(reason)
    except Exception:
        pass  # the detonation must land regardless


def _exit_rank(step: int) -> None:
    """``rank_kill``: a hard exit no handler can catch, as a host loss.
    Module-level so tests can patch the detonation."""
    _dump_flight(f"chaos-kill-step{step}")
    print(f"chaos: injected rank_kill@step:{step} — hard exit {RANK_KILL_EXIT} "
          "(simulated host loss)", flush=True)
    os._exit(RANK_KILL_EXIT)


def _hang_rank(step: int) -> None:
    """``rank_hang``: block the training thread forever; the heartbeat
    thread keeps beating while progress freezes."""
    _dump_flight(f"chaos-hang-step{step}")
    print(f"chaos: injected rank_hang@step:{step} — training thread blocked "
          "(heartbeat daemon still beating)", flush=True)
    while True:
        time.sleep(60.0)


class InjectedFault(RuntimeError):
    """An injected fault surfacing as an exception (``loader_die``)."""


class InjectedKill(InjectedFault):
    """The injected training crash: stands in for a lost host."""


@dataclasses.dataclass
class FaultSpec:
    """One planned fault and its lifecycle flags."""

    kind: str
    unit: str
    at: int
    fired: bool = False
    recovered: bool = False
    fired_at: Optional[float] = None  # monotonic; recovery-latency origin


class FaultPlan:
    """Parsed, validated chaos spec: an ordered list of :class:`FaultSpec`."""

    def __init__(self, specs: list[FaultSpec]) -> None:
        self.specs = specs

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        specs: list[FaultSpec] = []
        for entry in _tokens(spec):
            m = _ENTRY.fullmatch(entry)
            if m is None:
                raise ValueError(f"bad chaos entry '{entry}' — want kind@unit:N, e.g. "
                                 "kill@step:12")
            kind, unit, at = m.group(1), m.group(2), int(m.group(3))
            if kind not in FAULT_UNITS:
                raise ValueError(f"unknown fault kind '{kind}' (known: "
                                 f"{', '.join(sorted(FAULT_UNITS))})")
            if unit != FAULT_UNITS[kind]:
                raise ValueError(f"fault '{kind}' triggers on '{FAULT_UNITS[kind]}', "
                                 f"not '{unit}'")
            specs.append(FaultSpec(kind, unit, at))
        if not specs:
            raise ValueError(f"empty chaos spec: {spec!r}")
        return cls(specs)

    def __len__(self) -> int:
        return len(self.specs)

    def __repr__(self) -> str:
        return "FaultPlan(" + ",".join(f"{s.kind}@{s.unit}:{s.at}" for s in self.specs) + ")"


class ChaosInjector:
    """Fires a :class:`FaultPlan` through site hooks and books every fault,
    recovery and rollback. One injector spans a whole run, restarts
    included: its fired / recovered flags make "kill once at step 12" mean
    once, not once an attempt."""

    def __init__(self, plan: FaultPlan, *, registry: Any = None,
                 stall_s: float | None = None) -> None:
        self.plan = plan
        if stall_s is None:
            stall_s = float(os.environ.get(ENV_STALL, "2.0"))
        self.stall_s = stall_s
        self._registry: Any = None
        self._counts: dict[str, float] = {}
        self._latencies: list[float] = []
        if registry is not None:
            self.bind_registry(registry)

    @classmethod
    def from_spec(cls, spec: str | None, *, registry: Any = None,
                  stall_s: float | None = None) -> Optional["ChaosInjector"]:
        """Build from a CLI spec, falling back to ``$DMT_CHAOS``; None when
        neither is set (the hooks then cost one ``is None`` check)."""
        spec = spec or os.environ.get(ENV_SPEC) or ""
        if not spec.strip():
            return None
        return cls(FaultPlan.parse(spec), registry=registry, stall_s=stall_s)

    # -- telemetry ------------------------------------------------------------
    def bind_registry(self, registry: Any) -> None:
        """Mirror counts into ``registry`` from now on, backfilling what was
        counted before the bind."""
        self._registry = registry
        for name in (FAULT_INJECTED, RECOVERY, ROLLBACK):
            registry.counter(name)  # the books read all three, even at 0
        for name, v in self._counts.items():
            if v:
                registry.counter(name).inc(v)
        for lat in self._latencies:
            registry.histogram(RECOVERY_LATENCY).observe(lat)

    def _inc(self, name: str, amount: float = 1.0) -> None:
        self._counts[name] = self._counts.get(name, 0.0) + amount
        if self._registry is not None:
            self._registry.counter(name).inc(amount)

    def _observe_latency(self, latency_s: float) -> None:
        self._latencies.append(latency_s)
        if self._registry is not None:
            self._registry.histogram(RECOVERY_LATENCY).observe(latency_s)

    # -- firing ---------------------------------------------------------------
    def should_fire(self, kind: str, at: int) -> bool:
        """True iff a planned ``kind`` fault triggers at ``at``; counted on
        its FIRST firing only. Persistent kinds keep returning True on
        retries of the same trigger until recovered."""
        hit = False
        for spec in self.plan.specs:
            if spec.kind != kind or spec.at != at:
                continue
            if not spec.fired:
                spec.fired = True
                spec.fired_at = time.monotonic()
                self._inc(FAULT_INJECTED)
                self._inc(labeled(FAULT_INJECTED, kind=kind))
                hit = True
            elif kind in _PERSISTENT and not spec.recovered:
                hit = True
        return hit

    # -- site hooks -------------------------------------------------------------
    def check_kill(self, *, step: int) -> None:
        """Trainer hook, before the step: a planned kill raises."""
        if self.should_fire("kill", step):
            raise InjectedKill(f"chaos: injected kill@step:{step}")

    def check_rank_fault(self, *, step: int) -> None:
        """Trainer hook: the pod-level rank faults, on the target rank only
        (non-target ranks return before :meth:`should_fire`, so they never
        count a fault they did not suffer)."""
        if not any(s.kind in POD_KINDS and not s.fired for s in self.plan.specs):
            return
        if _process()[0] != _target_rank():
            return
        if self.should_fire("rank_kill", step):
            _exit_rank(step)
        if self.should_fire("rank_hang", step):
            _hang_rank(step)

    def maybe_poison(self, batch: dict[str, torch.Tensor], task: str, *,
                     step: int) -> dict[str, torch.Tensor]:
        """Trainer hook: a NaN-poisoned copy of ``batch`` when ``nan_grad``
        triggers at ``step``. The LM's mask becomes ``tokens * NaN`` (a
        float32 ``[B, S]`` mask that drives the masked mean to NaN); a CNN's
        image is multiplied by NaN. The step's NaN guard, not the injector,
        must keep the run alive."""
        if not self.should_fire("nan_grad", step):
            return batch
        poisoned = dict(batch)
        if task == "lm":
            poisoned["mask"] = poisoned["tokens"].to(torch.float32) * float("nan")
        else:
            key = "image" if "image" in poisoned else next(iter(poisoned))
            poisoned[key] = poisoned[key] * float("nan")
        return poisoned

    def maybe_guard_fault(self, batch: dict[str, torch.Tensor], *,
                          step: int) -> dict[str, torch.Tensor]:
        """Trainer hook: the in-process numerics kinds as batch keys the
        step pops: ``loss_spike`` → ``__loss_scale__`` 1e3; ``grad_spike``
        → ``__grad_scale__`` 1e4; ``nan_grads`` → a NaN ``__grad_scale__``.
        Float32 scalars on the batch's device. A clean batch is returned
        as it is."""
        scales = {}
        if self.should_fire("loss_spike", step):
            scales["__loss_scale__"] = 1e3
        if self.should_fire("grad_spike", step):
            scales["__grad_scale__"] = 1e4
        if self.should_fire("nan_grads", step):
            scales["__grad_scale__"] = float("nan")
        if not scales:
            return batch
        device = next(iter(batch.values())).device
        faulted = dict(batch)
        for key, value in scales.items():
            faulted[key] = torch.tensor(value, dtype=torch.float32, device=device)
        return faulted

    def maybe_bitflip(self, model: torch.nn.Module, *, step: int) -> str | None:
        """Trainer hook, after the update: silently corrupt THIS rank's
        replica. On the target rank only, flips bit 10 of the first element
        of the first digest-sampled parameter IN PLACE (the
        ``guardrails._digest_leaves`` enumeration, so the digest covers it;
        a captured step keeps reading the same storage). No collective runs:
        the peers keep their bytes and the replicas diverge. Returns the
        parameter's name, or None when nothing fired."""
        if not any(s.kind == "bitflip" and not s.fired for s in self.plan.specs):
            return None
        if _process()[0] != _target_rank():
            return None
        if not self.should_fire("bitflip", step):
            return None
        from deeplearning_mpi_tpu_torch.resilience.guardrails import _digest_leaves

        name, param = _digest_leaves(model, 1)[0]
        with torch.no_grad():
            first = param.data[(0,) * param.dim()]  # a view of the first element
            bits = first.view({8: torch.int64, 4: torch.int32}.get(param.element_size(),
                                                                     torch.int16))
            bits ^= 1 << 10
        print(f"chaos: injected bitflip@step:{step} in {name} "
              "(local replica corrupted; peers clean)", flush=True)
        return name

    def loader_fault(self, *, batch: int) -> None:
        """Watchdog-worker hook: a stall sleeps ``stall_s``; a die raises
        (every attempt: a poison batch stays poison across retries)."""
        if self.should_fire("loader_stall", batch):
            time.sleep(self.stall_s)
        if self.should_fire("loader_die", batch):
            raise InjectedFault(f"chaos: injected loader_die@batch:{batch} (poison batch)")

    def should_corrupt(self, *, epoch: int) -> bool:
        """Checkpointer hook, after a save lands."""
        return self.should_fire("corrupt_ckpt", epoch)

    def fire_observed(self, kind: str) -> Optional[FaultSpec]:
        """Supervisor-side firing: mark the oldest unfired ``kind`` spec
        fired because its effect was observed (a dead or hung rank). None
        when the failure matches no planned fault (a real crash)."""
        for spec in self.plan.specs:
            if spec.kind == kind and not spec.fired:
                spec.fired = True
                spec.fired_at = time.monotonic()
                self._inc(FAULT_INJECTED)
                self._inc(labeled(FAULT_INJECTED, kind=kind))
                return spec
        return None

    # -- the books --------------------------------------------------------------
    def record_recovery(self, kind: str, *, at: int | None = None,
                        latency_s: float | None = None) -> bool:
        """Mark the oldest fired, unrecovered ``kind`` fault recovered;
        idempotent per spec and a no-op when nothing matches."""
        return self._resolve(kind, RECOVERY, at=at, latency_s=latency_s)

    def record_rollback(self, kind: str = "corrupt_ckpt", *, at: int | None = None) -> bool:
        """As :meth:`record_recovery`, for a fault handled by DISCARDING
        state (a corrupted checkpoint walked past)."""
        return self._resolve(kind, ROLLBACK, at=at, latency_s=None)

    def _resolve(self, kind: str, counter: str, *, at: int | None,
                 latency_s: float | None) -> bool:
        for spec in self.plan.specs:
            if spec.kind != kind or not spec.fired or spec.recovered:
                continue
            if at is not None and spec.at != at:
                continue
            spec.recovered = True
            self._inc(counter)
            self._inc(labeled(counter, kind=kind))
            if latency_s is None and spec.fired_at is not None:
                latency_s = time.monotonic() - spec.fired_at
            if latency_s is not None:
                self._observe_latency(latency_s)
            return True
        return False

    def reconcile_nan_recoveries(self, skipped: int) -> int:
        """Trainer epoch-end hook: each pending ``nan_grad`` / ``nan_grads``
        fault counts as recovered once the epoch's skip count confirms the
        guard rejected a step; returns the recoveries booked."""
        n = 0
        for spec in self.plan.specs:
            if skipped - n <= 0:
                break
            if spec.kind in ("nan_grad", "nan_grads") and spec.fired and not spec.recovered:
                if self.record_recovery(spec.kind, at=spec.at):
                    n += 1
        return n

    # -- reporting ----------------------------------------------------------------
    def counts(self) -> dict[str, float]:
        return dict(self._counts)

    def balanced(self) -> bool:
        """The reconciliation invariant."""
        c = self._counts
        return c.get(FAULT_INJECTED, 0.0) == c.get(RECOVERY, 0.0) + c.get(ROLLBACK, 0.0)

    def unrecovered(self) -> list[FaultSpec]:
        return [s for s in self.plan.specs if s.fired and not s.recovered]

    def summary(self) -> str:
        c = self._counts
        line = (f"chaos: {c.get(FAULT_INJECTED, 0.0):.0f} fault(s) injected, "
                f"{c.get(RECOVERY, 0.0):.0f} recovered, "
                f"{c.get(ROLLBACK, 0.0):.0f} rolled back")
        pending = self.unrecovered()
        if pending:
            line += " — UNRECOVERED: " + ", ".join(f"{s.kind}@{s.unit}:{s.at}" for s in pending)
        unfired = [s for s in self.plan.specs if not s.fired]
        if unfired:
            line += " — never fired: " + ", ".join(f"{s.kind}@{s.unit}:{s.at}" for s in unfired)
        return line
