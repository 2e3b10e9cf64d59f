"""Numerics guardrails: spike detection, digest voting, rollback, quarantine.

Port of ``deeplearning_mpi_tpu/resilience/guardrails.py``. Process faults
announce themselves (a dead rank stops beating, a corrupt checkpoint fails
its manifest); bad numerics do not: a loss spike from a poison data region,
a gradient blow-up or a host flipping bits in its replica all keep training
"successfully". Three pieces close the loop from detection to recovery,
each plain host arithmetic that a fake clock can drive:

:class:`GuardrailPolicy`
    Judges the per-step health scalars (loss, gradient global norm, the
    finite flag) through EWMA-banded robust-z detectors, with a warmup
    grace, bands frozen during an anomaly episode and consecutive calm
    steps to close one. Verdicts: ``ok`` | ``spike`` (tolerated) |
    ``poisoned`` (the caller rolls back).

:class:`DigestVote`
    Every rank publishes a sha256 over a fixed sample of its replicated
    parameters (:func:`param_digest`) on its heartbeat. Under data
    parallelism those bytes are equal on every rank, so at a step two or
    more ranks hold, a mismatch blames the minority digest directly.

:class:`QuarantineLedger`
    A blamed host is booked in an atomic JSON ledger that the pod
    supervisor reads before every (re)spawn.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Mapping, Optional

import torch

from deeplearning_mpi_tpu_torch.resilience.integrity import atomic_write_json

__all__ = [
    "DigestVote",
    "GuardrailConfig",
    "GuardrailPolicy",
    "QuarantineLedger",
    "RollbackRequested",
    "Verdict",
    "VoteResult",
    "attach_digest_ring",
    "param_digest",
]


class RollbackRequested(RuntimeError):
    """Raised by the Trainer on a ``poisoned`` verdict: the run restores
    the pinned last-known-good checkpoint and replays. The auto-resume
    closure (``utils.config.execute``) reads ``trainer.pending_rollback``
    to tell it from a crash."""

    def __init__(self, verdict: "Verdict") -> None:
        super().__init__(
            f"guardrail verdict poisoned at step {verdict.step} "
            f"({verdict.signal}: z={verdict.z:.1f}, {verdict.reason}) — "
            "rollback to last-known-good requested"
        )
        self.verdict = verdict


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One step's judgement; ``region`` is the attributed poison window
    ``(first anomalous step, step)``."""

    status: str  # "ok" | "spike" | "poisoned"
    step: int
    signal: str = ""  # "loss" | "grad_norm" | "finite" | ""
    z: float = 0.0
    reason: str = ""
    region: tuple[int, int] | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """Detector thresholds (loose by default: a guardrail that cries wolf
    trains nothing). ``digest_every`` > 0 also computes
    :func:`param_digest` every N steps, a device read beyond the step's
    scalars, so it is opt-in."""

    warmup_steps: int = 8
    ewma_alpha: float = 0.2
    z_spike: float = 6.0
    z_poison: float = 12.0
    spike_patience: int = 2
    hysteresis_steps: int = 4
    digest_every: int = 0
    digest_sample_leaves: int = 8
    replay: str = "none"  # poison-region replay action: none | skip | clip
    clip_scale: float = 0.1


class _Band:
    """EWMA mean and EWMA mean absolute deviation of one signal; robust-z is
    ``|x - mean| / max(dev, eps)``."""

    __slots__ = ("mean", "dev", "n")

    def __init__(self) -> None:
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0

    def z(self, x: float) -> float:
        if self.n == 0:
            return 0.0
        return abs(x - self.mean) / max(self.dev, 1e-8, abs(self.mean) * 1e-3)

    def update(self, x: float, alpha: float) -> None:
        if self.n == 0:
            self.mean = x
            self.dev = max(abs(x) * 0.1, 1e-8)
        else:
            self.dev = (1 - alpha) * self.dev + alpha * abs(x - self.mean)
            self.mean = (1 - alpha) * self.mean + alpha * x
        self.n += 1


class GuardrailPolicy:
    """Per-step anomaly detector: ``ok`` steps update the bands; the first
    anomalous step opens an episode and freezes them; more than
    ``spike_patience`` consecutive anomalous steps escalate to
    ``poisoned``; ``hysteresis_steps`` calm steps close the episode. A
    ``poisoned`` verdict resets the policy (the caller rolls back to a state
    before this band history)."""

    def __init__(self, config: GuardrailConfig | None = None) -> None:
        self.config = config or GuardrailConfig()
        self._bands: dict[str, _Band] = {}
        self._seen = 0
        self._episode_start: Optional[int] = None
        self._anomaly_streak = 0
        self._calm_streak = 0

    def observe(self, step: int, *, loss: float, grad_norm: float | None = None,
                finite: bool = True) -> Verdict:
        """Judge one step's health signals; returns the worst verdict."""
        cfg = self.config
        self._seen += 1
        signals = [("loss", float(loss))]
        if grad_norm is not None:
            signals.append(("grad_norm", float(grad_norm)))
        # A non-finite step never updates a band and is always anomalous;
        # the step's guard already skipped its update, so one is a spike.
        if not finite:
            return self._anomalous(
                Verdict("spike", step, "finite", float("inf"),
                        "non-finite step (update skipped in-step)"), step)
        worst: tuple[float, str, float] | None = None
        for name, value in signals:
            band = self._bands.setdefault(name, _Band())
            if self._seen > cfg.warmup_steps and band.n > 0:
                z = band.z(value)
                if z >= cfg.z_spike and (worst is None or z > worst[0]):
                    worst = (z, name, value)
        if worst is not None:
            z, name, _value = worst
            if z >= cfg.z_poison:
                verdict = Verdict(
                    "poisoned", step, name, z, f"robust-z {z:.1f} >= z_poison {cfg.z_poison:g}",
                    region=(self._episode_start if self._episode_start is not None else step,
                            step))
                self.reset()
                return verdict
            return self._anomalous(
                Verdict("spike", step, name, z, f"robust-z {z:.1f} >= z_spike {cfg.z_spike:g}"),
                step)
        # Calm step: the bands stay frozen until the episode closes.
        if self._episode_start is not None:
            self._calm_streak += 1
            self._anomaly_streak = 0
            if self._calm_streak < cfg.hysteresis_steps:
                return Verdict("ok", step, reason="episode cooling")
            self._episode_start = None
            self._calm_streak = 0
        for name, value in signals:
            self._bands[name].update(value, cfg.ewma_alpha)
        return Verdict("ok", step)

    def _anomalous(self, verdict: Verdict, step: int) -> Verdict:
        """Book one anomalous step; escalate past the patience."""
        if self._episode_start is None:
            self._episode_start = step
            self._anomaly_streak = 0
        self._calm_streak = 0
        self._anomaly_streak += 1
        if self._anomaly_streak > self.config.spike_patience:
            escalated = Verdict(
                "poisoned", step, verdict.signal, verdict.z,
                f"{self._anomaly_streak} consecutive anomalous steps > "
                f"spike_patience {self.config.spike_patience}",
                region=(self._episode_start, step))
            self.reset()
            return escalated
        return dataclasses.replace(verdict, region=(self._episode_start, step))

    def reset(self) -> None:
        """Forget the band history (after a rollback)."""
        self._bands.clear()
        self._seen = 0
        self._episode_start = None
        self._anomaly_streak = 0
        self._calm_streak = 0

    def replay_scale(self, step: int, region: tuple[int, int] | None) -> float:
        """The loss scale a replay applies at ``step`` given the poison
        ``region``: 1.0 outside it; inside, 0.0 for ``replay="skip"``,
        ``clip_scale`` for ``"clip"``, 1.0 for ``"none"``."""
        if region is None or not (region[0] <= step <= region[1]):
            return 1.0
        if self.config.replay == "skip":
            return 0.0
        if self.config.replay == "clip":
            return float(self.config.clip_scale)
        return 1.0


# -- parameter digests ----------------------------------------------------------
def _digest_leaves(model: torch.nn.Module, sample_leaves: int) -> list[tuple[str, torch.Tensor]]:
    """The fixed parameter sample digested AND bit-flipped (chaos): sorted
    by name, so the same on every rank and run. Only leaves every rank holds
    whole qualify (``parallel.leaves``: no split dim, no stage stack): a
    tensor-, expert- or pipeline-sharded leaf differs by rank by design."""
    from deeplearning_mpi_tpu_torch.parallel.leaves import leaf_views

    views = leaf_views(model)
    leaves = []
    for name, p in sorted(model.named_parameters(), key=lambda kv: kv[0]):
        view = views.get(name)
        if view is not None and (view.split or view.stacked):
            continue
        leaves.append((name, p))
        if len(leaves) >= sample_leaves:
            break
    return leaves


def param_digest(model: torch.nn.Module, *, sample_leaves: int = 8) -> str:
    """sha256 hex digest over a fixed sample of the replicated parameters:
    name, dtype, shape and raw bytes of each (one host copy of
    ``sample_leaves`` tensors). Equal on every data-parallel rank by
    construction, so cross-rank comparison is an equality vote."""
    h = hashlib.sha256()
    for name, p in _digest_leaves(model, sample_leaves):
        t = p.detach().contiguous().cpu()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# -- the cross-rank digest vote -------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VoteResult:
    """One step's digests across ranks; ``minority`` holds the out-voted
    rank(s), empty for a tie the vote cannot break."""

    step: int
    minority: tuple[int, ...]
    digests: dict[int, str]


class DigestVote:
    """Cross-rank digest comparator fed from heartbeat payloads: each rank's
    beat carries a ring ``{step: digest}``; :meth:`tally` compares every step
    two or more ranks hold, oldest first. Agreement advances
    ``last_agreed_step``; the first disagreement blames the minority."""

    def __init__(self) -> None:
        self._rings: dict[int, dict[int, str]] = {}
        self.last_agreed_step: int = -1

    def observe(self, rank: int, digests: Mapping[Any, Any] | None) -> None:
        """Record a rank's latest ring (JSON turns its keys into str)."""
        if not digests:
            return
        self._rings[int(rank)] = {int(s): str(d) for s, d in digests.items()}

    def drop_rank(self, rank: int) -> None:
        """Forget a departed rank's ring."""
        self._rings.pop(int(rank), None)

    def tally(self) -> Optional[VoteResult]:
        """Compare the commonly held steps; the earliest mismatch wins."""
        if len(self._rings) < 2:
            return None
        common: dict[int, dict[int, str]] = {}
        for rank, ring in self._rings.items():
            for step, digest in ring.items():
                common.setdefault(step, {})[rank] = digest
        for step in sorted(common):
            votes = common[step]
            if len(votes) < 2 or step <= self.last_agreed_step:
                continue
            tallies: dict[str, list[int]] = {}
            for rank, digest in votes.items():
                tallies.setdefault(digest, []).append(rank)
            if len(tallies) == 1:
                self.last_agreed_step = step
                continue
            sizes = sorted(len(r) for r in tallies.values())
            minority: list[int] = []
            if sizes[-1] > sizes[0]:  # a strict majority exists
                biggest = max(tallies.values(), key=len)
                for ranks in tallies.values():
                    if ranks is not biggest:
                        minority.extend(ranks)
            return VoteResult(step, tuple(sorted(minority)),
                              {r: d for r, d in sorted(votes.items())})
        return None


# -- the quarantine ledger --------------------------------------------------------------
class QuarantineLedger:
    """Atomic JSON ledger of hosts blamed for silent corruption; it
    outlives the supervisor (a host that flipped bits once stays barred
    until a human clears it)."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.entries: list[dict[str, Any]] = []
        if self.path.exists():
            try:
                loaded = json.loads(self.path.read_text())
                if isinstance(loaded, list):
                    self.entries = [e for e in loaded if isinstance(e, dict)]
            except (OSError, json.JSONDecodeError):
                pass  # an unreadable ledger quarantines nobody (fail open)

    def hosts(self) -> set[str]:
        return {str(e.get("host")) for e in self.entries if e.get("host")}

    def __contains__(self, host: Any) -> bool:
        return str(host) in self.hosts()

    def quarantine(self, host: Any, *, reason: str, step: int | None = None,
                   digest: str | None = None) -> dict[str, Any]:
        """Book one host; idempotent per host."""
        if host in self:
            return next(e for e in self.entries if str(e.get("host")) == str(host))
        entry: dict[str, Any] = {"host": str(host), "reason": reason}
        if step is not None:
            entry["step"] = int(step)
        if digest is not None:
            entry["digest"] = digest
        self.entries.append(entry)
        atomic_write_json(self.path, self.entries)
        return entry


def attach_digest_ring(ring: dict[int, str], step: int, digest: str, *, cap: int = 16) -> None:
    """Add one digest to a heartbeat ring in place, evicting the oldest past
    ``cap`` (the ring rides every beat)."""
    ring[step] = digest
    while len(ring) > cap:
        del ring[min(ring)]
