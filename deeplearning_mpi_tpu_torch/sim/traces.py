"""Seeded multi-tenant workload trace generator.

Port of ``deeplearning_mpi_tpu/sim/traces.py``, numpy only: the same
``(config, seed)`` gives the reference's entries and JSONL bytes exactly.

Produces request traces at millions-of-requests scale in the SAME JSONL
replay schema ``cli/serve_lm.py --trace`` consumes (``arrival`` seconds
from start, ``prompt`` text, ``max_new``, optional ``deadline`` seconds
after arrival, optional ``tenant``) — a generated trace replays through
the real fleet byte-for-byte, and :func:`to_fleet_entries` converts the
same entries to the tokenized form :class:`~..serving.fleet.FleetSupervisor`
takes directly.

Traffic model (the regimes the Gemma-on-TPU serving measurements
distinguish):

- **diurnal cycle** — a sinusoidal rate modulation over
  ``diurnal_period_s`` (amplitude 0..1);
- **Poisson bursts** — a Poisson-distributed number of Gaussian rate
  bumps at uniform times (prefill-bound burst regime);
- **flash crowds** — :class:`FlashCrowd` events with a linear onset ramp
  to a peak multiplier and an exponential decay, the shape the
  predictive autoscaler must warm capacity ahead of;
- **prefix-sharing skew** — each tenant draws its prompt preamble from a
  Zipf-weighted pool of shared prefixes, so affinity routing and radix
  caches have something real to hit;
- **adversarial tenants** — arrivals re-clustered into submit storms
  with tight deadlines, the traffic shape tenant budgets and the
  brownout ladder exist to contain.

Everything is driven by one ``numpy`` Generator seed: the same seed
yields a byte-identical JSONL file (``tests/test_torch_sim.py`` holds it
to the reference's).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from pathlib import Path
from typing import Iterable

import numpy as np

__all__ = [
    "FlashCrowd",
    "TenantSpec",
    "TraceConfig",
    "generate_entries",
    "tenant_policies",
    "to_fleet_entries",
    "trace_digest",
    "write_jsonl",
]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape plus its admission policy knobs (the
    policy half feeds :func:`tenant_policies`, which hands the scheduler
    the same ``{"budget_tokens", "priority"}`` dict the live fleet
    ships to every worker)."""

    name: str
    #: relative arrival-rate weight (normalized across tenants).
    share: float = 1.0
    #: scheduler admission priority (higher admits first; the brownout
    #: ladder sheds strictly-below-top tiers at stage 1+).
    priority: float = 0.0
    #: committed-token budget (prompt + max_new in flight); 0 = unlimited.
    budget_tokens: int = 0
    #: prompt length distribution (lognormal around the mean, tokens).
    prompt_mean: int = 48
    prompt_jitter: float = 0.4
    #: output length distribution (lognormal around the mean, tokens).
    output_mean: int = 16
    output_jitter: float = 0.4
    #: per-request SLO deadline, seconds after arrival; 0 = no deadline.
    deadline_s: float = 8.0
    deadline_jitter: float = 0.25
    #: prefix sharing: preambles per tenant pool, preamble length, and
    #: the Zipf exponent skewing draws toward the pool's head.
    prefix_pool: int = 8
    prefix_len: int = 24
    prefix_skew: float = 1.1
    #: adversarial traffic: arrivals re-clustered into submit storms
    #: every ``storm_window_s`` and deadlines squeezed.
    adversarial: bool = False
    storm_window_s: float = 5.0


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """One flash-crowd event: rate ramps linearly over ``ramp_s`` up to
    ``amplitude`` x base at ``at_s``, then decays exponentially with
    time constant ``decay_s``. The onset ramp is what makes the crowd
    *forecastable* — a zero-lead step has no trend to extrapolate."""

    at_s: float
    amplitude: float = 6.0
    ramp_s: float = 4.0
    decay_s: float = 3.0


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Workload-level knobs. Defaults describe a compressed day; scale
    ``duration_s``/``base_rps`` for million-request traces."""

    duration_s: float = 3600.0
    base_rps: float = 10.0
    #: diurnal modulation: rate *= 1 + amplitude * sin(2*pi*t/period).
    diurnal_amplitude: float = 0.4
    diurnal_period_s: float = 86400.0
    diurnal_phase: float = 0.0
    #: Poisson bursts: expected bursts/second, each a Gaussian rate bump
    #: of ``burst_amplitude`` x base and sigma ``burst_width_s``.
    burst_rate_per_s: float = 0.001
    burst_amplitude: float = 2.0
    burst_width_s: float = 20.0
    flash_crowds: tuple[FlashCrowd, ...] = ()
    tenants: tuple[TenantSpec, ...] = (TenantSpec("default"),)
    #: arrival binning resolution for the inhomogeneous Poisson draw.
    bin_s: float = 1.0


def _rate_curve(cfg: TraceConfig, t: np.ndarray, rng: np.random.Generator
                ) -> np.ndarray:
    """Requests/second at each bin center — the inhomogeneous Poisson
    intensity all regimes compose into."""
    rate = np.full_like(t, float(cfg.base_rps))
    if cfg.diurnal_amplitude > 0:
        rate *= 1.0 + cfg.diurnal_amplitude * np.sin(
            2.0 * math.pi * (t / cfg.diurnal_period_s + cfg.diurnal_phase)
        )
    n_bursts = int(rng.poisson(cfg.burst_rate_per_s * cfg.duration_s))
    for _ in range(n_bursts):
        center = float(rng.uniform(0.0, cfg.duration_s))
        rate += (
            cfg.burst_amplitude * cfg.base_rps
            * np.exp(-0.5 * ((t - center) / cfg.burst_width_s) ** 2)
        )
    for crowd in cfg.flash_crowds:
        onset = np.clip((t - (crowd.at_s - crowd.ramp_s)) / crowd.ramp_s,
                        0.0, 1.0)
        decay = np.where(
            t > crowd.at_s,
            np.exp(-(t - crowd.at_s) / max(crowd.decay_s, 1e-9)),
            1.0,
        )
        rate += crowd.amplitude * cfg.base_rps * onset * decay
    return np.maximum(rate, 0.0)


def _lognormal(rng: np.random.Generator, mean: float, jitter: float,
               n: int, lo: int, hi: int) -> np.ndarray:
    if jitter <= 0:
        return np.full(n, int(round(mean)), dtype=np.int64)
    draw = rng.lognormal(math.log(max(mean, 1.0)), jitter, n)
    return np.clip(draw.round().astype(np.int64), lo, hi)


def _preambles(rng: np.random.Generator, spec: TenantSpec) -> list[str]:
    """The tenant's shared-prefix pool: deterministic lowercase-ascii
    preambles (byte-vocab friendly — ``serve_lm`` tokenizes prompt text
    as UTF-8 bytes)."""
    out = []
    for _ in range(max(spec.prefix_pool, 1)):
        chars = rng.integers(97, 123, size=max(spec.prefix_len, 1))
        out.append(bytes(chars.tolist()).decode("ascii"))
    return out


def generate_entries(cfg: TraceConfig, seed: int) -> list[dict]:
    """Generate one trace: a list of serve_lm-schema entry dicts sorted
    by arrival. Same ``(cfg, seed)`` -> identical entries, always."""
    rng = np.random.default_rng(seed)
    n_bins = max(int(math.ceil(cfg.duration_s / cfg.bin_s)), 1)
    edges = np.arange(n_bins) * cfg.bin_s
    centers = edges + 0.5 * cfg.bin_s
    rate = _rate_curve(cfg, centers, rng)
    counts = rng.poisson(rate * cfg.bin_s)
    total = int(counts.sum())
    arrivals = np.repeat(edges, counts) + rng.random(total) * cfg.bin_s
    arrivals = np.minimum(arrivals, cfg.duration_s)

    shares = np.asarray([max(t.share, 0.0) for t in cfg.tenants], float)
    if shares.sum() <= 0:
        raise ValueError("tenant shares must sum to a positive value")
    tenant_idx = rng.choice(len(cfg.tenants), size=total,
                            p=shares / shares.sum())

    prompt_len = np.zeros(total, dtype=np.int64)
    max_new = np.zeros(total, dtype=np.int64)
    deadline = np.zeros(total, dtype=np.float64)
    prefix_choice = np.zeros(total, dtype=np.int64)
    pools: list[list[str]] = []
    for ti, spec in enumerate(cfg.tenants):
        mask = tenant_idx == ti
        n = int(mask.sum())
        pools.append(_preambles(rng, spec))
        if n == 0:
            continue
        prompt_len[mask] = _lognormal(
            rng, spec.prompt_mean, spec.prompt_jitter, n,
            lo=max(spec.prefix_len + 1, 2), hi=4 * spec.prompt_mean + 64,
        )
        max_new[mask] = _lognormal(
            rng, spec.output_mean, spec.output_jitter, n,
            lo=1, hi=4 * spec.output_mean + 16,
        )
        dl = spec.deadline_s
        if spec.adversarial:
            dl *= 0.5  # storm traffic demands tight SLOs, by design
        if dl > 0:
            deadline[mask] = dl * (
                1.0 + spec.deadline_jitter * (rng.random(n) - 0.5)
            )
        k = np.arange(1, max(spec.prefix_pool, 1) + 1, dtype=float)
        w = k ** -max(spec.prefix_skew, 0.0)
        prefix_choice[mask] = rng.choice(len(k), size=n, p=w / w.sum())
        if spec.adversarial:
            # Submit storms: quantize arrivals to the storm window's
            # leading edge (plus a small spread) — a burst of
            # simultaneous submissions every window.
            a = arrivals[mask]
            arrivals[mask] = (
                np.floor(a / spec.storm_window_s) * spec.storm_window_s
                + rng.random(n) * 0.2
            )

    # Per-request private suffix text, drawn in one vectorized block.
    suffix_len = np.maximum(
        prompt_len - np.asarray(
            [cfg.tenants[i].prefix_len for i in tenant_idx]
        ),
        1,
    )
    buf = rng.integers(97, 123, size=int(suffix_len.sum()),
                       dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(suffix_len)])
    text = bytes(buf.tolist()).decode("ascii")

    order = np.argsort(arrivals, kind="stable")
    entries: list[dict] = []
    for i in order.tolist():
        spec = cfg.tenants[tenant_idx[i]]
        preamble = pools[tenant_idx[i]][int(prefix_choice[i])]
        prompt = preamble + text[int(offsets[i]):int(offsets[i + 1])]
        e: dict = {
            "arrival": round(float(arrivals[i]), 4),
            "prompt": prompt,
            "max_new": int(max_new[i]),
            "tenant": spec.name,
        }
        if deadline[i] > 0:
            e["deadline"] = round(float(deadline[i]), 4)
        entries.append(e)
    return entries


def tenant_policies(cfg: TraceConfig) -> dict[str, dict]:
    """The scheduler/fleet ``tenants=`` dict matching this trace's
    tenant specs — budgets and priorities travel with the workload so
    sim and real-process replays enforce the same admission policy."""
    return {
        t.name: {"budget_tokens": int(t.budget_tokens),
                 "priority": float(t.priority)}
        for t in cfg.tenants
    }


def to_fleet_entries(entries: Iterable[dict]) -> list[dict]:
    """Convert serve_lm-schema entries (prompt as text) to the tokenized
    form ``FleetSupervisor.run`` takes directly: prompt as a list of
    UTF-8 byte token ids — exactly the ``serve_lm._load_trace``
    tokenization, so both replay paths see identical token streams."""
    out = []
    for e in entries:
        fe = dict(e)
        fe["prompt"] = [
            int(b) for b in str(e["prompt"]).encode("utf-8")
        ]
        out.append(fe)
    return out


def write_jsonl(entries: Iterable[dict], path: str | Path) -> Path:
    """Serialize a trace to the serve_lm JSONL replay schema. Key order
    is fixed per entry, so the same entries always produce byte-identical
    files (the determinism test hashes the output)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:  # dmt-lint: disable=DMT005 — trace file generator is its single writer (fresh artifact, not a live IPC stream)
        for e in entries:
            fh.write(json.dumps(e, sort_keys=True) + "\n")
    return path


def trace_digest(entries: Iterable[dict]) -> str:
    """Short content digest of a trace — the sweep DB keys winners by it
    so tuned parameters only apply to the workload they were tuned on."""
    h = hashlib.sha256()
    for e in entries:
        h.update(json.dumps(e, sort_keys=True).encode())
        h.update(b"\n")
    return h.hexdigest()[:12]
