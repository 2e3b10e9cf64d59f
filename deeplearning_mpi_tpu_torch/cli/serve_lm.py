"""Serve a Poisson trace through the engine; with ``--selftest``, check parity.

Port of ``deeplearning_mpi_tpu/cli/serve_lm.py``: a model serves a seeded
synthetic Poisson trace through the continuous-batching engine. The model
is restored from a ``train_lm`` checkpoint with ``--model_dir`` (a
params-only restore behind the ``arch.json`` check, as ``cli.generate``
does), else it is a seeded random init. ``--selftest`` holds every
completed stream to the port's offline greedy ``generate`` of the same
prompt token for token — co-batched strangers, chunked prefill, paged KV
and slot churn must all be invisible in the tokens; without it the
completions are printed. Reports TTFT (arrival -> first token) and TPOT
(decode seconds per token after the first).

The reference's engine flags: ``--kv_dtype int8`` (int8 KV pools; lossy,
so ``--selftest`` gates on the share of tokens matching the float stream,
``--kv_acceptance_min``, and reports the float model's top-2 logit gap
where a stream diverges), ``--prefix_cache``, ``--spec_k N
--draft_layers M`` (a self-draft of the target's first M layers; the
selftest also reconciles the speculative counters; ``--tuning_db DB``
installs the tuning DB and, without ``--spec_k``, takes its ``spec_k``
entry for this model and draft, ``cli.autotune --spec_k``), ``--warmup`` (CUDA
graphs before traffic; the selftest checks that traffic captured
nothing), ``--decode_buckets`` and ``--max_hold_steps``.

The reference's trace and telemetry flags: ``--trace FILE`` replays a JSONL
trace instead of the Poisson one (one object a line: ``{"arrival":
seconds-from-start, "prompt": "text", "max_new": N, "deadline":
seconds-after-arrival, "tenant": name}``, only ``prompt`` required; the
prompt's UTF-8 bytes are its tokens), ``--deadline S`` sheds a request
still queued ``S`` seconds after its arrival (a trace entry may override),
and ``--metrics_file`` appends the engine's canonical telemetry records
(the ``serve_*`` counters, TTFT / TPOT histograms and gauges, one
``serve_summary`` record at the end) for ``tools/metrics_report.py``.
``--tenants 'prod=4096:1,batch=1024:0'`` sets per-tenant token budgets and
priorities (``name=budget_tokens[:priority]``).

The resilience flags: ``--disagg`` serves through the disaggregated
prefill / decode pair (``serving/disagg.py``); ``--chaos`` (or
``$DMT_CHAOS``) plans faults, validated per workload as the reference
does: ``serve_crash`` in one engine, also ``handoff_stall`` with
``--disagg``, ``replica_kill`` / ``replica_hang`` / ``replica_slow`` in a
fleet, also ``load_spike`` / ``scale_during_failure`` with ``--autoscale``;
the supervisor kinds are refused (this process is the supervisor and
nothing restarts it). ``--replicas N`` (or ``--autoscale``) serves the
trace through a supervised fleet of replica processes
(``serving/fleet.py``) with ``--hedge_ms``, ``--swap_at`` (a rolling hot
weight swap to the init of ``--random_seed + 1``), ``--min_replicas`` /
``--max_replicas``, ``--autoscale_predictive`` with the ``--forecast_*``
knobs and ``--fleet_dir``, and holds every completion bit-exactly to
offline greedy under its weight version. Fleet mode refuses
``--kv_dtype`` (its bar is bit-exact) and ``--spec_k``, and ``--tp``
(ROADMAP Queue 1 item 8.6).

    python -m deeplearning_mpi_tpu_torch.cli.serve_lm --selftest            # on the GPU
    python -m deeplearning_mpi_tpu_torch.cli.serve_lm --selftest --metrics_file serve.jsonl
    python -m deeplearning_mpi_tpu_torch.cli.serve_lm --selftest --device cpu \\
        --num_layers 2 --num_heads 2 --head_dim 8 --d_model 16 --d_ff 32 [--model_dir DIR] \\
        [--kv_dtype int8] [--prefix_cache] [--spec_k 2 --draft_layers 1] [--warmup] \\
        [--disagg] [--chaos serve_crash@step:3]
    python -m deeplearning_mpi_tpu_torch.cli.serve_lm --selftest --device cpu --num_layers 2 \\
        --replicas 2 --chaos replica_kill@step:4,replica_hang@step:6 --swap_at 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.utils.config import ema_decay


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="serve_lm",
        description="Replay a Poisson request trace through the continuous-"
        "batching engine and check every stream against offline greedy decode.",
    )
    model = parser.add_argument_group("model")
    model.add_argument("--vocab_size", type=int, default=256)
    model.add_argument("--num_layers", type=int, default=4)
    model.add_argument("--num_heads", type=int, default=8)
    model.add_argument("--num_kv_heads", type=int, default=0,
                       help="grouped-query K/V heads (0 = num_heads)")
    model.add_argument("--head_dim", type=int, default=32)
    model.add_argument("--d_model", type=int, default=256)
    model.add_argument("--d_ff", type=int, default=1024)
    model.add_argument("--attention_window", type=int, default=0)
    model.add_argument("--moe_experts", type=int, default=0,
                       help="accepted to be refused: serving is dense-MLP only")
    model.add_argument("--moe_top_k", type=int, default=2)
    model.add_argument("--moe_routing", default="token_choice",
                       choices=("token_choice", "expert_choice"))
    model.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ckpt = parser.add_argument_group(
        "checkpoint (model flags MUST match the training run)")
    ckpt.add_argument("--model_dir", default=None,
                      help="serve the weights of a train_lm checkpoint under "
                      "<model_dir>/<model_filename> (default: a random init)")
    ckpt.add_argument("--model_filename", default="lm")
    ckpt.add_argument("--epoch", type=int, default=None,
                      help="checkpoint epoch to serve (default: latest)")
    ckpt.add_argument("--ema", type=ema_decay, default=0.0,
                      help="nonzero: serve the EMA weights of an --ema run")
    eng = parser.add_argument_group("engine")
    eng.add_argument("--max_slots", type=int, default=4)
    eng.add_argument("--block_size", type=int, default=16)
    eng.add_argument("--num_blocks", type=int, default=64)
    eng.add_argument("--max_blocks_per_seq", type=int, default=8)
    eng.add_argument("--prefill_chunk", type=int, default=16)
    eng.add_argument("--max_queue", type=int, default=64)
    eng.add_argument("--kv_dtype", default=None, choices=("int8",),
                     help="KV pool storage (default: the compute dtype); int8 stores "
                     "per-(token, head) scales and is lossy, so --selftest gates on "
                     "token acceptance against the float stream")
    eng.add_argument("--kv_acceptance_min", type=float, default=0.9,
                     help="least share of tokens matching offline greedy (matched "
                     "prefix / expected) that --selftest accepts under --kv_dtype")
    eng.add_argument("--prefix_cache", action="store_true",
                     help="radix prefix cache: later requests adopt the KV blocks of a "
                     "cached prompt prefix (refcounted, copy-on-write)")
    eng.add_argument("--warmup", action="store_true",
                     help="capture the decode-path programs as CUDA graphs (one per "
                     "gather width) before traffic")
    eng.add_argument("--decode_buckets", default="",
                     help="comma-separated decode batch buckets, e.g. '4,8': hold the "
                     "decode phase while supply can still reach a larger bucket")
    eng.add_argument("--max_hold_steps", type=int, default=4,
                     help="most consecutive steps decode may be held for a bucket")
    eng.add_argument("--disagg", action="store_true",
                     help="disaggregated topology: a prefill-only engine hands completed "
                     "prompts (block tables over a shared KV pool, no KV bytes move) to a "
                     "decode-only engine; with --replicas every replica runs disaggregated")
    eng.add_argument("--tenants", default="",
                     help="per-tenant admission policy, e.g. 'prod=4096:1,batch=1024:0': "
                     "name=budget_tokens[:priority] (0 tokens = unlimited; over-budget "
                     "submits are shed as tenant_budget; higher priority admits first)")
    spec = parser.add_argument_group("speculative decoding (exact-greedy-match acceptance)")
    spec.add_argument("--spec_k", type=int, default=None,
                      help="draft tokens proposed per sequence per step (0 = off; -1, or not "
                      "given with --tuning_db: the tuning DB's spec_k winner for this "
                      "model/draft pair; default 0)")
    spec.add_argument("--tuning_db", default=None,
                      help="tuning DB (cli.autotune output), installed as the process default; "
                      "without --spec_k its spec_k entry for this model and --draft_layers "
                      "sets the proposal depth")
    spec.add_argument("--draft_layers", type=int, default=0,
                      help="self-draft: the target's first N layers (needed by --spec_k)")
    spec.add_argument("--draft_d_model", type=int, default=None,
                      help="custom draft width: a random-init draft of --draft_layers layers "
                      "instead of the target's truncation (parity still holds: the draft "
                      "only proposes, the target decides)")
    spec.add_argument("--draft_d_ff", type=int, default=None)
    spec.add_argument("--draft_heads", type=int, default=None)
    spec.add_argument("--draft_head_dim", type=int, default=None,
                      help="on the card K4 runs the draft's decode at this head dim; it must "
                      "be one K4 was compiled for (else the wrapper's refusal)")
    spec.add_argument("--draft_seed", type=int, default=0,
                      help="init seed for a custom-width draft")
    trace = parser.add_argument_group("trace")
    trace.add_argument("--trace", default=None,
                       help="JSONL request trace (module docstring); default: a synthetic "
                       "Poisson trace")
    trace.add_argument("--rate", type=float, default=20.0, help="Poisson arrivals, requests/s")
    trace.add_argument("--num_requests", type=int, default=16)
    trace.add_argument("--prompt_len_min", type=int, default=4)
    trace.add_argument("--prompt_len_max", type=int, default=24)
    trace.add_argument("--max_new_tokens", type=int, default=16)
    trace.add_argument("--deadline", type=float, default=0.0,
                       help="seconds after arrival a still-queued request is shed (0 = none; "
                       "trace entries may override)")
    trace.add_argument("--eos_id", type=int, default=-1, help="token that ends a stream (-1 = off)")
    trace.add_argument("--random_seed", type=int, default=0)
    parser.add_argument("--selftest", action="store_true",
                        help="check every stream against offline greedy decode; exit 0 "
                        "iff all match")
    parser.add_argument("--metrics_file", default=None,
                        help="append canonical telemetry JSONL records here (readable by "
                        "tools/metrics_report.py)")
    fleet = parser.add_argument_group(
        "fleet (supervised replica processes behind the SLO-aware router)")
    fleet.add_argument("--replicas", type=int, default=1,
                       help="serve through N supervised replica processes (1 = one "
                       "in-process engine); fleet mode implies --selftest semantics (a "
                       "random-init model, parity against offline greedy)")
    fleet.add_argument("--autoscale", action="store_true",
                       help="closed-loop fleet sizing from measured load, with hysteresis, "
                       "cooldown, the --min_replicas floor and the brownout ladder; implies "
                       "fleet mode even with --replicas 1")
    fleet.add_argument("--autoscale_predictive", action="store_true",
                       help="arm scale-up on the forecast load one --forecast_horizon_s "
                       "ahead (EWMA level and trend); implies --autoscale")
    fleet.add_argument("--forecast_horizon_s", type=float, default=3.0,
                       help="how far ahead the forecaster projects")
    fleet.add_argument("--forecast_tau_s", type=float, default=1.0,
                       help="EWMA time constant of the forecast load level")
    fleet.add_argument("--forecast_trend_tau_s", type=float, default=1.0,
                       help="EWMA time constant of the forecast load trend")
    fleet.add_argument("--min_replicas", type=int, default=1,
                       help="autoscaler floor (scale-down is vetoed at it)")
    fleet.add_argument("--max_replicas", type=int, default=4,
                       help="autoscaler ceiling (overload there climbs the brownout ladder)")
    fleet.add_argument("--hedge_ms", type=float, default=0.0,
                       help="a request outstanding this long (with deadline budget left) is "
                       "duplicated on a second replica; the first completion wins (0 = off)")
    fleet.add_argument("--swap_at", type=int, default=None,
                       help="after N completions, hot-swap every replica's weights (rolling "
                       "drain, in place) to the init of --random_seed + 1")
    fleet.add_argument("--fleet_dir", default=None,
                       help="directory for replica mailboxes, heartbeats and logs (default: "
                       "a fresh temporary directory)")
    fleet.add_argument("--tp", type=int, default=1,
                       help="tensor-parallel degree per replica: refused above 1 (ROADMAP "
                       "Queue 1 item 8.6)")
    parser.add_argument("--chaos", default=None,
                        help="fault plan, e.g. 'serve_crash@step:12' (the engine crashes "
                        "mid-step and recovers); with --disagg also 'handoff_stall@step:N'; "
                        "with --replicas 'replica_kill@step:4,replica_hang@step:6'; with "
                        "--autoscale also load_spike / scale_during_failure; falls back to "
                        "$DMT_CHAOS")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    from deeplearning_mpi_tpu_torch.utils.config import add_not_applicable

    add_not_applicable(parser, "platform", "use_kernel")
    return parser


def build_draft(args, model):
    """The draft of ``--spec_k``: the target's first ``--draft_layers``
    layers, or with any ``--draft_*`` width a random-init model of that
    depth and those widths from ``--draft_seed``, as the reference builds
    it (``draft_config``); None without ``--spec_k``."""
    if not args.spec_k:
        return None
    from deeplearning_mpi_tpu_torch.models.transformer import (
        TransformerLM,
        draft_config,
        self_draft,
    )

    overrides = {k: v for k, v in (("d_model", args.draft_d_model), ("d_ff", args.draft_d_ff),
                                   ("num_heads", args.draft_heads),
                                   ("head_dim", args.draft_head_dim)) if v is not None}
    if not overrides:
        return self_draft(model, args.draft_layers)
    return TransformerLM(draft_config(model.config, args.draft_layers, **overrides),
                         dtype=model.dtype, device=model.device).init_weights(args.draft_seed)


def _parse_tenants(spec: str):
    """``'prod=4096:1,batch=1024:0'`` -> the scheduler's tenants dict
    (``{name: {"budget_tokens": int, "priority": float}}``), or None for an
    empty spec; a bad entry raises ``SystemExit``."""
    spec = spec.strip()
    if not spec:
        return None
    tenants = {}
    for part in spec.split(","):
        part = part.strip()
        try:
            name, policy = part.split("=", 1)
            budget, _, priority = policy.partition(":")
            tenants[name.strip()] = {
                "budget_tokens": int(budget),
                "priority": float(priority) if priority else 0.0,
            }
        except ValueError:
            raise SystemExit(f"bad --tenants entry {part!r}: expected "
                             "name=budget_tokens[:priority]")
    return tenants


def poisson_trace(args) -> list[dict]:
    """Seeded Poisson arrivals with uniform prompt lengths (tokens 1..vocab-1)."""
    rng = np.random.default_rng(args.random_seed)
    t = 0.0
    entries = []
    for _ in range(args.num_requests):
        t += float(rng.exponential(1.0 / args.rate))
        n = int(rng.integers(args.prompt_len_min, args.prompt_len_max + 1))
        entries.append({
            "arrival": t,
            "prompt": rng.integers(1, args.vocab_size, size=n).astype(np.int32),
            "max_new": args.max_new_tokens,
            "deadline": args.deadline,
        })
    return entries


def load_trace(path: str, default_max_new: int, default_deadline: float) -> list[dict]:
    """The reference's JSONL trace (module docstring) as replay entries,
    sorted by arrival; a bad line or an empty file raises ``SystemExit``."""
    entries = []
    try:
        lines = Path(path).read_text(encoding="utf-8").splitlines()
    except OSError as e:
        raise SystemExit(f"cannot read --trace: {e}")
    for n, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
            text = obj["prompt"]
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            raise SystemExit(f"{path}:{n}: bad trace entry ({e})")
        entries.append({
            "arrival": float(obj.get("arrival", 0.0)),
            "prompt": np.frombuffer(text.encode("utf-8") or b"\x00", np.uint8).astype(np.int32),
            "max_new": int(obj.get("max_new", default_max_new)),
            "deadline": float(obj.get("deadline", default_deadline)),
            "tenant": str(obj.get("tenant", "default")),
        })
    if not entries:
        raise SystemExit(f"{path}: empty trace")
    return sorted(entries, key=lambda e: e["arrival"])


def replay(engine, entries, *, poll_s: float = 0.0005):
    """Submit each entry at its arrival offset (wall clock), with its
    deadline (seconds after arrival; 0 or absent: none) and tenant, and step
    the engine until everything drains; an injected crash is recovered in
    place. Returns (requests, wall seconds)."""
    from deeplearning_mpi_tpu_torch.resilience.faults import InjectedFault

    # A disaggregated pair is idle when both roles and the handoff queue are.
    idle = engine.idle if hasattr(engine, "idle") else engine.scheduler.idle
    pending = deque(entries)
    reqs = []
    t0 = time.monotonic()
    while pending or not idle():
        now = time.monotonic() - t0
        while pending and pending[0]["arrival"] <= now:
            e = pending.popleft()
            deadline = e.get("deadline", 0.0)
            reqs.append(engine.submit(
                e["prompt"], e["max_new"], arrival=t0 + e["arrival"],
                deadline=t0 + e["arrival"] + deadline if deadline > 0 else None,
                tenant=e.get("tenant", "default")))
        if not idle():
            try:
                engine.step()
            except InjectedFault as fault:
                print(f"chaos: {fault} — recovering", file=sys.stderr)
                engine.recover()
        elif pending:
            time.sleep(min(poll_s, max(pending[0]["arrival"] - now, 0.0)))
    return reqs, time.monotonic() - t0


def latency_report(reqs, wall_s: float) -> dict:
    """TTFT / TPOT percentiles (seconds) and throughput over the finished
    requests."""
    from deeplearning_mpi_tpu_torch.serving import RequestState

    done = [r for r in reqs if r.state is RequestState.FINISHED]
    ttft = np.array([r.ttft for r in done]) if done else np.zeros(0)
    tpot = np.array([r.tpot for r in done if len(r.generated) > 1])
    tokens = sum(len(r.generated) for r in done)

    def pct(a, q):
        return float(np.percentile(a, q)) if a.size else None

    return {
        "requests": len(reqs), "completed": len(done), "tokens": tokens,
        "wall_s": wall_s, "tokens_per_s": tokens / wall_s if wall_s > 0 else None,
        "ttft_p50_s": pct(ttft, 50), "ttft_p95_s": pct(ttft, 95),
        "tpot_p50_s": pct(tpot, 50), "tpot_p95_s": pct(tpot, 95),
    }


def offline_greedy(model, prompt: np.ndarray, max_new: int, eos_id: int | None) -> list[int]:
    """The parity oracle: offline prefill + decode of one prompt, cut after
    the first EOS (offline pads with EOS; the engine stops)."""
    from deeplearning_mpi_tpu_torch.models.generate import generate

    out = generate(
        model, torch.as_tensor(prompt, dtype=torch.long, device=model.device)[None],
        max_new_tokens=max_new, temperature=0.0, eos_id=eos_id,
    )
    expect = out[0, len(prompt):].tolist()
    if eos_id is not None and eos_id in expect:
        expect = expect[: expect.index(eos_id) + 1]
    return expect


def first_divergence(model, prompt: np.ndarray, got: list[int], want: list[int]) -> str:
    """Where a stream first leaves the expected one: the step, both tokens,
    and ``model``'s top-2 logit gap there (how close the expected stream
    was to a tie)."""
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    ctx = np.concatenate([prompt, np.asarray(want[:i], np.int32)])
    with torch.no_grad():
        logits = model(torch.as_tensor(ctx, dtype=torch.long, device=model.device)[None])[0, -1]
    top2 = torch.topk(logits, 2).values
    return (f"step {i}: engine {got[i]} expected {want[i]}, top-2 logit gap there "
            f"{float(top2[0] - top2[1]):.3e}")


def chaos_workload(args) -> tuple[frozenset[str], str]:
    """The chaos kinds ``serve_lm``'s workload has a hook for, and its
    name. The supervisor kinds are in none: this process is the supervisor
    and nothing restarts it."""
    from deeplearning_mpi_tpu_torch.resilience.faults import (
        AUTOSCALE_KINDS,
        DISAGG_KINDS,
        FLEET_KINDS,
        SERVE_KINDS,
    )

    if args.autoscale:
        return FLEET_KINDS | AUTOSCALE_KINDS, "autoscaled serving fleet"
    if args.replicas > 1:
        return FLEET_KINDS, "serving fleet"
    if args.disagg:
        return DISAGG_KINDS, "disaggregated serving"
    return SERVE_KINDS, "single-replica serving"


def _worker_threads(args) -> int | None:
    """A CPU fleet's torch threads a worker: this process's, split over the
    most replicas the fleet may run (None on the card)."""
    if args.device != "cpu":
        return None
    most = max(args.replicas, args.max_replicas if args.autoscale else 1)
    return max(1, torch.get_num_threads() // most)


def _run_fleet(args, eos_id) -> int:
    """``--replicas N`` (or ``--autoscale``): route the trace through a
    supervised replica fleet, then hold every completion to offline greedy
    under the weights of its version, bit for bit, failed-over and hedged
    requests included."""
    import tempfile

    from deeplearning_mpi_tpu_torch.serving import FleetFailure, FleetSupervisor
    from deeplearning_mpi_tpu_torch.telemetry import JsonlSink, MetricsRegistry

    model_spec = {
        "vocab_size": args.vocab_size, "num_layers": args.num_layers,
        "num_heads": args.num_heads, "num_kv_heads": args.num_kv_heads or None,
        "head_dim": args.head_dim, "d_model": args.d_model, "d_ff": args.d_ff,
        "attention_window": args.attention_window,
    }
    engine_spec = {
        "max_slots": args.max_slots, "block_size": args.block_size,
        "num_blocks": args.num_blocks, "max_blocks_per_seq": args.max_blocks_per_seq,
        "prefill_chunk": args.prefill_chunk, "max_queue": args.max_queue,
        "prefix_cache": args.prefix_cache,
    }
    try:
        entries = (load_trace(args.trace, args.max_new_tokens, args.deadline) if args.trace
                   else poisson_trace(args))
        tenants = _parse_tenants(args.tenants)
    except SystemExit as refusal:
        print(refusal.code, file=sys.stderr)
        return 1
    for e in entries:
        e["prompt"] = [int(t) for t in e["prompt"]]
    fleet_dir = args.fleet_dir or tempfile.mkdtemp(prefix="dmt_fleet_")
    registry = MetricsRegistry()
    if args.metrics_file:
        registry.add_sink(JsonlSink(args.metrics_file))
    autoscale = None
    if args.autoscale:
        from deeplearning_mpi_tpu_torch.serving import AutoscalerConfig

        autoscale = AutoscalerConfig(
            min_replicas=args.min_replicas, max_replicas=args.max_replicas,
            predictive=args.autoscale_predictive,
            forecast_horizon_s=args.forecast_horizon_s, forecast_tau_s=args.forecast_tau_s,
            forecast_trend_tau_s=args.forecast_trend_tau_s,
        )
    sup = FleetSupervisor(
        model_spec, engine_spec, args.replicas, fleet_dir, seed=args.random_seed,
        eos_id=eos_id, warmup=True, chaos=args.chaos, hedge_ms=args.hedge_ms,
        registry=registry, disagg=args.disagg, tenants=tenants, autoscale=autoscale,
        device=args.device, threads=_worker_threads(args),
    )
    swap_seed = args.random_seed + 1 if args.swap_at is not None else None
    try:
        result = sup.run(entries, swap_at=args.swap_at, swap_seed=swap_seed)
    except FleetFailure as e:
        print(f"fleet FAILED: {e} (logs under {fleet_dir})", file=sys.stderr)
        return 1
    shed = ", ".join(f"{n} {why}" for why, n in sorted(result.shed.items()))
    print(f"fleet: {result.completed} completed, {sum(result.shed.values())} shed"
          + (f" ({shed})" if shed else "")
          + f", {result.dropped} dropped | {result.redispatched} re-dispatched across "
          f"{result.restarts} restart(s)", file=sys.stderr)
    snap = result.snapshot
    if snap.get("serve_hedge_total", 0):
        parts = [f"{snap[k]:.0f} {k.split('=', 1)[1].strip(chr(34) + '}')}"
                 for k in sorted(snap) if k.startswith("serve_hedge_total{")]
        print("hedges: " + ", ".join(parts), file=sys.stderr)
    if result.scale:
        sc = result.scale
        print(f"autoscale: {sc['spawned']} spawned, {sc['retired']} retired, "
              f"{sc['vetoed']} vetoed ({sc['events']} decisions), brownout max stage "
              f"{sc['brownout_stage_max']}, final fleet {sc['replicas_final']}",
              file=sys.stderr)
    if result.swap["requested"]:
        drain = result.swap["drain_s"]
        print(f"swap: performed={result.swap['performed']} "
              f"drain={drain and round(drain, 2)}s "
              f"completions_during={result.swap['completions_during']} "
              f"compile_flat={result.swap['compile_flat']} "
              f"in_place={result.swap['in_place']}", file=sys.stderr)
    print(f"fleet workers: {json.dumps(result.workers, sort_keys=True)}", file=sys.stderr)
    versions: dict[int, int] = {}
    for rec in result.requests.values():
        versions[rec["version"]] = versions.get(rec["version"], 0) + 1
    print(f"fleet versions: {json.dumps(versions, sort_keys=True)}", file=sys.stderr)
    registry.close()

    # Parity: each weight version rebuilt from (config, seed) on the same
    # device, TF32 off as in the workers.
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(**model_spec)
    models = {}

    def version_model(version: int):
        if version not in models:
            seed = args.random_seed if version == 0 else swap_seed
            models[version] = TransformerLM(cfg, dtype=torch.float32,
                                            device=args.device).init_weights(seed)
        return models[version]

    mismatched = 0
    for rid, rec in sorted(result.requests.items()):
        expect = offline_greedy(version_model(rec["version"]),
                                np.asarray(rec["prompt"], np.int32), rec["max_new"], eos_id)
        if rec["tokens"] != expect:
            mismatched += 1
            print(f"fleet parity: rid {rid} (version {rec['version']}) diverged from offline "
                  f"greedy:\n  fleet  : {rec['tokens']}\n  offline: {expect}",
                  file=sys.stderr)
    if mismatched or not result.ok:
        print(f"fleet FAILED: ok={result.ok} (dropped={result.dropped}, compile_flat="
              f"{result.compile_flat}, chaos_balanced={result.chaos_balanced}, swap in place="
              f"{result.swap['in_place']}), {mismatched} parity mismatch(es); logs under "
              f"{fleet_dir}", file=sys.stderr)
        return 1
    peak = args.replicas + (result.scale["spawned"] if result.scale else 0)
    print(f"fleet OK: {result.completed} requests bit-identical to offline greedy across "
          f"{peak} replica(s)", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.autoscale_predictive:
        args.autoscale = True  # predictive is a mode of the autoscaler
    fleet = args.replicas > 1 or args.autoscale
    eos_id = args.eos_id if args.eos_id >= 0 else None
    # A kind this workload has no hook for would never fire and its books
    # could never balance: refuse it.
    chaos_spec = args.chaos or os.environ.get("DMT_CHAOS") or ""
    if chaos_spec.strip():
        from deeplearning_mpi_tpu_torch.resilience.faults import validate_plan_kinds

        supported, workload = chaos_workload(args)
        try:
            validate_plan_kinds(chaos_spec, supported, workload=workload)
        except ValueError as e:
            print(f"--chaos: {e}", file=sys.stderr)
            return 1
    if fleet:
        from deeplearning_mpi_tpu_torch.serving.fleet import TP_REPLICA_REASON

        refusal = None
        if args.tp > 1:
            refusal = TP_REPLICA_REASON
        elif args.kv_dtype:
            refusal = "--kv_dtype does not compose with fleet mode: fleet parity is bit-exact"
        elif args.spec_k:
            refusal = "--replicas > 1 does not compose with --spec_k yet"
        elif args.model_dir is not None:
            refusal = ("fleet mode serves a seeded random init (its replicas rebuild the "
                       "weights from (config, seed)); --model_dir is not served by a fleet")
        if refusal:
            print(refusal, file=sys.stderr)
            return 1
        return _run_fleet(args, eos_id)
    if not args.selftest and args.model_dir is None:
        print("serve_lm needs --model_dir (a checkpoint to serve) or --selftest",
              file=sys.stderr)
        return 2
    if args.tp > 1:
        print("--tp > 1 shards replica processes; it requires --replicas > 1 (and "
              "tensor-parallel replicas are ROADMAP Queue 1 item 8.6)", file=sys.stderr)
        return 1
    if args.moe_experts > 0:
        # The engine would raise anyway, but before the restore.
        print("serving is dense-MLP only: MoE capacity routing makes a token's output "
              "depend on co-batched strangers, breaking the engine's request-independence "
              "contract", file=sys.stderr)
        return 1
    if args.spec_k and args.draft_layers < 1:
        print("--spec_k needs a draft model: pass --draft_layers N (the target's first N "
              "layers)", file=sys.stderr)
        return 1
    try:
        decode_buckets = tuple(int(b) for b in args.decode_buckets.split(",") if b.strip())
    except ValueError:
        print(f"bad --decode_buckets {args.decode_buckets!r}: expected comma-separated "
              "integers like '4,8'", file=sys.stderr)
        return 1
    from deeplearning_mpi_tpu_torch import resolve_device
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.resilience.faults import ChaosInjector
    from deeplearning_mpi_tpu_torch.serving import (
        DisaggregatedEngine,
        EngineConfig,
        RequestState,
        ServingEngine,
    )
    from deeplearning_mpi_tpu_torch.telemetry import JsonlSink, MetricsRegistry
    from deeplearning_mpi_tpu_torch.utils.config import restore_lm

    try:
        tenants = _parse_tenants(args.tenants)
    except SystemExit as refusal:
        print(refusal.code, file=sys.stderr)
        return 1
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, num_kv_heads=args.num_kv_heads or None,
        head_dim=args.head_dim, d_model=args.d_model, d_ff=args.d_ff,
        attention_window=args.attention_window,
    )
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.tuning_db:
        from deeplearning_mpi_tpu_torch.compiler.autotune import set_default_db

        set_default_db(args.tuning_db)
    if args.spec_k == -1 or (args.spec_k is None and args.tuning_db and args.draft_layers):
        from deeplearning_mpi_tpu_torch.compiler.autotune import tuned_spec_k

        tuned = tuned_spec_k(cfg, args.draft_layers, dtype)
        args.spec_k = tuned["spec_k"] if tuned else 0
        note = (f"tuned accept_rate {tuned['accept_rate']}" if tuned
                else "no spec_k entry for this model/draft: disabled")
        print(f"spec_k from tuning DB: {args.spec_k} ({note})", file=sys.stderr)
    args.spec_k = args.spec_k or 0
    if args.model_dir is None:
        model = TransformerLM(cfg, dtype=dtype, device=args.device).init_weights(args.random_seed)
    else:
        try:
            model = restore_lm(cfg, dtype=dtype, device=resolve_device(args.device),
                               model_dir=args.model_dir, model_filename=args.model_filename,
                               epoch=args.epoch, ema=args.ema > 0)
        except SystemExit as refusal:
            print(refusal.code, file=sys.stderr)
            return 1
    registry = MetricsRegistry()
    if args.metrics_file:
        registry.add_sink(JsonlSink(args.metrics_file))
    chaos = ChaosInjector.from_spec(args.chaos, registry=registry)
    engine_cls = DisaggregatedEngine if args.disagg else ServingEngine
    engine = engine_cls(model, EngineConfig(
        max_slots=args.max_slots, block_size=args.block_size,
        num_blocks=args.num_blocks, max_blocks_per_seq=args.max_blocks_per_seq,
        prefill_chunk=args.prefill_chunk, max_queue=args.max_queue,
        spec_k=args.spec_k, decode_buckets=decode_buckets,
        max_hold_steps=args.max_hold_steps, kv_dtype=args.kv_dtype,
        prefix_cache=args.prefix_cache,
    ), eos_id=eos_id, draft=build_draft(args, model),
        registry=registry, chaos=chaos, tenants=tenants)
    if args.warmup:
        t_warm = time.monotonic()
        built = engine.warmup()
        print(f"warmup: {engine.captures} programs {built} in "
              f"{time.monotonic() - t_warm:.2f}s", file=sys.stderr)
    captures = engine.captures
    try:
        entries = (load_trace(args.trace, args.max_new_tokens, args.deadline) if args.trace
                   else poisson_trace(args))
    except SystemExit as refusal:
        print(refusal.code, file=sys.stderr)
        return 1
    reqs, wall_s = replay(engine, entries)
    if chaos is not None:
        print(chaos.summary(), file=sys.stderr)
    if args.disagg:
        c = engine.counters
        print(f"disagg: {c['serve_handoffs_total']} prefill->decode handoffs, "
              f"{c['serve_handoff_stalls_total']} stalled step(s)", file=sys.stderr)
    registry.emit("serve_summary", registry.snapshot())
    registry.close()
    rep = latency_report(reqs, wall_s)
    ms = {k: (f"{v * 1e3:.2f}" if v is not None else "n/a")
          for k, v in rep.items() if k.endswith("_s") and k != "wall_s"}
    print(
        f"requests: {rep['requests']} submitted, {rep['completed']} completed | "
        f"{rep['tokens']} tokens in {wall_s:.3f}s on {args.device} | TTFT p50/p95 "
        f"{ms['ttft_p50_s']}/{ms['ttft_p95_s']} ms | TPOT p50/p95 "
        f"{ms['tpot_p50_s']}/{ms['tpot_p95_s']} ms | {engine.decode_steps} decode "
        f"steps, {engine.prefill_chunks} prefill chunks",
        file=sys.stderr,
    )
    shed = [r for r in reqs if r.state is RequestState.SHED]
    if shed:
        reasons = sorted({r.shed_reason for r in shed})
        print(f"shed: {len(shed)} ("
              + ", ".join(f"{sum(r.shed_reason == why for r in shed)} {why}" for why in reasons)
              + ")", file=sys.stderr)
    if not args.selftest:
        for r in reqs:
            if r.state is RequestState.FINISHED:
                text = np.asarray(r.generated, np.uint8).tobytes().decode("utf-8", errors="replace")
                print(f"[{r.rid}] {text!r}")
        return 0
    bad = [(r.rid, r.state.value, r.shed_reason) for r in reqs
           if r.state is not RequestState.FINISHED]
    if bad:
        print(f"selftest: not all requests completed: {bad}", file=sys.stderr)
        return 1
    if chaos is not None and not chaos.balanced():
        print(f"selftest FAILED: chaos books unbalanced: {chaos.summary()}", file=sys.stderr)
        return 1
    if engine.captures != captures:
        print(f"selftest FAILED: traffic captured {engine.captures - captures} program(s) "
              "after warmup", file=sys.stderr)
        return 1
    kv_lossy = args.kv_dtype is not None
    mismatched = expected = accepted = 0
    for r in reqs:
        expect = offline_greedy(model, r.prompt, r.max_new_tokens, eos_id)
        # Greedy streams fork for good at their first difference, so the
        # matched prefix is the acceptance measure of a lossy KV cache.
        agree = next((j for j, (a, b) in enumerate(zip(r.generated, expect)) if a != b),
                     min(len(r.generated), len(expect)))
        expected += len(expect)
        accepted += agree
        if r.generated == expect:
            continue
        mismatched += 1
        if kv_lossy:
            print(f"selftest: rid {r.rid} leaves offline greedy at "
                  f"{first_divergence(model, r.prompt, r.generated, expect)}",
                  file=sys.stderr)
        else:
            print(f"selftest: rid {r.rid} diverged from offline greedy:\n"
                  f"  engine : {r.generated}\n  offline: {expect}", file=sys.stderr)
    if kv_lossy:
        acceptance = accepted / max(expected, 1)
        if acceptance < args.kv_acceptance_min:
            print(f"selftest FAILED: {args.kv_dtype} KV acceptance {acceptance:.1%} "
                  f"({accepted}/{expected} tokens match the float stream) below the "
                  f"--kv_acceptance_min {args.kv_acceptance_min:.1%} gate", file=sys.stderr)
            return 1
        print(f"selftest {args.kv_dtype} KV: acceptance {acceptance:.1%} ({accepted}/"
              f"{expected} tokens, {mismatched} stream(s) diverged) >= "
              f"{args.kv_acceptance_min:.1%} gate", file=sys.stderr)
    elif mismatched:
        print(f"selftest FAILED: {mismatched}/{len(reqs)} request(s) diverged", file=sys.stderr)
        return 1
    if args.spec_k:
        c = engine.counters
        prop, acc, rb = (c[f"spec_{k}_total"] for k in ("proposed", "accepted", "rollback"))
        if prop != acc + rb:
            print(f"selftest FAILED: speculative counters do not reconcile: proposed {prop} "
                  f"!= accepted {acc} + rolled back {rb}", file=sys.stderr)
            return 1
        if not prop or not acc:
            print(f"selftest FAILED: speculative path inert (proposed {prop}, accepted "
                  f"{acc}): the draft should land at least some exact matches",
                  file=sys.stderr)
            return 1
        print(f"selftest speculative: {prop} proposed = {acc} accepted + {rb} rolled back "
              f"(rate {acc / prop:.1%})", file=sys.stderr)
    if args.prefix_cache:
        c = engine.counters
        print(f"selftest prefix cache: {c['serve_prefix_hits_total']} hits, "
              f"{c['serve_prefix_tokens_reused_total']} tokens reused, "
              f"{c['serve_prefix_cow_copies_total']} copy-on-write copies", file=sys.stderr)
    bar = (f"within the {args.kv_acceptance_min:.1%} acceptance gate vs" if kv_lossy
           else "bit-identical to")
    print(f"selftest OK: {len(reqs)} requests {bar} offline greedy decode "
          f"({engine.pool.total_allocated} block allocations, "
          f"{engine.pool.total_freed} frees)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
