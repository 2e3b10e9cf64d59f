"""The port engine's telemetry and the serving CLI's trace flags against the reference.

- The engine: one request trace (a shared prompt preamble for the prefix
  cache, decode buckets for the held steps, a tenant over its budget for a
  shed) through the reference engine and the port's on the CPU, each with a
  registry and a span recorder, on one fake clock: every counter's name
  (in the reference's schema, as every gauge's) and value equal
  (``serve_compile_total`` by name: the reference counts
  its XLA traces, the port the CUDA graphs it captures, none when eager),
  ``ServingEngine.counters`` equal to the port registry's counters, the
  histograms' names and the TTFT / TPOT counts equal, the gauges' names
  equal, the same span and event names, and each request's queue +
  prefill + decode spans tiling its arrival to finish.
- ``serve_lm --trace`` / ``--deadline``: one trace file through both CLIs'
  loaders gives equal entries; a deadline case sheds the same requests for
  the same reason in both engines; the port's CLI replays a trace, sheds
  on a deadline, and writes canonical ``--metrics_file`` records that
  ``tools/metrics_report.py`` renders.
"""

import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.cli import serve_lm as ref_cli
from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.serving import EngineConfig as JaxEngineConfig
from deeplearning_mpi_tpu.serving import ServingEngine as JaxEngine
from deeplearning_mpi_tpu.telemetry import MetricsRegistry as JaxRegistry
from deeplearning_mpi_tpu.telemetry.schema import is_canonical
from deeplearning_mpi_tpu.telemetry.spans import SpanRecorder as JaxRecorder
from deeplearning_mpi_tpu.telemetry.spans import load_trace_file, span_tree
from deeplearning_mpi_tpu_torch.cli import serve_lm
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine
from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry, SpanRecorder
from deeplearning_mpi_tpu_torch.telemetry.schema import METRICS

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4,
             decode_buckets=(2,), prefix_cache=True)
TENANTS = {"prod": {"budget_tokens": 0, "priority": 1.0},
           "burst": {"budget_tokens": 30, "priority": 0.0}}
TINY = ["--num_layers", "2", "--num_heads", "2", "--head_dim", "8", "--d_model", "16",
        "--d_ff", "32"]


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxConfig.tiny()
    params = JaxLM(config=cfg, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    return SimpleNamespace(cfg=cfg, params=params, model=model)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(engine, clock, prompts):
    """Six prod requests and two burst ones (the second shed at the door),
    then steps on a clock 0.125 s a step."""
    reqs = [engine.submit(p, 5, tenant="prod") for p in prompts[:6]]
    reqs += [engine.submit(p, 5, tenant="burst") for p in prompts[6:8]]
    while not engine.scheduler.idle():
        clock.t += 0.125
        engine.step()
    return reqs


@pytest.fixture(scope="module")
def engine_runs(tiny, tmp_path_factory):
    rng = np.random.default_rng(21)
    preamble = rng.integers(1, 255, size=18).astype(np.int32)
    prompts = [np.concatenate([preamble, rng.integers(1, 255, size=n).astype(np.int32)])
               for n in (5, 3, 6, 2, 5, 4, 5, 5)]
    tdir = tmp_path_factory.mktemp("serve_spans")
    out = {}
    for side in ("ref", "port"):
        clock = Clock()
        if side == "ref":
            registry = JaxRegistry()
            tracer = JaxRecorder(tdir / "trace_ref.jsonl", proc="ref", registry=registry,
                                 clock=clock)
            engine = JaxEngine(tiny.cfg, tiny.params, JaxEngineConfig(**SHAPE), dtype=jnp.float32,
                               registry=registry, tracer=tracer, tenants=TENANTS, clock=clock)
        else:
            registry = MetricsRegistry()
            tracer = SpanRecorder(tdir / "trace_port.jsonl", proc="port", registry=registry,
                                  clock=clock)
            engine = ServingEngine(tiny.model, EngineConfig(**SHAPE), registry=registry,
                                   tracer=tracer, tenants=TENANTS, clock=clock)
        reqs = _drive(engine, clock, prompts)
        tracer.close()
        out[side] = SimpleNamespace(engine=engine, reqs=reqs, snap=registry.snapshot(),
                                    registry=registry, trace=load_trace_file(tracer.path)[1])
    return out


def _kind(name):
    return METRICS[name.split("{")[0]][0]


def _by_kind(registry, kind):
    """The registry's instruments of one kind, by name."""
    table = {"counter": registry._counters, "gauge": registry._gauges,
             "histogram": registry._histograms}[kind]
    return dict(table)


def test_streams_and_sheds_match(engine_runs):
    ref, port = engine_runs["ref"], engine_runs["port"]
    assert [r.generated for r in port.reqs] == [r.generated for r in ref.reqs]
    assert [r.state.value for r in port.reqs] == [r.state.value for r in ref.reqs]
    assert port.reqs[-1].shed_reason == ref.reqs[-1].shed_reason == "tenant_budget"


def test_counters_equal_the_reference_and_engine_counters(engine_runs):
    ref, port = engine_runs["ref"], engine_runs["port"]
    want = {k: c.value for k, c in _by_kind(ref.registry, "counter").items()}
    got = {k: c.value for k, c in _by_kind(port.registry, "counter").items()}
    assert set(got) == set(want)
    assert all(is_canonical(k) and _kind(k) == "counter" for k in got)
    assert want.pop("serve_compile_total") > 0 and got.pop("serve_compile_total") == 0
    assert got == want
    assert got["serve_prefix_hits_total"] > 0 and got["serve_decode_held_steps"] > 0
    counters = port.engine.counters
    for name, value in got.items():
        if not name.startswith(("span_", "flight_")):
            assert counters[name] == value, name
    assert all(counters[k] == 0 for k in set(counters) - set(got) if _kind(k) == "counter")


def test_histograms_gauges_and_spans_match(engine_runs):
    ref, port = engine_runs["ref"], engine_runs["port"]
    hist, ref_hist = _by_kind(port.registry, "histogram"), _by_kind(ref.registry, "histogram")
    assert set(hist) == set(ref_hist)
    for name in ("serve_ttft_s", "serve_tpot_s"):
        assert len(hist[name].observations) == len(ref_hist[name].observations) == 7
    assert hist["serve_ttft_s"].observations == ref_hist["serve_ttft_s"].observations
    gauges, ref_gauges = _by_kind(port.registry, "gauge"), _by_kind(ref.registry, "gauge")
    assert set(gauges) == set(ref_gauges)
    assert all(is_canonical(k) for k in gauges)
    assert {k: g.value for k, g in gauges.items() if "bytes" not in k and "offset" not in k} == \
        {k: g.value for k, g in ref_gauges.items() if "bytes" not in k and "offset" not in k}

    def names(trace):
        return sorted((r["kind"], r["name"]) for r in trace)

    assert names(port.trace) == names(ref.trace)
    by_sid, children, orphans = span_tree(port.trace)
    roots = [s for s in by_sid.values() if s["name"] == "request"]
    assert len(roots) == 7 and not orphans
    for root in roots:
        parts = {c["name"]: c["t1"] - c["t0"] for c in children[root["sid"]]}
        assert set(parts) == {"queue", "prefill", "decode"}
        assert sum(parts.values()) == pytest.approx(root["t1"] - root["t0"], abs=1e-12)


def _write_trace(path):
    lines = [
        {"arrival": 0.2, "prompt": "hello there", "max_new": 3},
        {"arrival": 0.0, "prompt": "naïve ok", "deadline": 0.5, "tenant": "prod"},
        {"prompt": ""},
        {"arrival": 0.1, "prompt": "x" * 20, "max_new": 2, "deadline": 0.0},
    ]
    path.write_text("\n".join(json.dumps(o) for o in lines) + "\n\n")


def test_trace_file_loads_equal_in_both_clis(tmp_path):
    path = tmp_path / "trace.jsonl"
    _write_trace(path)
    got = serve_lm.load_trace(str(path), 7, 1.5)
    want = ref_cli._load_trace(str(path), 7, 1.5)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert set(a) == set(b) and a["prompt"].dtype == b["prompt"].dtype
        assert np.array_equal(a["prompt"], b["prompt"])
        assert {k: v for k, v in a.items() if k != "prompt"} == \
            {k: v for k, v in b.items() if k != "prompt"}
    (tmp_path / "bad.jsonl").write_text('{"arrival": 1}\n')
    for load in (serve_lm.load_trace, ref_cli._load_trace):
        with pytest.raises(SystemExit, match="bad trace entry"):
            load(str(tmp_path / "bad.jsonl"), 7, 0.0)
    args = SimpleNamespace(random_seed=3, num_requests=5, rate=20.0, prompt_len_min=4,
                           prompt_len_max=9, max_new_tokens=6, deadline=0.25, vocab_size=256)
    for a, b in zip(serve_lm.poisson_trace(args), ref_cli._poisson_trace(args)):
        assert np.array_equal(a.pop("prompt"), b.pop("prompt")) and a == b


def test_deadlines_shed_the_same_requests(tiny):
    """One slot, six requests queued at t=0 with deadlines: the engines shed
    the same ones, for the same reason, at the same step."""
    deadlines = [None, 0.3, 0.45, 2.0, 0.2, None]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 255, size=6).astype(np.int32) for _ in deadlines]
    shape = dict(max_slots=1, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
    out = {}
    for side in ("ref", "port"):
        clock = Clock()
        if side == "ref":
            engine = JaxEngine(tiny.cfg, tiny.params, JaxEngineConfig(**shape), dtype=jnp.float32,
                               registry=(registry := JaxRegistry()), clock=clock)
        else:
            engine = ServingEngine(tiny.model, EngineConfig(**shape),
                                   registry=(registry := MetricsRegistry()), clock=clock)
        reqs = [engine.submit(p, 3, deadline=d, arrival=0.0) for p, d in zip(prompts, deadlines)]
        while not engine.scheduler.idle():
            clock.t += 0.1
            engine.step()
        out[side] = ([(r.state.value, r.shed_reason, r.t_finished) for r in reqs],
                     registry.snapshot())
    assert out["port"][0] == out["ref"][0]
    assert [s for s, _, _ in out["port"][0]].count("shed") >= 2
    key = 'serve_shed_total{reason="deadline"}'
    assert out["port"][1][key] == out["ref"][1][key] >= 2


def test_serve_cli_trace_deadline_and_metrics_file(tmp_path, capsys):
    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(json.dumps({"arrival": 0.01 * i, "prompt": f"request {i} hi"}) + "\n"
                             for i in range(5)))
    metrics = tmp_path / "serve.jsonl"
    rc = serve_lm.main(["--selftest", "--device", "cpu", *TINY, "--trace", str(trace),
                        "--max_new_tokens", "4", "--metrics_file", str(metrics)])
    assert rc == 0 and "selftest OK: 5 requests" in capsys.readouterr().err
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["kind"] for r in records] == ["serve_summary"]
    summary = records[0]
    hist = re.compile(r"_(count|mean|p50|p95|max)$")
    assert all(is_canonical(k) or is_canonical(hist.sub("", k))
               for k in summary if k not in ("ts", "kind"))
    assert summary["serve_requests_completed"] == 5 and summary["serve_ttft_s_count"] == 5
    report = subprocess.run([sys.executable, str(ROOT / "tools" / "metrics_report.py"),
                             str(metrics)], capture_output=True, text=True, timeout=60)
    assert report.returncode == 0 and "requests completed" in report.stdout, report.stderr
    # A deadline no queued request can meet: the selftest fails on the sheds.
    rc = serve_lm.main(["--selftest", "--device", "cpu", *TINY, "--trace", str(trace),
                        "--max_new_tokens", "4", "--max_slots", "1", "--deadline", "1e-9"])
    err = capsys.readouterr().err
    assert rc == 1 and "deadline" in err and "not all requests completed" in err
