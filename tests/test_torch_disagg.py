"""The port's disaggregated prefill / decode engine and ``serve_crash``
recovery against the JAX package's, on the same weights.

A staggered-arrival trace runs through the port's ``DisaggregatedEngine``,
the reference's ``DisaggregatedEngine`` and the port's colocated engine:
the streams equal each other and the port's offline greedy token for token,
the handoff count equals the reference's (every request with more than one
new token crossed the seam once), the roles stay in their lanes (the
prefill role's forward never decodes, the decode role's never prefills),
and the one shared pool drains. Then, each against the reference under the
same plan: ``handoff_stall`` with ``serve_crash`` across the seam, a cancel
in the handoff queue, a shared prefix crossing the handoff, and
``serve_crash`` in the colocated engine (the same requeued and discarded
counts, streams and counters). A warmed pair equals the eager one; the
``handoff`` span tiles with the others; every instrument is canonical.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.resilience import ChaosInjector as JaxChaos
from deeplearning_mpi_tpu.serving import DisaggregatedEngine as JaxDisagg
from deeplearning_mpi_tpu.serving import EngineConfig as JaxEngineConfig
from deeplearning_mpi_tpu.serving import ServingEngine as JaxEngine
from deeplearning_mpi_tpu.telemetry import MetricsRegistry as JaxRegistry
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import generate
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.resilience.faults import ChaosInjector
from deeplearning_mpi_tpu_torch.serving import (
    DisaggregatedEngine,
    EngineConfig,
    RequestState,
    ServingEngine,
)
from deeplearning_mpi_tpu_torch.serving.engine import chunk_attention
from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry, SpanRecorder
from deeplearning_mpi_tpu_torch.telemetry.schema import is_canonical

torch.set_num_threads(1)

PROMPT_LENS = (5, 13, 3, 17, 1, 9, 2, 11)
MAX_NEW = 5
SHAPE = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
ARRIVE_AT_STEP = {0: [0, 1, 2], 2: [3, 4], 4: [5], 6: [6, 7]}
SHARED_PREAMBLE_LEN = 18  # 4 full blocks + 2 rows: adoption copies on write


_HIST = re.compile(r"_(count|mean|p50|p95|max)$")


def canonical(name: str) -> bool:
    """A snapshot key names a registered instrument (a histogram's
    statistics by its own name)."""
    return is_canonical(name) or is_canonical(_HIST.sub("", name))


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _replay(engine, prompts, clock):
    idle = engine.idle if hasattr(engine, "idle") else engine.scheduler.idle
    reqs, step = {}, 0
    while step in ARRIVE_AT_STEP or not idle():
        for i in ARRIVE_AT_STEP.get(step, []):
            reqs[i] = engine.submit(prompts[i], MAX_NEW)
        engine.step()
        clock.t += 1.0
        step += 1
        assert step < 500, "engine did not drain"
    return [reqs[i] for i in range(len(prompts))]


@pytest.fixture(scope="module")
def tiny():
    jm = JaxLM(config=JaxConfig.tiny(), dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    return params, model


def _offline(model, prompt, max_new=MAX_NEW):
    out = generate(model, torch.from_numpy(np.asarray(prompt)).long()[None],
                   max_new_tokens=max_new, temperature=0.0)
    return out[0, len(prompt):].tolist()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def runs(tiny):
    params, model = tiny
    prompts = _prompts(7, PROMPT_LENS)
    calls = {"prefill": [], "decode": []}
    clock, registry = FakeClock(), MetricsRegistry()
    engine = DisaggregatedEngine(model, EngineConfig(**SHAPE), clock=clock, registry=registry)
    for role in ("prefill", "decode"):
        fwd = getattr(engine, role)._fwd
        for name in ("prefill_chunk", "decode_step", "verify_step"):
            def wrap(*a, _f=getattr(fwd, name), _n=name, _r=role, **kw):
                calls[_r].append(_n)
                return _f(*a, **kw)
            setattr(fwd, name, wrap)
    port = _replay(engine, prompts, clock)
    jclock, jreg = FakeClock(), JaxRegistry()
    jengine = JaxDisagg(JaxConfig.tiny(), params, JaxEngineConfig(**SHAPE), dtype=jnp.float32,
                        clock=jclock, registry=jreg)
    ref = _replay(jengine, prompts, jclock)
    cclock = FakeClock()
    colocated = _replay(ServingEngine(model, EngineConfig(**SHAPE), clock=cclock), prompts,
                        cclock)
    return {"engine": engine, "port": port, "jax": ref, "colocated": colocated,
            "offline": [_offline(model, p) for p in prompts], "snap": registry.snapshot(),
            "jsnap": jreg.snapshot(), "calls": calls}


def test_streams_equal_reference_colocated_and_offline(runs):
    for req, jreq, creq, expect in zip(runs["port"], runs["jax"], runs["colocated"],
                                       runs["offline"]):
        assert req.state is RequestState.FINISHED
        assert req.generated == expect == jreq.generated == creq.generated, f"rid {req.rid}"


def test_handoffs_equal_the_reference(runs):
    crossing = sum(len(r.generated) > 1 for r in runs["port"])
    snap, jsnap = runs["snap"], runs["jsnap"]
    assert snap["serve_handoffs_total"] == jsnap["serve_handoffs_total"] == crossing > 0
    assert runs["engine"].counters["serve_handoffs_total"] == crossing
    assert snap["serve_handoff_depth"] == 0
    assert all(r.t_detached is not None and r.t_adopted is not None
               for r in runs["port"] if len(r.generated) > 1)


def test_roles_stay_in_their_lanes(runs):
    calls = runs["calls"]
    assert set(calls["prefill"]) == {"prefill_chunk"}
    assert set(calls["decode"]) == {"decode_step"}
    engine = runs["engine"]
    assert (engine.prefill.role, engine.decode.role) == ("prefill", "decode")
    assert engine.prefill.counters["serve_decode_steps"] == 0
    assert engine.decode.counters["serve_prefill_chunks"] == 0
    snap, jsnap = runs["snap"], runs["jsnap"]
    for name in ("serve_prefill_chunks", "serve_decode_steps", "serve_tokens_generated",
                 "serve_requests_completed", 'serve_slots_active{role="prefill"}',
                 'serve_slots_active{role="decode"}', 'serve_queue_depth{role="prefill"}'):
        assert snap[name] == jsnap[name], name


def test_shared_pool_drained(runs):
    engine = runs["engine"]
    assert engine.prefill.pool is engine.decode.pool is engine.pool
    assert engine.prefill._kvh is engine.decode._kvh
    engine.pool.check()
    assert engine.pool.in_use == 0 and engine.pool.total_allocated == engine.pool.total_freed > 0
    assert not [n for n in runs["snap"] if not canonical(n)]


def _chaos_pair(tiny, plan, lens, seed, **engine_kw):
    """The port's and the reference's disaggregated engine under one plan."""
    params, model = tiny
    prompts = _prompts(seed, lens)
    out = []
    for side in ("port", "jax"):
        if side == "port":
            registry = MetricsRegistry()
            chaos = ChaosInjector.from_spec(plan, registry=registry)
            engine = DisaggregatedEngine(model, EngineConfig(**SHAPE, **engine_kw),
                                         registry=registry, chaos=chaos)
        else:
            registry = JaxRegistry()
            chaos = JaxChaos.from_spec(plan, registry=registry)
            engine = JaxDisagg(JaxConfig.tiny(), params, JaxEngineConfig(**SHAPE, **engine_kw),
                               dtype=jnp.float32, registry=registry, chaos=chaos)
        reqs = [engine.submit(p, MAX_NEW) for p in prompts]
        engine.run_until_idle()
        out.append((engine, reqs, registry.snapshot(), chaos))
    return prompts, out


def test_handoff_stall_and_crash_recovery_equal_the_reference(tiny):
    prompts, ((engine, reqs, snap, chaos), (_, jreqs, jsnap, jchaos)) = _chaos_pair(
        tiny, "handoff_stall@step:2,serve_crash@step:5", (5, 9, 3, 12), 11)
    _, model = tiny
    for req, jreq, p in zip(reqs, jreqs, prompts):
        assert req.state is RequestState.FINISHED
        assert req.generated == jreq.generated == _offline(model, p)
    for name in ("fault_injected_total", "recovery_total", "serve_handoff_stalls_total",
                 "serve_requeued_total", "serve_tokens_discarded_total", "serve_handoffs_total"):
        assert snap[name] == jsnap[name], name
    assert snap["fault_injected_total"] == snap["recovery_total"] == 2
    assert snap["serve_handoff_stalls_total"] == 1 and snap["serve_requeued_total"] > 0
    assert chaos.balanced() and jchaos.balanced()
    engine.pool.check()
    assert engine.pool.in_use == 0


def test_cancel_in_the_handoff_queue(tiny):
    params, model = tiny
    engine = DisaggregatedEngine(model, EngineConfig(**SHAPE))
    jengine = JaxDisagg(JaxConfig.tiny(), params, JaxEngineConfig(**SHAPE), dtype=jnp.float32)
    for eng in (engine, jengine):
        req = eng.submit(np.arange(1, 6, dtype=np.int32), MAX_NEW)
        steps = 0
        while not eng.prefill.handoff:
            eng.prefill.step()  # prefill only: nothing drains the queue
            steps += 1
            assert steps < 100
        assert eng.cancel(req)
        assert req.state.value == "shed" and req.shed_reason == "cancelled"
        assert eng.handoff_depth == 0 and eng.pool.in_use == 0
        eng.pool.check()
        assert not eng.cancel(req)


def test_shared_prefix_crosses_the_handoff(tiny):
    params, model = tiny
    rng = np.random.default_rng(13)
    preamble = rng.integers(1, 255, size=SHARED_PREAMBLE_LEN).astype(np.int32)
    prompts = [np.concatenate([preamble, rng.integers(1, 255, size=4).astype(np.int32)])
               for _ in range(4)]
    registry, jreg = MetricsRegistry(), JaxRegistry()
    engine = DisaggregatedEngine(model, EngineConfig(**SHAPE, prefix_cache=True),
                                 registry=registry)
    jengine = JaxDisagg(JaxConfig.tiny(), params,
                        dataclasses.replace(JaxEngineConfig(**SHAPE), prefix_cache=True),
                        dtype=jnp.float32, registry=jreg)
    assert (engine.prefill.scheduler.prefix_cache is engine.decode.scheduler.prefix_cache
            is engine.prefix_cache)
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    jreqs = [jengine.submit(p, MAX_NEW) for p in prompts]
    engine.run_until_idle()
    jengine.run_until_idle()
    snap, jsnap = registry.snapshot(), jreg.snapshot()
    for name in ("serve_prefix_hits_total", "serve_handoffs_total",
                 "serve_prefix_tokens_reused_total"):
        assert snap[name] == jsnap[name] > 0, name
    for req, jreq, p in zip(reqs, jreqs, prompts):
        assert req.generated == jreq.generated == _offline(model, p)
    assert engine.pool.in_use == len(engine.prefix_cache.referenced_blocks())
    engine.prefix_cache.flush()
    assert engine.pool.in_use == 0
    engine.pool.check()


def test_serve_crash_in_the_colocated_engine_equals_the_reference(tiny):
    """Reference ``tests/test_resilience.py::TestServeChaos`` on both: the
    same requeued and discarded counts, streams and counters."""
    params, model = tiny
    prompts = _prompts(7, (5, 9, 3, 12))
    cfg = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
    registry, jreg = MetricsRegistry(), JaxRegistry()
    chaos = ChaosInjector.from_spec("serve_crash@step:3", registry=registry)
    jchaos = JaxChaos.from_spec("serve_crash@step:3", registry=jreg)
    engine = ServingEngine(model, EngineConfig(**cfg), registry=registry, chaos=chaos)
    jengine = JaxEngine(JaxConfig.tiny(), params, JaxEngineConfig(**cfg), dtype=jnp.float32,
                        registry=jreg, chaos=jchaos)
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    jreqs = [jengine.submit(p, MAX_NEW) for p in prompts]
    engine.run_until_idle()
    jengine.run_until_idle()
    snap, jsnap = registry.snapshot(), jreg.snapshot()
    assert snap["serve_requeued_total"] >= 1
    for name in ("serve_requeued_total", "serve_tokens_discarded_total", "fault_injected_total",
                 "recovery_total", 'recovery_total{kind="serve_crash"}',
                 "serve_requests_completed", "serve_tokens_generated", "serve_prefill_chunks",
                 "serve_decode_steps"):
        assert snap[name] == jsnap[name], name
    assert engine.counters["serve_requeued_total"] == snap["serve_requeued_total"]
    for req, jreq, p in zip(reqs, jreqs, prompts):
        assert req.state is RequestState.FINISHED
        assert req.generated == jreq.generated == _offline(model, p)
    engine.pool.check()
    assert chaos.balanced() and not chaos.unrecovered()


def test_warmed_pair_equals_eager_and_spans_tile(tiny, tmp_path):
    _, model = tiny
    prompts = _prompts(7, PROMPT_LENS)
    streams = []
    for warm in (False, True):
        clock = FakeClock()
        tracer = SpanRecorder(tmp_path / f"trace{int(warm)}.jsonl", proc="t", clock=clock)
        engine = DisaggregatedEngine(model, EngineConfig(**SHAPE), clock=clock, tracer=tracer)
        if warm:
            built = engine.warmup()
            assert built and all(k.startswith("decode_role_") for k in built)
            assert engine.captures == engine.decode.captures > 0 == engine.prefill.captures
        captures = engine.captures
        reqs = _replay(engine, prompts, clock)
        assert engine.captures == captures
        streams.append([r.generated for r in reqs])
        tracer.close()
        recs = [json.loads(line) for line in tracer.path.read_text().splitlines()]
        spans = [r for r in recs if r.get("kind") == "span"
                 and r["name"] in ("queue", "prefill", "handoff", "decode")]
        for req in reqs:
            mine = sorted((r for r in spans if r.get("trace") == f"rid{req.rid}"),
                          key=lambda r: r["t0"])
            names = [r["name"] for r in mine]
            assert names[:2] == ["queue", "prefill"] and names[-1] == "decode"
            assert ("handoff" in names) == (len(req.generated) > 1)
            assert mine[0]["t0"] == req.arrival and mine[-1]["t1"] == req.t_finished
            assert all(a["t1"] == b["t0"] for a, b in zip(mine, mine[1:]))
    assert streams[0] == streams[1]


@pytest.mark.parametrize("start,chunk,length,window", [
    (0, 4, 16, None), (8, 4, 16, None), (14, 4, 16, None), (4, 4, 32, 3), (0, 16, 16, None),
])
def test_chunk_attention_equals_the_masked_matmul(start, chunk, length, window):
    """K1's square call for a prefill chunk (its plain version here) is the
    masked matmul's function: the chunk rows at their absolute positions,
    the pages padded when the chunk runs past them."""
    from deeplearning_mpi_tpu_torch.ops.attention import dense_attention

    gen = torch.Generator().manual_seed(start * 100 + chunk + length)
    q = torch.randn(1, chunk, 4, 8, generator=gen)
    k = torch.randn(1, length, 4, 8, generator=gen)
    v = torch.randn(1, length, 4, 8, generator=gen)
    got = chunk_attention(q, k, v, start, window=window)
    want = dense_attention(q, k, v, causal=True, window=window, q_offset=start)
    valid = min(chunk, length - start)
    torch.testing.assert_close(got[:, :valid], want[:, :valid], atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("start,chunk,length", [(0, 128, 1024), (384, 128, 1024), (120, 16, 128)])
def test_chunk_attention_calls_k1_over_the_chunks_keys_only(monkeypatch, start, chunk, length):
    """The square K1 call ends at the chunk's last row (``start + chunk``),
    not at the slot's last page row: no chunk row sees a key past it."""
    from deeplearning_mpi_tpu_torch.serving import engine as engine_mod

    shapes = []
    real = engine_mod.flash_attention

    def spy(q, k, v, **kw):
        shapes.append((q.shape[1], k.shape[1], v.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(engine_mod, "flash_attention", spy)
    q = torch.randn(1, chunk, 2, 8)
    k, v = torch.randn(1, length, 2, 8), torch.randn(1, length, 2, 8)
    assert chunk_attention(q, k, v, start).shape == q.shape
    assert shapes == [(start + chunk,) * 3]
