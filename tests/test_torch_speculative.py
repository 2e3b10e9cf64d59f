"""The port's speculative decoding against the JAX engine's, on one set of weights.

The cases of the reference's ``TestSpeculativeDecoding``
(``tests/test_serving.py``): a staggered trace through the speculative
engine (1-layer self-draft, ``spec_k`` 3) token-identical to offline greedy
and to the JAX speculative engine, with the JAX engine's speculative
counters; a full self-draft that accepts everything; an adversarial draft
whose every proposal rolls back; the ``spec_overflow`` shed; the
constructor's refusals. Beside them: ``verify_step``'s argmaxes equal the
JAX ``verify_step``'s on the same pools, tables and tokens, and the draft
helpers (``draft_config``, ``truncate_lm_params``, ``self_draft``) build
the model the reference's helpers do.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.transformer import draft_config as jax_draft_config
from deeplearning_mpi_tpu.models.transformer import truncate_lm_params as jax_truncate
from deeplearning_mpi_tpu.serving import EngineConfig as JaxEngineConfig
from deeplearning_mpi_tpu.serving import ServingEngine as JaxEngine
from deeplearning_mpi_tpu.serving.engine import PagedForward as JaxPagedForward
from deeplearning_mpi_tpu.telemetry import MetricsRegistry
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import generate
from deeplearning_mpi_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    draft_config,
    self_draft,
    truncate_lm_params,
)
from deeplearning_mpi_tpu_torch.serving import EngineConfig, RequestState, ServingEngine
from deeplearning_mpi_tpu_torch.serving.engine import PagedForward

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

PROMPT_LENS = (5, 13, 3, 17, 1, 9, 2, 11)
MAX_NEW = 5
SHAPE = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
ARRIVE_AT_STEP = {0: [0, 1, 2], 2: [3, 4], 4: [5], 6: [6, 7]}
SPEC_COUNTERS = ("spec_proposed_total", "spec_accepted_total", "spec_rollback_total",
                 "spec_verify_steps", "spec_draft_steps", "spec_blocks_rolled_back_total")


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxConfig.tiny()
    params = JaxLM(config=cfg, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    np_params = jax.device_get(params)
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(np_params))
    return SimpleNamespace(cfg=cfg, params=params, np_params=np_params, model=model)


def offline(model, prompt, max_new):
    out = generate(model, torch.as_tensor(prompt, dtype=torch.long)[None],
                   max_new_tokens=max_new, temperature=0.0)
    return out[0, len(prompt):].tolist()


def port_engine(tiny, *, draft_layers=1, spec_k=3, shape=SHAPE, **kw):
    return ServingEngine(tiny.model, EngineConfig(**shape, spec_k=spec_k),
                         draft=self_draft(tiny.model, draft_layers), **kw)


def jax_engine(tiny, *, draft_layers=1, spec_k=3, shape=SHAPE, **kw):
    return JaxEngine(tiny.cfg, tiny.params, JaxEngineConfig(**shape, spec_k=spec_k),
                     dtype=jnp.float32, draft_config=jax_draft_config(tiny.cfg, draft_layers),
                     draft_params=jax_truncate(tiny.params, draft_layers), **kw)


def replay(engine, prompts, clock):
    reqs, step = {}, 0
    while step in ARRIVE_AT_STEP or not engine.scheduler.idle():
        for i in ARRIVE_AT_STEP.get(step, []):
            reqs[i] = engine.submit(prompts[i], MAX_NEW)
        engine.step()
        clock.t += 1.0
        step += 1
        assert step < 500, "engine did not drain"
    return [reqs[i] for i in range(len(prompts))]


@pytest.fixture(scope="module")
def spec_runs(tiny):
    """The staggered trace through both speculative engines (1-layer
    self-draft, k=3): arrivals land in vacated slots and recycled blocks,
    with proposals, verify steps and rollbacks in the mix."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 255, size=n).astype(np.int32) for n in PROMPT_LENS]
    clock, jclock = FakeClock(), FakeClock()
    engine = port_engine(tiny, clock=clock)
    port = replay(engine, prompts, clock)
    registry = MetricsRegistry()
    ref = replay(jax_engine(tiny, clock=jclock, registry=registry), prompts, jclock)
    return {"engine": engine, "port": port, "jax": ref, "jax_counters": registry.snapshot(),
            "offline": [offline(tiny.model, p, MAX_NEW) for p in prompts]}


def test_staggered_parity_with_offline_and_jax(spec_runs):
    for req, jreq, expect in zip(spec_runs["port"], spec_runs["jax"], spec_runs["offline"]):
        assert req.state is RequestState.FINISHED
        assert req.generated == expect, f"rid {req.rid}: spec {req.generated} != offline {expect}"
        assert req.generated == jreq.generated, f"rid {req.rid}: port != JAX engine"


def test_counters_reconcile_and_equal_jax(spec_runs):
    """proposed == accepted + rolled back, and every speculative counter
    equals the JAX engine's: the drafts proposed the same tokens."""
    c = spec_runs["engine"].counters
    assert c["spec_proposed_total"] > 0 and c["spec_verify_steps"] > 0
    assert c["spec_draft_steps"] > 0
    assert c["spec_proposed_total"] == c["spec_accepted_total"] + c["spec_rollback_total"]
    assert {k: c[k] for k in SPEC_COUNTERS} == {
        k: int(spec_runs["jax_counters"][k]) for k in SPEC_COUNTERS}


def test_pool_drained_after_rollbacks(spec_runs):
    pool = spec_runs["engine"].pool
    pool.check()
    assert pool.in_use == 0
    assert pool.total_allocated == pool.total_freed > 0


def test_full_self_draft_accepts_everything(tiny):
    """A draft of all the target's layers agrees with every verify argmax:
    nothing rolls back, and the run takes fewer decode steps than the plain
    engine. The draft's KV rule (propose runs one step past its last
    proposal) is what keeps a fully accepted round's cache whole."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 255, size=6).astype(np.int32) for _ in range(4)]
    plain = ServingEngine(tiny.model, EngineConfig(**SHAPE))
    for p in prompts:
        plain.submit(p, MAX_NEW)
    plain.run_until_idle()
    engine = port_engine(tiny, draft_layers=tiny.cfg.num_layers)
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    engine.run_until_idle()
    for req, p in zip(reqs, prompts):
        assert req.generated == offline(tiny.model, p, MAX_NEW)
    c = engine.counters
    assert c["spec_proposed_total"] > 0 and c["spec_rollback_total"] == 0
    assert c["spec_accepted_total"] == c["spec_proposed_total"]
    assert c["serve_decode_steps"] < plain.counters["serve_decode_steps"]


def test_adversarial_draft_full_rollback_keeps_parity(tiny):
    """Proposals replaced by constant garbage (the test seam): every one is
    rejected, the output does not change, and the rejected tails' blocks
    flow back through ``shrink``."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 255, size=n).astype(np.int32) for n in (5, 9, 3)]
    engine = port_engine(tiny)
    engine._spec.propose = lambda tables, lengths, last, n_prop, active: (
        np.zeros((len(last), 3), np.int64), 0)
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    engine.run_until_idle()
    for req, p in zip(reqs, prompts):
        assert req.state is RequestState.FINISHED
        assert req.generated == offline(tiny.model, p, MAX_NEW)
    c = engine.counters
    assert c["spec_proposed_total"] > 0 and c["spec_rollback_total"] > 0
    assert c["spec_proposed_total"] == c["spec_accepted_total"] + c["spec_rollback_total"]
    engine.pool.check()
    assert engine.pool.in_use == 0
    assert engine.pool.total_allocated == engine.pool.total_freed


def test_spec_overflow_shed_reason(tiny):
    """A verify batch that cannot cover its own growth sheds the requester
    as ``spec_overflow``; the survivor still matches offline greedy, and the
    JAX engine sheds the same request for the same reason."""
    rng = np.random.default_rng(5)
    long_p = rng.integers(1, 255, size=8).astype(np.int32)
    short_p = rng.integers(1, 255, size=7).astype(np.int32)
    shape = dict(max_slots=2, block_size=4, num_blocks=5, max_blocks_per_seq=4, prefill_chunk=4)
    results, engines = [], []
    for build in (port_engine, jax_engine):
        clock = FakeClock()
        engine = build(tiny, shape=shape, clock=clock)
        a = engine.submit(long_p, 8)  # grows to 4 blocks: the whole pool
        clock.t += 1.0
        b = engine.submit(short_p, 5)
        engine.run_until_idle()
        results.append((a.state.value, a.shed_reason, b.state.value, b.generated))
        engine.pool.check()
        assert engine.pool.in_use == 0
        engines.append(engine)
    assert results[0] == results[1]
    assert results[0][:3] == ("shed", "spec_overflow", "finished")
    assert results[0][3] == offline(tiny.model, short_p, 5)
    assert engines[0].counters['serve_shed_total{reason="spec_overflow"}'] == 1


@pytest.mark.parametrize("case", ["no_draft", "vocab_mismatch", "negative_k"])
def test_constructor_refusals(tiny, case):
    cfg = EngineConfig(**SHAPE, spec_k=-1 if case == "negative_k" else 2)
    draft = None
    if case == "vocab_mismatch":
        draft = TransformerLM(dataclasses.replace(draft_config(tiny.model.config, 1),
                                                  vocab_size=128),
                              dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match={"no_draft": "draft", "vocab_mismatch": "vocab",
                                          "negative_k": "spec_k"}[case]):
        ServingEngine(tiny.model, cfg, draft=draft)


@pytest.mark.parametrize("window", [0, 6])
def test_verify_step_argmax_equals_jax(tiny, window):
    """One verify step on the same seeded pools, tables, lengths, tokens,
    ``n_live`` and active rows in both packages: the same argmaxes, and the
    same K/V written through the tables."""
    rng = np.random.default_rng(11)
    S, W, MB, BS, NB = 3, 4, 4, 4, 16
    e_shape = dict(max_slots=S, block_size=BS, num_blocks=NB, max_blocks_per_seq=MB,
                   prefill_chunk=4, spec_k=W - 1)
    c = tiny.cfg
    pools = [rng.normal(size=(c.num_layers, NB, BS, c.num_heads, c.head_dim)).astype(np.float32)
             for _ in range(2)]
    tables = np.array([[3, 7, 9, 0], [1, 2, 0, 0], [4, 5, 6, 8]], np.int64)
    lengths = np.array([9, 5, 13], np.int64)
    tokens = rng.integers(1, 255, size=(S, W)).astype(np.int64)
    n_live = np.array([4, 2, 3], np.int64)
    active = np.array([True, True, False])
    jcfg = dataclasses.replace(c, attention_window=window)
    jfwd = JaxPagedForward(jcfg, JaxEngineConfig(**e_shape), jnp.float32)
    jkv, jgot = jfwd.verify_step(
        tiny.params, tuple(jnp.asarray(p) for p in pools), jnp.asarray(tables, jnp.int32),
        jnp.asarray(lengths, jnp.int32), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(n_live, jnp.int32), jnp.asarray(active))
    model = tiny.model
    if window:
        model = TransformerLM(dataclasses.replace(model.config, attention_window=window),
                              dtype=torch.float32, device="cpu")
        model.load_state_dict(tiny.model.state_dict())
    fwd = PagedForward(model, EngineConfig(**e_shape))
    kv = tuple(torch.from_numpy(p.copy()) for p in pools)
    got = fwd.verify_step(kv, *(torch.from_numpy(a) for a in (tables, lengths, tokens, n_live,
                                                               active)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    for mine, ref in zip(kv, jkv):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_draft_helpers_build_the_reference_draft(tiny):
    """``truncate_lm_params`` keeps the reference's keys by reference;
    ``self_draft`` shares the target's modules and computes what the JAX
    draft model (``draft_config`` + ``truncate_lm_params``) computes."""
    sub = truncate_lm_params(tiny.np_params, 1)
    assert set(sub) == set(jax_truncate(tiny.np_params, 1))
    assert sub["layer_0"] is tiny.np_params["layer_0"]
    with pytest.raises(ValueError):
        truncate_lm_params(tiny.np_params, 3)
    with pytest.raises(ValueError):
        draft_config(tiny.model.config, 0)
    draft = self_draft(tiny.model, 1)
    assert draft.config == draft_config(tiny.model.config, 1)
    assert draft.layers[0] is tiny.model.layers[0] and draft.embed is tiny.model.embed
    tokens = np.random.default_rng(2).integers(1, 255, size=(2, 7)).astype(np.int32)
    want = JaxLM(config=jax_draft_config(tiny.cfg, 1), dtype=jnp.float32).apply(
        {"params": jax_truncate(tiny.params, 1)}, jnp.asarray(tokens))
    with torch.no_grad():
        got = draft(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
