"""The port's radix prefix cache against the JAX engine's, on one set of weights.

The cases of the reference's ``TestPoolRefcounts``,
``TestRadixPrefixCacheTrie`` and ``TestPrefixCacheServing``
(``tests/test_serving.py``; the disaggregated ones wait for
``serving/disagg.py``): refcounted sharing and copy-on-write refusals in
the pool, the trie's matching, partial adoption, upgrades, LRU eviction
and flush, and an engine with the cache on whose every stream equals
offline greedy and the JAX engine's, with the JAX cache's counters.
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
from deeplearning_mpi_tpu.serving import EngineConfig as JaxEngineConfig
from deeplearning_mpi_tpu.serving import RadixPrefixCache as JaxPrefixCache
from deeplearning_mpi_tpu.serving import ServingEngine as JaxEngine
from deeplearning_mpi_tpu.serving.kv_pool import PagedKVPool as JaxPool
from deeplearning_mpi_tpu.serving.prefix_cache import prefix_signature as jax_signature
from deeplearning_mpi_tpu.telemetry import MetricsRegistry
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import generate
from deeplearning_mpi_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    self_draft,
)
from deeplearning_mpi_tpu_torch.serving import (
    EngineConfig,
    PagedKVPool,
    RadixPrefixCache,
    RequestState,
    ServingEngine,
    prefix_signature,
)

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

MAX_NEW = 5
SHAPE = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
PREFIX_COUNTERS = ("serve_prefix_hits_total", "serve_prefix_tokens_reused_total",
                   "serve_prefix_cow_copies_total", "serve_prefix_evictions_total")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxConfig.tiny()
    params = JaxLM(config=cfg, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    return SimpleNamespace(cfg=cfg, params=params, model=model)


def offline(model, prompt, max_new):
    out = generate(model, torch.as_tensor(prompt, dtype=torch.long)[None],
                   max_new_tokens=max_new, temperature=0.0)
    return out[0, len(prompt):].tolist()


# -- the pool's sharing layer -------------------------------------------------

def test_share_requires_allocated_block():
    pool = PagedKVPool(8, 4)
    with pytest.raises(ValueError):
        pool.share([3])


def test_shared_block_survives_first_free():
    pool = PagedKVPool(8, 4)
    (b,) = pool.alloc(1)
    pool.share([b])
    assert pool.refcount(b) == 2
    pool.free([b])
    assert pool.refcount(b) == 1 and pool.in_use == 1
    pool.free([b])
    assert pool.refcount(b) == 0 and pool.available == pool.capacity
    pool.check()


def test_refcount_underflow_raises():
    pool = PagedKVPool(8, 4)
    torn = pool.alloc(1)
    pool._refcount[torn[0]] = 0  # corrupted books (a double-freed sharer)
    with pytest.raises(ValueError, match="underflow"):
        pool.free(torn)


@pytest.mark.parametrize("kind", ["fill", "scale"])
def test_write_to_shared_block_requires_cow(kind):
    pool = PagedKVPool(8, 4, kv_dtype=torch.int8)
    shared = pool.alloc(1)
    pool.share(shared)
    record = pool.record_fill if kind == "fill" else pool.record_scale
    with pytest.raises(ValueError, match="copy-on-write"):
        record(shared)
    pool.free(shared)
    pool.record_fill(shared)
    pool.record_scale(shared)
    pool.free(shared)
    pool.check()


def test_reconcile_multiplicity_rebuilds_refcounts():
    pool = PagedKVPool(8, 4)
    a, b, leaked = pool.alloc(3)
    assert pool.reconcile([a, a, b]) == {"reclaimed": 1, "adopted": 0}
    assert (pool.refcount(a), pool.refcount(b), pool.refcount(leaked)) == (2, 1, 0)
    pool.check()
    pool.free([a, b])
    assert pool.in_use == 1
    pool.free([a])
    assert pool.in_use == 0
    pool.check()


# -- the trie, in both packages -----------------------------------------------

BS = 4


def _complete(cache, pool, prompt, frozen):
    """A finished request: its blocks allocated, its frozen span indexed,
    its own references dropped (the cache keeps its shares)."""
    blocks = pool.alloc(pool.blocks_for(len(prompt)))
    cache.insert(prompt, blocks, frozen)
    pool.free(blocks)
    return blocks


def _trie_case(name, pool, cache):
    """One reference trie case against ``(pool, cache)``; returns what it
    observed, so the port's and the JAX cache's runs can be compared."""
    seen = []
    if name == "miss":
        seen.append(cache.match(list(range(1, 10))))
    elif name == "full_blocks":
        prompt = list(range(10, 23))  # 13 tokens: 3 full blocks + 1 row
        blocks = _complete(cache, pool, prompt, frozen=12)
        assert cache.match(prompt) == (12, blocks[:3], None)
        assert sorted(cache.referenced_blocks()) == sorted(blocks[:3])
        assert pool.in_use == 3
    elif name == "fill_caps_before_last":
        prompt = list(range(1, 13))
        blocks = _complete(cache, pool, prompt, frozen=12)
        assert cache.match(prompt) == (11, blocks[:2], (blocks[2], 3))
    elif name == "divergent_tail":
        blocks = _complete(cache, pool, [1, 2, 3, 4, 5, 6, 7, 8], frozen=8)
        assert cache.match([1, 2, 3, 4, 5, 6, 99, 98, 97, 96]) == (6, blocks[:1], (blocks[1], 2))
    elif name == "partial_upgrade":
        _complete(cache, pool, [1, 2, 3, 4, 5, 6], frozen=6)
        ext = [1, 2, 3, 4, 5, 6, 7, 8]
        blocks2 = _complete(cache, pool, ext, frozen=7)
        fill, _, partial = cache.match(ext)
        assert fill == 7 and partial == (blocks2[1], 3)
        assert pool.in_use == len(cache.referenced_blocks()) == 2
    elif name == "superspan_kept":
        ext = [1, 2, 3, 4, 5, 6, 7, 8]
        blocks1 = _complete(cache, pool, ext, frozen=7)
        nodes = cache.num_nodes
        _complete(cache, pool, [1, 2, 3, 4, 5, 6], frozen=6)
        assert cache.num_nodes == nodes
        fill, _, partial = cache.match(ext)
        assert fill == 7 and partial == (blocks1[1], 3)
    elif name == "evict_sole_owner_only":
        a = _complete(cache, pool, [1, 2, 3, 4, 9], frozen=4)
        _complete(cache, pool, [5, 6, 7, 8, 9], frozen=4)
        pool.share(a[:1])  # a live adopter pins A's block
        assert cache.evict(2) == 1
        assert cache.referenced_blocks() == a[:1]
        assert cache.match([5, 6, 7, 8, 9]) == (0, [], None)
        pool.free(a[:1])
        assert cache.evict(1) == 1 and pool.in_use == 0
    elif name == "evict_lru":
        a = _complete(cache, pool, [1, 2, 3, 4, 9], frozen=4)
        b = _complete(cache, pool, [5, 6, 7, 8, 9], frozen=4)
        cache.match([1, 2, 3, 4, 9])  # touch A: B is the LRU leaf
        assert cache.evict(1) == 1
        assert cache.referenced_blocks() == a[:1] and b[0] not in cache.referenced_blocks()
    elif name == "flush":
        _complete(cache, pool, list(range(1, 14)), frozen=12)
        assert cache.flush() == 3
        assert pool.in_use == 0 and cache.num_nodes == 0
        assert cache.match(list(range(1, 14))) == (0, [], None)
    pool.check()
    seen += [sorted(cache.referenced_blocks()), cache.num_nodes, pool.in_use, pool.available]
    return seen


@pytest.mark.parametrize("name", [
    "miss", "full_blocks", "fill_caps_before_last", "divergent_tail", "partial_upgrade",
    "superspan_kept", "evict_sole_owner_only", "evict_lru", "flush",
])
def test_trie_case_matches_jax(name):
    pool = PagedKVPool(32, BS)
    jpool = JaxPool(32, BS)
    assert _trie_case(name, pool, RadixPrefixCache(pool)) == \
        _trie_case(name, jpool, JaxPrefixCache(jpool))


def test_prefix_signature_matches_jax():
    for tokens in ([1, 2, 3], list(range(5, 30)), [255] * 16):
        assert prefix_signature(tokens, 4) == jax_signature(tokens, 4)


# -- serving ------------------------------------------------------------------

SHARED_PREAMBLE_LEN = 18  # 4 full blocks + 2 rows: every adoption copies a block
TENANTS = {
    "prod": {"budget_tokens": 0, "priority": 1.0},
    # One burst request commits 23 + 5 = 28 tokens: budget 30 holds one.
    "burst": {"budget_tokens": 30, "priority": 0.0},
}


def _prefix_trace(engine, prompts):
    reqs = [engine.submit(p, MAX_NEW, tenant="prod") for p in prompts[:6]]
    reqs.append(engine.submit(prompts[6], MAX_NEW, tenant="burst"))
    shed = engine.submit(prompts[7], MAX_NEW, tenant="burst")
    engine.run_until_idle()
    return reqs, shed


@pytest.fixture(scope="module")
def prefix_runs(tiny):
    """Six prod requests sharing an 18-token preamble, plus a burst tenant
    whose second submit sheds on its budget, through both engines."""
    rng = np.random.default_rng(21)
    preamble = rng.integers(1, 255, size=SHARED_PREAMBLE_LEN).astype(np.int32)
    prompts = [np.concatenate([preamble, rng.integers(1, 255, size=5).astype(np.int32)])
               for _ in range(8)]
    engine = ServingEngine(tiny.model, EngineConfig(**SHAPE, prefix_cache=True),
                           tenants=TENANTS)
    reqs, shed = _prefix_trace(engine, prompts)
    registry = MetricsRegistry()
    jengine = JaxEngine(tiny.cfg, tiny.params, JaxEngineConfig(**SHAPE, prefix_cache=True),
                        dtype=jnp.float32, registry=registry, tenants=TENANTS)
    jreqs, jshed = _prefix_trace(jengine, prompts)
    return {"engine": engine, "reqs": reqs, "shed": shed, "jreqs": jreqs, "jshed": jshed,
            "counters": engine.counters, "jax_counters": registry.snapshot(),
            "offline": [offline(tiny.model, p, MAX_NEW) for p in prompts[:7]]}


def test_streams_match_cold_offline_and_jax(prefix_runs):
    for req, jreq, expect in zip(prefix_runs["reqs"], prefix_runs["jreqs"],
                                 prefix_runs["offline"]):
        assert req.state is RequestState.FINISHED
        assert req.generated == expect, f"rid {req.rid}: cached {req.generated} != {expect}"
        assert req.generated == jreq.generated


def test_cache_worked_as_the_jax_cache_did(prefix_runs):
    c, jc = prefix_runs["counters"], prefix_runs["jax_counters"]
    assert c["serve_prefix_hits_total"] > 0 and c["serve_prefix_tokens_reused_total"] > 0
    assert c["serve_prefix_cow_copies_total"] > 0  # 18 % 4 != 0
    assert c["serve_prefix_blocks"] > 0
    assert {k: c[k] for k in PREFIX_COUNTERS} == {k: int(jc[k]) for k in PREFIX_COUNTERS}


def test_burst_tenant_shed_on_budget(prefix_runs):
    shed = prefix_runs["shed"]
    assert shed.state is RequestState.SHED and shed.shed_reason == "tenant_budget"
    assert prefix_runs["jshed"].shed_reason == "tenant_budget"
    c = prefix_runs["counters"]
    assert c['serve_tenant_shed_total{tenant="burst"}'] == 1
    assert c['serve_shed_total{reason="tenant_budget"}'] == 1


def test_refcount_books_balance_at_drain(prefix_runs):
    """Last of the fixture's users (it flushes the cache): at drain the
    pool's only references are the cache's, and a flush brings them to
    zero."""
    engine = prefix_runs["engine"]
    cache = engine.prefix_cache
    assert engine.pool.in_use == len(cache.referenced_blocks()) > 0
    cache.flush()
    assert engine.pool.in_use == 0
    assert engine.pool.total_allocated == engine.pool.total_freed > 0
    engine.pool.check()


@pytest.mark.parametrize("spec_k", [0, 2])
def test_cow_storm_with_eviction_parity(tiny, spec_k):
    """A pool far too small for the working set: admissions evict cached
    branches mid-run. Streams and the refcount books survive; with a
    draft, its pools take the mirrored copies and the streams still match."""
    rng = np.random.default_rng(5)
    preambles = [rng.integers(1, 255, size=10).astype(np.int32) for _ in range(3)]
    prompts = [np.concatenate([preambles[i % 3], rng.integers(1, 255, size=4).astype(np.int32)])
               for i in range(9)]
    shape = dict(SHAPE, num_blocks=13, max_slots=2)
    engine = ServingEngine(tiny.model, EngineConfig(**shape, prefix_cache=True, spec_k=spec_k),
                           draft=self_draft(tiny.model, 1) if spec_k else None)
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    engine.run_until_idle()
    registry = MetricsRegistry()
    jengine = JaxEngine(tiny.cfg, tiny.params,
                        dataclasses.replace(JaxEngineConfig(**shape), prefix_cache=True),
                        dtype=jnp.float32, registry=registry)
    jreqs = [jengine.submit(p, MAX_NEW) for p in prompts]
    jengine.run_until_idle()
    c = engine.counters
    assert c["serve_prefix_evictions_total"] > 0
    if not spec_k:
        jc = registry.snapshot()
        assert {k: c[k] for k in PREFIX_COUNTERS} == {k: int(jc[k]) for k in PREFIX_COUNTERS}
    for req, jreq, p in zip(reqs, jreqs, prompts):
        assert req.state is RequestState.FINISHED
        assert req.generated == offline(tiny.model, p, MAX_NEW) == jreq.generated
    cache = engine.prefix_cache
    assert engine.pool.in_use == len(cache.referenced_blocks())
    cache.flush()
    assert engine.pool.in_use == 0
    engine.pool.check()
