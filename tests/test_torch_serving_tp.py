"""The port's serving engine over a tensor-parallel model against JAX.

``test_torch_serving.py``'s staggered trace (8 ragged requests over 3
slots) through the port's ``ServingEngine`` over a ``LockstepTP(2, "cpu")``
model: 2 layers, 4 heads of 16, 2 K/V heads (a rank holds one), float32,
on the JAX model's weights (``models/convert.py`` ``lm_params_from_jax``,
split by the tp plan). Every stream must equal the JAX ``ServingEngine``'s
and the port's offline greedy at tp 1 and at tp 2, token for token; the
paged decode and prefill-chunk logits must sit within ``LOGIT_L2`` relative
L2 of the JAX model's logits at the same positions. The rest of the engine
at tp 2: the disaggregated pair, the prefix cache's copy-on-write, warmup,
the per-rank pools, the hot swap in place, and the refusals. Four wrong
copies (a rank's partial dropped, rank 1's K/V written into rank 0's pool,
a copy-on-write of rank 0's pools only, a swap of rank 0's shards only)
each fail the bar they are aimed at.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.serving import EngineConfig as JaxEngineConfig
from deeplearning_mpi_tpu.serving import ServingEngine as JaxEngine
from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    self_draft,
)
from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP, split_name
from deeplearning_mpi_tpu_torch.serving import (
    DisaggregatedEngine,
    EngineConfig,
    PagedForward,
    RequestState,
    ServingEngine,
)
from deeplearning_mpi_tpu_torch.serving.engine import (
    TP_INT8_REASON,
    TP_SPEC_REASON,
    engine_kv_buffers,
)

torch.set_num_threads(1)

from test_torch_serving import (  # noqa: E402
    ARRIVE_AT_STEP, MAX_NEW, PROMPT_LENS, SHAPE, FakeClock)
from test_torch_serving import _replay as _jax_replay  # noqa: E402

TP = 2
WIDTHS = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              d_model=32, d_ff=64)
#: the paged logits against the JAX model's, relative L2, float32
LOGIT_L2 = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(config=JaxConfig(**WIDTHS), dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    one = TransformerLM(TransformerConfig(**WIDTHS), dtype=torch.float32, device="cpu")
    one.load_state_dict(lm_params_from_jax(params))
    tpm = TransformerLM(TransformerConfig(**WIDTHS), dtype=torch.float32, device="cpu",
                        tp=LockstepTP(TP, "cpu"))
    tpm.load_state_dict(lm_params_from_jax(params, tpm))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 255, size=n).astype(np.int32) for n in PROMPT_LENS]
    return {"jax": jm, "params": params, "one": one, "tp": tpm, "prompts": prompts}


def serve(model, prompts, *, engine_cls=ServingEngine, warm=False, **cfg):
    """``test_torch_serving``'s staggered replay, for the colocated engine
    or the disaggregated pair."""
    clock = FakeClock()
    engine = engine_cls(model, EngineConfig(**SHAPE, **cfg), clock=clock)
    if warm:
        engine.warmup()
    idle = engine.idle if engine_cls is DisaggregatedEngine else engine.scheduler.idle
    reqs, step = {}, 0
    while step in ARRIVE_AT_STEP or not idle():
        for i in ARRIVE_AT_STEP.get(step, []):
            reqs[i] = engine.submit(prompts[i], MAX_NEW)
        engine.step()
        clock.t += 1.0
        step += 1
        assert step < 500, "engine did not drain"
    return engine, [reqs[i] for i in range(len(prompts))]


@pytest.fixture(scope="module")
def runs(models):
    prompts = models["prompts"]
    engine, port = serve(models["tp"], prompts)
    jclock = FakeClock()
    jengine = JaxEngine(JaxConfig(**WIDTHS), models["params"], JaxEngineConfig(**SHAPE),
                        dtype=jnp.float32, clock=jclock)
    ref = _jax_replay(jengine, prompts, jclock)
    offline = {name: [offline_greedy(models[name], p, MAX_NEW, None) for p in prompts]
               for name in ("one", "tp")}
    return {"engine": engine, "port": port, "jax": ref, "offline": offline}


def test_tp_streams_equal_jax_engine_and_offline_greedy(runs):
    assert sorted(ARRIVE_AT_STEP) == [0, 2, 4, 6]
    for i, (req, jreq) in enumerate(zip(runs["port"], runs["jax"])):
        assert req.state is RequestState.FINISHED
        assert req.generated == jreq.generated, f"request {i}: tp 2 engine != JAX engine"
        assert req.generated == runs["offline"]["one"][i] == runs["offline"]["tp"][i], (
            f"request {i}: tp 2 engine != offline greedy")
    pool = runs["engine"].pool
    pool.check()
    assert pool.in_use == 0 and pool.total_allocated == pool.total_freed > 0


def paged_logits(model, prompts, cont, kv=None):
    """Each prompt prefilled chunk by chunk through ``PagedForward`` in its
    own block table (every chunk's last-row logits), then ``len(cont[0])``
    batched decode steps feeding each row its continuation (every step's
    logits): ``[(prompt index, position, logits)]``."""
    e = EngineConfig(**SHAPE)
    kv = engine_kv_buffers(model, e, None).bufs if kv is None else kv
    fwd = PagedForward(model, e)
    tables = np.zeros((e.max_slots, e.max_blocks_per_seq), np.int64)
    for s in range(len(prompts)):
        tables[s] = 1 + s * e.max_blocks_per_seq + np.arange(e.max_blocks_per_seq)
    out = []
    for s, p in enumerate(prompts):
        for start in range(0, len(p), e.prefill_chunk):
            n = min(e.prefill_chunk, len(p) - start)
            chunk = np.zeros(e.prefill_chunk, np.int64)
            chunk[:n] = p[start:start + n]
            logits = fwd.prefill_chunk(kv, torch.from_numpy(tables[s]), torch.from_numpy(chunk),
                                       start, n)
            out.append((s, start + n - 1, logits.numpy()))
    for t in range(len(cont[0])):
        lengths = np.zeros(e.max_slots, np.int64)
        tokens = np.zeros(e.max_slots, np.int64)
        active = np.zeros(e.max_slots, bool)
        for s, p in enumerate(prompts):
            lengths[s], tokens[s], active[s] = len(p) + t + 1, cont[s][t], True
        logits = fwd.decode_logits(kv, *(torch.from_numpy(a) for a in
                                         (tables, lengths, tokens, active)))
        out.extend((s, len(p) + t, logits[s].numpy()) for s, p in enumerate(prompts))
    return out


@pytest.fixture(scope="module")
def logit_case(models):
    """Two prompts (13 and 6 tokens, several chunks, one partial) with a
    seeded 5-token continuation each, and the JAX model's logits over each
    whole sequence."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 255, size=n).astype(np.int64) for n in (13, 6)]
    cont = [rng.integers(1, 255, size=5).astype(np.int64) for _ in prompts]
    want = []
    for p, c in zip(prompts, cont):
        seq = jnp.asarray(np.concatenate([p, c])[None], jnp.int32)
        want.append(np.asarray(models["jax"].apply({"params": models["params"]}, seq))[0])
    return prompts, cont, want


def worst_logit_error(model, logit_case, kv=None) -> float:
    prompts, cont, want = logit_case
    return max(rel(got, want[s][pos]) for s, pos, got in paged_logits(model, prompts, cont, kv))


def test_tp_paged_logits_match_jax(models, logit_case):
    """Every prefill chunk's and decode step's logits at tp 2 (and at tp 1)
    within ``LOGIT_L2`` relative L2 of the JAX model's at that position."""
    for name in ("tp", "one"):
        worst = worst_logit_error(models[name], logit_case)
        assert worst <= LOGIT_L2, f"{name}: worst relative L2 {worst:.3e}"


def test_wrong_copy_a_rank_partial_dropped_fails_the_logit_bar(models, logit_case, monkeypatch):
    over_ranks = PagedForward._over_ranks

    def dropped(self, pair, h, ranks, attend):
        def attend_wrong(j, *a):
            out = attend(j, *a)
            return out * 0 if j == 1 else out
        return over_ranks(self, pair, h, ranks, attend_wrong)

    monkeypatch.setattr(PagedForward, "_over_ranks", dropped)
    assert worst_logit_error(models["tp"], logit_case) > LOGIT_L2


def test_wrong_copy_rank1_kv_into_rank0_pool_fails_the_logit_bar(models, logit_case,
                                                                  monkeypatch):
    scatter = PagedForward._scatter
    bufs = engine_kv_buffers(models["tp"], EngineConfig(**SHAPE), None).bufs

    def misrouted(self, kv, *a):
        scatter(self, bufs[0] if kv is bufs[1] else kv, *a)

    monkeypatch.setattr(PagedForward, "_scatter", misrouted)
    assert worst_logit_error(models["tp"], logit_case, bufs) > LOGIT_L2


def test_tp_kv_buffers_per_rank(models):
    e = EngineConfig(**SHAPE)
    one, tp = (engine_kv_buffers(models[n], e, None) for n in ("one", "tp"))
    assert len(tp.bufs) == TP and all(len(r) == 2 for r in tp.bufs)
    c = models["one"].config
    local = (c.num_layers, e.num_blocks, e.block_size, c.kv_heads // TP, c.head_dim)
    assert all(tuple(t.shape) == local for t in tp.tensors())
    assert tp.nbytes == one.nbytes
    engine = ServingEngine(models["tp"], e)
    assert engine._kvh.nbytes == one.nbytes and len(engine.rank_launches) == TP


def test_tp_disaggregated_pair_equals_colocated(models, runs):
    engine, reqs = serve(models["tp"], models["prompts"], engine_cls=DisaggregatedEngine)
    assert [r.generated for r in reqs] == [r.generated for r in runs["port"]]
    assert engine.decode._kvh is engine.prefill._kvh and len(engine.prefill._kvh.bufs) == TP
    assert engine.counters["serve_handoffs_total"] == len(reqs)
    engine.pool.check()
    assert engine.pool.in_use == 0


def prefix_prompts():
    """Three groups sharing a 10-token prefix (tails diverging mid-block
    of the 4-token blocks), one prompt repeated."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        prefix = rng.integers(1, 255, size=10)
        for tail in (3, 5, 3):
            out.append(np.concatenate([prefix, rng.integers(1, 255, size=tail)]).astype(np.int32))
    out.append(out[0].copy())
    return out


def run_prefix(model):
    engine = ServingEngine(model, EngineConfig(**SHAPE, prefix_cache=True))
    prompts = prefix_prompts()
    reqs = []
    for p in prompts:  # one at a time: each finds its predecessors cached
        reqs.append(engine.submit(p, MAX_NEW))
        engine.run_until_idle()
    return engine, prompts, reqs


def test_tp_prefix_cache_copy_on_write(models):
    engine, prompts, reqs = run_prefix(models["tp"])
    c = engine.counters
    assert c["serve_prefix_tokens_reused_total"] > 0 and c["serve_prefix_cow_copies_total"] > 0
    assert [r.generated for r in reqs] == [offline_greedy(models["one"], p, MAX_NEW, None)
                                           for p in prompts]
    engine.pool.check()
    engine.prefix_cache.flush()
    engine.pool.check()
    assert engine.pool.in_use == 0


def test_wrong_copy_cow_of_rank0_only_fails_the_stream_bar(models, monkeypatch):
    def rank0_only(self, kv, src, dst):
        for buf in kv[0]:
            buf[:, dst] = buf[:, src]

    monkeypatch.setattr(PagedForward, "copy_block", rank0_only)
    engine, prompts, reqs = run_prefix(models["tp"])
    assert engine.counters["serve_prefix_cow_copies_total"] > 0
    assert [r.generated for r in reqs] != [offline_greedy(models["one"], p, MAX_NEW, None)
                                           for p in prompts]


def test_tp_warmup_builds_the_programs_of_tp1(models, runs):
    built = {}
    for name in ("one", "tp"):
        engine, reqs = serve(models[name], models["prompts"], warm=True)
        built[name] = (engine.captures, engine.counters["serve_compile_total"])
        assert [r.generated for r in reqs] == [r.generated for r in runs["port"]]
    assert built["one"] == built["tp"] and built["tp"][0] > 0


def swap(model, seed: int, *, rank0_only: bool = False) -> None:
    """The fleet's hot swap (``init_weights`` in place); ``rank0_only``
    refills the replicated leaves and rank 0's shards only."""
    if not rank0_only:
        model.init_weights(seed)
        return
    fresh = TransformerLM(model.config, dtype=torch.float32, device="cpu",
                          tp=LockstepTP(TP, "cpu")).init_weights(seed)
    new = dict(fresh.named_parameters())
    with torch.no_grad():
        for name, p in model.named_parameters():
            if split_name(name)[1] in (None, 0):
                p.copy_(new[name])


@pytest.mark.parametrize("rank0_only", [False, True], ids=["in_place", "wrong_rank0_only"])
def test_tp_hot_swap(models, rank0_only):
    """The swap refills every rank's shards in the same storages; the
    swapped engine's streams equal the UNSHARDED model of the new seed's
    offline greedy. A swap of rank 0's shards only fails that bar."""
    cfg = TransformerConfig(**WIDTHS)
    model = TransformerLM(cfg, dtype=torch.float32, device="cpu",
                          tp=LockstepTP(TP, "cpu")).init_weights(0)
    engine = ServingEngine(model, EngineConfig(**SHAPE))
    engine.warmup()
    storages = [p.data_ptr() for p in model.parameters()]
    swap(model, 1, rank0_only=rank0_only)
    assert [p.data_ptr() for p in model.parameters()] == storages
    prompts = models["prompts"]
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    engine.run_until_idle()
    want = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(1)
    same = [r.generated for r in reqs] == [offline_greedy(want, p, MAX_NEW, None)
                                           for p in prompts]
    assert same is not rank0_only


def test_tp_refusals(models):
    tpm = models["tp"]
    with pytest.raises(NotImplementedError) as err:
        ServingEngine(tpm, EngineConfig(**SHAPE, spec_k=2), draft=self_draft(tpm, 1))
    assert str(err.value) == TP_SPEC_REASON and "--spec_k" in TP_SPEC_REASON
    with pytest.raises(NotImplementedError) as err:
        ServingEngine(tpm, EngineConfig(**SHAPE, kv_dtype="int8"))
    assert str(err.value) == TP_INT8_REASON and "--kv_dtype" in TP_INT8_REASON
    with pytest.raises(NotImplementedError, match="kv_dtype"):
        DisaggregatedEngine(tpm, EngineConfig(**SHAPE, kv_dtype="int8"))
    with pytest.raises(NotImplementedError, match="spec_k"):
        PagedForward(tpm, EngineConfig(**SHAPE)).verify_step(*[None] * 6)
