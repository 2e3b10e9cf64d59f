"""The port's serving engine against offline greedy and the JAX engine.

One staggered-arrival trace (8 ragged requests over 3 slots, later arrivals
landing in slots and KV blocks that earlier requests vacated) runs through
the port's ``ServingEngine`` and the JAX ``ServingEngine`` on the same
weights. Every port stream must equal both the port's offline greedy
``generate`` and the JAX engine's stream, token for token. The port's
pool and scheduler (host-side copies of the JAX ones) get invariant checks.
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
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import generate
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.serving import (
    SCRATCH_BLOCK,
    EngineConfig,
    PagedKVPool,
    RequestState,
    ServingEngine,
)

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

PROMPT_LENS = (5, 13, 3, 17, 1, 9, 2, 11)
MAX_NEW = 5
SHAPE = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
ARRIVE_AT_STEP = {0: [0, 1, 2], 2: [3, 4], 4: [5], 6: [6, 7]}


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _replay(engine, prompts, clock):
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
def runs():
    jm = JaxLM(config=JaxConfig.tiny(), dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 255, size=n).astype(np.int32) for n in PROMPT_LENS]

    clock = FakeClock()
    engine = ServingEngine(model, EngineConfig(**SHAPE), clock=clock)
    port = _replay(engine, prompts, clock)
    jclock = FakeClock()
    jengine = JaxEngine(JaxConfig.tiny(), params, JaxEngineConfig(**SHAPE),
                        dtype=jnp.float32, clock=jclock)
    ref = _replay(jengine, prompts, jclock)
    offline = [
        generate(model, torch.from_numpy(p).long()[None], max_new_tokens=MAX_NEW,
                 temperature=0.0)[0, len(p):].tolist()
        for p in prompts
    ]
    return {"engine": engine, "port": port, "jax": ref, "offline": offline}


def test_streams_match_offline_greedy_and_jax_engine(runs):
    for req, jreq, expect in zip(runs["port"], runs["jax"], runs["offline"]):
        assert req.state is RequestState.FINISHED
        assert req.generated == expect, f"rid {req.rid}: engine {req.generated} != offline {expect}"
        assert req.generated == jreq.generated, f"rid {req.rid}: port != JAX engine"


def test_slot_reuse_exercised_and_pool_drained(runs):
    reqs = runs["port"]
    reused = [
        (f.rid, g.rid) for f in reqs for g in reqs
        if f.t_finished is not None and g.t_admitted is not None
        and g.t_admitted >= f.t_finished and set(f.blocks) & set(g.blocks)
    ]
    assert reused, "no finished request's blocks were ever reassigned"
    pool = runs["engine"].pool
    pool.check()
    assert pool.in_use == 0 and pool.total_allocated == pool.total_freed > 0
    assert all(r.ttft is not None and r.tpot is not None for r in reqs)


def test_engine_decode_path_kernel_and_matmul_agree():
    """``use_kernel`` True (K4's plain walk on CPU) and False (the masked
    matmul) are two schedules of one function."""
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu").init_weights(3)
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % 251 for n in (6, 11, 2)]
    streams = []
    for use_kernel in (True, False):
        engine = ServingEngine(model, EngineConfig(**SHAPE, use_kernel=use_kernel))
        reqs = [engine.submit(p, 6) for p in prompts]
        engine.run_until_idle()
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]


def test_pool_alloc_free_and_scratch():
    pool = PagedKVPool(8, 4)
    assert pool.capacity == 7 and pool.alloc(3) == [1, 2, 3]
    assert SCRATCH_BLOCK not in pool.alloc(4)
    assert pool.alloc(1) is None  # all-or-nothing
    pool.free([1, 2])
    with pytest.raises(ValueError):
        pool.free([1])  # double free
    with pytest.raises(ValueError):
        pool.free([SCRATCH_BLOCK])
    pool.check()


def test_engine_rejects_undersized_pool_and_sheds_too_long():
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="max_blocks_per_seq"):
        ServingEngine(model, EngineConfig(num_blocks=4, max_blocks_per_seq=8))
    engine = ServingEngine(model, EngineConfig(**SHAPE))
    req = engine.submit(np.ones(30, np.int32), 5)  # 35 > 8 * 4 positions
    assert req.state is RequestState.SHED and req.shed_reason == "too_long"


def test_serve_lm_selftest_cli_on_cpu(capsys):
    """``cli/serve_lm.py --selftest``: a Poisson trace through the engine,
    every stream checked against offline greedy, TTFT/TPOT reported."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import main

    rc = main([
        "--selftest", "--device", "cpu", "--num_layers", "2", "--num_heads", "2",
        "--num_kv_heads", "1", "--head_dim", "8", "--d_model", "16", "--d_ff", "32",
        "--num_requests", "5", "--rate", "1000", "--max_new_tokens", "4",
        "--max_slots", "2", "--block_size", "4", "--num_blocks", "16",
        "--max_blocks_per_seq", "8", "--prefill_chunk", "4",
    ])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "selftest OK: 5 requests" in err and "TTFT p50/p95" in err
