"""int8 KV pools: the port's engine against the JAX int8 engine, and K4's int8 route.

The reference's acceptance case (``tests/test_quant.py``
``TestInt8KVCache``): on the same weights and trace, the float engine
equals offline greedy and the int8 engine's streams keep at least 90% of
the float streams' tokens (matched prefixes). Beyond it: the port's int8
streams equal the JAX int8 engine's token for token (plain, speculative
and with the prefix cache's copy-on-write), the pools' data and scales are
written together, and on the same int8 pages and scales K4's plain version
(``flash_decode_reference`` with scales, the function K4 computes on the
card) agrees with the CPU path's dequantize-then-masked-matmul within 1e-5
in float32: the link that lets the decode step hand K4 int8 pages.
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
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import generate
from deeplearning_mpi_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    self_draft,
)
from deeplearning_mpi_tpu_torch.ops.attention import batched_decode_attention
from deeplearning_mpi_tpu_torch.ops.kernels.flash_decode import flash_decode_reference
from deeplearning_mpi_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine
from deeplearning_mpi_tpu_torch.serving.engine import PagedForward, kv_storage
from deeplearning_mpi_tpu_torch.serving.kv_pool import init_kv_buffers

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

SHAPE = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
MAX_NEW = 5


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxConfig.tiny()
    params = JaxLM(config=cfg, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    return SimpleNamespace(cfg=cfg, params=params, model=model)


def _streams(engine, prompts):
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    engine.run_until_idle()
    engine.pool.check()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("case", ["roundtrip", "saturate", "zero_rows"])
def test_kv_scheme(case):
    """The engine's scheme: |x - q * scale| <= scale / 2, the row's absmax
    at +-127, and zero rows safe (the scale is floored, never 0)."""
    if case == "roundtrip":
        x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 8, 2, 16)).astype(np.float32))
        q, scale = quantize_kv(x)
        assert q.dtype == torch.int8 and scale.shape == x.shape[:-1]
        assert bool(((x - dequantize_kv(q, scale)).abs() <= scale[..., None] / 2 + 1e-7).all())
    elif case == "saturate":
        q, scale = quantize_kv(torch.tensor([[4.0, -2.0, 1.0, -4.0]]))
        assert int(q.abs().max()) == 127
        torch.testing.assert_close(scale, torch.tensor([4.0 / 127.0]))
    else:
        q, scale = quantize_kv(torch.zeros(4, 2, 8))
        assert bool((q == 0).all()) and bool((scale > 0).all())
        assert bool((dequantize_kv(q, scale) == 0).all())


def test_engine_acceptance_at_the_reference_gate(tiny):
    """The reference's case on the same weights and prompts: the float
    engine equals offline greedy, the int8 engine keeps >= 90% of its
    tokens, and both equal the JAX engines' streams token for token."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 255, size=n).astype(np.int32) for n in (5, 11, 3)]
    fp = _streams(ServingEngine(tiny.model, EngineConfig(**SHAPE)), prompts)
    int8_engine = ServingEngine(tiny.model, EngineConfig(**SHAPE, kv_dtype="int8"))
    q8 = _streams(int8_engine, prompts)
    assert int8_engine.pool.quantized and int8_engine.pool.in_use == 0
    for p, stream in zip(prompts, fp):
        out = generate(tiny.model, torch.as_tensor(p, dtype=torch.long)[None],
                       max_new_tokens=MAX_NEW, temperature=0.0)
        assert stream == out[0, len(p):].tolist()
    accepted = sum(next((i for i, (a, b) in enumerate(zip(f, g)) if a != b), len(f))
                   for f, g in zip(fp, q8))
    assert accepted / sum(len(f) for f in fp) >= 0.9, f"fp={fp} int8={q8}"
    for kv_dtype, mine in ((None, fp), ("int8", q8)):
        jengine = JaxEngine(tiny.cfg, tiny.params, JaxEngineConfig(**SHAPE, kv_dtype=kv_dtype),
                            dtype=jnp.float32)
        assert _streams(jengine, prompts) == mine


@pytest.mark.parametrize("mode", ["staggered", "speculative", "prefix_cache"])
def test_int8_streams_equal_the_jax_int8_engine(tiny, mode):
    """int8 pools through the draft's own pools (spec_k 2, 1-layer
    self-draft) and through copy-on-write copies of cached blocks (data and
    scales) give the JAX int8 engine's streams."""
    rng = np.random.default_rng(17)
    if mode == "prefix_cache":
        pre = rng.integers(1, 255, size=10).astype(np.int32)
        prompts = [np.concatenate([pre, rng.integers(1, 255, size=n).astype(np.int32)])
                   for n in (3, 6, 1, 4)]
    else:
        prompts = [rng.integers(1, 255, size=n).astype(np.int32) for n in (7, 2, 13, 5, 9)]
    kw = {"speculative": dict(spec_k=2), "prefix_cache": dict(prefix_cache=True)}.get(mode, {})
    engine = ServingEngine(tiny.model, EngineConfig(**SHAPE, kv_dtype="int8", **kw),
                           draft=self_draft(tiny.model, 1) if mode == "speculative" else None)
    jkw = {}
    if mode == "speculative":
        jkw = dict(draft_config=jax_draft_config(tiny.cfg, 1),
                   draft_params=jax_truncate(tiny.params, 1))
    jengine = JaxEngine(tiny.cfg, tiny.params,
                        dataclasses.replace(JaxEngineConfig(**SHAPE, kv_dtype="int8"), **kw),
                        dtype=jnp.float32, **jkw)
    assert _streams(engine, prompts) == _streams(jengine, prompts)
    if mode == "prefix_cache":
        assert engine.counters["serve_prefix_cow_copies_total"] > 0


def test_int8_pools_write_rows_and_scales_together(tiny):
    """A scatter stores ``quantize_kv`` of the rows and their scales through
    the table; the raw gather returns them; ``copy_block`` copies the four
    pools (data and scales) of a block."""
    c = tiny.model.config
    e = EngineConfig(**SHAPE, kv_dtype="int8")
    fwd = PagedForward(tiny.model, e, kv_dtype=torch.int8)
    kv = init_kv_buffers(c.num_layers, e.num_blocks, e.block_size, c.kv_heads, c.head_dim,
                         torch.int8, "cpu")
    assert len(kv) == 4
    rows = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, c.kv_heads, c.head_dim)).astype(np.float32))
    bid, off = torch.tensor([[5, 5, 6], [7, 7, 7]]), torch.tensor([[2, 3, 0], [0, 1, 2]])
    fwd._scatter(kv, 1, bid, off, rows, -rows)
    table = torch.tensor([[5, 6], [7, 0]])
    k, v, ks, vs = fwd._gather(kv, 1, table, 2, raw=True)
    qk, sk = quantize_kv(rows)
    torch.testing.assert_close(k[0, 2:5], qk[0], rtol=0, atol=0)
    torch.testing.assert_close(ks[1, 0:3], sk[1], rtol=0, atol=0)
    torch.testing.assert_close(v[1, 0:3], quantize_kv(-rows)[0][1], rtol=0, atol=0)
    deq_k, _ = fwd._gather(kv, 1, table, 2)
    torch.testing.assert_close(deq_k, dequantize_kv(k, ks))
    fwd.copy_block(kv, 7, 9)
    for buf in kv:
        assert torch.equal(buf[:, 9], buf[:, 7])


K4_CASES = {
    # (B, L, H, Hkv, D, window, fills)
    "mha": (3, 24, 4, 4, 8, None, [5, 23, 0]),
    "gqa_inactive_row": (4, 32, 4, 2, 16, None, [31, -1, 12, 7]),
    "window": (2, 40, 4, 1, 8, 6, [39, 10]),
}


@pytest.mark.parametrize("name", sorted(K4_CASES))
def test_k4_int8_route_equals_dequantized_matmul(name):
    """On the same int8 pages and scales (the engine's scheme), K4's plain
    version with scales and the masked matmul over dequantized pages agree
    within 1e-5 in float32; inactive rows are zero in both."""
    B, L, H, Hkv, D, window, fills = K4_CASES[name]
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    kq, ks = quantize_kv(torch.from_numpy(rng.normal(size=(B, L, Hkv, D)).astype(np.float32)))
    vq, vs = quantize_kv(torch.from_numpy(rng.normal(size=(B, L, Hkv, D)).astype(np.float32)))
    index = torch.tensor(fills, dtype=torch.int32)
    got = flash_decode_reference(q, kq, vq, index, window=window, k_scale=ks, v_scale=vs)
    want = batched_decode_attention(q, dequantize_kv(kq, ks), dequantize_kv(vq, vs), index,
                                    window=window, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="K4"):
        batched_decode_attention(q, kq, vq, index, use_kernel=False, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("name,error", [("int16", NotImplementedError), ("nope", ValueError),
                                        ("bfloat16", ValueError)])
def test_kv_dtype_names(tiny, name, error):
    """Storage is named, None or int8; an integer type other than int8
    raises, as in the reference, and so does any other name."""
    assert kv_storage("int8") == torch.int8 and kv_storage(None) is None
    with pytest.raises(error):
        ServingEngine(tiny.model, EngineConfig(**SHAPE, kv_dtype=name))
