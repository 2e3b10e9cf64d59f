"""The port's weight-only int8 quantization against ``deeplearning_mpi_tpu.ops.quant``.

At float32 on the CPU, on numpy-seeded weights and inputs:

- ``quantize_array`` gives JAX's int8 values exactly and its scales, and
  keeps the reference's bounds (``|w - q * scale| <= scale / 2``, extremes
  at ±127, a zero column safe);
- ``QuantDense`` gives JAX's ``QuantDense`` output within 1e-6;
- ``quantize_lm_params`` on the port's state dict gives JAX's converted
  tree (kernels in its ``[in, out]`` layout), and the ``quantized=True``
  model's logits equal JAX's quantized model's within 1e-5;
- a quantized greedy stream (uniform and ragged) is token-identical to
  JAX's quantized stream;
- the host-side ``quantize_kv`` / ``dequantize_kv`` equal JAX's;
- the BHSD training layout is refused for a quantized model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.generate import generate as jax_generate
from deeplearning_mpi_tpu.ops import quant as jquant
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import generate
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.ops import quant
from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)


def test_quantize_array_matches_jax_and_keeps_its_bounds():
    w = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    q, scale = quant.quantize_array(torch.from_numpy(w))
    jq, jscale = jquant.quantize_array(jnp.asarray(w))
    assert q.dtype == torch.int8 and scale.shape == (32,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)
    err = np.abs(w - q.numpy().astype(np.float32) * scale.numpy())
    assert np.all(err <= scale.numpy() / 2 + 1e-7)
    q, scale = quant.quantize_array(torch.tensor([[1.0, -3.0], [-1.0, 3.0]]))
    np.testing.assert_array_equal(q.abs().numpy(), 127)
    q, scale = quant.quantize_array(torch.zeros(8, 4))
    assert bool((q == 0).all()) and bool((scale > 0).all())


def test_quant_dense_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    x = rng.normal(size=(4, 3, 16)).astype(np.float32)
    jq, jscale = jquant.quantize_array(jnp.asarray(w))
    want = jquant.QuantDense(8, jnp.float32).apply(
        {"params": {"kernel": jq, "scale": jscale}}, jnp.asarray(x))
    layer = quant.QuantDense(16, 8, torch.float32)
    layer.load_state_dict({"kernel": torch.from_numpy(np.array(jq)),
                           "scale": torch.from_numpy(np.array(jscale))})
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


CFG = dict(num_kv_heads=2, vocab_size=64)


@pytest.fixture(scope="module")
def pair():
    """JAX's float and quantized models and the port's, on one init."""
    jc = dataclasses.replace(JaxConfig.tiny(), **CFG)
    jm = JaxLM(config=jc, dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tc = dataclasses.replace(TransformerConfig.tiny(), **CFG)
    fp = TransformerLM(tc, dtype=torch.float32, device="cpu")
    fp.load_state_dict(lm_params_from_jax(params))
    qsd = quant.quantize_lm_params(fp.state_dict())
    qm = TransformerLM(tc, dtype=torch.float32, device="cpu", quantized=True)
    qm.load_state_dict(qsd)
    jqm = dataclasses.replace(jm, quantized=True)
    return jqm, jquant.quantize_lm_params(params), qm, qsd


def test_quantize_lm_params_matches_jax(pair):
    _, jqp, _, qsd = pair
    for i in range(2):
        for block, names in (("attn", ("q_proj", "k_proj", "v_proj", "out_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                want = jqp[f"layer_{i}"][block][name]
                pre = f"layers.{i}.{block}.{name}"
                assert f"{pre}.weight" not in qsd
                np.testing.assert_array_equal(qsd[f"{pre}.kernel"].numpy(), np.asarray(want["kernel"]))
                np.testing.assert_allclose(qsd[f"{pre}.scale"].numpy(), np.asarray(want["scale"]),
                                           rtol=1e-7)
    np.testing.assert_array_equal(qsd["embed.weight"].numpy(), np.asarray(jqp["embed"]["embedding"]))


def test_quantized_model_and_greedy_streams_match_jax(pair):
    jqm, jqp, qm, _ = pair
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, CFG["vocab_size"], (2, 12)).astype(np.int32)
    want = np.asarray(jqm.apply({"params": jqp}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = qm(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    prompt = tokens[:, :7]
    want = np.asarray(jax_generate(jqm, jqp, jnp.asarray(prompt), max_new_tokens=8,
                                   rng=jax.random.key(0), temperature=0.0))
    got = generate(qm, torch.from_numpy(prompt).long(), max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    plens = np.array([7, 4], np.int32)
    want = np.asarray(jax_generate(jqm, jqp, jnp.asarray(prompt), max_new_tokens=5,
                                   rng=jax.random.key(0), temperature=0.0,
                                   prompt_lens=jnp.asarray(plens), shared_prefix=4))
    got = generate(qm, torch.from_numpy(prompt).long(), max_new_tokens=5, temperature=0.0,
                   prompt_lens=torch.from_numpy(plens), shared_prefix=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_kv_quantization_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 5, 3, 8)).astype(np.float32) * 4
    x[0, 1, 2] = 0.0  # a zero row: the 1e-12 scale floor
    q, scale = quant.quantize_kv(torch.from_numpy(x))
    jq, jscale = jquant.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = quant.dequantize_kv(q, scale, dtype).float().numpy()
        want = np.asarray(jquant.dequantize_kv(jq, jscale, jdtype).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    got = quant.dequantize_kv(q, scale).numpy()
    assert np.all(np.abs(x - got) <= scale.numpy()[..., None] / 2 + 1e-6)


def test_bhsd_layout_refused_for_a_quantized_model(pair):
    qm = pair[2]
    with pytest.raises(ValueError, match="BSHD path only"):
        qm(torch.zeros(1, 4, dtype=torch.long), attention_fn=flash_attention_bhsd)
