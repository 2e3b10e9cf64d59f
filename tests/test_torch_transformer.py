"""The port's TransformerLM against the flax model on the same weights.

Weights come across through ``lm_params_from_jax``; inputs are numpy-seeded
tokens fed to both. float32 on the CPU, atol = rtol = 1e-4. Each config
checks the three modes: the full-sequence forward, prefill on an empty
cache (cache contents and last-row logits) and step-by-step decode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.generate import prefill as jax_prefill
from deeplearning_mpi_tpu.models.transformer import apply_rope as jax_rope
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import prefill
from deeplearning_mpi_tpu_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    TransformerLM,
    apply_rope,
)

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT, TOTAL, STEPS = 9, 14, 4

CONFIGS = {
    "tiny": {},
    "gqa_untied": {"num_kv_heads": 2, "tied_embeddings": False},
    "window": {"attention_window": 5},
    "d64": {"num_layers": 2, "num_heads": 2, "head_dim": 64, "d_model": 128, "d_ff": 256},
}


def port_config(jc: JaxConfig) -> TransformerConfig:
    return TransformerConfig(**{
        f.name: getattr(jc, f.name) for f in dataclasses.fields(TransformerConfig)
    })


def port_model(jc: JaxConfig, params) -> TransformerLM:
    model = TransformerLM(port_config(jc), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    return model


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def pair(request):
    jc = dataclasses.replace(JaxConfig.tiny(), **CONFIGS[request.param])
    jm = JaxLM(config=jc, dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tokens = np.random.default_rng(11).integers(0, jc.vocab_size, (2, PROMPT)).astype(np.int32)
    return jm, params, port_model(jc, params), tokens


def test_full_sequence_logits(pair):
    jm, params, tm, tokens = pair
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens).long()).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_cache_and_decode_steps(pair):
    jm, params, tm, tokens = pair
    jcache, jlogits = jax_prefill(jm, params, jnp.asarray(tokens), total_len=TOTAL)
    cache, logits = prefill(tm, torch.from_numpy(tokens).long(), total_len=TOTAL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache.index == PROMPT
    for i in range(tm.config.num_layers):
        attn = jcache[f"layer_{i}"]["attn"]
        np.testing.assert_allclose(cache.k[i].numpy(), np.asarray(attn["cached_key"]), **TOL)
        np.testing.assert_allclose(cache.v[i].numpy(), np.asarray(attn["cached_value"]), **TOL)
        assert not cache.k[i][:, PROMPT:].any()  # unfilled rows stay zero

    decode_model = dataclasses.replace(jm, decode=True)
    feed = np.random.default_rng(12).integers(0, tm.config.vocab_size, (STEPS, 2)).astype(np.int32)
    for step, tok in enumerate(feed):
        pos = PROMPT + step
        jl, mutated = decode_model.apply(
            {"params": params, "cache": jcache}, jnp.asarray(tok)[:, None],
            positions=jnp.full((2, 1), pos, jnp.int32), mutable=["cache"],
        )
        jcache = mutated["cache"]
        with torch.no_grad():
            tl = tm(torch.from_numpy(tok).long()[:, None], cache=cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert cache.index == PROMPT + STEPS


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cache_contract():
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu").init_weights(0)
    cache = KVCache.empty(model.config, 1, 6, torch.float32, "cpu")
    with torch.no_grad():
        model(torch.zeros(1, 4, dtype=torch.long), cache=cache)
        with pytest.raises(ValueError, match="empty cache only"):
            model(torch.zeros(1, 2, dtype=torch.long), cache=cache)
        model(torch.zeros(1, 1, dtype=torch.long), cache=cache)
        model(torch.zeros(1, 1, dtype=torch.long), cache=cache)
        with pytest.raises(ValueError, match="overflows"):
            model(torch.zeros(1, 1, dtype=torch.long), cache=cache)


def test_default_config_is_the_110m_model():
    cfg = TransformerConfig()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.tied_embeddings) == (12, 768, 12, 64, 2048, 32000, True)
    assert port_config(JaxConfig()) == cfg and port_config(JaxConfig.tiny()) == TransformerConfig.tiny()
    with torch.device("meta"):
        n = sum(p.numel() for p in TransformerLM(cfg, device="meta").parameters())
    assert 105e6 < n < 115e6


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(TransformerConfig.tiny())
