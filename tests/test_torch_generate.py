"""The port's generation against ``deeplearning_mpi_tpu.models.generate``.

Greedy streams are compared token for token on the same weights. Sampled
streams cannot be: ``jax.random`` and ``torch.Generator`` give different
numbers from one seed, so top-k / top-p are compared by their keep-sets on
identical logits (the JAX keep-set read off many JAX draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.generate import generate as jax_generate
from deeplearning_mpi_tpu.models.generate import sample_logits as jax_sample
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import filter_logits, generate, sample_logits
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JaxLM(config=JaxConfig.tiny(), dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    tm.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    prompt = np.random.default_rng(21).integers(1, 256, (2, 7)).astype(np.int32)
    return jm, params, tm, prompt


def _both_greedy(tiny_pair, **kw):
    jm, params, tm, prompt = tiny_pair
    want = np.asarray(jax_generate(
        jm, params, jnp.asarray(prompt), max_new_tokens=6, rng=jax.random.key(0),
        temperature=0.0, **kw))
    got = generate(tm, torch.from_numpy(prompt).long(), max_new_tokens=6,
                   temperature=0.0, **kw).numpy()
    return got, want


def test_greedy_generate_matches_jax(tiny_pair):
    got, want = _both_greedy(tiny_pair)
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_with_eos_matches_jax(tiny_pair):
    plain, _ = _both_greedy(tiny_pair)
    eos = int(plain[0, 7 + 2])  # row 0 samples it at its third new token
    got, want = _both_greedy(tiny_pair, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[0, 7 + 2:] == eos)


LOGITS = np.array([
    [2.0, 1.9, 1.7, 1.5, 0.2, -1.0, -1.0, -3.0, 0.0, 1.0, -2.0, -4.0],
    [0.5, 0.4, 0.45, 3.0, 2.9, -1.0, 0.3, 0.35, -2.0, 0.1, 0.2, -1.0],
], np.float32)


def _jax_keep_set(**kw):
    keys = jax.random.split(jax.random.key(0), 3000)
    draws = jax.vmap(lambda k: jax_sample(jnp.asarray(LOGITS), k, **kw))(keys)
    return [set(np.unique(np.asarray(draws)[:, b]).tolist()) for b in range(LOGITS.shape[0])]


@pytest.mark.parametrize(
    "kw",
    [dict(temperature=1.0, top_k=3), dict(temperature=1.0, top_p=0.7),
     dict(temperature=0.7, top_k=5, top_p=0.8), dict(temperature=1.0, top_p=0.0)],
    ids=["top_k", "top_p", "both", "top_p_zero"],
)
def test_keep_sets_match_jax(kw):
    filtered = filter_logits(torch.from_numpy(LOGITS), **kw)
    keep = [set(torch.nonzero(torch.isfinite(row)).flatten().tolist()) for row in filtered]
    assert keep == _jax_keep_set(**kw)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([
        sample_logits(torch.from_numpy(LOGITS), gen, **kw) for _ in range(200)
    ])
    for b in range(LOGITS.shape[0]):
        assert set(draws[:, b].tolist()) <= keep[b]


def test_greedy_sample_is_first_argmax():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert sample_logits(logits, temperature=0.0).tolist() == [1]
    assert int(jax_sample(jnp.asarray(logits.numpy()), jax.random.key(0), temperature=0.0)[0]) == 1
