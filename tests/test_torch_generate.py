"""The port's generation against ``deeplearning_mpi_tpu.models.generate``.

Greedy streams are compared token for token on the same weights: uniform
prompts, ragged prompts (``prompt_lens``, every ``shared_prefix`` up to the
shortest, with EOS), and beam search (plain, EOS, length penalty, the
exhaustive width against a brute-force search; ties ordered as
``lax.top_k``). Sampled streams cannot be: ``jax.random`` and
``torch.Generator`` give different numbers from one seed, so top-k / top-p
are compared by their keep-sets on identical logits (the JAX keep-set read
off many JAX draws).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.generate import beam_search as jax_beam_search
from deeplearning_mpi_tpu.models.generate import generate as jax_generate
from deeplearning_mpi_tpu.models.generate import sample_logits as jax_sample
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import (
    beam_search,
    filter_logits,
    generate,
    sample_logits,
)
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)


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


# -- ragged prompts, shared prefix, beam search (tests/test_generate.py) -------

def _pair(vocab=32, seed=3):
    """A JAX model and the port's on the same weights, ``vocab`` tokens."""
    jc = dataclasses.replace(JaxConfig.tiny(), vocab_size=vocab)
    jm = JaxLM(config=jc, dtype=jnp.float32)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(dataclasses.replace(TransformerConfig.tiny(), vocab_size=vocab),
                       dtype=torch.float32, device="cpu")
    tm.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    return jm, params, tm


PADDED = np.array([[5, 9, 11, 2, 7], [8, 1, 0, 0, 0], [3, 3, 4, 0, 0]], np.int32)
PLENS = np.array([5, 2, 3], np.int32)


def _ragged(pair, prompt=PADDED, plens=PLENS, **kw):
    jm, params, tm = pair
    want = np.asarray(jax_generate(
        jm, params, jnp.asarray(prompt), max_new_tokens=kw.pop("new", 4), rng=jax.random.key(0),
        temperature=0.0, prompt_lens=jnp.asarray(plens), **kw))
    return want


@pytest.mark.parametrize("shared_prefix", [0, 1, 2])
def test_ragged_greedy_matches_jax_and_solo_runs(shared_prefix):
    """Each ragged row equals JAX's ragged output token for token, and its
    own len + new window equals its solo greedy run; every shared prefix up
    to min(prompt_lens) gives the same tokens."""
    pair = _pair()
    want = _ragged(pair, shared_prefix=shared_prefix)
    got = generate(pair[2], torch.from_numpy(PADDED).long(), max_new_tokens=4, temperature=0.0,
                   prompt_lens=torch.from_numpy(PLENS), shared_prefix=shared_prefix).numpy()
    np.testing.assert_array_equal(got, want)
    for b, n in enumerate(PLENS):
        solo = generate(pair[2], torch.from_numpy(PADDED[b: b + 1, :n]).long(), max_new_tokens=4,
                        temperature=0.0).numpy()
        np.testing.assert_array_equal(got[b, : n + 4], solo[0])


def test_pad_bytes_never_fed():
    pair = _pair()
    padded = np.array([[8, 1, 31, 31, 31]], np.int32)
    got = generate(pair[2], torch.from_numpy(padded).long(), max_new_tokens=2, temperature=0.0,
                   prompt_lens=torch.tensor([2])).numpy()
    np.testing.assert_array_equal(got, _ragged(pair, padded, np.array([2], np.int32), new=2))
    assert got[0, :2].tolist() == [8, 1] and got[0, 2:5].tolist() != [31, 31, 31]


@pytest.mark.parametrize("shared_prefix", [0, 2])
def test_ragged_eos_matches_jax(shared_prefix):
    """Per-row EOS windows (a row's selections start at its own length) with
    the done-seed at the prefix boundary: row 1's first greedy token is the
    EOS, so it pads from its first generated slot."""
    pair = _pair()
    free = _ragged(pair, new=5)
    eos = int(free[1, 2])
    want = _ragged(pair, new=5, eos_id=eos, shared_prefix=shared_prefix)
    got = generate(pair[2], torch.from_numpy(PADDED).long(), max_new_tokens=5, temperature=0.0,
                   prompt_lens=torch.from_numpy(PLENS), eos_id=eos,
                   shared_prefix=shared_prefix).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[1, 2:7] == eos)


def _beams(pair, prompt, **kw):
    jm, params, tm = pair
    want = np.asarray(jax_beam_search(jm, params, jnp.asarray(prompt), **kw))
    got = beam_search(tm, torch.from_numpy(prompt).long(), **kw).numpy()
    return got, want


def test_single_beam_equals_greedy():
    pair = _pair(vocab=16, seed=1)
    prompt = np.array([[3, 1, 4, 1]], np.int32)
    got, want = _beams(pair, prompt, max_new_tokens=6, num_beams=1)
    np.testing.assert_array_equal(got, want)
    greedy = generate(pair[2], torch.from_numpy(prompt).long(), max_new_tokens=6,
                      temperature=0.0).numpy()
    np.testing.assert_array_equal(got, greedy)


@pytest.mark.parametrize("kw", [
    dict(num_beams=3), dict(num_beams=4, eos_id=2), dict(num_beams=4, eos_id=2, length_penalty=0.6),
], ids=["plain", "eos", "eos_length_penalty"])
def test_beam_search_matches_jax(kw):
    """Batch rows are independent and each equals JAX's best beam."""
    pair = _pair(vocab=16, seed=1)
    prompts = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    got, want = _beams(pair, prompts, max_new_tokens=5, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :3], prompts)
    for b in range(2):
        solo = beam_search(pair[2], torch.from_numpy(prompts[b: b + 1]).long(),
                           max_new_tokens=5, **kw).numpy()
        np.testing.assert_array_equal(got[b], solo[0])


def test_ties_go_to_the_lower_index_as_in_lax_top_k():
    from deeplearning_mpi_tpu_torch.models.generate import _top_k

    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    values, index = _top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert index.tolist() == np.asarray(want_i).tolist() == [[1, 2, 4, 3]]
    assert values.tolist() == np.asarray(want_v).tolist()


@pytest.mark.parametrize("eos", [None, 2], ids=["plain", "eos"])
def test_exhaustive_beam_finds_the_brute_force_optimum(eos):
    """With W = vocab**2 every prefix survives, so the search is exhaustive:
    it returns the continuation the full causal forward scores highest
    (canonical sequences, scored through their first EOS, with ``eos``),
    and JAX's beam search returns the same tokens."""
    vocab, new = 6, 3
    pair = _pair(vocab=vocab, seed=1)
    prompt = np.array([[2, 5, 0]], np.int32)
    conts = np.array(list(itertools.product(range(vocab), repeat=new)), np.int64)
    full = np.concatenate([np.repeat(prompt, len(conts), 0), conts], axis=1)
    with torch.no_grad():
        logp = torch.log_softmax(pair[2](torch.from_numpy(full)).float(), -1).numpy()
    p_len = prompt.shape[1]

    def score(row, cont):  # through the first EOS; None if not canonical
        s, done = 0.0, False
        for j, t in enumerate(cont):
            if done:
                if t != eos:
                    return None
                continue
            s += logp[row, p_len - 1 + j, t]
            done = eos is not None and t == eos
        return s

    best_score = max(s for s in (score(r, c) for r, c in enumerate(conts)) if s is not None)
    got, want = _beams(pair, prompt, max_new_tokens=new, num_beams=vocab**2, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    row = int(np.argwhere((conts == got[0, p_len:]).all(1))[0, 0])
    np.testing.assert_allclose(score(row, got[0, p_len:]), best_score, atol=1e-5)


def test_length_penalty_requires_eos():
    with pytest.raises(ValueError, match="length_penalty requires"):
        beam_search(_pair(vocab=6)[2], torch.zeros(1, 2, dtype=torch.long), max_new_tokens=2,
                    num_beams=2, length_penalty=0.6)
