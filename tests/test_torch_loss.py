"""The port's LM losses against ``deeplearning_mpi_tpu/ops/loss.py``.

The same numpy inputs go through both; values and gradients (with respect
to the logits, or to the pre-head activations and the head kernel) agree
within atol = rtol = 1e-6 at float32: both compute an f32 log-softmax and
f32 sums, in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.ops import loss as jloss
from deeplearning_mpi_tpu_torch.ops import loss as tloss

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)
B, S, V, DM = 3, 17, 11, 8


def _inputs(masked: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, S, V)).astype(np.float32)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    return logits, tokens, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_lm_cross_entropy_matches_jax(masked):
    logits, tokens, mask = _inputs(masked)
    want, want_g = jax.value_and_grad(
        lambda l: jloss.lm_cross_entropy(l, _j(tokens), _j(mask)))(_j(logits))
    x = _t(logits).requires_grad_()
    got = tloss.lm_cross_entropy(x, _t(tokens), _t(mask))
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("where", [None, "token", "row", "all_zero"])
def test_masked_mean_matches_jax(where):
    rng = np.random.default_rng(1)
    values = rng.normal(size=(B, S)).astype(np.float32)
    w = {None: None, "token": (rng.random((B, S)) < 0.5).astype(np.float32),
         "row": np.array([[1.0], [0.0], [1.0]], np.float32),
         "all_zero": np.zeros((B, S), np.float32)}[where]
    want, want_g = jax.value_and_grad(lambda v: jloss.masked_mean(v, _j(w)))(_j(values))
    x = _t(values).requires_grad_()
    got = tloss.masked_mean(x, _t(w))
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, V)).astype(np.float32)
    labels = rng.integers(0, V, 5).astype(np.int32)
    where = np.array([1, 0, 1, 1, 0], np.float32) if masked else None
    want, want_g = jax.value_and_grad(
        lambda l: jloss.softmax_cross_entropy(l, _j(labels), _j(where)))(_j(logits))
    x = _t(logits).requires_grad_()
    got = tloss.softmax_cross_entropy(x, _t(labels), _t(where))
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("chunk", [5, 16, 64], ids=["ragged", "exact", "over"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_chunked_lm_loss_matches_jax(chunk, masked):
    """S-1 = 16 positions: chunk 5 pads to 20 with zero weight."""
    _, tokens, mask = _inputs(masked, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, DM)).astype(np.float32)
    kernel = rng.normal(size=(DM, V)).astype(np.float32)
    fn = lambda a, k: jloss.chunked_lm_loss(a, k, _j(tokens), chunk_size=chunk, mask=_j(mask))  # noqa: E731
    want, (want_gx, want_gk) = jax.value_and_grad(fn, argnums=(0, 1))(_j(x), _j(kernel))
    tx, tk = _t(x).requires_grad_(), _t(kernel).requires_grad_()
    got = tloss.chunked_lm_loss(tx, tk, _t(tokens), chunk_size=chunk, mask=_t(mask))
    got_gx, got_gk = torch.autograd.grad(got, (tx, tk))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx), **TOL)
    np.testing.assert_allclose(got_gk.numpy(), np.asarray(want_gk), **TOL)
    # and the chunked loss is the standard loss on the full logits
    dense = tloss.lm_cross_entropy(tx.detach() @ tk.detach(), _t(tokens), _t(mask))
    np.testing.assert_allclose(got.item(), dense.item(), **TOL)
