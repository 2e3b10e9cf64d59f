"""The PyTorch port's attention ops against the JAX reference, on the CPU.

Same numpy-seeded inputs through ``deeplearning_mpi_tpu.ops.attention`` and
``deeplearning_mpi_tpu_torch.ops.attention``; float32, atol = rtol = 2e-5
(the two frameworks sum in different orders, nothing more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.ops import attention as jattn
from deeplearning_mpi_tpu_torch.ops import attention as tattn

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "sq, skv, kw",
    [
        (10, 10, dict(causal=False)),
        (10, 10, dict(causal=True)),
        (10, 10, dict(causal=True, window=3)),
        (6, 10, dict(causal=True, q_offset=4)),
        # kv shard entirely in some rows' future: those rows must be zero.
        (6, 10, dict(causal=True, kv_offset=4)),
        (6, 10, dict(causal=True, window=2, q_offset=4, kv_offset=1)),
    ],
    ids=["full", "causal", "window", "q_offset", "empty_rows", "window_offsets"],
)
def test_dense_attention_matches_jax(sq, skv, kw):
    rng = np.random.default_rng(0)
    q = _normal(rng, 2, sq, 3, 8)
    k, v = _normal(rng, 2, skv, 3, 8), _normal(rng, 2, skv, 3, 8)
    want = np.asarray(jattn.dense_attention(*map(jnp.asarray, (q, k, v)), **kw))
    got = tattn.dense_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if kw.get("kv_offset") == 4 and "window" not in kw:
        assert np.all(got[:, :4] == 0)


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("schedule", ["dense", "walk"])
def test_decode_attention_matches_jax(hkv, window, schedule):
    rng = np.random.default_rng(1)
    L, idx = 24, 17
    q = _normal(rng, 2, 1, 4, 8)
    k, v = _normal(rng, 2, L, hkv, 8), _normal(rng, 2, L, hkv, 8)
    kw = dict(window=window, block=8, use_kernel=False)
    if schedule == "walk":
        kw["dense_max"] = 8  # below L: the blockwise walk
    want = np.asarray(jattn.decode_attention(
        *map(jnp.asarray, (q, k, v)), jnp.int32(idx), **kw))
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)), idx, **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hkv", [4, 1], ids=["mha", "mqa"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["matmul", "kernel_plain"])
def test_batched_decode_attention_matches_jax(hkv, window, use_kernel):
    """Per-row fill levels, including an inactive row (-1 -> zeros). The
    JAX side always takes its matmul schedule (its kernel path is the
    Pallas interpreter, held in test_torch_kernels); the port's
    ``use_kernel=True`` on CPU tensors runs K4's plain walk."""
    rng = np.random.default_rng(2)
    L = 20
    index = np.array([0, 7, -1, 19], np.int32)
    q = _normal(rng, 4, 1, 4, 8)
    k, v = _normal(rng, 4, L, hkv, 8), _normal(rng, 4, L, hkv, 8)
    want = np.asarray(jattn.batched_decode_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(index), window=window,
        use_kernel=False))
    got = tattn.batched_decode_attention(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(index), window=window,
        use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[2] == 0)


def test_repeat_kv_matches_jax():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(x), 3).numpy(), np.asarray(jattn.repeat_kv(jnp.asarray(x), 3))
    )
    assert tattn.NEG_INF == jattn.NEG_INF


def test_decode_shape_errors():
    q = torch.zeros(2, 2, 4, 8)
    k = torch.zeros(2, 8, 4, 8)
    with pytest.raises(ValueError, match="one query token"):
        tattn.decode_attention(q, k, k, 3)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        tattn.batched_decode_attention(q[:, :1], k[:, :, :3], k[:, :, :3], torch.zeros(2))
    with pytest.raises(ValueError, match="one fill level per row"):
        tattn.batched_decode_attention(q[:, :1], k, k, torch.zeros(3))
