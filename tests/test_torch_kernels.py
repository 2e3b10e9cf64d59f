"""The plain versions of K1 and K4 against the Pallas kernels they replace.

The JAX kernels run in the Pallas interpreter on the CPU, as the JAX
package's own kernel tests run them; the port's wrappers, given CPU tensors,
run their plain PyTorch versions (the CUDA kernels are held to those plain
versions on the GPU by ``chip_smoke.py`` and ``test_torch_gpu.py``).
float32, atol = rtol = 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.ops.pallas.flash_attention import flash_fwd_block
from deeplearning_mpi_tpu.ops.pallas.flash_decode import flash_decode as pallas_decode
from deeplearning_mpi_tpu.ops.pallas.flash_decode import quantize_kv as pallas_quantize_kv
from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as tfa
from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as tfd

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [
        dict(causal=True),
        dict(causal=False),
        dict(causal=True, window=20),
        dict(causal=True, window=20, shift=32),
    ],
    ids=["causal", "full", "window", "window_shift"],
)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_attention_plain_matches_pallas(kw, layout):
    """B1 S64 H2 D16 with 16/32 blocks; output and logsumexp (the
    reference's lane-replicated ``lse[..., 0]``)."""
    rng = np.random.default_rng(3)
    shape = (1, 64, 2, 16) if layout == "bshd" else (1, 2, 64, 16)
    q, k, v = (_normal(rng, *shape) for _ in range(3))
    want, want_lse = flash_fwd_block(
        *map(jnp.asarray, (q, k, v)), kw["causal"], 16, 32, True, with_lse=True,
        native_bhsd=layout == "bhsd", window=kw.get("window"), shift=kw.get("shift", 0),
    )
    entry = tfa.flash_attention if layout == "bshd" else tfa.flash_attention_bhsd
    got, got_lse = entry(*map(torch.from_numpy, (q, k, v)), return_lse=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], **TOL)


def test_flash_attention_f32_out_from_bf16():
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, 1, 64, 2, 16) for _ in range(3))
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    want, _ = flash_fwd_block(*jb, True, 16, 32, True, with_lse=False,
                                  out_dtype=jnp.float32, window=24)
    got = tfa.flash_attention(*tb, window=24, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    # Same bf16 inputs, f32 accumulation on both sides; only the order of
    # the f32 sums and the bf16 rounding of p differ.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2, rtol=1e-2)


def test_flash_attention_cpu_dispatch_and_contract():
    """CPU tensors take the plain version and never touch the launch
    counts; a grad-requiring input returns grads through the autograd
    Function; the forward-only options and the option checks raise."""
    x = torch.randn(1, 20, 2, 12)  # ragged S, head dim 12: fine on the plain path
    before = tfa.flash_attention_cuda.launches
    out = tfa.flash_attention(x, x, x)
    assert out.shape == x.shape and tfa.flash_attention_cuda.launches == before == 0
    q = x.clone().requires_grad_()
    out = tfa.flash_attention(q, x, x)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    (grad,) = torch.autograd.grad(out.sum(), q)
    assert grad.shape == x.shape and bool(torch.isfinite(grad).all())
    assert (tfa.flash_attention_bwd_dq_cuda.launches, tfa.flash_attention_bwd_dkv_cuda.launches) == (0, 0)
    with pytest.raises(ValueError, match="forward-only"):
        tfa.flash_attention(q, x, x, return_lse=True)
    with torch.no_grad():
        tfa.flash_attention(q, x, x, return_lse=True)
    with pytest.raises(ValueError, match="shift requires window"):
        tfa.flash_attention(x, x, x, shift=4)
    with pytest.raises(ValueError, match="causal by definition"):
        tfa.flash_attention(x, x, x, causal=False, window=4)
    assert tfa.flash_attention_bhsd.layout == "bhsd"


def _decode_inputs(rng, B=3, L=64, H=4, hkv=2, D=16):
    q = _normal(rng, B, 1, H, D)
    k, v = _normal(rng, B, L, hkv, D), _normal(rng, B, L, hkv, D)
    return q, k, v


@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("window", [None, 20])
def test_flash_decode_plain_matches_pallas(hkv, window):
    rng = np.random.default_rng(5)
    q, k, v = _decode_inputs(rng, hkv=hkv)
    index = np.array([5, 40, 63], np.int32)
    want = pallas_decode(*map(jnp.asarray, (q, k, v)), jnp.asarray(index),
                            block=16, interpret=True, window=window)
    got = tfd.flash_decode(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(index),
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_decode_plain_int8_matches_pallas(window):
    rng = np.random.default_rng(6)
    q, k, v = _decode_inputs(rng)
    jk8, jks = pallas_quantize_kv(jnp.asarray(k))
    jv8, jvs = pallas_quantize_kv(jnp.asarray(v))
    tk8, tks = tfd.quantize_kv(torch.from_numpy(k))
    tv8, tvs = tfd.quantize_kv(torch.from_numpy(v))
    np.testing.assert_array_equal(tk8.numpy(), np.asarray(jk8))
    np.testing.assert_array_equal(tv8.numpy(), np.asarray(jv8))
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=1e-6)
    index = np.array([17, 0, 50], np.int32)
    want = pallas_decode(jnp.asarray(q), jk8, jv8, jnp.asarray(index), block=16,
                            interpret=True, window=window, k_scale=jks, v_scale=jvs)
    got = tfd.flash_decode(torch.from_numpy(q), tk8, tv8, torch.from_numpy(index),
                           window=window, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_decode_cpu_dispatch_and_contract():
    rng = np.random.default_rng(7)
    q, k, v = map(torch.from_numpy, _decode_inputs(rng))
    before = tfd.flash_decode_cuda.launches
    out = tfd.flash_decode(q, k, v, torch.tensor([-1, 3, 63], dtype=torch.int32))
    assert tfd.flash_decode_cuda.launches == before == 0
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    # A scalar index broadcasts to every row.
    torch.testing.assert_close(
        tfd.flash_decode(q, k, v, 9), tfd.flash_decode(q, k, v, torch.full((3,), 9))
    )
    k8, ks = tfd.quantize_kv(k)
    with pytest.raises(ValueError, match="together"):
        tfd.flash_decode(q, k8, k8, 3, k_scale=ks)
    with pytest.raises(ValueError, match="need k_scale"):
        tfd.flash_decode(q, k8, k8, 3)
    with pytest.raises(ValueError, match="one fill level per row"):
        tfd.flash_decode(q, k, v, torch.zeros(2, dtype=torch.int32))
