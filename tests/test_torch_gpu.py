"""The CUDA kernels against their plain versions, on the GPU.

Marked ``gpu``: each test skips (from the ``cuda`` fixture, never at import
time) where ``torch.cuda.is_available()`` is false. On the card:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file does
not use and the card's machine need not have.)
"""

import pytest
import torch

from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "kw",
    [dict(), dict(causal=False), dict(window=33), dict(window=40, shift=70, return_lse=True)],
    ids=["causal", "full", "window", "shift_lse"],
)
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, kw):
    q, k, v = (torch.randn(2, 150, 3, 64, generator=cuda, device="cuda").to(dtype)
               for _ in range(3))
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_reference(q, k, v, **kw)
    if kw.get("return_lse"):
        (got, got_lse), (want, want_lse) = got, want
        torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_kernel_rejects_unsupported_head_dim(cuda):
    x = torch.randn(1, 16, 2, 12, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(x, x, x)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 50])
def test_flash_decode_kernel_matches_plain(cuda, quant, window):
    q = torch.randn(4, 1, 8, 64, generator=cuda, device="cuda")
    k = torch.randn(4, 300, 2, 64, generator=cuda, device="cuda")
    v = torch.randn(4, 300, 2, 64, generator=cuda, device="cuda")
    index = torch.tensor([-1, 0, 150, 299], dtype=torch.int32, device="cuda")
    scales = {}
    if quant:
        k, ks = fd.quantize_kv(k)
        v, vs = fd.quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    got = fd.flash_decode(q, k, v, index, window=window, **scales)
    want = fd.flash_decode_reference(q, k, v, index, window=window, **scales)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.all(got[0] == 0)
