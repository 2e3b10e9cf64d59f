"""K2/K3 (the flash-attention backward) and the autograd join, against JAX.

- The plain version of K2 and K3 (``flash_attention_bwd_reference``, which
  the CUDA kernels are held to on the card) against the Pallas
  ``flash_bwd_block`` (``_bwd_pallas``) in interpret mode, on the same q, k,
  v, o, do and lse; the port's ``[B, H, S]`` lse goes to JAX broadcast to
  the reference's lane-replicated ``[B, H, S, 128]``.
- The port's autograd Function on CPU tensors against ``jax.grad`` through
  the Pallas ``flash_attention`` / ``flash_attention_bhsd`` (interpret,
  16 x 16 blocks, so JAX really tiles).
- Port only: rows that see no key get zero dq and give nothing to dk/dv.
- ``chip_smoke.py``'s phase-7 bound on the bf16 kernels (``GRAD_TOL``), at
  the main path's S2048, on CPU stand-ins for the kernels' output: the
  exact gradients rounded once more (summation-order noise) pass it; a K2
  that drops its last kv tile, a K3 that drops its last q tile and a dq 3%
  low fail it. An elementwise bound alone, ``2e-2 (1 + |want|)``, passes the
  last.

Tolerances: atol = rtol = 1e-5 at float32 (the same sums in another
order); 2e-2 at bf16 (p and ds are rounded to bf16 on both sides, and a
value near a rounding boundary may round the other way).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from deeplearning_mpi_tpu.ops.pallas.flash_attention import (
    flash_attention_bhsd as jax_flash_bhsd,
)
from deeplearning_mpi_tpu.ops.pallas.flash_attention import flash_bwd_block
from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as tfa

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)

CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    # window 40 at S 64 with 32-row blocks: within one block of S, the case
    # the reference's clamped dkv anchor fixed.
    "window_clamp": dict(causal=True, window=40),
    "window_shift": dict(causal=True, window=40, shift=16),
    "f32_grads": dict(causal=True, window=24, grad_dtype="f32"),
}


def _inputs(rng, shape, dtype):
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_bwd_matches_pallas(case, layout, dtype):
    kw = dict(CASES[case])
    grad_dtype = torch.float32 if kw.pop("grad_dtype", None) else None
    rng = np.random.default_rng(7)
    shape = (2, 64, 2, 16) if layout == "bshd" else (2, 2, 64, 16)
    q, k, v, do = _inputs(rng, shape, dtype)
    o, lse = tfa.flash_attention_reference(q, k, v, return_lse=True, layout=layout, **kw)
    assert bool((lse > -1e29).all())  # every row sees a key: the reference's premise
    got = tfa.flash_attention_bwd_reference(q, k, v, o, do, lse, layout=layout,
                                            grad_dtype=grad_dtype, **kw)
    lse128 = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], (*lse.shape, 128))
    want = flash_bwd_block(
        *map(_jnp, (q, k, v, o, do)), lse128, kw["causal"], 32, 32, True,
        grad_dtype=jnp.float32 if grad_dtype else None, native_bhsd=layout == "bhsd",
        window=kw.get("window"), shift=kw.get("shift", 0),
    )
    for g, w in zip(got, want):
        assert g.dtype == (grad_dtype or dtype)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False), dict(causal=True, window=20)],
                         ids=["causal", "full", "window"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_autograd_function_matches_jax_grad(kw, layout):
    rng = np.random.default_rng(8)
    shape = (2, 64, 2, 16) if layout == "bshd" else (2, 2, 64, 16)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    jentry = jax_flash if layout == "bshd" else jax_flash_bhsd
    jfn = functools.partial(jentry, block_q=16, block_k=16, interpret=True, **kw)
    want = jax.grad(lambda a, b, c: jnp.sum(jfn(a, b, c) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    entry = tfa.flash_attention if layout == "bshd" else tfa.flash_attention_bhsd
    out = entry(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_rows_without_keys_get_zero_grads():
    """shift 20, window 4, S 32: rows 15.. see no key (lse NEG_INF). Their
    dq is zero and their do changes nothing in dk/dv."""
    rng = np.random.default_rng(9)
    q, k, v, do = _inputs(rng, (1, 2, 32, 8), torch.float32)
    kw = dict(causal=True, window=4, shift=20, layout="bhsd")
    o, lse = tfa.flash_attention_reference(q, k, v, return_lse=True, **kw)
    dead = lse[0, 0] < -1e29
    assert dead[15:].all() and not dead[:15].any()
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert bool((dq[:, :, 15:] == 0).all()) and bool(torch.isfinite(dq).all())
    do_live = do.clone()
    do_live[:, :, 15:] = 0
    _, dk2, dv2 = tfa.flash_attention_bwd(q, k, v, o, do_live, lse, **kw)
    torch.testing.assert_close(dk, dk2, atol=0, rtol=0)
    torch.testing.assert_close(dv, dv2, atol=0, rtol=0)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _masked_bwd(q, k, v, o, do, lse, keep, acc):
    """The plain K2/K3 math over BHSD, summing in ``acc``, with the pairs
    outside ``keep`` left out (a stand-in for a kernel that skips them)."""
    scale = q.shape[-1] ** -0.5
    s = (q.to(acc) @ k.to(acc).mT) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None].to(acc)), 0.0)
    delta = (o.to(acc) * do.to(acc)).sum(-1, keepdim=True)
    ds = torch.where(keep, p * (do.to(acc) @ v.to(acc).mT - delta) * scale, 0.0)
    ds, p = ds.to(q.dtype).to(acc), p.to(q.dtype).to(acc)
    return tuple(g.to(q.dtype) for g in (ds @ k.to(acc), ds.mT @ q.to(acc), p.mT @ do.to(acc)))


@functools.lru_cache(maxsize=2)
def _main_path_bwd(window):
    """bf16 B1 H2 S2048 D64 causal inputs and their plain (dq, dk, dv)."""
    gen = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(1, 2, 2048, 64, generator=gen).bfloat16() for _ in range(4))
    o, lse = tfa.flash_attention_reference(q, k, v, return_lse=True, layout="bhsd", window=window)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, do, lse, layout="bhsd", window=window)
    return (q, k, v, o, do, lse), want


@pytest.mark.parametrize("mutant", ["none", "k2_last_kv_tile", "k3_last_q_tile", "dq_3pct_low"])
@pytest.mark.parametrize("window", [None, 512], ids=["causal", "window512"])
def test_phase7_bound_rejects_a_wrong_kernel(mutant, window):
    cs = _chip_smoke()
    inputs, want = _main_path_bwd(window)
    # The bf16 kernels' block and streamed tile (kBlockRows, kTileRows in
    # csrc/flash_attention_bwd.cu): a block owns 128 q rows (K2) or keys (K3)
    # and streams 64-row tiles of the other side.
    seq, block, tile = 2048, 128, 64
    i, j = torch.arange(seq)[:, None], torch.arange(seq)[None, :]
    valid = tfa._valid_pairs(seq, True, window, 0, "cpu")
    # The last tile of each block's loop: K2's block ends at q row i|127, its
    # last kv tile holds that row; K3's last q tile holds row k_hi + window - 1.
    last_kv = (i // block * block + block - 1).clamp(max=seq - 1) // tile
    last_q = (j // block * block + block - 1 + (window or seq) - 1).clamp(max=seq - 1) // tile
    if mutant == "none":
        got = _masked_bwd(*inputs, valid, torch.float64)
    elif mutant == "k2_last_kv_tile":
        got = (_masked_bwd(*inputs, valid & (j // tile != last_kv), torch.float32)[0], *want[1:])
    elif mutant == "k3_last_q_tile":
        got = (want[0], *_masked_bwd(*inputs, valid & (i // tile != last_q), torch.float32)[1:])
    else:
        got = ((want[0].float() * 0.97).bfloat16(), *want[1:])
    verdicts = [cs.grads_close(g, w, *cs.GRAD_TOL["bfloat16"])[0] for g, w in zip(got, want)]
    assert all(verdicts) == (mutant == "none"), verdicts
    if mutant == "dq_3pct_low":
        assert cs.close(got[0], want[0], 2e-2)


@functools.lru_cache(maxsize=1)
def _gqa_bwd():
    """bf16 B1 S1024 D64 causal inputs with 6 query heads over 2 KV heads
    (K/V repeated, as Ulysses' inner gets them), and the plain per-head
    (dq, dk, dv) over BHSD."""
    gen = torch.Generator().manual_seed(12)
    q, do = (torch.randn(1, 6, 1024, 64, generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, 2, 1024, 64, generator=gen).bfloat16().repeat_interleave(3, dim=1)
            for _ in range(2))
    o, lse = tfa.flash_attention_reference(q, k, v, return_lse=True, layout="bhsd")
    want = tfa.flash_attention_bwd_reference(q, k, v, o, do, lse, layout="bhsd")
    return (q, k, v, o, do, lse), want


def _group_sum(g: torch.Tensor) -> torch.Tensor:
    """Per-head ``[B, H, S, D]`` gradients summed over each KV head's 3
    query heads in float32 and rounded once, as GQA's repeat backward."""
    b, h, s, d = g.shape
    return g.float().reshape(b, h // 3, 3, s, d).sum(2).bfloat16()


@pytest.mark.parametrize("mutant", ["none", "k3_last_q_tile", "dv_3pct_low", "dk_64_rows"])
def test_14a_gqa_bound_rejects_a_wrong_kernel(mutant):
    """Phase 14a's dK / dV bound under GQA, taken of each group's sum of
    term magnitudes (``chip_smoke.terms_scale``): a right kernel (the terms
    rounded from another accumulation order) passes; a dropped q tile, a
    dV 3% low and a dropped 64-row chunk of dK each fail."""
    cs = _chip_smoke()
    inputs, want = _gqa_bwd()
    seq, block, tile = 1024, 128, 64
    i = torch.arange(seq)[:, None]
    valid = tfa._valid_pairs(seq, True, None, 0, "cpu")
    terms = _masked_bwd(*inputs, valid, torch.float64)
    if mutant == "k3_last_q_tile":
        j = torch.arange(seq)[None, :]
        last_q = (j // block * block + block - 1 + seq - 1).clamp(max=seq - 1) // tile
        terms = (terms[0], *_masked_bwd(*inputs, valid & (i // tile != last_q), torch.float32)[1:])
    elif mutant == "dv_3pct_low":
        terms = (*terms[:2], (terms[2].float() * 0.97).bfloat16())
    elif mutant == "dk_64_rows":
        dk = terms[1].clone()
        dk[:, :, 512:576] = 0
        terms = (terms[0], dk, terms[2])
    to_bshd = lambda t: t.transpose(1, 2)  # noqa: E731
    verdicts = []
    for g_terms, w_terms in zip(terms[1:], want[1:]):
        got, ref = to_bshd(_group_sum(g_terms)), to_bshd(_group_sum(w_terms))
        scale = cs.terms_scale(to_bshd(w_terms), 3)
        verdicts.append(cs.grads_close(got, ref, *cs.GRAD_TOL["bfloat16"], scale)[0])
    assert all(verdicts) == (mutant == "none"), verdicts
