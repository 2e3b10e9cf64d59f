"""``chip_smoke.py``'s phase-4 bound on K4 (``DEC_TOL``, held by each batch
row through ``decode_close``), at the serving engine's B8 H12 D64 and at
L1024 and L8192, on CPU stand-ins for K4's output.

The stand-in follows the kernel's blocking (``csrc/flash_decode.cu``): each
row's cache is cut into splits of ``SPLIT_ROWS`` rows, each split into
``CHUNK_ROWS``-row chunks, one for each of the block's warps; a warp takes
its chunk's softmax and rounds ``p`` (after the V scale) to q's dtype
against the chunk's max, the warps combine in warp order, and a merge
combines the splits in split order. These must pass the bound:
- the exact output (float64, p rounded at the reference's point against the
  row's max), rounded to the output dtype;
- the split-K stand-in.
These must fail it:
- a K4 that drops each row's last 64-row chunk (rows of one chunk keep it),
  which passes the old bf16 bound ``2e-2 (1 + |want|)`` at L8192;
- a K4 that loses one split of each row (the last, in rows of two or more);
- a merge that weights the partials by l alone, without ``e^(m_i - m)``;
- an output 3% low.
The stand-in also matches the plain version within float32 rounding on every
window and split-boundary case of phase 4.

(The plain version itself is held to the Pallas kernel in interpret mode by
``tests/test_torch_kernels.py``.) ``python -m tests.test_torch_flash_decode``
prints each version's worst-row error against the bound.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu_torch.ops.attention import NEG_INF
from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

B, H, D = 8, 12, 64


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(seed, b, length, heads, kv_heads, head_dim, dtype, fills=None, quant=False):
    """Seeded ``(q, k, v, index, scales)``; ``fills`` None draws fill levels
    with rows 1, 2 and 3 at -1, 0 and L-1."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
               for shape in ((b, 1, heads, head_dim),) + ((b, length, kv_heads, head_dim),) * 2)
    if fills is None:
        fills = rng.integers(0, length, b)
        fills[1:4] = (-1, 0, length - 1)
    index = torch.as_tensor(np.asarray(fills), dtype=torch.int32)
    scales = {}
    if quant:
        k, ks = fd.quantize_kv(k)
        v, vs = fd.quantize_kv(v)
        scales = {"k_scale": ks, "v_scale": vs}
    return q, k, v, index, scales


@functools.lru_cache(maxsize=4)
def _main_path(dtype, length):
    """Phase 4's main-path inputs (B8 H12 Hkv12 D64) and the plain output."""
    q, k, v, index, _ = _inputs(7, B, length, H, H, D, dtype)
    return (q, k, v, index), fd.flash_decode_reference(q, k, v, index)


def _exact(q, k, v, index):
    """The plain version's math in float64 (p rounded to q's dtype against
    the row's max), rounded once to the output dtype."""
    heads, kv_heads = q.shape[2], k.shape[2]
    out = torch.zeros(q.shape[0], heads, q.shape[3], dtype=torch.float64)
    for b, idx in enumerate(index.tolist()):
        if idx < 0:
            continue
        qg = q[b, 0].double().reshape(kv_heads, heads // kv_heads, -1)
        kb, vb = k[b, : idx + 1].double(), v[b, : idx + 1].to(q.dtype).double()
        s = torch.einsum("hgd,khd->hgk", qg, kb) * q.shape[3] ** -0.5
        p = torch.exp(s - s.amax(-1, keepdim=True))
        pv = torch.einsum("hgk,khd->hgd", p.to(q.dtype).double(), vb)
        out[b] = (pv / p.sum(-1, keepdim=True)).reshape(heads, -1)
    return out[:, None].to(q.dtype)


def _split_k(q, k, v, index, window=None, k_scale=None, v_scale=None, mutant=None):
    """K4's split walk on the CPU: each warp's chunk softmax (p rounded to
    q's dtype against the chunk's max), the warps of a split combined, the
    splits merged in order. ``mutant``: ``"last_chunk"`` drops each row's
    last 64-row chunk (in rows of more than one), ``"lost_split"`` each
    row's last split (in rows of more than one), ``"unscaled_merge"`` merges
    by l alone."""
    batch, _, heads, head_dim = q.shape
    length, kv_heads = k.shape[1], k.shape[2]
    group = heads // kv_heads
    split = fd.SPLIT_ROWS
    n_split = -(-length // split)
    pos = torch.arange(n_split * split).reshape(n_split, fd.WARPS, fd.CHUNK_ROWS)
    at = pos.clamp(max=length - 1)
    out = torch.zeros(batch, kv_heads, group, head_dim)
    for b, idx in enumerate(index.tolist()):
        if idx < 0:
            continue
        lo = max(idx - window + 1, 0) if window else 0
        hi = min(idx, length - 1)
        if mutant == "last_chunk" and hi // 64 > lo // 64:
            hi = hi // 64 * 64 - 1
        valid = (pos >= lo) & (pos <= hi)  # [n_split, W, C]
        if mutant == "lost_split" and hi // split > lo // split:
            valid[hi // split] = False
        qg = q[b, 0].float().reshape(kv_heads, group, head_dim)
        kk, vv = k[b][at].to(q.dtype).float(), v[b][at].to(q.dtype).float()
        s = torch.einsum("hgd,swchd->swhgc", qg, kk) * head_dim**-0.5
        if k_scale is not None:
            s = s * k_scale[b][at].permute(0, 1, 3, 2)[:, :, :, None, :]
        mask = valid[:, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(-1)  # [n_split, W, Hkv, G]
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        l = p.sum(-1)
        if v_scale is not None:
            p = p * v_scale[b][at].permute(0, 1, 3, 2)[:, :, :, None, :]
        acc = torch.einsum("swhgc,swchd->swhgd", p.to(q.dtype).float(), vv)

        def combine(m, l, acc, dim, scaled=True):
            live = l > 0
            top = torch.where(live, m, NEG_INF).amax(dim, keepdim=True)
            f = torch.where(live, torch.exp(m - top), 0.0) if scaled else live.float()
            return top.squeeze(dim), (f * l).sum(dim), (f[..., None] * acc).sum(dim)

        m, l, acc = combine(m, l, acc, 1)  # the warps of each split
        _, l, acc = combine(m, l, acc, 0, scaled=mutant != "unscaled_merge")  # the splits
        out[b] = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-37)[..., None], 0.0)
    return out.reshape(batch, heads, head_dim)[:, None].to(q.dtype)


MUTANTS = ["exact", "split_k", "last_chunk", "lost_split", "unscaled_merge", "out_3pct_low"]


@pytest.mark.parametrize("mutant", MUTANTS)
@pytest.mark.parametrize("length", [1024, 8192])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_phase4_bound_rejects_a_wrong_kernel(dtype, length, mutant):
    cs = _chip_smoke()
    (q, k, v, index), want = _main_path(dtype, length)
    if mutant == "exact":
        got = _exact(q, k, v, index)
    elif mutant == "out_3pct_low":
        got = (want.float() * 0.97).to(dtype)
    else:
        got = _split_k(q, k, v, index, mutant=None if mutant == "split_k" else mutant)
    ok, err, rel = cs.decode_close(got, want, *cs.DEC_TOL[str(dtype)[6:]])
    assert ok == (mutant in ("exact", "split_k")), (err, rel)
    if mutant == "last_chunk" and dtype == torch.bfloat16 and length == 8192:
        assert cs.close(got, want, 2e-2)  # what the old bound let through


def _boundary_cases():
    """Phase 4's cases with a window or fills at split edges (float32)."""
    return [c for c in _chip_smoke().k4_cases(fd.SPLIT_ROWS)
            if c[6] == torch.float32 and (c[7] is not None or "split edges" in c[0])]


@pytest.mark.parametrize("case", _boundary_cases(), ids=lambda c: c[0])
def test_split_k_stand_in_matches_plain_on_phase4_edges(case):
    name, b, length, heads, kv_heads, head_dim, dtype, window, quant, fills = case
    q, k, v, index, scales = _inputs(11, b, length, heads, kv_heads, head_dim, dtype, fills, quant)
    got = _split_k(q, k, v, index, window=window, **scales)
    want = fd.flash_decode_reference(q, k, v, index, window=window, **scales)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert bool((got[index < 0] == 0).all())


if __name__ == "__main__":
    # The bound's margins: each version's worst batch row against the plain
    # version, on the main-path inputs and on every bf16 case of phase 4.
    cs = _chip_smoke()
    for dtype in (torch.bfloat16, torch.float32):
        for length in (1024, 8192):
            (q, k, v, index), want = _main_path(dtype, length)
            for mutant in MUTANTS:
                if mutant == "exact":
                    got = _exact(q, k, v, index)
                elif mutant == "out_3pct_low":
                    got = (want.float() * 0.97).to(dtype)
                else:
                    got = _split_k(q, k, v, index, mutant=None if mutant == "split_k" else mutant)
                ok, err, rel = cs.decode_close(got, want, *cs.DEC_TOL[str(dtype)[6:]])
                print(f"{str(dtype)[6:]} L{length} {mutant}: worst row rel L2 {rel:.2e}, "
                      f"max abs {err:.2e}, {'within' if ok else 'outside'} DEC_TOL")
    for name, b, length, heads, kv_heads, head_dim, dtype, window, quant, fills in cs.k4_cases(
            fd.SPLIT_ROWS):
        if dtype == torch.bfloat16:
            q, k, v, index, scales = _inputs(3, b, length, heads, kv_heads, head_dim, dtype, fills,
                                             quant)
            got = _split_k(q, k, v, index, window=window, **scales)
            want = fd.flash_decode_reference(q, k, v, index, window=window, **scales)
            print(f"stand-in, {name}: worst row rel L2 "
                  f"{cs.decode_close(got, want, *cs.DEC_TOL['bfloat16'])[2]:.2e}")
