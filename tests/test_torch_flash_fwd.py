"""``chip_smoke.py``'s phase-3 bound on K1 (``FWD_TOL``), at the main path's
S2048, on CPU stand-ins for K1's output.

The stand-ins follow the kernels' blocking (``csrc/flash_attention_fwd.cu``):
a bf16 block owns 128 q rows, a float32 block 32, and both stream 64-key
tiles from the tile holding the block's first visible key to the one holding
its last row. These must pass the bound:
- the exact output and lse (float64, with the reference's rounding points),
  rounded once more to the output dtype: summation-order noise;
- an online softmax over 64-key tiles that rounds ``p`` to the input dtype
  against the running max, as the kernel does (the reference's rounding
  point, ``p.astype(v.dtype)``).
These must fail it:
- a K1 that drops the last kv tile of each block's loop;
- a K1 whose last tile reads the previous ring stage's V;
- an output 3% low, which the old bf16 bound ``2e-2 (1 + |want|)`` passes
  on every row past the first kv tile (whose rows see few keys and so hold
  the output's largest values).

(The plain version itself is held to the Pallas kernel in interpret mode by
``tests/test_torch_kernels.py``.)
"""

import functools
import importlib.util
import pathlib

import pytest
import torch

from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as tfa

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

SEQ, TILE = 2048, 64
BLOCK_ROWS = {torch.bfloat16: 128, torch.float32: 32}


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=4)
def _main_path_fwd(dtype, window):
    """B1 H2 S2048 D64 causal inputs and their plain (o, lse), BHSD."""
    gen = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(1, 2, SEQ, 64, generator=gen).to(dtype) for _ in range(3))
    return (q, k, v), tfa.flash_attention_reference(q, k, v, return_lse=True, layout="bhsd",
                                                    window=window)


def _exact(q, k, v, window):
    """The plain version's math in float64, rounded once to the output dtype."""
    valid = tfa._valid_pairs(SEQ, True, window, 0, "cpu")
    s = (q.double() @ k.double().mT) * q.shape[-1] ** -0.5
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = p.to(q.dtype).double() @ v.double() / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0].float()


def _online(q, k, v, window, block, mutant=None):
    """K1's online softmax, tile by tile: p rounded to the input dtype
    against the running max, l summed from the unrounded p. ``mutant``
    ``"last_kv_tile"`` leaves out the last tile of each block's loop;
    ``"stale_v"`` gives that tile the previous tile's V."""
    scale = q.shape[-1] ** -0.5
    rows = torch.arange(SEQ)
    valid = tfa._valid_pairs(SEQ, True, window, 0, "cpu")
    q_lo = rows // block * block
    q_hi = (q_lo + block - 1).clamp(max=SEQ - 1)
    first = ((q_lo - (window or SEQ) + 1).clamp(min=0) // TILE)[:, None]
    last = (q_hi // TILE)[:, None]  # the loop's last tile, for each row's block
    m = torch.full((*q.shape[:3], 1), -1e30)
    l = torch.zeros(*q.shape[:3], 1)
    acc = torch.zeros(q.shape)
    for j in range(SEQ // TILE):
        keys = slice(j * TILE, (j + 1) * TILE)
        ok = valid[:, keys]
        if mutant == "last_kv_tile":
            ok = ok & (last != j)
        s = torch.where(ok, (q.float() @ k[..., keys, :].float().mT), -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp((s - m_new) * scale), 0.0)
        alpha = torch.exp((m - m_new) * scale)
        l = l * alpha + p.sum(-1, keepdim=True)
        pr = p.to(q.dtype).float()
        pv = pr @ v[..., keys, :].float()
        if mutant == "stale_v" and j > 0:
            stale = (last == j) & (first < j)  # rows whose loop ends on tile j, not its first
            pv = torch.where(stale, pr @ v[..., keys.start - TILE:keys.start, :].float(), pv)
        acc = acc * alpha + pv
        m = m_new
    o = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return o.to(q.dtype), torch.where(l > 0, m * scale + torch.log(l), -1e30)[..., 0]


@pytest.mark.parametrize("mutant", ["exact", "online", "last_kv_tile", "stale_v", "out_3pct_low"])
@pytest.mark.parametrize("window", [None, 300], ids=["causal", "window300"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_phase3_bound_rejects_a_wrong_kernel(dtype, window, mutant):
    cs = _chip_smoke()
    (q, k, v), (want, want_lse) = _main_path_fwd(dtype, window)
    if mutant == "exact":
        got, got_lse = _exact(q, k, v, window)
    elif mutant == "out_3pct_low":
        got, got_lse = (want.float() * 0.97).to(dtype), want_lse
    else:
        got, got_lse = _online(q, k, v, window, BLOCK_ROWS[dtype],
                               None if mutant == "online" else mutant)
    ok, err, rel = cs.grads_close(got, want, *cs.FWD_TOL[str(dtype)[6:]])
    assert ok == (mutant in ("exact", "online")), (err, rel)
    if mutant in ("exact", "online"):
        assert float((got_lse - want_lse).abs().max()) <= 1e-4
    if mutant == "out_3pct_low" and dtype == torch.bfloat16:
        assert cs.close(got[..., TILE:, :], want[..., TILE:, :], 2e-2)
