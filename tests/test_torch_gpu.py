"""The CUDA kernels against their plain versions, on the GPU; the decode
paths (ragged prompts, beam search) on the card against the CPU plain run;
the serving engine's CUDA graphs against its eager steps, and its int8 KV
decode (K4 on int8 pages) against the CPU plain path; the CNN train steps
(cuDNN, TF32 off) against the CPU's, and over NCCL at world size 1 against
no group; K1-K4 at a tensor-parallel rank's local head counts, and the
one-process tensor-parallel model on the card against the CPU; with four
cards, data, expert, sequence, tensor and pipeline parallelism, ZeRO-1 and
the composed layouts (pp x tp, tp x sp, ep x sp, ep x tp, pp x ep,
loss_chunk x sp, ZeRO-1 x ep / sp / pp) over NCCL against one card; and
the elastic pod (``nccl_pod``: ``launch_pod`` over 2 NCCL ranks with
``rank_kill``, re-formed onto 1 and resumed bitwise a clean resume); the
serving engine over ``LockstepTP`` (``tp_engine``: every rank on one card
warmed, a replayed step bitwise the eager one; one rank a card on four
cards, warmup refused by name and served eagerly) and a fleet of
tensor-parallel replicas across four cards (``tp_fleet``); a capture that
a collection of dead graphs must not invalidate (``dead_graphs``).

Marked ``gpu``: each test skips (from the ``cuda`` fixture, never at import
time) where ``torch.cuda.is_available()`` is false. On the card:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file does
not use and the card's machine need not have.)
"""

import importlib.util
import pathlib

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


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _out_close(got, want, in_dtype, label=""):
    """K1's output within ``chip_smoke.FWD_TOL`` (by input dtype) of its plain
    version: ``atol + rtol * |want|`` element by element and a relative L2
    bound."""
    cs = _chip_smoke()
    assert got.dtype == want.dtype
    assert bool(torch.isfinite(got).all()), f"{label}: non-finite"
    ok, err, rel = cs.grads_close(got, want, *cs.FWD_TOL[str(in_dtype)[6:]])
    assert ok, f"{label}: max abs err {err}, rel L2 {rel}"


def _fwd_case(gen, shape, dtype, layout="bshd", **kw):
    """K1 (with the lse) and its plain version on seeded inputs: the output
    held to FWD_TOL, the lse to 1e-4 where finite; returns (got, lse)."""
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    call = dict(causal=kw.pop("causal", True), window=kw.pop("window", None),
                shift=kw.pop("shift", 0), return_lse=True, out_dtype=kw.pop("out_dtype", None),
                layout=layout)
    assert not kw
    before = fa.flash_attention_cuda.launches
    got, lse = fa.flash_attention_cuda(q, k, v, **call)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want, want_lse = fa.flash_attention_reference(q, k, v, **call)
    _out_close(got, want, dtype, f"{tuple(shape)} {call}")
    finite = want_lse > -1e29
    assert torch.equal(finite, lse > -1e29)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-4, rtol=0)
    return got, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "kw",
    [dict(), dict(causal=False), dict(window=33), dict(window=40, shift=70, return_lse=True)],
    ids=["causal", "full", "window", "shift_lse"],
)
def test_flash_attention_kernel_matches_plain(cuda, dtype, kw):
    q, k, v = (torch.randn(2, 150, 3, 64, generator=cuda, device="cuda").to(dtype)
               for _ in range(3))
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_reference(q, k, v, **kw)
    if kw.get("return_lse"):
        (got, got_lse), (want, want_lse) = got, want
        torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-4)
    _out_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "seq, kw",
    [(127, {}), (128, {}), (129, {}), (2000, {}), (2048, dict(window=300)),
     (300, dict(window=7, shift=100))],
    ids=["S127", "S128", "S129", "S2000", "window300", "window7_shift_dead_rows"],
)
def test_flash_attention_kernel_block_edges(cuda, dtype, seq, kw):
    """K1 at the edges of its blocks (128 q rows bf16, 32 float32) and 64-key
    tiles: S around 128, a ragged 2000, a window of 300 (not a multiple of
    64 or 128), and a shift that leaves rows with no key (zero output, lse
    NEG_INF)."""
    got, lse = _fwd_case(cuda, (1, seq, 4, 64), dtype, **kw)
    dead = lse < -1e29  # [B, H, S]
    assert bool(dead.any()) == ("shift" in kw)
    assert bool((got.transpose(1, 2)[dead] == 0).all())


@pytest.mark.parametrize("head_dim", [8, 24, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_head_dims(cuda, head_dim, dtype):
    """Head dims below 64 and between 64 and 128 (zero-padded in the bf16
    kernel's shared memory), ragged S across two bf16 blocks, BHSD."""
    _fwd_case(cuda, (2, 3, 197, head_dim), dtype, layout="bhsd", window=150)


def test_flash_attention_kernel_f32_out_from_bf16(cuda):
    got, _ = _fwd_case(cuda, (2, 300, 3, 64), torch.bfloat16, window=100, out_dtype=torch.float32)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_is_deterministic_and_layout_free(cuda, dtype):
    """Two launches on the same inputs give bit-identical output and lse,
    and BHSD views of BSHD storage (the train step's call) give the BSHD
    call's output and lse bit for bit, as a view of BSHD storage."""
    q, k, v = (torch.randn(2, 1000, 4, 64, generator=cuda, device="cuda").to(dtype)
               for _ in range(3))
    call = dict(causal=True, window=None, shift=0, return_lse=True, out_dtype=None)
    first = fa.flash_attention_cuda(q, k, v, layout="bshd", **call)
    second = fa.flash_attention_cuda(q, k, v, layout="bshd", **call)
    views = fa.flash_attention_cuda(*(t.transpose(1, 2) for t in (q, k, v)), layout="bhsd", **call)
    assert views[0].transpose(1, 2).is_contiguous()
    for a, b, c in zip(first, second, (views[0].transpose(1, 2), views[1])):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_flash_attention_kernel_rejects_unsupported_head_dim(cuda):
    x = torch.randn(1, 16, 2, 12, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(x, x, x)


def _grads_close(got, want, in_dtype, label=""):
    """Each gradient within ``chip_smoke.GRAD_TOL`` (by input dtype) of its
    plain version: ``atol + rtol * |want|`` element by element and a
    relative L2 bound (bf16: p and ds may round the other way near a
    rounding boundary)."""
    cs = _chip_smoke()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype
        assert bool(torch.isfinite(g).all()), f"{label} {name}: non-finite"
        ok, err, rel = cs.grads_close(g, w, *cs.GRAD_TOL[str(in_dtype)[6:]])
        assert ok, f"{label} {name}: max abs err {err}, rel L2 {rel}"


def _bwd_case(gen, shape, dtype, layout="bhsd", **kw):
    """K2/K3 and their plain version on seeded inputs with o and lse from
    the plain forward; returns (got, want, lse)."""
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    fwd = {n: kw[n] for n in ("causal", "window", "shift") if n in kw}
    o, lse = fa.flash_attention_reference(q, k, v, return_lse=True, layout=layout, **fwd)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, layout=layout, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, o, do, lse, layout=layout, **kw)
    return got, want, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "kw",
    [dict(), dict(causal=False), dict(window=33), dict(window=40, shift=70),
     dict(grad_dtype=torch.float32), dict(window=7, shift=100)],
    ids=["causal", "full", "window", "shift", "f32_grads", "rows_without_keys"],
)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_attention_bwd_kernels_match_plain(cuda, dtype, kw, layout):
    """K2 and K3 against their plain version on the same o, do and lse
    (ragged S 150, D 64); rows with no valid key get zero grads."""
    shape = (2, 150, 3, 64) if layout == "bshd" else (2, 3, 150, 64)
    before = (fa.flash_attention_bwd_dq_cuda.launches, fa.flash_attention_bwd_dkv_cuda.launches)
    got, want, lse = _bwd_case(cuda, shape, dtype, layout, **kw)
    after = (fa.flash_attention_bwd_dq_cuda.launches, fa.flash_attention_bwd_dkv_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1)
    assert got[0].dtype == (kw.get("grad_dtype") or dtype)
    _grads_close(got, want, dtype)
    if "shift" in kw and kw["shift"] > 99:
        dead = lse < -1e29  # [B, H, S]: rows that saw no key
        assert bool(dead.any())
        dq = got[0] if layout == "bhsd" else got[0].transpose(1, 2)
        assert bool((dq[dead] == 0).all())


@pytest.mark.parametrize(
    "seq, kw",
    [(63, {}), (64, {}), (65, {}), (127, {}), (128, {}), (129, {}), (2000, {}),
     (129, dict(causal=False)), (300, dict(window=100)), (300, dict(window=100, shift=250))],
    ids=["S63", "S64", "S65", "S127", "S128", "S129", "S2000", "full_S129", "window100",
         "window100_shift_dead_rows"],
)
def test_flash_attention_bwd_kernels_block_edges(cuda, seq, kw):
    """bf16 K2/K3 at the edges of their 128-row blocks and 64-row tiles: S
    around 64 and 128 and a ragged 2000, a window of 100 whose edge crosses
    a block boundary, and a shift that leaves rows with no key."""
    got, want, lse = _bwd_case(cuda, (1, 2, seq, 64), torch.bfloat16, **kw)
    _grads_close(got, want, torch.bfloat16, f"S{seq} {kw}")
    dead = lse < -1e29
    assert bool(dead.any()) == ("shift" in kw)
    assert bool((got[0][dead] == 0).all())


@pytest.mark.parametrize("head_dim", [8, 24, 72, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_bwd_kernels_head_dims(cuda, head_dim, dtype):
    """Head dims below 64 and between 64 and 128 (zero-padded in the bf16
    kernel's shared memory) and 128, ragged S across two blocks."""
    got, want, _ = _bwd_case(cuda, (1, 2, 197, head_dim), dtype, window=150)
    _grads_close(got, want, dtype, f"D{head_dim}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_bwd_kernels_are_deterministic(cuda, dtype):
    """Two launches on the same inputs give bit-identical dq, dk and dv: no
    atomics, a fixed order of every sum."""
    q, k, v, do = (torch.randn(2, 4, 1000, 64, generator=cuda, device="cuda").to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=None, shift=0,
                                     return_lse=True, out_dtype=None, layout="bhsd")
    first = fa.flash_attention_bwd(q, k, v, o, do, lse, layout="bhsd")
    second = fa.flash_attention_bwd(q, k, v, o, do, lse, layout="bhsd")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_autograd_runs_k1_k2_k3(cuda):
    """Under autograd the entry runs K1 with the lse, then K2 and K3."""
    q, k, v = (torch.randn(2, 4, 130, 64, generator=cuda, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    counts = lambda: (fa.flash_attention_cuda.launches, fa.flash_attention_bwd_dq_cuda.launches,  # noqa: E731
                      fa.flash_attention_bwd_dkv_cuda.launches)
    before = counts()
    out = fa.flash_attention_bhsd(q, k, v, window=64)
    do = torch.randn(out.shape, generator=cuda, device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert counts() == tuple(c + 1 for c in before)
    o, lse = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(), return_lse=True,
                                          layout="bhsd", window=64)
    want = fa.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), o, do, lse,
                                            layout="bhsd", window=64)
    _grads_close(got, want, torch.bfloat16)


def test_bhsd_views_of_bshd_tensors_match_bshd(cuda):
    """``flash_attention_bhsd`` on BHSD views of BSHD tensors (what the model
    passes) runs the same kernels over the same memory as ``flash_attention``
    on the tensors themselves: the same output and grads, bit for bit, and
    the output and grads come back as views of BSHD storage."""
    q, k, v = (torch.randn(2, 130, 4, 64, generator=cuda, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn(2, 130, 4, 64, generator=cuda, device="cuda").to(torch.bfloat16)
    want = fa.flash_attention(q, k, v, window=64)
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    got = fa.flash_attention_bhsd(*(t.transpose(1, 2) for t in (q, k, v)), window=64)
    assert got.transpose(1, 2).is_contiguous()
    got_grads = torch.autograd.grad(got, (q, k, v), do.transpose(1, 2))
    torch.testing.assert_close(got.transpose(1, 2), want, atol=0, rtol=0)
    for g, w in zip(got_grads, want_grads):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_composes_with_the_kernels(cuda, remat):
    """Under ``torch.utils.checkpoint`` (full, and the selective "dots"
    policy) the flash path recomputes K1 in the backward and gives the
    grads of remat "none"."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=4, head_dim=64,
                            d_model=256, d_ff=512)
    tokens = torch.randint(0, 512, (2, 256), generator=cuda, device="cuda")

    def grads(policy):
        model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda", remat=policy).init_weights(0)
        before = fa.flash_attention_cuda.launches
        model(tokens, attention_fn=fa.flash_attention_bhsd).float().square().mean().backward()
        return fa.flash_attention_cuda.launches - before, {
            n: p.grad for n, p in model.named_parameters()}

    k1_none, want = grads("none")
    k1_remat, got = grads(remat)
    assert k1_none == 2 and k1_remat == 4  # the forward of each layer runs again
    for n in want:
        torch.testing.assert_close(got[n], want[n], atol=1e-5, rtol=1e-4, msg=n)


def _decode_case(gen, B, L, H, hkv, D, dtype, fills, window=None, quant=False):
    """K4 on seeded inputs against its plain version: held to
    ``chip_smoke.DEC_TOL`` (by q dtype), inactive rows zero, one launch
    counted per call (the merge pass not counted), and a second launch
    bit-identical."""
    cs = _chip_smoke()
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, L, hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, L, hkv, D, generator=gen, device="cuda").to(dtype)
    index = torch.tensor(fills, dtype=torch.int32, device="cuda")
    scales = {}
    if quant:
        k, ks = fd.quantize_kv(k)
        v, vs = fd.quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    before = fd.flash_decode_cuda.launches
    got = fd.flash_decode_cuda(q, k, v, index, window=window, **scales)
    again = fd.flash_decode_cuda(q, k, v, index, window=window, **scales)
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = fd.flash_decode_reference(q, k, v, index, window=window, **scales)
    assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
    assert all(bool((got[b] == 0).all()) for b, f in enumerate(fills) if f < 0)
    ok, err, rel = cs.decode_close(got, want, *cs.DEC_TOL[str(dtype)[6:]])
    assert ok, f"max abs err {err}, rel L2 {rel}"


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 50])
def test_flash_decode_kernel_matches_plain(cuda, quant, window):
    _decode_case(cuda, 4, 300, 8, 2, 64, torch.float32, [-1, 0, 150, 299], window, quant)


def _split_edges(L):
    s = fd.SPLIT_ROWS
    return [s - 1, s, s + 1, 0, -1, L - 1, 2 * s + 17, s // 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, "half_split", "mid_split"])
@pytest.mark.parametrize("L", [1024, 1000, 2111])
def test_flash_decode_kernel_split_edges(cuda, dtype, window, L):
    """Fills on a split boundary and either side of it; a window shorter
    than one split, and one whose first row falls mid-split; L not a
    multiple of the split."""
    s = fd.SPLIT_ROWS
    w = {None: None, "half_split": s // 2 + 3, "mid_split": 2 * s + s // 3}[window]
    _decode_case(cuda, 8, L, 12, 4, 64, dtype, _split_edges(L), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hkv", [1, 4, 12])
def test_flash_decode_kernel_gqa(cuda, hkv, dtype):
    _decode_case(cuda, 8, 1500, 12, hkv, 64, dtype, [5, 1499, -1, 700, 128, 0, 1023, 384], 400)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 300])
def test_flash_decode_kernel_int8(cuda, dtype, window):
    _decode_case(cuda, 8, 1100, 12, 4, 64, dtype, _split_edges(1100), window, quant=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("head_dim", [8, 24, 128])
def test_flash_decode_kernel_head_dims(cuda, head_dim, quant, dtype):
    _decode_case(cuda, 4, 700, 6, 2, head_dim, dtype, [699, -1, 127, 300], 200, quant)


def test_flash_decode_kernel_fill_past_the_buffer(cuda):
    """A fill level past L - 1 reads up to L - 1; with a short window it
    attends nothing, and the row's output is zero."""
    _decode_case(cuda, 4, 600, 4, 2, 64, torch.float32, [900, 650, 599, 3], 64)
    _decode_case(cuda, 4, 600, 4, 2, 64, torch.bfloat16, [900, 700, -1, 200], None)


def test_flash_decode_kernel_serving_shape(cuda):
    cs = _chip_smoke()
    _decode_case(cuda, 8, 1024, 12, 12, 64, torch.float32, cs.serve_fills())


def test_flash_decode_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.randn(2, 1, 4, 72 + 4, device="cuda")
    k = torch.randn(2, 64, 2, 76, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fd.flash_decode(q, k, k, torch.tensor([3, 5], device="cuda"))


@pytest.mark.parametrize("heads", [3, 1], ids=["H3", "H1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_at_tensor_parallel_local_heads(cuda, dtype, heads):
    """K1 (BSHD and the train step's BHSD), K2/K3 and K4 (Hkv = H) at the
    head counts a rank of tp 4 runs: 3 of the 110M model's 12, 1 of
    ``TP_SHAPE``'s 4; against their plain versions."""
    _fwd_case(cuda, (2, 1000, heads, 64), dtype)
    _fwd_case(cuda, (2, heads, 1000, 64), dtype, layout="bhsd")
    got, want, _ = _bwd_case(cuda, (2, heads, 1000, 64), dtype)
    _grads_close(got, want, dtype, f"H{heads}")
    _decode_case(cuda, 8, 1024, heads, heads, 64, dtype, [143, 527, 1023, 0, -1, 300, 600, 900])


def test_lockstep_tp_generation_on_the_card_equals_cpu(cuda):
    """The one-process tensor-parallel model (tp 2, every shard on this
    card; K1 prefill and K4 decode per rank at its local heads) gives the
    CPU plain run's greedy tokens, with 2 x layers K1 launches."""
    from deeplearning_mpi_tpu_torch.models.generate import generate
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP

    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=4, head_dim=64,
                            d_model=128, d_ff=256)
    cpu = TransformerLM(cfg, dtype=torch.float32, device="cpu",
                        tp=LockstepTP(2, "cpu")).init_weights(0)
    gpu = TransformerLM(cfg, dtype=torch.float32, device="cuda",
                        tp=LockstepTP(2, "cuda")).init_weights(0)
    prompt = torch.randint(1, 256, (3, 40), generator=torch.Generator().manual_seed(5))
    want = generate(cpu, prompt, max_new_tokens=16, temperature=0.0)
    fa.flash_attention_cuda.launches = fd.flash_decode_cuda.launches = 0
    got = generate(gpu, prompt.cuda(), max_new_tokens=16, temperature=0.0)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == 2 * 2
    assert fd.flash_decode_cuda.launches == 2 * 2 * 15
    assert torch.equal(got.cpu(), want)


def _decode_pair():
    """A small f32 model on the CPU (plain versions) and its copy on the card."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                            head_dim=64, d_model=128, d_ff=256)
    cpu = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    gpu = TransformerLM(cfg, dtype=torch.float32, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


@pytest.mark.parametrize("what", ["ragged", "ragged_shared_prefix", "beam", "beam_eos"])
def test_beam_and_ragged_decode_on_the_card_equal_the_cpu_plain_run(cuda, what):
    """Ragged generation (every step on K4, the shared prefix on K1) and beam
    search (K4 at B * W rows, the parents' cache rows gathered each step)
    give the CPU plain run's tokens."""
    from deeplearning_mpi_tpu_torch.models.generate import beam_search, generate

    cpu, gpu = _decode_pair()
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, 256, (3, 40), generator=g)
    if what.startswith("ragged"):
        lens = torch.tensor([40, 17, 29])
        kw = dict(max_new_tokens=24, temperature=0.0, prompt_lens=lens,
                  shared_prefix=17 if what.endswith("prefix") else 0)
        run = lambda m, p: generate(m, p, **kw)  # noqa: E731
    else:
        kw = dict(max_new_tokens=16, num_beams=4)
        if what == "beam_eos":
            kw.update(eos_id=int(generate(cpu, prompt, max_new_tokens=3, temperature=0.0)[0, -1]),
                      length_penalty=0.6)
        run = lambda m, p: beam_search(m, p, **kw)  # noqa: E731
    want = run(cpu, prompt)
    fa.flash_attention_cuda.launches = fd.flash_decode_cuda.launches = 0
    got = run(gpu, prompt.cuda())
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.launches > 0
    assert (fa.flash_attention_cuda.launches > 0) == (what != "ragged")
    assert torch.equal(got.cpu(), want)


def _paged_pair(kv_dtype=None):
    """``_decode_pair``'s models with a ``PagedForward`` each and seeded
    pools (int8 pools: ``ops.quant``'s scheme) on both devices, with the
    tables, lengths, tokens and active rows of one decode step."""
    from deeplearning_mpi_tpu_torch.ops.quant import quantize_kv
    from deeplearning_mpi_tpu_torch.serving.engine import EngineConfig, PagedForward
    from deeplearning_mpi_tpu_torch.serving.kv_pool import init_kv_buffers

    cpu, gpu = _decode_pair()
    e = EngineConfig(max_slots=4, block_size=16, num_blocks=40, max_blocks_per_seq=8,
                     kv_dtype=kv_dtype)
    storage = torch.int8 if kv_dtype else torch.float32
    c = cpu.config
    g = torch.Generator().manual_seed(3)
    kv = init_kv_buffers(c.num_layers, e.num_blocks, e.block_size, c.kv_heads, c.head_dim,
                         storage, "cpu")
    rows = [torch.randn(kv[0].shape, generator=g) for _ in range(2)]
    if kv_dtype:
        (kv[0][:], kv[2][:]), (kv[1][:], kv[3][:]) = (quantize_kv(r) for r in rows)
    else:
        kv[0][:], kv[1][:] = rows
    step = (torch.randperm(39, generator=g)[:32].reshape(4, 8) + 1,
            torch.tensor([100, 17, 128, 61]), torch.randint(1, 256, (4,), generator=g),
            torch.tensor([True, True, False, True]))
    sides = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        sides[name] = (PagedForward(model, e, kv_dtype=storage if kv_dtype else None),
                       tuple(t.to(name) for t in kv), tuple(t.to(name) for t in step))
    return sides


@pytest.mark.parametrize("width", [2, 8])
def test_graphed_decode_step_equals_eager_bit_for_bit(cuda, width):
    """One decode step captured as a CUDA graph at a gather width (the
    engine's warmup) gives the eager step's logits bit for bit, and K4's
    counted launches include the replay's (one a layer)."""
    from deeplearning_mpi_tpu_torch.compiler.aot import CapturedProgram

    fwd, kv, (tables, lengths, tokens, active) = _paged_pair()["cuda"]
    tables, lengths = tables[:, :width].contiguous(), torch.clamp(lengths, max=width * 16)
    args = (tables, lengths, tokens, active)
    eager = fwd.decode_logits(kv, *args)
    layers = fwd.config.num_layers
    before = fd.flash_decode_cuda.launches
    prog = CapturedProgram(lambda *a: fwd.decode_logits(kv, *a), args,
                           pool=torch.cuda.graph_pool_handle())
    assert fd.flash_decode_cuda.launches == before + layers  # the eager warm run only
    assert prog.graph is not None
    assert prog.launches == {(fd.flash_decode_cuda, "launches"): layers}
    got = prog(*(t.cpu().numpy() for t in args)).clone()
    again = prog(*args).clone()
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.launches == before + 3 * layers
    assert torch.equal(got, eager) and torch.equal(again, eager)


def test_int8_engine_decode_on_the_card_equals_the_cpu_plain_path(cuda):
    """int8 pools: the card hands K4 the int8 pages and their scales; the
    CPU dequantizes in the gather and runs the masked matmul. Logits within
    1e-4 (absolute, f32; K4 and the matmul round differently), the same
    greedy tokens, one int8 K4 launch a layer."""
    sides = _paged_pair(kv_dtype="int8")
    fwd, kv, args = sides["cpu"]
    want = fwd.decode_logits(kv, *args)
    fwd, kv, args = sides["cuda"]
    before = fd.flash_decode_cuda.int8_launches
    got = fwd.decode_logits(kv, *args)
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.int8_launches == before + fwd.config.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))


@pytest.mark.parametrize("mode", ["plain", "speculative_int8_prefix"])
def test_warmed_engine_on_the_card_equals_the_eager_engine(cuda, mode):
    """The engine warmed by CUDA-graph capture serves the streams of the
    unwarmed engine and of the CPU engine; traffic captures nothing."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.models.transformer import self_draft
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

    cpu, gpu = _decode_pair()
    kw = dict(spec_k=3, kv_dtype="int8", prefix_cache=True) if mode != "plain" else {}
    e = EngineConfig(max_slots=4, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                     prefill_chunk=32, **kw)
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 256, size=40)
    prompts = [np.concatenate([pre, rng.integers(1, 256, size=n)]) for n in (3, 30, 61, 9, 17)]
    streams = []
    for model, warm in ((cpu, False), (gpu, False), (gpu, True)):
        engine = ServingEngine(model, e, draft=self_draft(model, 1) if kw else None)
        if warm:
            engine.warmup()
        captures = engine.captures
        fd.flash_decode_cuda.launches = 0
        reqs = [engine.submit(p, 12) for p in prompts]
        engine.run_until_idle()
        torch.cuda.synchronize()
        assert engine.captures == captures
        if model is gpu:
            assert fd.flash_decode_cuda.launches > 0
        engine.pool.check()
        streams.append([r.generated for r in reqs])
    assert streams[1] == streams[2]
    if mode == "plain":
        assert streams[0] == streams[1]


def _cnn_step(model, batch, task):
    """Loss and parameter gradients of one train-mode step."""
    from deeplearning_mpi_tpu_torch.train.trainer import _INPUTS, _loss_fn

    model.train()
    loss = _loss_fn(task)(model(batch[_INPUTS[task]]), batch)
    return loss.detach().double().cpu(), [g.double().cpu() for g in torch.autograd.grad(
        loss, list(model.parameters()))]


def _worst_rel(got, want):
    return max(float((a - b).norm() / b.norm().clamp(min=1e-30)) for a, b in zip(got, want))


def test_resnet18_step_on_card_equals_cpu(cuda):
    """Phase 12b's check: full-width ResNet-18 (imagenet stem), B8, float32
    with TF32 off: the loss and every gradient within 1e-4 (relative L2) of
    the CPU's on the same weights and batch."""
    import copy

    from deeplearning_mpi_tpu_torch.models import resnet18

    torch.backends.cudnn.allow_tf32 = False
    cpu = resnet18(device="cpu").init_weights(0)
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(8, 32, 32, 3, generator=gen),
             "label": torch.randint(0, 10, (8,), generator=gen)}
    want = _cnn_step(cpu, batch, "classification")
    got = _cnn_step(copy.deepcopy(cpu).cuda(), {k: v.cuda() for k, v in batch.items()},
                    "classification")
    assert float((got[0] - want[0]).abs() / want[0]) <= 1e-4
    assert _worst_rel(got[1], want[1]) <= 1e-4


def test_unet_step_on_card_equals_cpu_in_float64(cuda):
    """The full-width UNet, B2 at 64x64, float64 on both: every gradient
    within 1e-4 (in float32 a pre-activation within ~1e-5 of a ReLU's kink
    lands on opposite sides now and then, which moves the deepest layers'
    gradients by ~1e-3 whatever the conv algorithm; phase 12c reports it)."""
    from deeplearning_mpi_tpu_torch.models import UNet

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    batch = {"image": torch.rand(2, 64, 64, 3, generator=gen, dtype=torch.float64),
             "mask": (torch.rand(2, 64, 64, generator=gen) > 0.5).double()}
    out = []
    for dev in ("cpu", "cuda"):
        model = UNet(dtype=torch.float64, device="cpu").init_weights(3).double().to(dev)
        out.append(_cnn_step(model, {k: v.to(dev) for k, v in batch.items()}, "segmentation"))
    assert float((out[1][0] - out[0][0]).abs() / out[0][0]) <= 1e-6
    assert _worst_rel(out[1][1], out[0][1]) <= 1e-4


def test_nccl_world_one_step_equals_no_group(cuda, tmp_path):
    """Over NCCL at world size 1 (a file store) the data-parallel step —
    BatchNorm's all-reduced moments, the flat gradient mean — equals the
    step without a group bit for bit, and runs one gradient all-reduce."""
    import copy

    from deeplearning_mpi_tpu_torch.models import resnet18
    from deeplearning_mpi_tpu_torch.runtime import bootstrap, collectives
    from deeplearning_mpi_tpu_torch.runtime.hello_world import run_hello_world
    from deeplearning_mpi_tpu_torch.runtime.mesh import create_mesh, data_group
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    model = resnet18(num_filters=16, device="cuda").init_weights(0)
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(8, 32, 32, 3, generator=gen).cuda(),
             "label": torch.randint(0, 10, (8,), generator=gen).cuda()}
    tx = build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=1e-5)
    bootstrap.init(f"file://{tmp_path / 'store'}", 1, 0, "cuda", timeout_s=60)
    try:
        assert run_hello_world().ok
        group = data_group(create_mesh(device="cuda"))
        states = [create_train_state(copy.deepcopy(model), tx) for _ in range(2)]
        collectives.counts.clear()
        for i, g in enumerate((group, None)):
            states[i], _ = make_train_step("classification", group=g)(states[i], batch)
        assert collectives.counts["all_reduce_mean"] == 1
    finally:
        bootstrap.shutdown()
    for (n, a), b in zip(states[0].model.state_dict().items(), states[1].model.state_dict().values()):
        assert torch.equal(a, b), n


def test_nccl_ranks_train_like_one_card(cuda, tmp_path):
    """Every card of the machine a rank over NCCL (``tests/test_torch_runtime.py``'s
    float64 worker, which runs over gloo there): the transport checks, then
    3 float64 ResNet steps within 1e-7 of one card on the global batch, the
    replicas bitwise equal. Skips with fewer than two cards."""
    import sys

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards: NCCL refuses two ranks on one device")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import test_torch_runtime as rt

    rt.check_ranks_train_like_one_process(rt.spawn(tmp_path, n, "w_train_f64", "cuda"), n,
                                          "cuda")


@pytest.fixture(scope="module")
def expert_parallel_runs(tmp_path_factory):
    """4 NCCL ranks (one card each) of ``tests/torch_moe_ranks.py``'s
    :data:`CUDA_LAYOUTS` on the MoE LM at 2 layers of full width (8
    experts, top 2), TF32 off, and one card's run of the global batch in
    float32 and in float64. Skips with fewer than four cards."""
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: dp 2 x ep 2, one rank a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_moe_ranks as ranks

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    tmp_path = tmp_path_factory.mktemp("expert_parallel")
    cfg = TransformerConfig(num_layers=2, moe_experts=8, moe_top_k=2)
    full = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    ds = SyntheticTokens(4, 256, vocab_size=cfg.vocab_size, seed=0)
    tokens = torch.stack([torch.from_numpy(ds[i]["tokens"]) for i in range(4)])
    torch.save({"cfg": cfg, "moe_sd": full.state_dict(), "tokens": tokens},
               tmp_path / "inputs.pt")
    spawned = ranks.spawn(tmp_path, 4, ranks.worker_cuda)
    one = {dtype: ranks.moe_case(cfg, full.state_dict(), tokens, device="cuda", dtype=dtype)
           for dtype in (torch.float32, torch.float64)}
    # one card's own float32 noise: the same global batch with its rows in
    # another order (the same sums, associated differently).
    twin = ranks.moe_case(cfg, full.state_dict(), tokens[[1, 0, 3, 2]], device="cuda")
    return ranks, spawned, one, twin


def test_nccl_expert_parallel_matches_one_card(expert_parallel_runs):
    """``dp 2 x ep 2`` in float32 against one card on the global batch: the
    load-balance loss and one step's loss within 1e-6 relative; every
    gradient and every parameter after one Adam step (expert stacks
    gathered) within 2x (``torch_moe_ranks.SPLIT_BATCH_FACTOR``) the worst
    relative L2 error of its class in ``dp 4`` on the same cards in the same
    spawn (``split_batch_rule``: splitting the batch associates float32 sums
    differently, ~1.9e-6 on four H100s, over the old flat 1e-6); the
    replicas of every non-expert parameter bitwise equal across the ranks.
    It prints the worst errors beside those of ``dp 4`` and ``ep 4`` and one
    card's own float32 noise (rows reordered)."""
    ranks, spawned, one, twin = expert_parallel_runs
    results = [res["dp2_ep2"] for res in spawned]
    worst = ranks.relative_errors(results, one[torch.float32])
    print("worst relative errors:", worst[:12])
    for layout in ("dp4", "ep4"):
        print(f"{layout}:", ranks.relative_errors([res[layout] for res in spawned],
                                                  one[torch.float32])[:4])
    noise = sorted(((ranks.relative_error(twin[key][n], t), key, n) for key in ("grads", "params")
                    for n, t in one[torch.float32][key].items()), reverse=True)
    print("one card, rows reordered:", noise[:6])
    over, bars = ranks.split_batch_rule(results, [res["dp4"] for res in spawned],
                                        one[torch.float32])
    print("split-batch bars:", bars)
    scalars = [(k, e) for k, e in worst if k[1] in ("aux", "loss") and e > 1e-6]
    replicas = ranks.differing_replicas(results)
    assert not scalars and not over and not replicas, (
        f"losses over 1e-6: {scalars}; {len(over)} tensors over {bars}: {over[:20]}; "
        f"replicas differing: {replicas}")


def test_nccl_expert_parallel_f64_matches_one_card(expert_parallel_runs):
    """The same ``dp 2 x ep 2`` step in float64 (parameters and compute)
    against one card in float64 within 1e-7 relative, where float32's own
    noise (~1e-6) cannot hide a fault in the expert group's collectives;
    the non-expert replicas bitwise equal."""
    ranks, spawned, one, _ = expert_parallel_runs
    results = [res["dp2_ep2_f64"] for res in spawned]
    worst = ranks.relative_errors(results, one[torch.float64])
    print("float64 worst relative errors:", worst[:12])
    over = [(k, e) for k, e in worst if e > 1e-7]
    replicas = ranks.differing_replicas(results)
    assert not over and not replicas, (f"{len(over)} of {len(worst)} over 1e-7: {over[:20]}; "
                                       f"replicas differing: {replicas}")


@pytest.fixture(scope="module")
def sequence_parallel_runs(tmp_path_factory):
    """4 NCCL ranks (one card each) of ``tests/torch_seq_ranks.py``'s
    :data:`CUDA_LAYOUTS` on the LM at 2 layers of the 110M widths, B4 S4096
    (the float64 cases B2 S2048), TF32 off; and one card's step on the
    global batch: float32 with flash over the whole sequence, float64 with
    the one-process plain ring over 4 shards and with dense attention over
    whole sequences. Skips with fewer than four cards."""
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: sp 4 and dp 2 x sp 2, one rank a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_seq_ranks as seq_ranks

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    tmp_path = tmp_path_factory.mktemp("sequence_parallel")
    cfg = TransformerConfig(num_layers=2)
    full = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)

    def rows(n, seq, seed):
        ds = SyntheticTokens(n, seq, vocab_size=cfg.vocab_size, seed=seed)
        return torch.stack([torch.from_numpy(ds[i]["tokens"]) for i in range(n)])

    inputs = {"cfg": cfg, "params": full.state_dict(), "tokens": rows(4, 4096, 0),
              "tokens_f64": rows(2, 2048, 1)}
    torch.save(inputs, tmp_path / "inputs.pt")
    spawned = seq_ranks.spawn(tmp_path, 4, seq_ranks.worker_cuda)
    one = {torch.float32: seq_ranks.lm_step_case(inputs, device="cuda", attention="flash"),
           torch.float64: seq_ranks.lm_step_case(inputs, device="cuda", dtype=torch.float64,
                                                 attention="ring_xla", tokens="tokens_f64",
                                                 sp=4),
           "f64_whole": seq_ranks.lm_step_case(inputs, device="cuda", dtype=torch.float64,
                                               attention="dense", tokens="tokens_f64")}
    return seq_ranks, spawned, one


@pytest.mark.parametrize("layout", ["sp4_ring", "sp4_ulysses", "dp2_sp2_ring"])
def test_nccl_sequence_parallel_matches_one_card(sequence_parallel_runs, layout):
    """``sp 4`` ring (K1-K3 a rotation), ``sp 4`` Ulysses and ``dp 2 x sp
    2`` ring over 4 NCCL cards, float32, against one card with flash over
    the whole sequence: both losses within 1e-6 relative; every gradient
    and every parameter after one Adam step within the split-batch rule of
    ``torch_moe_ranks.split_batch_rule`` (2x the worst relative L2 of its
    class in ``dp 4`` on the same cards in the same spawn); every rank's
    parameters bitwise equal."""
    import torch_moe_ranks as moe_ranks

    seq_ranks, spawned, one = sequence_parallel_runs
    results = [res[layout] for res in spawned]
    worst = seq_ranks.relative_errors(results, one[torch.float32])
    print(f"{layout} worst relative errors:", worst[:12])
    print("dp4:", seq_ranks.relative_errors([res["dp4"] for res in spawned],
                                            one[torch.float32])[:4])
    over, bars = moe_ranks.split_batch_rule(results, [res["dp4"] for res in spawned],
                                            one[torch.float32])
    print("split-batch bars:", bars)
    losses = [(k, e) for k, e in worst if len(k) == 2 and e > 1e-6]
    replicas = seq_ranks.differing_replicas(results)
    assert not losses and not over and not replicas, (
        f"losses over 1e-6: {losses}; {len(over)} tensors over {bars}: {over[:20]}; "
        f"replicas differing: {replicas}")


def test_nccl_sequence_parallel_f64_matches_one_card(sequence_parallel_runs):
    """``sp 4`` with the plain ring in float64 over 4 NCCL cards against one
    card running the same schedule over 4 shards in one process (float64,
    whole rows, no seq axis in the step): the losses, every gradient and
    every updated parameter within 1e-7 relative, where float32's noise
    (~1e-6) cannot hide a fault in the rotations, the loss's shard edges or
    the gradient sum over the seq group; the ranks' parameters bitwise
    equal."""
    seq_ranks, spawned, one = sequence_parallel_runs
    results = [res["sp4_ring_f64"] for res in spawned]
    assert all(g.dtype == torch.float64 for g in results[0]["grads"].values())
    worst = seq_ranks.relative_errors(results, one[torch.float64])
    print("float64 worst relative errors:", worst[:12])
    over = [(k, e) for k, e in worst if e > 1e-7]
    replicas = seq_ranks.differing_replicas(results)
    assert not over and not replicas, (f"{len(over)} of {len(worst)} over 1e-7: {over[:20]}; "
                                       f"replicas differing: {replicas}")


def test_nccl_sequence_parallel_dp2_sp2_f64_matches_whole_sequences(sequence_parallel_runs):
    """``dp 2 x sp 2`` with the plain ring in float64 over 4 NCCL cards
    against one card on whole sequences (dense attention, no seq axis):
    the losses, every gradient and every updated parameter within 1e-7
    relative, so the data x seq plane's gradient sum and its division by
    the data size have a float64 check of their own; the ranks' parameters
    bitwise equal."""
    seq_ranks, spawned, one = sequence_parallel_runs
    results = [res["dp2_sp2_ring_f64"] for res in spawned]
    assert all(g.dtype == torch.float64 for g in results[0]["grads"].values())
    worst = seq_ranks.relative_errors(results, one["f64_whole"])
    print("dp2_sp2 float64 worst relative errors:", worst[:12])
    over = [(k, e) for k, e in worst if e > 1e-7]
    replicas = seq_ranks.differing_replicas(results)
    assert not over and not replicas, (f"{len(over)} of {len(worst)} over 1e-7: {over[:20]}; "
                                       f"replicas differing: {replicas}")


@pytest.fixture(scope="module")
def tensor_parallel_runs(tmp_path_factory):
    """4 NCCL ranks (one card each) of ``tests/torch_tp_ranks.py``'s
    :data:`CUDA_TP_LAYOUTS` on the LM at 2 layers of the 110M widths (3
    heads a rank at tp 4), B4 S4096 (the float64 cases B2 S2048), TF32 off;
    and one card's step on the global batch: float32 with flash, float64
    with dense attention. Skips with fewer than four cards."""
    import dataclasses
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: tp 4 and dp 2 x tp 2, one rank a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_tp_ranks as tp_ranks

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    tmp_path = tmp_path_factory.mktemp("tensor_parallel")
    cfg = TransformerConfig(num_layers=2)
    full = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)

    def rows(n, seq, seed):
        ds = SyntheticTokens(n, seq, vocab_size=cfg.vocab_size, seed=seed)
        return torch.stack([torch.from_numpy(ds[i]["tokens"]) for i in range(n)])

    inputs = {"cfg": dataclasses.asdict(cfg), "params": full.state_dict(),
              "tokens": rows(4, 4096, 0), "tokens_f64": rows(2, 2048, 1)}
    torch.save(inputs, tmp_path / "inputs.pt")
    spawned = tp_ranks.spawn(tmp_path, tp_ranks.worker_cuda_tp)
    one = {torch.float32: tp_ranks.tp_step_case(inputs, device="cuda",
                                                attention=fa.flash_attention_bhsd),
           torch.float64: tp_ranks.tp_step_case(inputs, device="cuda", dtype=torch.float64,
                                                tokens="tokens_f64")}
    return spawned, one


@pytest.mark.parametrize("layout", ["tp4", "dp2_tp2"])
def test_nccl_tensor_parallel_matches_one_card(tensor_parallel_runs, layout):
    """``tp 4`` and ``dp 2 x tp 2`` over 4 NCCL cards (K1-K3 at the local
    heads), float32, against one card on the global batch: both losses
    within 1e-6 relative; every gradient and every parameter after one Adam
    step (gathered whole) within ``torch_moe_ranks.split_batch_rule`` (2x
    the worst of its class in ``dp 4`` from the same spawn, ``dp 4`` itself
    under ``DP_CEILING``); every rank's whole parameters bitwise equal."""
    import torch_moe_ranks as moe_ranks
    import torch_seq_ranks as seq_ranks

    spawned, one = tensor_parallel_runs
    results = [res[layout] for res in spawned]
    worst = seq_ranks.relative_errors(results, one[torch.float32])
    print(f"{layout} worst relative errors:", worst[:12])
    print("dp4:", seq_ranks.relative_errors([res["dp4"] for res in spawned],
                                            one[torch.float32])[:4])
    over, bars = moe_ranks.split_batch_rule(results, [res["dp4"] for res in spawned],
                                            one[torch.float32])
    print("split-batch bars:", bars)
    losses = [(k, e) for k, e in worst if len(k) == 2 and e > 1e-6]
    replicas = seq_ranks.differing_replicas(results)
    assert not losses and not over and not replicas, (
        f"losses over 1e-6: {losses}; {len(over)} tensors over {bars}: {over[:20]}; "
        f"replicas differing: {replicas}")


@pytest.mark.parametrize("layout", ["tp4", "dp2_tp2"])
def test_nccl_tensor_parallel_f64_matches_one_card(tensor_parallel_runs, layout):
    """The float64 twins (dense attention) against one card in float64: the
    losses, every gradient and every updated parameter within 1e-7
    relative; every rank's whole parameters bitwise equal."""
    import torch_seq_ranks as seq_ranks

    spawned, one = tensor_parallel_runs
    results = [res[f"{layout}_f64"] for res in spawned]
    worst = seq_ranks.relative_errors(results, one[torch.float64])
    print(f"{layout} float64 worst relative errors:", worst[:12])
    over = [(k, e) for k, e in worst if e > 1e-7]
    replicas = seq_ranks.differing_replicas(results)
    assert not over and not replicas, (f"{len(over)} of {len(worst)} over 1e-7: {over[:20]}; "
                                       f"replicas differing: {replicas}")


def test_nccl_tensor_generate_tp4_equals_tp1(cuda, tmp_path, capsys):
    """``cli.generate --device cuda --tp 4`` (shard i on card i) prints
    what ``--tp 1`` prints, greedy, on a checkpoint of the 110M widths at 2
    layers (vocab 256)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: generate --tp 4 puts one shard on each")
    from deeplearning_mpi_tpu_torch.cli import generate
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_mpi_tpu_torch.utils.config import save_arch

    cfg = TransformerConfig(vocab_size=256, num_layers=2)
    model = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    save_arch(cfg, tmp_path / "lm")
    Checkpointer(tmp_path / "lm").save(create_train_state(model, None), epoch=0)
    argv = ["--device", "cuda", "--num_layers", "2", "--num_heads", "12", "--head_dim", "64",
            "--d_model", "768", "--d_ff", "2048", "--model_dir", str(tmp_path), "--prompt",
            "Tensor parallel decode", "--max_new_tokens", "24", "--greedy"]
    capsys.readouterr()
    assert generate.main(argv) == 0
    single = capsys.readouterr().out
    fd.flash_decode_cuda.launches = 0
    assert generate.main(argv + ["--tp", "4"]) == 0
    assert capsys.readouterr().out == single and single.strip()
    assert fd.flash_decode_cuda.launches == 4 * 2 * 23


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    """4 NCCL ranks (one card each) of ``torch_tp_ranks.worker_cuda_zero``
    over ``dp 4`` on the LM at 2 layers of the 110M widths, 3 steps of B8
    S1024 with clip (half one card's float64 step-1 gradient norm) and EMA
    0.9, TF32 off. Skips with fewer than four cards."""
    import dataclasses
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: dp 4, one rank a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_tp_ranks as tp_ranks

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    tmp_path = tmp_path_factory.mktemp("zero")
    cfg = TransformerConfig(num_layers=2)
    full = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    ds = SyntheticTokens(24, 1024, vocab_size=cfg.vocab_size, seed=3)
    batches = [torch.stack([torch.from_numpy(ds[i * 8 + j]["tokens"]) for j in range(8)])
               for i in range(3)]
    probe = TransformerLM(cfg, dtype=torch.float64, device="cuda").double()
    probe.load_state_dict(full.state_dict())
    _, metrics = make_train_step("lm", guard_metrics=True)(
        create_train_state(probe, build_optimizer("adam", 1e-3)), {"tokens": batches[0].cuda()})
    inputs = {"cfg": dataclasses.asdict(cfg), "zero_params": full.state_dict(),
              "zero_batches": batches, "clip": 0.5 * float(metrics["grad_norm"])}
    del probe
    torch.save(inputs, tmp_path / "inputs.pt")
    return tp_ranks, tp_ranks.spawn(tmp_path, tp_ranks.worker_cuda_zero)


def test_nccl_zero_is_bitwise_dp4(zero_runs):
    """``--zero`` over 4 NCCL cards, float32, 3 steps with clip and EMA:
    losses, parameters, gathered moments and EMA bitwise those of ``dp 4``
    on the same cards."""
    _, spawned = zero_runs
    for res in spawned:
        got, want = res["zero_f32"], res["dp_f32"]
        assert got["losses"] == want["losses"]
        for key in ("params", "mu", "nu", "ema"):
            assert all(torch.equal(got[key][n], t) for n, t in want[key].items()), key


def test_nccl_zero_overlap_f64_matches_dp4(zero_runs):
    """The bucketed schedule over 4 NCCL cards (reduce-scatters under the
    backward), float64: losses, parameters, gathered moments and EMA within
    1e-7 relative of ``dp 4``'s; the ranks' parameters bitwise equal."""
    tp_ranks, spawned = zero_runs
    for res in spawned:
        got, want = res["overlap_f64"], res["dp_f64"]
        errs = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
        errs += [e for key in ("params", "mu", "nu", "ema")
                 for _, e in tp_ranks.tree_errors(got[key], want[key])]
        print("worst relative error:", max(errs))
        assert max(errs) <= 1e-7
    for res in spawned[1:]:
        assert all(torch.equal(res["overlap_f64"]["params"][n], t)
                   for n, t in spawned[0]["overlap_f64"]["params"].items())


def test_nccl_zero_moments_are_a_quarter(zero_runs):
    """Each rank keeps a quarter of every sharded leaf's moments (the rest
    whole, as ``dp 4`` keeps all); it prints the moments' bytes a rank."""
    from deeplearning_mpi_tpu_torch.parallel.zero import param_zero_dim

    _, spawned = zero_runs
    for res in spawned:
        zero, dp = res["zero_f32"]["local_numel"], res["dp_f32"]["local_numel"]
        shapes = {n: tuple(t.shape) for n, t in res["dp_f32"]["mu"].items()}
        for n, k in dp.items():
            sharded = param_zero_dim(n, shapes[n], 4) is not None
            assert zero[n] * (4 if sharded else 1) == k, n
    print("Adam moments a rank:", spawned[0]["zero_f32"]["local_bytes"], "bytes with --zero,",
          spawned[0]["dp_f32"]["local_bytes"], "with dp 4")


@pytest.fixture(scope="module")
def nccl_pipeline_runs(tmp_path_factory):
    """4 NCCL ranks (one card each) of ``tests/torch_pipe_ranks.py``'s
    :data:`CUDA_PIPE_LAYOUTS` on the LM at 4 layers of the 110M widths, B4
    S2048 (float64: B4 S512), TF32 off, and a ``--pp 4`` checkpoint over 3
    steps of B4 S512; one card's flat step on the global batch (float32
    with flash, float64 dense). Skips with fewer than four cards."""
    import dataclasses
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: pp 4 and dp 2 x pp 2, one rank a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_pipe_ranks as pipe_ranks
    import torch_tp_ranks as tp_ranks

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    tmp_path = tmp_path_factory.mktemp("pipeline")
    cfg = TransformerConfig(num_layers=4)
    full = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)

    def rows(n, seq, seed):
        ds = SyntheticTokens(n, seq, vocab_size=cfg.vocab_size, seed=seed)
        return torch.stack([torch.from_numpy(ds[i]["tokens"]) for i in range(n)])

    inputs = {"cfg": dataclasses.asdict(cfg), "params": full.state_dict(),
              "tokens": rows(4, 2048, 0), "tokens_f64": rows(4, 512, 1), "clip": 1.0,
              "batches": [rows(4, 512, 2 + i) for i in range(3)]}
    torch.save(inputs, tmp_path / "inputs.pt")
    spawned = tp_ranks.spawn(tmp_path, pipe_ranks.worker_cuda_pipe)
    one = {torch.float32: tp_ranks.tp_step_case(inputs, device="cuda",
                                                attention=fa.flash_attention_bhsd),
           torch.float64: tp_ranks.tp_step_case(inputs, device="cuda", dtype=torch.float64,
                                                tokens="tokens_f64")}
    return spawned, one


@pytest.mark.parametrize("layout", ["pp4", "dp2_pp2"])
def test_nccl_pipeline_matches_one_card(nccl_pipeline_runs, layout):
    """``pp 4`` (M 4) and ``dp 2 x pp 2`` (M 2) over 4 NCCL cards (K1-K3 at
    the microbatch shape, activations by send / receive), float32, against
    one card's flat step on the global batch: both losses within 1e-6
    relative; every gradient and every parameter after one Adam step
    (remapped flat) within ``torch_moe_ranks.split_batch_rule`` against
    ``dp 4`` from the same spawn (``dp 4`` itself under ``DP_CEILING``);
    every rank's whole parameters bitwise equal."""
    import torch_moe_ranks as moe_ranks
    import torch_seq_ranks as seq_ranks

    spawned, one = nccl_pipeline_runs
    results = [res[layout] for res in spawned]
    worst = seq_ranks.relative_errors(results, one[torch.float32])
    print(f"{layout} worst relative errors:", worst[:12])
    print("dp4:", seq_ranks.relative_errors([res["dp4"] for res in spawned],
                                            one[torch.float32])[:4])
    over, bars = moe_ranks.split_batch_rule(results, [res["dp4"] for res in spawned],
                                            one[torch.float32])
    print("split-batch bars:", bars)
    losses = [(k, e) for k, e in worst if len(k) == 2 and e > 1e-6]
    replicas = seq_ranks.differing_replicas(results)
    assert not losses and not over and not replicas, (
        f"losses over 1e-6: {losses}; {len(over)} tensors over {bars}: {over[:20]}; "
        f"replicas differing: {replicas}")


@pytest.mark.parametrize("layout", ["pp4", "dp2_pp2"])
def test_nccl_pipeline_f64_matches_one_card(nccl_pipeline_runs, layout):
    """The float64 twins (dense attention) against one card in float64: the
    losses, every gradient and every updated parameter within 1e-7
    relative; every rank's whole parameters bitwise equal."""
    import torch_seq_ranks as seq_ranks

    spawned, one = nccl_pipeline_runs
    results = [res[f"{layout}_f64"] for res in spawned]
    worst = seq_ranks.relative_errors(results, one[torch.float64])
    print(f"{layout} float64 worst relative errors:", worst[:12])
    over = [(k, e) for k, e in worst if e > 1e-7]
    replicas = seq_ranks.differing_replicas(results)
    assert not over and not replicas, (f"{len(over)} of {len(worst)} over 1e-7: {over[:20]}; "
                                       f"replicas differing: {replicas}")


def test_nccl_pipeline_checkpoint_resumes_bitwise(nccl_pipeline_runs):
    """A ``--pp 4`` save over 4 NCCL cards (the stage leaves gathered,
    stacked ``[4, ...]``): every rank's digests equal, its verified restore
    the same digests, and the resumed step bitwise the uninterrupted one."""
    spawned, _ = nccl_pipeline_runs
    ckpts = [res["checkpoint"] for res in spawned]
    saved = ckpts[0]["saved"]
    assert any("stages.block_0" in k for k in saved)
    for c in ckpts:
        assert c["saved"] == saved and c["restored"] == saved
        assert c["resumed"] == c["uninterrupted"]


@pytest.fixture(scope="module")
def nccl_compose_runs(tmp_path_factory):
    """4 NCCL ranks (one card each) of ``tests/torch_compose_ranks.py``'s
    compositions on the 110M widths at 2 layers (the MoE LM with 4 experts),
    B4 S2048 in float32 (K1-K3 at the local heads and shards; the kernel
    ring on CUDA) and the float64 twins (dense attention), TF32 off, with
    the split-batch baselines (:data:`_COMPOSE_BASE`) and the wrong copies
    of :data:`_COMPOSE_WRONG` in the same spawn; one card's flat step on
    the global batch (float32 with flash, float64 dense). Skips with fewer
    than four cards."""
    import dataclasses
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: pp 2 x tp 2, tp 2 x sp 2, ep 2 x sp 2 and ep 2 x tp 2, "
                    "one rank a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_compose_ranks as compose_ranks
    import torch_tp_ranks as tp_ranks

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    tmp_path = tmp_path_factory.mktemp("compose")
    cfg = TransformerConfig(num_layers=2)
    moe_cfg = dataclasses.replace(cfg, moe_experts=4)
    dense = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    moe = TransformerLM(moe_cfg, dtype=torch.float32, device="cpu").init_weights(1)
    ds = SyntheticTokens(4, 2048, vocab_size=cfg.vocab_size, seed=0)
    tokens = torch.stack([torch.from_numpy(ds[i]["tokens"]) for i in range(4)])
    as_dict = lambda c: {k: v for k, v in dataclasses.asdict(c).items()  # noqa: E731
                         if k != "moe_routing"}
    inputs = {"cfg": as_dict(cfg), "moe_cfg": as_dict(moe_cfg), "params": dense.state_dict(),
              "moe_params": moe.state_dict(), "tokens": tokens,
              "clip": {name: 1.0 for name in compose_ranks.LAYOUTS},
              "layouts": list(compose_ranks.LAYOUTS), "dp4": ["pp2_tp2", "ep2_tp2"],
              "dp2_sp2": ["tp2_sp2_ring", "ep2_sp2", "ep2_sp2_ec"], "wrong": _COMPOSE_WRONG}
    torch.save(inputs, tmp_path / "inputs.pt")
    spawned = tp_ranks.spawn(tmp_path, compose_ranks.worker_cuda)
    one = {name: {torch.float32: compose_ranks.step_case(inputs, name, device="cuda",
                                                         attention_fn=fa.flash_attention_bhsd),
                  torch.float64: compose_ranks.step_case(inputs, name, device="cuda",
                                                         dtype=torch.float64)}
           for name in compose_ranks.LAYOUTS}
    return spawned, one


#: Each composition's split-batch baseline in the same spawn: the same
#: model and routing as pure data parallelism where the layout splits the
#: batch's work by rows or weights (``dp 4``), and over ``dp 2 x sp 2``
#: with the ring where it splits each row's sequence, which re-associates
#: each row's float32 sums as a batch split does not.
_COMPOSE_BASE = {"pp2_tp2": "dp4_pp2_tp2", "tp2_sp2_ring": "dp2_sp2_tp2_sp2_ring",
                 "tp2_sp2_ulysses": "dp2_sp2_tp2_sp2_ring", "ep2_sp2": "dp2_sp2_ep2_sp2",
                 "ep2_sp2_ec": "dp2_sp2_ep2_sp2_ec", "ep2_tp2": "dp4_ep2_tp2"}
#: Wrong copies (``torch_compose_ranks.WRONG``) the seq-split bar must
#: reject on four cards: the gradients not summed over the seq group; each
#: shard's balance loss averaged after; capacity from the shard's length.
_COMPOSE_WRONG = ["grads_not_summed_over_seq", "balance_loss_per_shard", "capacity_from_shard"]


def _compose_failures(nccl_compose_runs, layout: str, case: str) -> tuple[list, dict, list]:
    """``(tensors over the split-batch bar, the bars, scalars over 1e-6)`` of
    ``case``'s float32 step on ``layout`` against one card's flat step."""
    import torch_moe_ranks as moe_ranks

    spawned, one = nccl_compose_runs
    ref = one[layout][torch.float32]
    results = [res[case] for res in spawned]
    over, bars = moe_ranks.split_batch_rule(results, [res[_COMPOSE_BASE[layout]]
                                                      for res in spawned], ref)
    worst = sorted(((moe_ranks.relative_error(got[key][n], t), key, n) for got in results[:1]
                    for key in ("grads", "params") for n, t in ref[key].items()), reverse=True)
    print(f"{case} on {layout}: split-batch bars", bars, "worst:", worst[:6])
    scalars = [(r, k, got[k], ref[k]) for r, got in enumerate(results)
               for k in ("adam_loss", "moe_aux_loss", "moe_dropped_frac") if k in ref
               and abs(got[k] - ref[k]) > 1e-6 * max(1.0, abs(ref[k]))]
    return over, bars, scalars


@pytest.mark.parametrize("layout", ["pp2_tp2", "tp2_sp2_ring", "tp2_sp2_ulysses", "ep2_sp2",
                                    "ep2_sp2_ec", "ep2_tp2"])
def test_nccl_compose_matches_one_card(nccl_compose_runs, layout):
    """``nccl_pp_tp``, ``nccl_tp_sp`` (ring, Ulysses), ``nccl_ep_sp`` (token
    and expert choice) and ``nccl_ep_tp`` over 4 NCCL cards, float32,
    against one card's flat step on the global batch: the losses within
    1e-6 relative, the MoE metrics within 1e-6; every gradient and every
    parameter after one Adam step within ``torch_moe_ranks.split_batch_rule``
    against the layout's split-batch baseline (:data:`_COMPOSE_BASE`) from
    the same spawn (the baseline itself under ``DP_CEILING``); every rank's
    whole parameters bitwise equal."""
    over, bars, scalars = _compose_failures(nccl_compose_runs, layout, layout)
    results = [res[layout] for res in nccl_compose_runs[0]]
    replicas = [n for got in results[1:] for n, t in results[0]["params"].items()
                if not torch.equal(got["params"][n], t)]
    assert not over and not scalars and not replicas, (
        f"{len(over)} tensors over {bars}: {over[:20]}; scalars: {scalars}; replicas "
        f"differing: {replicas}")


@pytest.mark.parametrize("kind", _COMPOSE_WRONG)
def test_nccl_compose_bar_rejects_a_wrong_copy(nccl_compose_runs, kind):
    """Each wrong copy of :data:`_COMPOSE_WRONG` on four cards puts a
    gradient or an updated parameter over its layout's split-batch bar."""
    import torch_compose_ranks as compose_ranks

    over, bars, _ = _compose_failures(nccl_compose_runs, compose_ranks.WRONG[kind], kind)
    assert over, f"{kind} passed the bars {bars}"


@pytest.mark.parametrize("layout", ["pp2_tp2", "tp2_sp2_ring", "tp2_sp2_ulysses", "ep2_sp2",
                                    "ep2_sp2_ec", "ep2_tp2"])
def test_nccl_compose_f64_matches_one_card(nccl_compose_runs, layout):
    """The float64 twins (dense attention) against one card in float64: the
    loss, every gradient, its clip and every updated parameter within 1e-7
    relative."""
    import torch_compose_ranks as compose_ranks

    spawned, one = nccl_compose_runs
    results = [res[f"{layout}_f64"] for res in spawned]
    bad = compose_ranks.f64_failures(results, one[layout][torch.float64])
    assert not bad, bad[:20]


@pytest.fixture(scope="module")
def nccl_sharded_runs(tmp_path_factory):
    """4 NCCL ranks (one card each) of ``tests/torch_sharded_ranks.py``'s
    composed layouts on the 110M widths at 2 layers (the MoE LM with 4
    experts), B8 S1024: ``pp 2 x ep 2`` (2 microbatches), ``--loss_chunk``
    under ``dp 2 x sp 2`` (ring) and ZeRO-1 beside ``ep 2``, ``sp 2`` (ring)
    and ``pp 2``, each in float32 (K1-K3; the kernel ring) and float64 (the
    plain cores), TF32 off, with the split-batch baseline of ``pp 2 x ep 2``
    (``dp 4``) in the same spawn; one card's step of the pipelined MoE LM
    (its stages in order, every expert) and of the flat LM with the chunked
    loss, each in float32 with flash and in float64. Skips with fewer than
    four cards."""
    import dataclasses
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: pp 2 x ep 2 and dp 2 x (ep, sp, pp) 2, one rank a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_sharded_ranks as sharded
    import torch_tp_ranks as tp_ranks

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    tmp_path = tmp_path_factory.mktemp("sharded")
    cfg = TransformerConfig(num_layers=2)
    moe_cfg = dataclasses.replace(cfg, moe_experts=4)
    dense = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    moe = TransformerLM(moe_cfg, dtype=torch.float32, device="cpu").init_weights(1)
    ds = SyntheticTokens(8, 1024, vocab_size=cfg.vocab_size, seed=0)
    as_dict = lambda c: {k: v for k, v in dataclasses.asdict(c).items()  # noqa: E731
                         if k != "moe_routing"}
    layouts = [*sharded.COMPOSE, *sharded.ZERO]
    inputs = {"cfg": as_dict(cfg), "moe_cfg": as_dict(moe_cfg), "params": dense.state_dict(),
              "moe_params": moe.state_dict(),
              "tokens": torch.stack([torch.from_numpy(ds[i]["tokens"]) for i in range(8)]),
              "clip": {name: 1.0 for name in [*layouts, "dp4_pp2_ep2"]}, "layouts": layouts}
    torch.save(inputs, tmp_path / "inputs.pt")
    spawned = tp_ranks.spawn(tmp_path, sharded.worker_cuda)
    one = {name: {torch.float32: sharded.step_case(inputs, name, device="cuda",
                                                   attention_fn=fa.flash_attention_bhsd),
                  torch.float64: sharded.step_case(inputs, name, device="cuda",
                                                   dtype=torch.float64)}
           for name in sharded.COMPOSE}
    return spawned, one


def test_nccl_compose_pp2_ep2_matches_one_card(nccl_sharded_runs):
    """``pp 2 x ep 2`` over 4 NCCL cards, float32, against one card's
    pipelined MoE step: the loss, the balance loss and the dropped fraction
    within 1e-6 relative; every gradient and every parameter after one Adam
    step within ``torch_moe_ranks.split_batch_rule`` against ``dp 4`` from
    the same spawn (itself under ``DP_CEILING``); every rank's whole
    parameters bitwise equal."""
    assert not _sharded_failures(nccl_sharded_runs, "pp2_ep2", "dp4_pp2_ep2")


def test_nccl_compose_pp2_ep2_f64_matches_one_card(nccl_sharded_runs):
    """The float64 twin (dense attention) against one card in float64: the
    loss, every gradient, its clip and every updated parameter within 1e-7
    relative."""
    assert not _sharded_f64_failures(nccl_sharded_runs, "pp2_ep2")


def test_nccl_loss_chunk_sp_matches_one_card(nccl_sharded_runs):
    """``--loss_chunk`` under ``dp 2 x sp 2`` (the kernel ring) over 4 NCCL
    cards, float32, against one card's flat step with the chunked loss: the
    loss within 1e-6 relative; every gradient and every parameter after one
    Adam step within ``torch_moe_ranks.split_batch_rule`` against the
    ``dp 2 x sp 2`` ring step of the same model without it from the same
    spawn (``dp2_sp2_zero`` without ZeRO-1, the seq-split baseline of
    :data:`_COMPOSE_BASE`; itself under ``DP_CEILING``); every rank's whole
    parameters bitwise equal."""
    assert not _sharded_failures(nccl_sharded_runs, "dp2_sp2_chunk", "dp2_sp2_zero_unzeroed")


def test_nccl_loss_chunk_sp_f64_matches_one_card(nccl_sharded_runs):
    """The float64 twin (the plain ring) against one card's chunked step in
    float64: the loss, every gradient, its clip and every updated parameter
    within 1e-7 relative."""
    assert not _sharded_f64_failures(nccl_sharded_runs, "dp2_sp2_chunk")


def _sharded_failures(nccl_sharded_runs, layout: str, baseline: str) -> list:
    """What fails the float32 bar of ``layout`` in ``nccl_sharded_runs``:
    the tensors over ``split_batch_rule`` against ``baseline``, the scalars
    over 1e-6 relative, the parameters that differ between ranks."""
    import torch_moe_ranks as moe_ranks

    spawned, one = nccl_sharded_runs
    ref = one[layout][torch.float32]
    results = [res[layout] for res in spawned]
    over, bars = moe_ranks.split_batch_rule(results, [res[baseline] for res in spawned], ref)
    print(f"{layout}: split-batch bars", bars, "over:", over[:6])
    scalars = [(r, k, got[k], ref[k]) for r, got in enumerate(results)
               for k in ("step_loss", "moe_aux_loss", "moe_dropped_frac")
               if k in ref and abs(got[k] - ref[k]) > 1e-6 * max(1.0, abs(ref[k]))]
    replicas = [n for got in results[1:] for n, t in results[0]["params"].items()
                if not torch.equal(got["params"][n], t)]
    return over[:20] + scalars + replicas


def _sharded_f64_failures(nccl_sharded_runs, layout: str) -> list:
    """The float64 twin's loss, gradients, clip and updated parameters over
    1e-7 relative of one card's, on any rank."""
    import torch_moe_ranks as moe_ranks

    spawned, one = nccl_sharded_runs
    ref = one[layout][torch.float64]
    bad = []
    for r, res in enumerate(spawned):
        got = res[f"{layout}_f64"]
        if abs(got["step_loss"] - ref["step_loss"]) > 1e-7 * abs(ref["step_loss"]):
            bad.append((r, "step_loss", got["step_loss"], ref["step_loss"]))
        for key in ("grads", "clipped", "params"):
            worst = max((moe_ranks.relative_error(got[key][n], t), n) for n, t in ref[key].items())
            if worst[0] > 1e-7:
                bad.append((r, key, worst))
    return bad


@pytest.mark.parametrize("layout", ["dp2_ep2_zero", "dp2_sp2_zero", "dp2_pp2_zero"])
def test_nccl_zero_composed_is_bitwise_without_it(nccl_sharded_runs, layout):
    """ZeRO-1 beside ``ep 2``, ``sp 2`` (the kernel ring) and ``pp 2`` over 4
    NCCL cards: the loss and every whole parameter after one Adam step
    bitwise the same layout's step without ZeRO-1, in float32 and in the
    float64 twin; some moment cut over data."""
    spawned, _ = nccl_sharded_runs
    for res in spawned:
        for suffix in ("", "_f64"):
            got, want = res[f"{layout}{suffix}"], res[f"{layout}_unzeroed{suffix}"]
            assert got["step_loss"] == want["step_loss"]
            assert all(torch.equal(got["params"][n], t) for n, t in want["params"].items())
        got = res[layout]
        assert any(s != got["param_shapes"][n] for n, s in got["moment_shapes"].items())


def _pod_losses(path) -> tuple[dict, dict]:
    """``(epoch, step) -> loss`` and ``epoch -> loss`` of a ``metrics.jsonl``,
    epochs >= 1 (epoch 0 predates the failure)."""
    import json

    steps, epochs = {}, {}
    for rec in map(json.loads, open(path)):
        if rec.get("epoch") is None or rec["epoch"] < 1 or "loss" not in rec:
            continue
        if rec["kind"] == "step":
            steps[(rec["epoch"], rec["step"])] = rec["loss"]
        elif rec["kind"] == "epoch":
            epochs[rec["epoch"]] = rec["loss"]
    return steps, epochs


def test_nccl_pod_rank_kill_reforms_and_resumes_bitwise(cuda, tmp_path, monkeypatch, capsys):
    """``nccl_pod``: ``cli.launch_pod`` over 2 NCCL ranks (cards 0 and 1) of
    ``train_lm`` at the 110M widths, 2 layers (vocab 256), bf16 B8 S2048
    with flash, 3 epochs of 2 steps, ``rank_kill@step:3`` and
    ``min_world_size 1``: the world sizes are [2, 1] (the reference's
    ``tools/pod_drill.py``), the pod's books balance, and the resumed
    world's step and epoch losses are bitwise a clean ``--resume`` of the
    epoch-0 checkpoint at world size 1 on card 0."""
    import json
    import shutil
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: one NCCL rank a card")
    from deeplearning_mpi_tpu_torch.cli import launch_pod, train_lm
    from deeplearning_mpi_tpu_torch.ops.kernels import _build

    root = pathlib.Path(__file__).resolve().parents[1]
    print("nccl_pod cards:", _chip_smoke().gpu_name_and_power(), "x", torch.cuda.device_count())
    _build.build_all(["flash_attention_fwd", "flash_attention_bwd"])  # once, for every rank
    for var in [k for k in __import__("os").environ if k.startswith("DMT_")] + [
            "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "LOCAL_RANK"]:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTHONPATH", str(root))
    monkeypatch.chdir(root)

    def flags(tag):
        return ["--device", "cuda", "--attention", "flash", "--dtype", "bfloat16",
                "--num_layers", "2", "--d_model", "768", "--num_heads", "12", "--head_dim", "64",
                "--d_ff", "2048", "--seq_len", "2048", "--batch_size", "8",
                "--train_sequences", "18", "--num_epochs", "3", "--eval_every", "1",
                "--keep_checkpoints", "10", "--resume", "--model_dir", str(tmp_path / f"{tag}m"),
                "--log_dir", str(tmp_path / f"{tag}l"), "--metrics_dir", str(tmp_path / f"{tag}x")]

    rc = launch_pod.main(["--num_processes", "2", "--pod_dir", str(tmp_path / "pod"),
                          "--chaos", "rank_kill@step:3", "--min_world_size", "1",
                          "--heartbeat_interval_s", "0.5", "--poll_interval_s", "0.25",
                          "--heartbeat_deadline_s", "120", "--spawn_grace_s", "300", "--",
                          sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.train_lm",
                          *flags("")])
    logs = "".join(p.read_text()[-3000:] for p in sorted((tmp_path / "pod").glob("*.log")))
    assert rc == 0, capsys.readouterr().out + logs
    summary = [r for r in map(json.loads, open(tmp_path / "pod" / "pod_metrics.jsonl"))
               if r.get("kind") == "pod_summary"][-1]
    print("nccl_pod summary:", {k: v for k, v in summary.items() if not k.startswith("ts")})
    assert summary["world_sizes"] == "2->1" and summary["chaos_balanced"] is True
    assert summary["fault_injected_total"] == summary["recovery_total"] == 1
    assert (summary["pod_rank_failures_total"], summary["pod_restarts_total"]) == (1, 1)
    shutil.copytree(tmp_path / "m", tmp_path / "oraclem")
    for child in (tmp_path / "oraclem" / "lm").iterdir():
        if (child.is_dir() and child.name.isdigit() and int(child.name) > 0) or (
                child.name.startswith("manifest-") and child.stem != "manifest-0"):
            shutil.rmtree(child) if child.is_dir() else child.unlink()
    capsys.readouterr()
    assert train_lm.main(flags("oracle")) == 0
    assert "resumed from verified epoch 0" in capsys.readouterr().out
    pod = _pod_losses(tmp_path / "x" / "metrics.jsonl")
    oracle = _pod_losses(tmp_path / "oraclex" / "metrics.jsonl")
    print("nccl_pod resumed losses:", pod, "oracle:", oracle)
    assert oracle[0] and sorted(oracle[1]) == [1, 2]
    assert pod == oracle


# -- the serving half of the resilience layer ------------------------------------------
@pytest.mark.parametrize("start,chunk,length", [(0, 16, 128), (48, 16, 128), (120, 16, 128),
                                                (384, 128, 1024)])
def test_prefill_chunk_attention_through_k1(cuda, start, chunk, length):
    """The engine's prefill-chunk call (``chunk_attention``) launches K1 once
    and agrees with the masked matmul on the chunk's rows (the pages padded
    where the chunk runs past them)."""
    from deeplearning_mpi_tpu_torch.ops.attention import dense_attention
    from deeplearning_mpi_tpu_torch.serving.engine import chunk_attention

    q = torch.randn(1, chunk, 12, 64, generator=cuda, device="cuda")
    k, v = (torch.randn(1, length, 12, 64, generator=cuda, device="cuda") for _ in range(2))
    before = fa.flash_attention_cuda.launches
    got = chunk_attention(q, k, v, start)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    valid = min(chunk, length - start)
    want = dense_attention(q, k, v, causal=True, q_offset=start)
    _out_close(got[:, :valid].contiguous(), want[:, :valid].contiguous(), torch.float32,
               f"chunk at {start}")


def test_disaggregated_pair_on_the_card(cuda):
    """A warmed disaggregated pair on the card under ``handoff_stall`` and
    ``serve_crash``: the streams equal the colocated engine's and offline
    greedy's, the prefill role launches K1 and never K4, the decode role K4
    and never K1, the shared pool drains and the books balance."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.resilience.faults import ChaosInjector
    from deeplearning_mpi_tpu_torch.serving import (
        DisaggregatedEngine,
        EngineConfig,
        ServingEngine,
    )

    model = TransformerLM(TransformerConfig(vocab_size=256, num_layers=2), dtype=torch.float32,
                          device="cuda").init_weights(0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (7, 40, 19, 64, 3)]
    cfg = EngineConfig(max_slots=3, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                       prefill_chunk=16)
    chaos = ChaosInjector.from_spec("handoff_stall@step:2,serve_crash@step:5")
    pair = DisaggregatedEngine(model, cfg, chaos=chaos)
    pair.warmup()
    lanes = {"prefill": [0, 0], "decode": [0, 0]}

    def counted(role, step):
        def run():
            b = (fa.flash_attention_cuda.launches, fd.flash_decode_cuda.launches)
            done = step()
            lanes[role][0] += fa.flash_attention_cuda.launches - b[0]
            lanes[role][1] += fd.flash_decode_cuda.launches - b[1]
            return done
        return run

    pair.prefill.step = counted("prefill", pair.prefill.step)
    pair.decode.step = counted("decode", pair.decode.step)
    reqs = [pair.submit(p, 12) for p in prompts]
    pair.run_until_idle()
    colocated = ServingEngine(model, cfg)
    creqs = [colocated.submit(p, 12) for p in prompts]
    colocated.run_until_idle()
    for r, c, p in zip(reqs, creqs, prompts):
        assert r.generated == c.generated == offline_greedy(model, p, 12, None)
    assert lanes["prefill"][0] > 0 == lanes["prefill"][1]
    assert lanes["decode"][1] > 0 == lanes["decode"][0]
    assert chaos.balanced() and pair.pool.in_use == 0
    pair.pool.check()


def test_fleet_on_the_card(cuda, tmp_path, capsys):
    """``serve_lm --replicas 2`` on the card with a kill, a hang and a
    rolling swap: exit 0 with the CLI's bit-exact parity, the swap in place,
    every worker that served reporting K1 and K4 launches."""
    import json

    from deeplearning_mpi_tpu_torch.cli import serve_lm

    rc = serve_lm.main(["--selftest", "--device", "cuda", "--num_layers", "2",
                        "--num_heads", "12", "--head_dim", "64", "--d_model", "768",
                        "--d_ff", "2048", "--replicas", "2", "--chaos",
                        "replica_kill@step:4,replica_hang@step:6", "--swap_at", "8",
                        "--num_requests", "24", "--rate", "3", "--fleet_dir",
                        str(tmp_path / "f")])
    out = capsys.readouterr()
    text = out.out + out.err
    assert rc == 0, text
    assert "in_place=True" in text and "compile_flat=True" in text
    workers = json.loads(next(ln for ln in text.splitlines()
                              if ln.startswith("fleet workers: ")).split(": ", 1)[1])
    served = [w for w in workers.values() if w["served"]]
    assert served and all(w["K1"] > 0 and w["K4"] > 0 for w in served)


def _tp_serving(devices, tp):
    """A tensor-parallel engine's model (``LockstepTP(tp, devices)``) at the
    110M widths and 2 blocks (vocab 256), its unsharded twin on ``cuda:0``,
    seeded prompts and an engine config."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP
    from deeplearning_mpi_tpu_torch.serving import EngineConfig

    cfg = TransformerConfig(vocab_size=256, num_layers=2)
    model = TransformerLM(cfg, dtype=torch.float32, device="cuda",
                          tp=LockstepTP(tp, devices)).init_weights(0)
    one = TransformerLM(cfg, dtype=torch.float32, device="cuda").init_weights(0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (7, 40, 19, 64, 3)]
    engine = EngineConfig(max_slots=3, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                          prefill_chunk=16)
    return model, one, prompts, engine


def test_tp_engine_on_one_card_warmed_equals_offline_greedy(cuda):
    """The engine over ``LockstepTP(4)`` with every rank on this card,
    warmed: streams equal the unsharded model's offline greedy, each rank
    launched K1 a layer a prefill chunk and K4 a layer a decode step through
    the replays, and no capture during traffic; a captured decode step's
    logits equal the eager step's bit for bit."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
    from deeplearning_mpi_tpu_torch.serving import ServingEngine

    model, one, prompts, cfg = _tp_serving("cuda", 4)
    engine = ServingEngine(model, cfg)
    engine.warmup()
    captures, warm = engine.captures, engine.rank_launches
    reqs = [engine.submit(p, 12) for p in prompts]
    engine.run_until_idle()
    torch.cuda.synchronize()
    for r, p in zip(reqs, prompts):
        assert r.generated == offline_greedy(one, p, 12, None)
    assert engine.captures == captures
    layers = model.config.num_layers
    served = [{k: r[k] - w[k] for k in r} for r, w in zip(engine.rank_launches, warm)]
    assert served == [{"K1": layers * engine.prefill_chunks,
                       "K4": layers * engine.decode_steps}] * 4
    from deeplearning_mpi_tpu_torch.compiler.aot import CapturedProgram

    fwd = engine._fwd
    args = (torch.tensor([[1, 2], [3, 4], [5, 6]], device="cuda"),
            torch.tensor([20, 9, 31], device="cuda"), torch.tensor([5, 6, 7], device="cuda"),
            torch.tensor([True, False, True], device="cuda"))
    eager = fwd.decode_logits(engine._kv, *args)
    prog = CapturedProgram(lambda *a: fwd.decode_logits(engine._kv, *a), args,
                           pool=torch.cuda.graph_pool_handle(), counters=fwd.rank_counters())
    before = engine.rank_launches
    got = prog(*args).clone()
    torch.cuda.synchronize()
    assert prog.graph is not None and torch.equal(got, eager)
    assert [r["K4"] - b["K4"] for r, b in zip(engine.rank_launches, before)] == [layers] * 4


def test_tp_engine_across_cards_refuses_capture_and_serves_eagerly(cuda):
    """``LockstepTP(4)`` with one rank a card: ``warmup()`` raises
    ``TP_CAPTURE_REASON`` (a graph captured on one card's stream does not
    record the others' kernels), and the eager engine's streams equal the
    unsharded model's offline greedy, each rank's kernels launched on its
    own card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: one rank a card")
    from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
    from deeplearning_mpi_tpu_torch.serving import ServingEngine
    from deeplearning_mpi_tpu_torch.serving.engine import TP_CAPTURE_REASON

    model, one, prompts, cfg = _tp_serving([f"cuda:{i}" for i in range(4)], 4)
    engine = ServingEngine(model, cfg)
    assert [t.device.index for t in engine._kvh.tensors()] == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(NotImplementedError) as err:
        engine.warmup()
    assert str(err.value) == TP_CAPTURE_REASON and engine.captures == 0
    reqs = [engine.submit(p, 12) for p in prompts]
    engine.run_until_idle()
    for r, p in zip(reqs, prompts):
        assert r.generated == offline_greedy(one, p, 12, None)
    assert all(r["K1"] > 0 and r["K4"] > 0 for r in engine.rank_launches)


def test_tp_fleet_across_cards(cuda, tmp_path, capsys):
    """``serve_lm --replicas 2 --tp 2`` with one rank a card (replica r's
    rank j on ``cuda:(2r + j)``), a kill, a hang and a rolling swap: exit 0
    with the CLI's bit-exact parity against the unsharded model, the swap
    in place, no capture after warmup (each worker's warmup refused by
    name, served eagerly), every rank of a serving worker launching K1 and
    K4."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: one rank a card")
    import json

    from deeplearning_mpi_tpu_torch.cli import serve_lm
    from deeplearning_mpi_tpu_torch.resilience.cluster import JOURNAL_FILE, replay_journal

    rc = serve_lm.main(["--selftest", "--device", "cuda", "--num_layers", "2",
                        "--num_heads", "12", "--head_dim", "64", "--d_model", "768",
                        "--d_ff", "2048", "--replicas", "2", "--tp", "2", "--chaos",
                        "replica_kill@step:4,replica_hang@step:6", "--swap_at", "8",
                        "--num_requests", "30", "--rate", "1.2", "--fleet_dir",
                        str(tmp_path / "f")])
    out = capsys.readouterr()
    text = out.out + out.err
    assert rc == 0, text
    assert "in_place=True" in text and "compile_flat=True" in text
    assert "warmup refused" in text
    workers = json.loads(next(ln for ln in text.splitlines()
                              if ln.startswith("fleet workers: ")).split(": ", 1)[1])
    served = [w for w in workers.values() if w["served"]]
    assert served and all(min(w["K1_by_rank"] + w["K4_by_rank"]) > 0 for w in served)
    devices = {r["idx"]: r["devices"] for r in replay_journal(tmp_path / "f" / JOURNAL_FILE)
               if r["ev"] == "ready"}
    assert devices[0] == ["cuda:0", "cuda:1"] and devices[1] == ["cuda:2", "cuda:3"]


@pytest.mark.parametrize("guard", [True, False], ids=["guarded", "wrong_unguarded"])
def test_capture_survives_a_collection_of_dead_graphs(cuda, guard, monkeypatch):
    """A warmed engine dropped in a reference cycle (engine -> warmed
    program -> captured program -> engine) holds its CUDA graphs until a
    cyclic collection; one that runs during another capture frees a graph
    mid-capture and invalidates that capture (as it did to
    ``chip_smoke.py`` phase 22b's third engine). ``CapturedProgram``
    collects before a capture and keeps the collector off during it. The collector runs where allocations happen
    to trigger it, so here the captured decode step runs a collection
    itself whenever the collector is on: the guarded engine captures and
    serves offline greedy, the wrong copy (its ``gc`` calls made no-ops)
    fails its capture. It runs last: a failed capture leaves the card
    usable, but nothing after it depends on that."""
    import gc
    import types

    import numpy as np

    from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
    from deeplearning_mpi_tpu_torch.compiler import aot
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

    model = TransformerLM(TransformerConfig(vocab_size=256, num_layers=2), dtype=torch.float32,
                          device="cuda").init_weights(0)
    cfg = EngineConfig(max_slots=3, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                       prefill_chunk=16)
    dead = ServingEngine(model, cfg)
    dead.warmup()
    gc.collect()  # the dead engine's objects reach the oldest generation
    del dead  # its graphs now wait for a full cyclic collection
    engine = ServingEngine(model, cfg)
    step = engine._fwd.decode_step

    def collecting_step(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing() and gc.isenabled():
            gc.collect()  # where an allocation may set the collector off
        return step(*args, **kwargs)

    engine._fwd.decode_step = collecting_step
    if not guard:
        monkeypatch.setattr(aot, "gc", types.SimpleNamespace(
            collect=lambda: 0, isenabled=gc.isenabled, disable=lambda: None, enable=gc.enable))
        with pytest.raises(RuntimeError, match="capture"):
            engine.warmup()
        return
    engine.warmup()
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % 251 for n in (9, 30, 4)]
    reqs = [engine.submit(p, 8) for p in prompts]
    engine.run_until_idle()
    assert engine.captures > 0
    for r, p in zip(reqs, prompts):
        assert r.generated == offline_greedy(model, p, 8, None)
