"""The port's sequence-parallel schedules against ``deeplearning_mpi_tpu``'s.

The JAX references run here on the 8 virtual CPU devices of
``tests/conftest.py``: ``make_ring_attention_fn(mesh, flash=True,
block_q=8, block_k=8)`` (the Pallas kernels in interpret mode, as
``tests/test_ring_flash.py`` runs them), ``flash=False`` (the XLA ring) and
``make_ulysses_attention_fn``, each output and its VJP jitted together. The
same numpy inputs from a seed go through the port's one-process form
(``make_*_attention_fn(sp=n)`` over global tensors): the kernel ring with
K1-K3's plain versions (these are CPU tensors), the plain ring and Ulysses
on ``dense_attention``. float32: outputs within atol 2e-5, gradients within
atol 3e-5 (the JAX tests' own); one bf16 case at 0.05, as
``test_ring_flash.py``'s.

- The ring, both inners: causal, full, windows 5, 8, 20 and 31 at S_l 8
  (one shard, two, four and every rotation: the windowed backward's hop
  home at ``n_upd`` strictly between 1 and n), window 5 at S_l 16 (rows no
  past block reaches: an empty partial must merge as nothing), GQA Hkv 2
  of H4 with and without a window, S_l 20 (ragged: the reference's flash
  inner falls back to its XLA ring, the port's has no fallback), ring size
  1 (one flash call on repeated K/V).
- Ulysses: causal, full, windows 8 and 20, GQA with K/V repeated before the
  all-to-all (Hkv 2, n 4) and riding it grouped (Hkv 4 of H8), ring size 1.
- A sequence the ring does not divide raises, as the reference's; batch 1
  takes the whole-sequence core; Ulysses refuses heads that n does not
  divide; ``windowed_rotations`` and the merge of an empty partial.
- ONE spawn of 4 gloo ranks (``tests/torch_seq_ranks.py``): the
  process-group form (``sp 4`` ring with each inner, ``sp 4`` ring with GQA
  and window 20, ``sp 4`` Ulysses, ``dp 2 x sp 2`` ring with window 20),
  the ranks' shards reassembled, equal to the one-process form within
  1e-6 and to the JAX references within the tolerances above; and one
  ``make_train_step("lm")`` step of ``TransformerConfig.tiny()`` (2 layers,
  d 32, S 32, batch 4) under ``dp 2 x sp 2`` with the plain ring, Adam
  1e-3 with clip 1.0: the loss (atol 1e-5), the reduced gradients (atol
  1e-5, rtol 1e-4) and the parameters after the step (atol 5e-5, rtol
  1e-4) equal the JAX train step with ``make_ring_attention_fn(mesh)`` on a
  ``data 2 x seq 2`` virtual mesh, and the port's one-process step; a copy
  whose last shard keeps its edge target (a wrapped next token) fails.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_seq_ranks as seq_ranks

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.parallel import make_ring_attention_fn as jax_ring
from deeplearning_mpi_tpu.parallel import make_ulysses_attention_fn as jax_ulysses
from deeplearning_mpi_tpu.parallel import shard_state as jax_shard_state
from deeplearning_mpi_tpu.parallel.ring_attention import windowed_rotations as jax_rotations
from deeplearning_mpi_tpu.runtime.mesh import MeshSpec as JaxSpec
from deeplearning_mpi_tpu.runtime.mesh import batch_sharding as jax_batch_sharding
from deeplearning_mpi_tpu.runtime.mesh import create_mesh as jax_create_mesh
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.data import SyntheticTokens
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig
from deeplearning_mpi_tpu_torch.ops.attention import NEG_INF
from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn, make_ulysses_attention_fn
from deeplearning_mpi_tpu_torch.parallel.ring_attention import windowed_rotations
from deeplearning_mpi_tpu_torch.parallel.ring_flash import _merge

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

B, S, H, D = 4, 32, 4, 16
OUT_TOL = dict(atol=2e-5, rtol=0)
GRAD_TOL = dict(atol=3e-5, rtol=0)
LM_LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
LM_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LM_PARAM_TOL = dict(atol=5e-5, rtol=1e-4)


def _inputs(b=B, s=S, h=H, hkv=None, seed=0):
    """q, k, v (``hkv`` heads) and the output gradient, float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, D)).astype(np.float32) for n in (h, hkv or h, hkv or h, h)]


def _jax_mesh(data, seq):
    return jax_create_mesh(JaxSpec(data=data, seq=seq), devices=jax.devices()[:data * seq])


def _jax_run(fn, kw, arrays, dtype=jnp.float32):
    """The JAX fn's output and VJP on ``arrays``, jitted together."""

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw), q, k, v)
        return (out, *vjp(do))

    return [np.asarray(x.astype(jnp.float32)) for x in
            run(*(jnp.asarray(a).astype(dtype) for a in arrays))]


def _port_run(fn, kw, arrays, dtype=torch.float32):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, **kw)
    return [x.detach().float().numpy() for x in (out, *torch.autograd.grad(out, leaves, do))]


def _assert_close(got, want, out_tol=OUT_TOL, grad_tol=GRAD_TOL):
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, err_msg=label, **(out_tol if label == "out" else grad_tol))


#: id -> (batch, seq, heads, kv heads, sp, data, causal, window)
RING_CASES = {
    "causal": (4, 32, 4, 4, 4, 2, True, None),
    "full": (4, 32, 4, 4, 4, 2, False, None),
    "w5": (4, 32, 4, 4, 4, 2, True, 5),
    "w8": (4, 32, 4, 4, 4, 2, True, 8),
    "w20": (4, 32, 4, 4, 4, 2, True, 20),
    "w31": (4, 32, 4, 4, 4, 2, True, 31),
    "w5_sl16": (4, 64, 4, 4, 4, 2, True, 5),
    "gqa": (4, 32, 4, 2, 4, 2, True, None),
    "gqa_w20": (4, 32, 4, 2, 4, 2, True, 20),
    "ragged_sl20": (4, 80, 4, 4, 4, 2, True, None),
    "ring1_gqa": (8, 32, 4, 2, 1, 8, True, None),
}


def _kw(causal, window):
    return {"causal": causal} | ({"window": window} if window is not None else {})


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "xla"])
def test_ring_matches_jax(flash, case):
    b, s, h, hkv, sp, data, causal, window = RING_CASES[case]
    arrays = _inputs(b, s, h, hkv)
    kw = _kw(causal, window)
    jax_kw = {"flash": True, "block_q": 8, "block_k": 8} if flash else {"flash": False}
    want = _jax_run(jax_ring(_jax_mesh(data, sp), **jax_kw), kw, arrays)
    got = _port_run(make_ring_attention_fn(sp=sp, flash=flash), kw, arrays)
    _assert_close(got, want)


def test_ring_bf16_matches_jax():
    """bf16 through the kernel ring at the JAX test's 0.05."""
    arrays = _inputs()
    want = _jax_run(jax_ring(_jax_mesh(2, 4), flash=True, block_q=8, block_k=8),
                    {"causal": True}, arrays, jnp.bfloat16)
    got = _port_run(make_ring_attention_fn(sp=4, flash=True), {"causal": True}, arrays,
                    torch.bfloat16)
    tol = dict(atol=0.05, rtol=0.05)
    _assert_close(got, want, tol, tol)


#: id -> (heads, kv heads, sp, data, batch, causal, window)
ULYSSES_CASES = {
    "causal": (4, 4, 4, 2, 4, True, None),
    "full": (4, 4, 4, 2, 4, False, None),
    "w8": (4, 4, 4, 2, 4, True, 8),
    "w20": (4, 4, 4, 2, 4, True, 20),
    "gqa_repeated": (4, 2, 4, 2, 4, True, None),
    "gqa_grouped": (8, 4, 4, 2, 4, True, None),
    "ring1": (4, 2, 1, 8, 8, True, None),
}


@pytest.mark.parametrize("case", list(ULYSSES_CASES))
def test_ulysses_matches_jax(case):
    h, hkv, sp, data, b, causal, window = ULYSSES_CASES[case]
    arrays = _inputs(b, S, h, hkv)
    kw = _kw(causal, window)
    want = _jax_run(jax_ulysses(_jax_mesh(data, sp)), kw, arrays)
    got = _port_run(make_ulysses_attention_fn(sp=sp), kw, arrays)
    _assert_close(got, want)


@pytest.mark.parametrize("make", ["ring", "ulysses"])
def test_indivisible_sequence_raises_and_batch_one_takes_the_whole_core(make):
    port = {"ring": make_ring_attention_fn, "ulysses": make_ulysses_attention_fn}[make]
    ref = {"ring": jax_ring, "ulysses": jax_ulysses}[make]
    q, k, v, _ = _inputs(s=30)
    with pytest.raises(ValueError, match="not divisible"):
        port(sp=4)(*(torch.from_numpy(a) for a in (q, k, v)))
    with pytest.raises(ValueError, match="not divisible"):
        ref(_jax_mesh(2, 4))(*(jnp.asarray(a) for a in (q, k, v)))
    one = [a[:1] for a in (q, k, v)]
    got = port(sp=4)(*(torch.from_numpy(a) for a in one), causal=True, window=7)
    want = ref(_jax_mesh(2, 4))(*(jnp.asarray(a) for a in one), causal=True, window=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_ulysses_refuses_heads_the_ring_does_not_divide():
    q, k, v, _ = _inputs(h=6)
    with pytest.raises(ValueError, match="divisible"):
        make_ulysses_attention_fn(sp=4)(*(torch.from_numpy(a) for a in (q, k, v)))
    with pytest.raises(ValueError, match="divisible"):
        jax_ulysses(_jax_mesh(2, 4))(*(jnp.asarray(a) for a in (q, k, v)))


def test_windowed_rotations_match_jax():
    for window in (None, 1, 5, 8, 9, 16, 17, 20, 31, 100):
        for s_local in (8, 16, 20):
            for n in (1, 2, 4):
                assert windowed_rotations(window, s_local, n) == jax_rotations(window, s_local, n)


def test_merge_of_an_empty_partial_is_nothing():
    """NEG_INF is finite: a partial whose rows saw no key (lse NEG_INF, o 0)
    leaves the running output as it was, and two empty ones stay zero."""
    o = torch.randn(1, 3, 2, 4)
    lse = torch.tensor([[[0.5, -1.0], [2.0, 0.0], [NEG_INF, NEG_INF]]])
    o[:, 2] = 0.0
    empty_o, empty_lse = torch.zeros_like(o), torch.full_like(lse, NEG_INF)
    got, got_lse = _merge(o, lse, empty_o, empty_lse)
    assert torch.equal(got, o) and torch.isfinite(got).all()
    assert torch.equal(got_lse[:, :2], lse[:, :2]) and bool((got_lse[:, 2] < -1e29).all())


# -- the process-group form and the LM step: one spawn ---------------------------
def _assemble(results, name, data, seq):
    """The ranks' shards of a case, back in global ``[B, S, ...]`` order
    (rank ``d * seq + s`` holds data block ``d``, sequence slice ``s``)."""
    parts = [res[name] for res in results]
    return [torch.cat([torch.cat([parts[d * seq + s][i] for s in range(seq)], dim=1)
                       for d in range(data)]).numpy() for i in range(4)]


def _jax_lm_step(jc, jparams, tokens, tx):
    """JAX's train step with ``make_ring_attention_fn`` on a ``data 2 x seq
    2`` virtual mesh, from ``jparams``: the metrics and the new state."""
    mesh = _jax_mesh(2, 2)
    jm = JaxLM(config=jc, dtype=jnp.float32, attention_fn=jax_ring(mesh))
    state = jax_create_state(jm, jax.random.key(0), jnp.zeros((1, S), jnp.int32), tx)
    state = jax_shard_state(state.replace(params=jparams, opt_state=tx.init(jparams)), mesh)
    batch = {"tokens": jax.device_put(tokens, jax_batch_sharding(mesh, ndim=2))}
    state, metrics = jax_make_step("lm", donate=False)(state, batch)
    return jax.device_get(metrics), jax.device_get(state)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq")
    jc = JaxConfig.tiny()
    cfg = TransformerConfig(**{f.name: getattr(jc, f.name)
                               for f in dataclasses.fields(TransformerConfig)})
    jparams = jax_create_state(JaxLM(config=jc, dtype=jnp.float32), jax.random.key(0),
                               jnp.zeros((1, S), jnp.int32),
                               jax_optimizer("adam", 1e-3, clip_norm=1.0)).params
    ds = SyntheticTokens(B, S, seed=3)
    tokens = np.stack([ds[i]["tokens"] for i in range(B)])
    qkv = dict(zip("q k v do".split(), (torch.from_numpy(a) for a in _inputs())))
    gqa = dict(zip("q k v do".split(), (torch.from_numpy(a) for a in _inputs(hkv=2, seed=1))))
    inputs = {"qkv": qkv, "gqa": gqa, "cfg": cfg,
              "params": lm_params_from_jax(jax.device_get(jparams)),
              "tokens": torch.from_numpy(tokens)}
    torch.save(inputs, out / "inputs.pt")
    results = seq_ranks.spawn(out)
    probe = optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))
    jax_probe, jax_probe_state = _jax_lm_step(jc, jparams, tokens, probe)
    jax_adam, jax_adam_state = _jax_lm_step(jc, jparams, tokens,
                                            jax_optimizer("adam", 1e-3, clip_norm=1.0))
    return {"ranks": results, "inputs": inputs,
            "one_lm": seq_ranks.lm_step_case(inputs, attention="dense"),
            "jax_lm": {"probe_loss": float(jax_probe["loss"]),
                       "grads": lm_params_from_jax(jax_probe_state.opt_state["g"]),
                       "adam_loss": float(jax_adam["loss"]),
                       "params": lm_params_from_jax(jax_adam_state.params)}}


def _jax_attention(inputs, schedule, kw, data, sp):
    kw = dict(kw)
    gqa = kw.pop("gqa", False)
    arrays = [inputs["gqa" if gqa and n in "kv" else "qkv"][n].numpy() for n in ("q", "k", "v", "do")]
    mesh = _jax_mesh(data, sp)
    fn = jax_ulysses(mesh) if schedule == "ulysses" else jax_ring(
        mesh, **({"flash": True, "block_q": 8, "block_k": 8} if schedule == "ring_flash"
                 else {"flash": False}))
    return _jax_run(fn, kw, arrays)


@pytest.mark.parametrize("case", list(seq_ranks.ATTENTION_CASES))
def test_process_group_form_matches_one_process_and_jax(spawned, case):
    data, sp, schedule, kw = seq_ranks.ATTENTION_CASES[case]
    got = _assemble(spawned["ranks"], case, data, sp)
    one = [t.numpy() for t in seq_ranks.attention_case(spawned["inputs"], schedule, kw, sp=sp)]
    tight = dict(atol=1e-6, rtol=1e-6)
    _assert_close(got, one, tight, tight)
    _assert_close(got, _jax_attention(spawned["inputs"], schedule, kw, data, sp))


def _assert_lm_matches(got, want, *, grads=True):
    np.testing.assert_allclose(got["probe_loss"], want["probe_loss"], **LM_LOSS_TOL)
    np.testing.assert_allclose(got["adam_loss"], want["adam_loss"], **LM_LOSS_TOL)
    assert set(got["grads"]) == set(want["grads"])
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), err_msg=n, **LM_GRAD_TOL)
    for n, p in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), err_msg=n,
                                   **LM_PARAM_TOL)


@pytest.mark.parametrize("reference", ["jax", "one_process"])
def test_dp2_sp2_lm_step_matches(spawned, reference):
    want = spawned["jax_lm"] if reference == "jax" else spawned["one_lm"]
    for r, res in enumerate(spawned["ranks"]):
        _assert_lm_matches(res["lm"], want)
    first = spawned["ranks"][0]["lm"]["params"]
    for res in spawned["ranks"][1:]:  # every rank takes the same step
        assert all(torch.equal(res["lm"]["params"][n], p) for n, p in first.items())


def test_a_last_shard_that_keeps_its_edge_target_fails(spawned):
    for res in spawned["ranks"]:
        with pytest.raises(AssertionError):
            _assert_lm_matches(res["lm_edge_target"], spawned["jax_lm"])
        loss, want = res["lm_edge_target"]["probe_loss"], spawned["jax_lm"]["probe_loss"]
        assert abs(loss - want) > 1e-3, (loss, want)


def test_seq_ranks_hold_the_same_rows():
    """The loader shards by data coordinate only, so every seq rank of a data
    group is handed the same whole rows."""
    from deeplearning_mpi_tpu_torch.data import Loader

    ds = SyntheticTokens(16, S, seed=0)
    rows = {}
    for rank in range(4):  # a dp 2 x sp 2 mesh: data coordinate rank // 2
        loader = Loader(ds, 8, shuffle=True, seed=1, num_replicas=2, rank=rank // 2, device="cpu")
        rows[rank] = [b["tokens"] for b in loader.epoch(0)]
    for a, b in ((0, 1), (2, 3)):
        assert all(torch.equal(x, y) for x, y in zip(rows[a], rows[b]))
    assert not torch.equal(rows[0][0], rows[2][0])

