"""Pipeline parallelism in the port against ``deeplearning_mpi_tpu``.

Every JAX reference runs inside ``jax.jit`` on the virtual CPU mesh, once a
module (module-scoped fixtures). Float32 throughout but for the float64
twin.

- ``split_microbatches`` / ``merge_microbatches`` round trip; an
  indivisible batch raises.
- ``pipeline_apply`` on a linear-tanh stage function against JAX's, the
  cases of ``tests/test_pipeline.py``: 4 stages over 8 microbatches
  (``LockstepPipe(4)`` against the pipe-4 mesh) and their sequential
  composition, the gradient of a sum of squares, the pipe-1 paths (one
  stage, a 3-stack run in order), each within 1e-6; a stack that does not
  match the pipe size raises.
- ``PipelinedLM`` against JAX's ``PipelinedLM`` on the same weights
  (``models.convert.pipelined_params_from_jax``): ``TransformerConfig.tiny()``
  at pipe 2 / M 2 and at 4 layers, pipe 4 / M 4: logits within 1e-5 and
  every gradient of the mean LM loss within 1e-5 relative L2; with
  ``return_prehead`` the chunked loss within 1e-5; the flat remap
  (``flat_params_from_pipelined``) gives the flat model's logits.
- MoE through the stages (``tiny_moe``, pipe 2, M 2): the logits, the
  load-balance loss within 1e-6 of JAX's mutated aux, the dropped
  fraction equal to JAX's; a dense pipeline emits no dropped fraction; the
  router takes a non-zero gradient from the aux alone.
- The train step: 3 Adam steps (1e-2, clip 1.0) of the port's
  ``make_train_step("lm")`` on ``PipelinedLM`` over ``LockstepPipe(2)``,
  against the reference's jitted step on its pipe-2 mesh: the losses within
  1e-5 and every parameter within 1e-4 relative L2; and every parameter
  within 1e-5 relative L2 of the port's flat ``TransformerLM`` after the
  same 3 steps. (Adam at 1e-2 turns the two frameworks' float32 rounding of
  near-zero gradients into LR-sized steps: the flat port itself ends 4e-5
  relative L2 from JAX's embedding, 5e-5 at its worst element, while the
  pipelined port sits 6e-7 from the flat port.)
- ONE spawn of 4 gloo ranks (``tests/torch_pipe_ranks.py``): ``pp 4`` (M 4)
  and ``dp 2 x pp 2`` (M 2) on 4 layers against the reference's
  single-device step on the whole batch (the loss within 1e-5, every
  gradient and its clip within 1e-5 relative L2, the parameters after one
  Adam step within 1e-4 of JAX's and 1e-5 of the port's flat step, and
  every rank's whole parameters bitwise equal); the float64 twin of ``pp 4`` within 1e-12 of one
  process; each of the seven wrong copies (the tied embedding's gradient
  without its encode part, summed on every pipe rank, the outputs at
  microbatch ``t - S``, the last microbatch dropped, the clip on the local
  stage's norm, the MoE aux averaged over stages, the drop fraction not
  divided by the stage count) rejected by its bar; the MoE step under
  ``dp 2 x pp 2`` equal to the reference (aux within 1e-6); a ``dp 2 x pp
  2`` checkpoint that resumes bit for bit and restores in one process.
- ``cli.train_lm --device cpu --nproc 2 --pp 2 --microbatches 2`` logs the
  one-process run's epoch losses; ``--pp`` beside ``--tp``, ``--ep``,
  ``--zero`` / ``--zero_overlap`` and adafactor runs on gloo ranks, and
  beside a sequence-parallel attention (on which the reference raises) and
  in the CNN CLIs exits 1 with its ROADMAP item.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.moe import AUX_COLLECTION, METRIC_COLLECTION
from deeplearning_mpi_tpu.models.moe import collect_aux_loss as jax_aux
from deeplearning_mpi_tpu.models.moe import collect_dropped_fraction as jax_drop
from deeplearning_mpi_tpu.models.pipeline_lm import PipelinedLM as JaxPipelinedLM
from deeplearning_mpi_tpu.ops.loss import chunked_lm_loss as jax_chunked_loss
from deeplearning_mpi_tpu.ops.loss import lm_cross_entropy as jax_lm_loss
from deeplearning_mpi_tpu.parallel import merge_microbatches as jax_merge
from deeplearning_mpi_tpu.parallel import pipeline_apply as jax_pipeline_apply
from deeplearning_mpi_tpu.parallel import split_microbatches as jax_split
from deeplearning_mpi_tpu.runtime.mesh import MeshSpec, create_mesh
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.models import moe
from deeplearning_mpi_tpu_torch.models.convert import (
    flat_params_from_pipelined,
    lm_params_from_jax,
    pipelined_from_flat,
    pipelined_params_from_jax,
)
from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.ops.loss import chunked_lm_loss, lm_cross_entropy
from deeplearning_mpi_tpu_torch.parallel.pipeline import (
    LockstepPipe,
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
)
from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_pipe_ranks as ranks  # noqa: E402
import torch_tp_ranks  # noqa: E402

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: ``pipeline_apply`` against JAX's (outputs and gradients).
APPLY_TOL = 1e-6
#: logits (elementwise), gradients (relative L2 per tensor), the chunked
#: loss and the trained parameters against JAX's.
LM_TOL = 1e-5
#: the MoE load-balance loss against JAX's.
AUX_TOL = 1e-6
#: 3 Adam steps at 1e-2 against JAX's, relative L2 per parameter (the flat
#: port's own distance is 4e-5: module docstring).
TRAJECTORY_L2 = 1e-4
#: the float64 twin against one process.
F64_TOL = 1e-12
B, S = 8, 32


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def port_config(jc: JaxConfig) -> TransformerConfig:
    return TransformerConfig(**{f.name: getattr(jc, f.name)
                                for f in dataclasses.fields(TransformerConfig)})


def jax_mesh(pipe: int):
    return create_mesh(MeshSpec(data=8 // pipe, pipe=pipe))


# -- microbatches -----------------------------------------------------------------
def test_microbatch_roundtrip_and_indivisible():
    x = {"a": torch.arange(24.0).reshape(8, 3)}
    split = split_microbatches(x, 4)
    assert split["a"].shape == (4, 2, 3)
    assert torch.equal(merge_microbatches(split)["a"], x["a"])
    with pytest.raises(ValueError, match="divisible"):
        split_microbatches({"a": torch.zeros(6, 2)}, 4)


# -- pipeline_apply ------------------------------------------------------------------
def _tanh_stage(p, acts):
    return {"x": torch.tanh(acts["x"] @ p["w"] + p["b"])}


def _jax_tanh_stage(p, acts):
    return {"x": jnp.tanh(acts["x"] @ p["w"] + p["b"])}


@pytest.fixture(scope="module")
def apply_reference():
    """JAX's ``pipeline_apply`` on the cases of ``tests/test_pipeline.py``,
    each in one ``jax.jit``."""
    rng = np.random.default_rng(0)
    out = {}
    w, b = rng.normal(size=(4, 8, 8)) * 0.3, rng.normal(size=(4, 8))
    x = rng.normal(size=(16, 8))
    mesh = jax_mesh(4)
    run = jax.jit(lambda w, b, x: jax_merge(jax_pipeline_apply(
        _jax_tanh_stage, {"w": w, "b": b}, jax_split({"x": x}, 8), mesh=mesh))["x"])
    out["seq"] = (w, b, x, np.asarray(run(*(jnp.asarray(a, jnp.float32) for a in (w, b, x)))))
    w, b = rng.normal(size=(4, 4, 4)) * 0.3, rng.normal(size=(4, 4))
    x = rng.normal(size=(8, 4))

    def loss(w, b, x):
        out = jax_pipeline_apply(_jax_tanh_stage, {"w": w, "b": b}, jax_split({"x": x}, 4),
                                 mesh=mesh)
        return jnp.sum(jax_merge(out)["x"] ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jnp.float32) for a in (w, b, x)))
    out["grads"] = (w, b, x, [np.asarray(g) for g in grads])
    flat = create_mesh(MeshSpec(data=8))
    for name, n in (("one", 1), ("stack3", 3)):
        w, b = rng.normal(size=(n, 4, 4)) * 0.3, rng.normal(size=(n, 4))
        x = rng.normal(size=(8, 4))
        run = jax.jit(lambda w, b, x: jax_merge(jax_pipeline_apply(
            _jax_tanh_stage, {"w": w, "b": b}, jax_split({"x": x}, 4), mesh=flat))["x"])
        out[name] = (w, b, x, np.asarray(run(*(jnp.asarray(a, jnp.float32) for a in (w, b, x)))))
    return out


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


@pytest.mark.parametrize("case", ["seq", "one", "stack3"])
def test_pipeline_apply_matches_jax(apply_reference, case):
    """4 stages over 8 microbatches in lockstep (the sequential composition
    too), and the pipe-1 paths: one stage, a 3-stack run in order."""
    w, b, x, want = apply_reference[case]
    pipe = LockstepPipe(4) if case == "seq" else None
    got = merge_microbatches(pipeline_apply(
        _tanh_stage, {"w": _t(w), "b": _t(b)}, split_microbatches({"x": _t(x)}, 8 if case == "seq"
                                                                 else 4), pipe=pipe))["x"]
    np.testing.assert_allclose(got.numpy(), want, atol=APPLY_TOL, rtol=0)
    expected = _t(x)
    for s in range(len(w)):
        expected = torch.tanh(expected @ _t(w)[s] + _t(b)[s])
    np.testing.assert_allclose(got.numpy(), expected.numpy(), atol=APPLY_TOL, rtol=0)


def test_pipeline_apply_grads_match_jax(apply_reference):
    """The gradient of a sum of squares of the outputs, with respect to the
    stacked weights, biases and the input, within 1e-6 of JAX's."""
    w, b, x, want = apply_reference["grads"]
    w, b, x = _t(w, True), _t(b, True), _t(x, True)
    out = pipeline_apply(_tanh_stage, {"w": w, "b": b}, split_microbatches({"x": x}, 4),
                         pipe=LockstepPipe(4))
    got = torch.autograd.grad((merge_microbatches(out)["x"] ** 2).sum(), (w, b, x))
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref, atol=APPLY_TOL, rtol=0)


def test_pipeline_apply_refuses_a_wrong_stack():
    mb = split_microbatches({"x": torch.zeros(4, 2)}, 2)
    with pytest.raises(ValueError, match="stacked"):
        pipeline_apply(lambda p, a: a, {"w": torch.zeros(3, 2)}, mb, pipe=LockstepPipe(4))
    with pytest.raises(ValueError, match="inconsistent stage-stack"):
        pipeline_apply(lambda p, a: a, {"w": torch.zeros(3, 2), "b": torch.zeros(4)}, mb)
    with pytest.raises(ValueError, match="inconsistent microbatch"):
        pipeline_apply(lambda p, a: a, {"w": torch.zeros(4, 2)},
                       {"x": torch.zeros(2, 2), "y": torch.zeros(3, 2)}, pipe=LockstepPipe(4))


# -- PipelinedLM ------------------------------------------------------------------------
LM_CASES = {"tiny_pp2": (JaxConfig.tiny(), 2, 2),
            "l4_pp4": (dataclasses.replace(JaxConfig.tiny(), num_layers=4), 4, 4)}


def _tokens(seed: int, batch: int = 4, seq: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (batch, seq)).astype(np.int32)


def _long(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).long()


@pytest.fixture(scope="module")
def lm_reference():
    """JAX's ``PipelinedLM`` per case: its params, the logits and the
    gradients of the mean LM loss (one jitted ``value_and_grad``); for
    ``tiny_pp2`` also the chunked loss of ``return_prehead`` and the flat
    model's logits on the remapped weights."""
    out = {}
    for name, (cfg, pipe, m) in LM_CASES.items():
        model = JaxPipelinedLM(cfg, jax_mesh(pipe), num_microbatches=m, dtype=jnp.float32)
        tokens = jnp.asarray(_tokens(1))
        params = model.init(jax.random.key(0), tokens)["params"]

        def loss(p, model=model, tokens=tokens):
            logits = model.apply({"params": p}, tokens)
            return jax_lm_loss(logits, tokens), logits

        (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[name] = {"params": jax.device_get(params), "tokens": np.asarray(tokens),
                     "logits": np.asarray(logits), "grads": jax.device_get(grads)}
    cfg, pipe, m = LM_CASES["tiny_pp2"]
    ref = out["tiny_pp2"]
    pre = JaxPipelinedLM(cfg, jax_mesh(pipe), num_microbatches=m, dtype=jnp.float32,
                         return_prehead=True)
    tokens = jnp.asarray(ref["tokens"])
    ref["chunked"] = float(jax.jit(lambda p: jax_chunked_loss(
        *pre.apply({"params": p}, tokens), tokens, chunk_size=8))(ref["params"]))
    flat = JaxLM(config=cfg, dtype=jnp.float32)
    ref["flat_logits"] = np.asarray(jax.jit(flat.apply)(
        {"params": flat_params_from_pipelined(ref["params"])}, tokens))
    return out


def _port_lm(ref: dict, name: str, **kw) -> PipelinedLM:
    cfg, pipe, m = LM_CASES[name]
    model = PipelinedLM(port_config(cfg), num_stages=pipe, num_microbatches=m,
                        dtype=torch.float32, device="cpu", pipe=LockstepPipe(pipe), **kw)
    model.load_full_state_dict(pipelined_params_from_jax(ref["params"]))
    return model


@pytest.mark.parametrize("name", list(LM_CASES))
def test_pipelined_lm_matches_jax(lm_reference, name):
    ref = lm_reference[name]
    model = _port_lm(ref, name)
    tokens = _long(ref["tokens"])
    logits = model(tokens)
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], atol=LM_TOL, rtol=0)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(lm_cross_entropy(logits, tokens), params)
    want = pipelined_params_from_jax(ref["grads"])
    assert set(names) == set(want)
    worst = max((rel(g, want[n]), n) for n, g in zip(names, grads))
    assert worst[0] <= LM_TOL, worst


def test_pipelined_prehead_and_flat_remap(lm_reference):
    """``return_prehead``: the chunked loss within 1e-5 of JAX's; the flat
    remap of the reference's tree gives JAX's flat model the same logits,
    and the port's flat model on the converted tree the port's."""
    ref = lm_reference["tiny_pp2"]
    tokens = _long(ref["tokens"])
    model = _port_lm(ref, "tiny_pp2", return_prehead=True)
    x, kernel = model(tokens)
    np.testing.assert_allclose(float(chunked_lm_loss(x, kernel, tokens, chunk_size=8).detach()),
                               ref["chunked"], atol=LM_TOL, rtol=LM_TOL)
    np.testing.assert_allclose(ref["flat_logits"], ref["logits"], atol=LM_TOL, rtol=0)
    flat = TransformerLM(port_config(LM_CASES["tiny_pp2"][0]), dtype=torch.float32, device="cpu")
    flat.load_state_dict(lm_params_from_jax(flat_params_from_pipelined(ref["params"])))
    np.testing.assert_allclose(flat(tokens).detach().numpy(), ref["logits"], atol=LM_TOL, rtol=0)
    assert set(pipelined_from_flat(flat.state_dict(), 2)) == set(model.state_dict())


# -- MoE through the stages --------------------------------------------------------
@pytest.fixture(scope="module")
def moe_reference():
    """JAX's ``PipelinedLM`` on ``tiny_moe`` (pipe 2, M 2): logits, the
    mutated aux and the dropped fraction."""
    cfg = JaxConfig.tiny_moe()
    model = JaxPipelinedLM(cfg, jax_mesh(2), num_microbatches=2, dtype=jnp.float32)
    tokens = jnp.asarray(_tokens(2))
    params = model.init(jax.random.key(0), tokens)["params"]
    logits, mutated = jax.jit(lambda p: model.apply(
        {"params": p}, tokens, mutable=[AUX_COLLECTION, METRIC_COLLECTION]))(params)
    return {"params": jax.device_get(params), "tokens": np.asarray(tokens),
            "logits": np.asarray(logits), "aux": float(jax_aux(mutated)),
            "drop": float(jax_drop(mutated))}


def test_moe_through_the_stages_matches_jax(moe_reference):
    ref = moe_reference
    model = PipelinedLM(port_config(JaxConfig.tiny_moe()), num_stages=2, num_microbatches=2,
                        dtype=torch.float32, device="cpu", pipe=LockstepPipe(2))
    model.load_full_state_dict(pipelined_params_from_jax(ref["params"]))
    tokens = _long(ref["tokens"])
    with moe.collecting(model) as sown:
        logits = model(tokens)
        aux, drop = moe.collect_aux_loss(sown), moe.collect_dropped_fraction(sown)
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], atol=LM_TOL, rtol=0)
    assert ref["aux"] > 0 and abs(float(aux.detach()) - ref["aux"]) <= AUX_TOL
    assert abs(float(drop) - ref["drop"]) <= AUX_TOL
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(aux, params, allow_unused=True)))
    router = grads["stages.0.block_0.mlp.router.weight"]
    assert router is not None and float(router.abs().max()) > 0.0


def test_dense_pipeline_emits_no_drop_fraction():
    model = PipelinedLM(TransformerConfig.tiny(), num_stages=2, num_microbatches=2,
                        dtype=torch.float32, device="cpu").init_weights(0)
    with torch.no_grad(), moe.collecting(model) as sown:
        model(torch.zeros(4, 8, dtype=torch.long))
    assert moe.collect_dropped_fraction(sown) is None and not sown.aux


# -- the train step ------------------------------------------------------------------
@pytest.fixture(scope="module")
def train_reference():
    """3 steps of the reference's jitted step (Adam 1e-2, clip 1.0) on its
    ``PipelinedLM`` over the pipe-2 mesh (tiny, M 2)."""
    cfg = JaxConfig.tiny()
    model = JaxPipelinedLM(cfg, jax_mesh(2), num_microbatches=2, dtype=jnp.float32)
    state = jax_create_state(model, jax.random.key(3), jnp.zeros((1, 16), jnp.int32),
                             jax_optimizer("adam", 1e-2, clip_norm=1.0))
    params0 = jax.device_get(state.params)
    batches = [_tokens(10 + i, batch=8) for i in range(3)]
    step = jax_make_step("lm", donate=False)
    losses = []
    for tokens in batches:
        state, metrics = step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(metrics["loss"]))
    return {"params0": params0, "batches": batches, "losses": losses,
            "params": pipelined_params_from_jax(jax.device_get(state.params))}


def test_pipelined_train_step_matches_jax(train_reference):
    ref = train_reference
    model = PipelinedLM(TransformerConfig.tiny(), num_stages=2, num_microbatches=2,
                        dtype=torch.float32, device="cpu", pipe=LockstepPipe(2))
    model.load_full_state_dict(pipelined_params_from_jax(ref["params0"]))
    state = create_train_state(model, build_optimizer("adam", 1e-2, clip_norm=1.0))
    step = make_train_step("lm")
    losses = []
    for tokens in ref["batches"]:
        state, metrics = step(state, {"tokens": _long(tokens)})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], atol=LM_TOL, rtol=LM_TOL)
    flat = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    flat.load_state_dict(lm_params_from_jax(flat_params_from_pipelined(ref["params0"])))
    state = create_train_state(flat, build_optimizer("adam", 1e-2, clip_norm=1.0))
    for tokens in ref["batches"]:
        state, _ = step(state, {"tokens": _long(tokens)})
    flat_now = pipelined_from_flat(flat.state_dict(), 2)
    for n, p in model.named_parameters():
        assert rel(p.detach(), ref["params"][n]) <= TRAJECTORY_L2, n
        assert rel(p.detach(), flat_now[n]) <= LM_TOL, n


# -- four gloo ranks ------------------------------------------------------------------
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's single-device step on :data:`ranks.CFG` (loss,
    gradients, their clip at half their norm, one Adam step), the flat MoE
    model's per-microbatch aux and drop, one process's float64 step; then
    ONE spawn of 4 gloo ranks of ``torch_pipe_ranks.worker_pipe``."""
    cfg = JaxConfig(**ranks.CFG)
    jm = JaxLM(config=cfg, dtype=jnp.float32)
    state = jax_create_state(jm, jax.random.key(0), jnp.zeros((1, S), jnp.int32),
                             jax_optimizer("adam", 1e-3, clip_norm=1.0))
    tokens = _tokens(4, batch=B, seq=S)

    def loss(p):
        return jax_lm_loss(jm.apply({"params": p}, jnp.asarray(tokens)), jnp.asarray(tokens))

    value, grads = jax.jit(jax.value_and_grad(loss))(state.params)
    grads = lm_params_from_jax(jax.device_get(grads))
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    clip = 0.5 * norm
    new, _ = jax_make_step("lm", donate=False)(state, {"tokens": jnp.asarray(tokens)})
    ref = {"loss": float(value), "grads": grads,
           "clipped": {n: g * min(1.0, clip / norm) for n, g in grads.items()},
           "stepped": lm_params_from_jax(jax.device_get(new.params))}
    # MoE: the flat model on each of the 2 microbatches, averaged.
    mcfg = JaxConfig(**ranks.MOE_CFG)
    flat = JaxLM(config=mcfg, dtype=jnp.float32)
    moe_tokens = _tokens(5, batch=B, seq=S)
    mparams = flat.init(jax.random.key(1), jnp.zeros((1, S), jnp.int32))["params"]
    apply = jax.jit(lambda p, t: flat.apply({"params": p}, t,
                                            mutable=[AUX_COLLECTION, METRIC_COLLECTION]))
    auxes, drops = [], []
    for mb in np.split(moe_tokens, 2):
        _, mutated = apply(mparams, jnp.asarray(mb))
        auxes.append(float(jax_aux(mutated)))
        drops.append(float(jax_drop(mutated)))
    logits, _ = apply(mparams, jnp.asarray(moe_tokens))
    ref["moe"] = {"moe_aux_loss": float(np.mean(auxes)), "moe_dropped_frac": float(np.mean(drops)),
                  "loss": float(jax_lm_loss(logits, jnp.asarray(moe_tokens)))}
    out = tmp_path_factory.mktemp("pipe_ranks")
    gen = np.random.default_rng(6)
    inputs = {"cfg": ranks.CFG, "params": lm_params_from_jax(jax.device_get(state.params)),
              "tokens": _long(tokens), "clip": clip,
              "moe_params": lm_params_from_jax(jax.device_get(mparams)),
              "moe_tokens": _long(moe_tokens),
              "batches": [torch.from_numpy(gen.integers(0, 256, (B, S))) for _ in range(3)]}
    torch.save(inputs, out / "inputs.pt")
    ref["f64"] = torch_tp_ranks.tp_step_case(inputs, dtype=torch.float64, cfg=ranks.CFG)
    ref["f32"] = torch_tp_ranks.tp_step_case(inputs, cfg=ranks.CFG)
    return {"ranks": torch_tp_ranks.spawn(out, ranks.worker_pipe), "ref": ref, "out": out,
            "inputs": inputs}


def bar_failures(results: list[dict], ref: dict) -> list:
    """What fails the float32 bar against the reference's step: the loss
    within 1e-5, each gradient and each clipped gradient within 1e-5
    relative L2; each parameter after the Adam step within 1e-4 relative L2
    of JAX's and 1e-5 of the port's one-process flat step (as in the train
    step's test, Adam's first step is near the sign of each gradient, and
    the flat port itself ends 7e-6 relative L2 from JAX's ``gate_proj``,
    5.8e-5 at its worst element)."""
    bad = []
    for r, got in enumerate(results):
        for key in ("probe_loss", "clip_loss", "adam_loss"):
            if not np.isclose(got[key], ref["loss"], atol=LM_TOL, rtol=LM_TOL):
                bad.append((r, key, got[key]))
        for key in ("grads", "clipped"):
            bad += [(r, key, n, e) for n, g in ref[key].items()
                    if (e := rel(got[key][n], g)) > LM_TOL]
        bad += [(r, "params", n, e) for n, p in ref["stepped"].items()
                if (e := rel(got["params"][n], p)) > TRAJECTORY_L2]
        bad += [(r, "params vs one process", n, e) for n, p in ref["f32"]["params"].items()
                if (e := rel(got["params"][n], p)) > LM_TOL]
    return bad


@pytest.mark.parametrize("layout", list(ranks.PIPE_LAYOUTS))
def test_pipe_ranks_match_jax(spawned, layout):
    """``pp 4`` and ``dp 2 x pp 2`` over 4 gloo ranks against the
    reference's single-device step; every rank's whole parameters bitwise
    equal."""
    results = [res[layout] for res in spawned["ranks"]]
    assert not bar_failures(results, spawned["ref"])
    for got in results[1:]:
        assert all(torch.equal(got["params"][n], t) for n, t in results[0]["params"].items())


def test_pipe_ranks_f64_match_one_process(spawned):
    one = spawned["ref"]["f64"]
    for got in (res["pp4_f64"] for res in spawned["ranks"]):
        assert abs(got["adam_loss"] - one["adam_loss"]) <= F64_TOL * abs(one["adam_loss"])
        for key in ("grads", "params"):
            worst = max((rel(got[key][n], t), n) for n, t in one[key].items())
            assert worst[0] <= F64_TOL, (key, worst)


@pytest.mark.parametrize("kind", ranks.WRONG_PIPE)
def test_pipe_bar_rejects_wrong_copy(spawned, kind):
    assert bar_failures([res[kind] for res in spawned["ranks"]], spawned["ref"])


def moe_failures(got: dict, ref: dict) -> list:
    """The MoE bar: the loss within 1e-5, the aux and the drop fraction
    within 1e-6 of the reference's."""
    tols = {"loss": LM_TOL, "moe_aux_loss": AUX_TOL, "moe_dropped_frac": AUX_TOL}
    return [(k, got[k], ref[k]) for k, tol in tols.items() if abs(got[k] - ref[k]) > tol]


def test_moe_pipe_ranks_match_jax(spawned):
    """The MoE LM under ``dp 2 x pp 2`` (each data rank its share of each
    reference microbatch): the loss, the load-balance loss and the dropped
    fraction the step reports equal the reference's per-microbatch means."""
    for res in spawned["ranks"]:
        assert not moe_failures(res["moe"], spawned["ref"]["moe"])


@pytest.mark.parametrize("kind", ranks.WRONG_MOE)
def test_moe_bar_rejects_wrong_copy(spawned, kind):
    assert all(moe_failures(res[kind], spawned["ref"]["moe"]) for res in spawned["ranks"])


def test_pp2_checkpoint_resumes_bitwise_and_restores_in_one_process(spawned):
    """A ``dp 2 x pp 2`` save: the same digests on every rank and after its
    restore, the resumed step bitwise the uninterrupted one; restored in
    one process over ``LockstepPipe(2)``, the same digests."""
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    ckpts = [res["checkpoint"] for res in spawned["ranks"]]
    saved = ckpts[0]["saved"]
    assert any("stages.block_0" in k for k in saved)
    for c in ckpts:
        assert c["saved"] == saved and c["restored"] == saved
        assert c["resumed"] == c["uninterrupted"]
    model = PipelinedLM(port_config(JaxConfig(**ranks.CFG)), num_stages=2, num_microbatches=2,
                        dtype=torch.float32, device="cpu", pipe=LockstepPipe(2))
    template = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0), ema=True)
    state, epoch = Checkpointer(spawned["out"] / "pp2").restore_verified(template)
    assert epoch == 0 and tree_digests(state.arrays()) == saved


# -- the CLI -----------------------------------------------------------------------
LM_FLAGS = ["--device", "cpu", "--num_layers", "2", "--num_heads", "2", "--head_dim", "8",
            "--d_model", "16", "--d_ff", "32", "--seq_len", "32", "--batch_size", "4",
            "--train_sequences", "40", "--num_epochs", "2", "--learning_rate", "1e-2"]


def test_train_lm_cli_pp2_logs_the_one_process_losses(capsys):
    from deeplearning_mpi_tpu_torch.cli import train_lm

    assert train_lm.main(LM_FLAGS) == 0
    want = re.findall(r"^Epoch \d+: loss ([0-9.]+)", capsys.readouterr().out, re.M)
    out = subprocess.run([sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.train_lm",
                          *LM_FLAGS, "--nproc", "2", "--pp", "2", "--microbatches", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--pp 2 x 2 microbatches" in out.stdout
    got = re.findall(r"^Epoch \d+: loss ([0-9.]+)", out.stdout, re.M)
    assert len(want) == 2 and got == want, (got, want)


@pytest.mark.parametrize("cli,extra", [
    ("train_lm", ["--tp", "2"]),
    ("train_lm", ["--sp", "2", "--attention", "ring"]),
    ("train_lm", ["--attention", "ulysses"]),
    ("train_lm", ["--ep", "2", "--moe_experts", "4"]),
    ("train_lm", ["--zero"]),
    ("train_lm", ["--zero_overlap"]),
    ("train_lm", ["--optimizer", "adafactor"]),
    ("train_resnet", ["--synthetic"]),
], ids=["tp", "sp", "ulysses", "ep", "zero", "zero_overlap", "adafactor", "cnn"])
def test_pp_refusals(cli, extra, capsys):
    """Beside ``--pp``, a sequence-parallel attention is refused with the
    reason the reference raises on it and ROADMAP Queue 1 item 8.6, as are
    the CNNs. ``--pp 2`` with ``--tp 2``, ``--ep 2``, ``--zero`` /
    ``--zero_overlap`` (over ``--dp 2``) and adafactor runs on gloo ranks;
    the dense runs log the one-process run's epoch losses (``--zero_overlap``
    after its logged fallback), the MoE run the losses and dropped
    fractions of ``--pp 2`` with every expert on each stage, and adafactor
    finite losses (its block RMS spans the stacked leaf: a ``--pp 2`` step
    is not a ``--pp 1`` step)."""
    import importlib

    from deeplearning_mpi_tpu_torch.utils.config import PP_SEQ_REASON

    module = importlib.import_module(f"deeplearning_mpi_tpu_torch.cli.{cli}")
    flags = LM_FLAGS if cli == "train_lm" else ["--device", "cpu"]
    if cli == "train_resnet" or "--attention" in extra:
        assert module.main([*flags, "--pp", "2", *extra]) == 1
        err = capsys.readouterr().err
        assert "--pp" in err and "item 8.6" in err
        assert cli == "train_resnet" or PP_SEQ_REASON in err
        return
    # widths whose Megatron pairs clear the rule's min_size
    wide = [*LM_FLAGS, "--num_heads", "4", "--head_dim", "16", "--d_model", "32",
            "--d_ff", "64"]
    pattern = r"^Epoch \d+: (?:loss|moe_dropped_frac) ([0-9.]+)"

    def losses(*more, nproc=None):
        if nproc is None:
            assert module.main([*wide, *more]) == 0
            return re.findall(pattern, capsys.readouterr().out, re.M), ""
        out = subprocess.run([sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.train_lm",
                              *wide, *more, "--nproc", str(nproc), "--microbatches", "2"],
                             cwd=ROOT, capture_output=True, text=True, timeout=300,
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr[-2000:]
        assert "--pp 2 x 2 microbatches" in out.stdout
        return re.findall(pattern, out.stdout, re.M), out.stdout

    if extra == ["--optimizer", "adafactor"]:
        got, _ = losses("--pp", "2", *extra, nproc=2)
        assert len(got) == 2 and all(np.isfinite(float(x)) for x in got), got
        return
    if "--ep" in extra:
        want, _ = losses("--pp", "2", "--moe_experts", "4", nproc=2)
        got, _ = losses("--pp", "2", *extra, nproc=4)
    else:
        want, _ = losses()
        more = ["--tp", "2"] if extra == ["--tp", "2"] else ["--dp", "2", *extra]
        got, stdout = losses("--pp", "2", *more, nproc=4)
        if extra == ["--zero_overlap"]:
            assert "non-data mesh axes in use (['pipe'])" in stdout
    assert len(want) >= 2 and got == want, (got, want)
