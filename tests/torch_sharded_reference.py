"""The JAX side of ``tests/test_torch_compose_pipe.py`` and
``tests/test_torch_sharded_optim.py``: the reference's single-device train
step on the whole batch (its arrays are global, so this is what its GSPMD
step over any mesh computes), flat or pipelined, and the ZeRO-1 placement
of its optimizer state on a mesh of the layout's degrees.

The pipelined step is the reference's ``PipelinedLM`` on a mesh whose
``pipe`` axis is 1: it runs the ``[S, ...]`` stack in order, on the
microbatches ``split_microbatches`` cuts, and its optimizer sees the
stacked leaves (``tests/test_pipeline.py``'s oracle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.moe import AUX_COLLECTION, METRIC_COLLECTION
from deeplearning_mpi_tpu.models.moe import collect_aux_loss as jax_aux
from deeplearning_mpi_tpu.models.moe import collect_dropped_fraction as jax_drop
from deeplearning_mpi_tpu.models.pipeline_lm import PipelinedLM as JaxPipelinedLM
from deeplearning_mpi_tpu.parallel.tensor_parallel import infer_state_sharding
from deeplearning_mpi_tpu.runtime.mesh import MESH_AXES
from deeplearning_mpi_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from deeplearning_mpi_tpu.runtime.mesh import create_mesh as jax_create_mesh
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.models.convert import (
    flat_params_from_pipelined,
    lm_params_from_jax,
    pipelined_params_from_jax,
)

#: The global batch: 4 rows of 32 tokens.
B, S = 4, 32


def tokens(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _model(cfg: dict, pipelined: bool, loss_chunk: int):
    config = JaxConfig(**cfg)
    if pipelined:
        mesh = jax_create_mesh(JaxMeshSpec(data=8, pipe=1))
        return JaxPipelinedLM(config, mesh, num_stages=2, num_microbatches=2,
                              dtype=jnp.float32, return_prehead=loss_chunk > 0)
    return JaxLM(config=config, dtype=jnp.float32, return_prehead=loss_chunk > 0)


def _flat(tree, pipelined: bool) -> dict:
    tree = jax.device_get(tree)
    return lm_params_from_jax(flat_params_from_pipelined(tree) if pipelined else tree)


def jax_step(cfg: dict, toks: np.ndarray, *, optimizer: str = "adam", pipelined: bool = False,
             aux_weight: float = 0.0, loss_chunk: int = 0, seed: int = 0) -> dict:
    """The reference's ``cfg`` LM (init from ``seed``; pipelined in 2
    stages of 2 microbatches): its loss on ``toks``, the gradients of the
    differentiated total, their clip at half their global norm, the
    parameters after one step of ``make_train_step("lm")`` (``optimizer``
    at 1e-3, clip 1.0; ``loss_chunk``: the chunked head and loss) and, for
    an MoE model, the load-balance loss and the dropped fraction. Flat
    port names, float32 tensors."""
    model = _model(cfg, pipelined, loss_chunk)
    tx = jax_optimizer(optimizer, 1e-3, clip_norm=1.0)
    state = jax_create_state(model, jax.random.key(seed), jnp.zeros((1, S), jnp.int32), tx)
    t = jnp.asarray(toks)
    moe = bool(cfg.get("moe_experts"))
    step = jax_make_step("lm", donate=False, aux_weight=aux_weight, loss_chunk=loss_chunk)
    dense = _model(cfg, pipelined, 0)

    def objective(p):
        from deeplearning_mpi_tpu.ops.loss import lm_cross_entropy

        logits, mutated = dense.apply({"params": p}, t, mutable=[AUX_COLLECTION,
                                                                 METRIC_COLLECTION])
        loss = lm_cross_entropy(logits, t)
        aux = jax_aux(mutated) if moe else jnp.zeros(())
        return loss + aux_weight * aux, (loss, aux, jax_drop(mutated) if moe else jnp.zeros(()))

    (_, (loss, aux, drop)), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        state.params)
    grads = _flat(grads, pipelined)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    clip = 0.5 * norm
    new, metrics = step(state, {"tokens": t})
    out = {"params0": _flat(state.params, pipelined), "loss": float(loss),
           "step_loss": float(metrics["loss"]), "grads": grads, "clip": clip,
           "clipped": {n: g * min(1.0, clip / norm) for n, g in grads.items()},
           "stepped": _flat(new.params, pipelined)}
    if moe:
        out["moe_dropped_frac"] = float(drop)
        out["moe_aux_loss"] = float(aux)
    return out


def _jax_from_port(sd: dict, template, pipelined: bool):
    """The inverse of :func:`_flat`: each JAX leaf numbered element by
    element, converted, tells where each port element goes."""
    leaves, treedef = jax.tree.flatten(template)
    offsets = np.cumsum([0] + [leaf.size for leaf in leaves])
    ids = [np.arange(a, b, dtype=np.float64).reshape(leaf.shape)
           for a, b, leaf in zip(offsets[:-1], offsets[1:], leaves)]
    where = _flat(jax.tree.unflatten(treedef, ids), pipelined)
    flat = np.zeros(offsets[-1], np.float32)
    for name, pos in where.items():
        flat[pos.numpy().astype(np.int64).ravel()] = sd[name].numpy().ravel()
    return jax.tree.unflatten(treedef, [jnp.asarray(flat[a:b].reshape(leaf.shape)) for a, b, leaf
                                        in zip(offsets[:-1], offsets[1:], leaves)])


def optax_deltas(cfg: dict, grads: dict, *, optimizer: str = "adafactor",
                 pipelined: bool = False, seed: int = 0) -> dict:
    """The reference optimizer's first update (``optimizer`` at 1e-3 behind
    clip 1.0, on the reference's whole leaves: a pipelined model's stacked
    ``[S, ...]``) of the whole gradients ``grads`` (flat port names) at
    :func:`jax_step`'s initial parameters: the step delta it takes from
    those gradients. Flat port names."""
    model = _model(cfg, pipelined, 0)
    state = jax_create_state(model, jax.random.key(seed), jnp.zeros((1, S), jnp.int32),
                             jax_optimizer(optimizer, 1e-3, clip_norm=1.0))
    g = _jax_from_port(grads, state.params, pipelined)
    updates, _ = jax.jit(state.tx.update)(g, state.opt_state, state.params)
    return _flat(updates, pipelined)


def zero_moment_shapes(cfg: dict, degrees: dict, *, pipelined: bool = False) -> dict:
    """The local shape of each Adam moment under the reference's ZeRO-1
    placement (``infer_state_sharding(zero=True)``) on a mesh of
    ``degrees`` (a data axis of 2 beside one other axis), by the port's
    parameter name of the member a process holds (a stage leaf's member
    per stage; a Dense weight transposed)."""
    model = _model(cfg, pipelined, 0)
    state = jax_create_state(model, jax.random.key(0), jnp.zeros((1, S), jnp.int32),
                             jax_optimizer("adam", 1e-3, clip_norm=1.0))
    shape = tuple(degrees.get(a, 1) for a in MESH_AXES)
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), MESH_AXES)
    shardings = infer_state_sharding(state, mesh, zero=True)
    mu = state.opt_state[1][0].mu
    local = jax.tree.map(lambda x, s: np.zeros(s.shard_shape(x.shape), np.float32), mu,
                         shardings.opt_state[1][0].mu)
    if pipelined:  # each stage's member: the stacked leaf cut at its stage
        stages = len(np.asarray(jax.tree.leaves(mu["stages"])[0]))
        local["stages"] = jax.tree.map(
            lambda x: np.zeros((stages, *x.shape[1:]), np.float32), local["stages"])
        return {n: tuple(t.shape) for n, t in pipelined_params_from_jax(local).items()}
    return {n: tuple(t.shape) for n, t in lm_params_from_jax(local).items()}
