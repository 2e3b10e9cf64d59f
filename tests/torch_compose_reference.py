"""The JAX side of ``tests/test_torch_compose_dense.py`` and
``tests/test_torch_compose_moe.py``: the reference's single-device train
step on the whole batch, which is what its GSPMD step over any mesh
computes (its arrays are global), and the inputs the gloo ranks read.

One call a configuration, once a test module (module-scoped fixtures), so
its compiles stay few.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.moe import AUX_COLLECTION, METRIC_COLLECTION
from deeplearning_mpi_tpu.models.moe import collect_aux_loss as jax_aux
from deeplearning_mpi_tpu.models.moe import collect_dropped_fraction as jax_drop
from deeplearning_mpi_tpu.ops.loss import lm_cross_entropy as jax_lm_loss
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax

#: The global batch of every composition: 4 rows of 32 tokens (2
#: microbatches, 2 sequence shards).
B, S = 4, 32


def tokens(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def jax_step(cfg: dict, toks: np.ndarray, *, aux_weight: float = 0.0, seed: int = 0) -> dict:
    """The reference's ``cfg`` LM (init from ``seed``): its loss on
    ``toks``, the gradients of the differentiated total (the load-balance
    loss weighted ``aux_weight``), their clip at half their global norm,
    the parameters after one step of its ``make_train_step("lm")`` (Adam
    1e-3, clip 1.0) and, for an MoE model, the load-balance loss and the
    dropped fraction. Port names, float32 tensors."""
    jm = JaxLM(config=JaxConfig(**cfg), dtype=jnp.float32)
    state = jax_create_state(jm, jax.random.key(seed), jnp.zeros((1, S), jnp.int32),
                             jax_optimizer("adam", 1e-3, clip_norm=1.0))
    t = jnp.asarray(toks)
    moe = bool(cfg.get("moe_experts"))

    def objective(p):
        logits, mutated = jm.apply({"params": p}, t, mutable=[AUX_COLLECTION, METRIC_COLLECTION])
        loss = jax_lm_loss(logits, t)
        aux = jax_aux(mutated) if moe else jnp.zeros(())
        return loss + aux_weight * aux, (loss, aux, jax_drop(mutated) if moe else jnp.zeros(()))

    (_, (loss, aux, drop)), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        state.params)
    grads = lm_params_from_jax(jax.device_get(grads))
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    clip = 0.5 * norm
    new, _ = jax_make_step("lm", donate=False, aux_weight=aux_weight)(state, {"tokens": t})
    out = {"params0": lm_params_from_jax(jax.device_get(state.params)), "loss": float(loss),
           "grads": grads, "clip": clip,
           "clipped": {n: g * min(1.0, clip / norm) for n, g in grads.items()},
           "stepped": lm_params_from_jax(jax.device_get(new.params))}
    if moe:
        out["moe_dropped_frac"] = float(drop)
        if cfg.get("moe_routing", "token_choice") == "token_choice":  # expert choice sows none
            out["moe_aux_loss"] = float(aux)
    return out
