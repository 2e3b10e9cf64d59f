"""The port's MoE layer (``models/moe.py``) against the flax ``MoEMLP``.

The flax layer's params go across as the port's converter carries them (the
router kernel transposed, the expert stacks ``[E, in, out]`` as they are);
inputs and output cotangents are numpy-seeded. float32 on the CPU: outputs
within atol 1e-5, the load-balance loss and the dropped fraction within
1e-6, gradients within atol 1e-5 (rtol 1e-4).

- Token and expert choice, each with ample capacity (capacity factor E/k:
  no claim can drop, so token choice drops 0.0) and under forced imbalance
  (capacity factor 0.5, ``tests/test_generate.py``'s droppy config: the
  dropped fraction is above 0), with the gradients of ``sum(out * g) +
  aux`` to the input, the router and every expert stack.
- Tied router probabilities (a zero router): the order of claims and of
  the experts' picks follows ``jax.lax.top_k``'s lower-index rule.
- One expert with capacity for every token is a plain SwiGLU.
- The collectors: 0.0 and None for a dense model, the sum of the layers'
  losses and the mean of their fractions for an MoE model, against
  ``collect_aux_loss`` / ``collect_dropped_fraction`` of the reference.
- ``init_weights`` draws an expert stack with flax's ``lecun_normal`` fan
  in, ``E * in``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.moe import MoEMLP as JaxMoE
from deeplearning_mpi_tpu.models.moe import collect_aux_loss as jax_aux
from deeplearning_mpi_tpu.models.moe import collect_dropped_fraction as jax_drop
from deeplearning_mpi_tpu_torch.models import moe
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import (
    SwiGLU,
    TransformerConfig,
    TransformerLM,
)

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

B, S, D, F, E = 2, 12, 16, 24, 4
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
COLLECTIONS = ["moe_losses", "moe_metrics"]


def _pair(routing, cf, *, top_k=2, experts=E, zero_router=False, seed=0):
    jm = JaxMoE(F, dtype=jnp.float32, num_experts=experts, top_k=top_k, capacity_factor=cf,
                routing=routing)
    x = np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x))["params"])
    if zero_router:
        params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    tm = moe.MoEMLP(D, F, torch.float32, num_experts=experts, top_k=top_k, capacity_factor=cf,
                    routing=routing)
    tm.load_state_dict({"router.weight": torch.from_numpy(np.array(params["router"]["kernel"]).T),
                        **{n: torch.from_numpy(np.array(params[n]))
                           for n in ("experts_gate", "experts_up", "experts_down")}})
    return jm, params, tm, x


def _jax_run(jm, params, x, cot):
    def f(p, xx):
        out, mut = jm.apply({"params": p}, xx, mutable=COLLECTIONS)
        return jnp.sum(out * cot) + jax_aux(mut), (out, mut)

    (_, (out, mut)), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    return out, float(jax_aux(mut)), float(jax_drop(mut)), grads


def _port_run(tm, x, cot):
    xt = torch.from_numpy(x).requires_grad_()
    with moe.collecting(tm) as sown:
        out = tm(xt)
    aux = moe.collect_aux_loss(sown)
    total = (out * torch.from_numpy(np.asarray(cot))).sum() + aux
    names = ["router.weight", "experts_gate", "experts_up", "experts_down"]
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(total, [xt] + [params[n] for n in names])
    drop = float(moe.collect_dropped_fraction(sown))
    return out, float(aux.detach()), drop, dict(zip(["x"] + names, grads))


def _check(jm, params, tm, x):
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    jout, jaux, jdrop, (jg, jgx) = _jax_run(jm, params, x, cot)
    out, aux, drop, g = _port_run(tm, x, cot)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **OUT_TOL)
    np.testing.assert_allclose(aux, jaux, atol=1e-6)
    np.testing.assert_allclose(drop, jdrop, atol=1e-6)
    np.testing.assert_allclose(g["x"].numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(g["router.weight"].numpy(), np.asarray(jg["router"]["kernel"]).T,
                               **GRAD_TOL)
    for n in ("experts_gate", "experts_up", "experts_down"):
        np.testing.assert_allclose(g[n].numpy(), np.asarray(jg[n]), err_msg=n, **GRAD_TOL)
    return aux, drop


@pytest.mark.parametrize("routing", moe.ROUTINGS)
@pytest.mark.parametrize("capacity", ["ample", "tight"])
def test_moe_layer_matches_flax(routing, capacity):
    cf = E / 2 if capacity == "ample" else 0.5
    aux, drop = _check(*_pair(routing, cf))
    if routing == "token_choice":
        assert aux > 0.0
        assert drop == 0.0 if capacity == "ample" else drop > 0.0
    else:
        assert aux == 0.0  # expert choice sows no balance loss
        assert drop > 0.0 if capacity == "tight" else drop >= 0.0


@pytest.mark.parametrize("routing", moe.ROUTINGS)
def test_tied_router_probabilities_break_ties_like_lax_top_k(routing):
    jm, params, tm, x = _pair(routing, 1.0, zero_router=True)
    aux, drop = _check(jm, params, tm, x)
    with torch.no_grad():
        probs = torch.softmax(tm.router(torch.from_numpy(x).float()), dim=-1)
        cap = tm.capacity(S)
        combine = (tm._token_choice([probs], cap)[0][0] if routing == "token_choice"
                   else tm._expert_choice([probs], cap)[0][0])
    used = (combine > 0).any(dim=3)  # [B, S, E]
    if routing == "token_choice":
        # Every token's top 2 are experts 0 and 1, the first tokens claim them.
        assert not used[:, :, 2:].any() and used[:, :cap, :2].all() and not used[:, cap:].any()
    else:
        # Every expert picks the first C positions.
        assert used[:, :cap].all() and not used[:, cap:].any()


def test_single_expert_is_a_swiglu():
    jm, params, tm, x = _pair("token_choice", 1.0, top_k=1, experts=1)
    mlp = SwiGLU(D, F, torch.float32)
    mlp.load_state_dict({"gate_proj.weight": tm.experts_gate[0].T,
                         "up_proj.weight": tm.experts_up[0].T,
                         "down_proj.weight": tm.experts_down[0].T})
    with torch.no_grad():
        xt = torch.from_numpy(x)
        torch.testing.assert_close(tm(xt), mlp(xt), **OUT_TOL)
    _check(jm, params, tm, x)


def test_collectors_match_the_reference():
    dense = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    dense.init_weights(0)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 10)).astype(np.int32)
    with moe.collecting(dense) as sown:
        dense(torch.from_numpy(tokens).long())
    assert float(moe.collect_aux_loss(sown)) == 0.0
    assert moe.collect_dropped_fraction(sown) is None

    jc = dataclasses.replace(JaxConfig.tiny_moe(), moe_capacity_factor=0.5)
    jm = JaxLM(config=jc, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    _, mut = jax.jit(lambda p, t: jm.apply({"params": p}, t, mutable=COLLECTIONS))(
        params, jnp.asarray(tokens))
    tc = TransformerConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(TransformerConfig)})
    tm = TransformerLM(tc, dtype=torch.float32, device="cpu")
    tm.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    with torch.no_grad(), moe.collecting(tm) as sown:
        tm(torch.from_numpy(tokens).long())
    assert len(sown.aux) == len(sown.dropped) == tc.num_layers
    np.testing.assert_allclose(float(moe.collect_aux_loss(sown)), float(jax_aux(mut)), atol=1e-6)
    np.testing.assert_allclose(float(moe.collect_dropped_fraction(sown)), float(jax_drop(mut)),
                               atol=1e-6)


def test_init_draws_expert_stacks_with_flax_fan_in():
    cfg = dataclasses.replace(TransformerConfig.tiny_moe(8), num_layers=1, d_model=64, d_ff=128)
    model = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(3)
    mlp = model.layers[0].mlp
    # Truncated at 2 std and rescaled by 1/0.8796, the draw's std is 1/sqrt(fan_in).
    for name, fan_in in (("experts_gate", 8 * 64), ("experts_up", 8 * 64),
                         ("experts_down", 8 * 128)):
        std = float(getattr(mlp, name).detach().std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (name, std)
    std = float(mlp.router.weight.detach().std())
    assert abs(std * np.sqrt(64) - 1.0) < 0.15, std
