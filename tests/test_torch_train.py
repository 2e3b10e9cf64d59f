"""The port's train step against ``deeplearning_mpi_tpu``'s, from one init.

Weights go across with ``lm_params_from_jax``; the batches are numpy-seeded
tokens fed to both. float32 on the CPU, ``TransformerConfig.tiny()``,
batch 4, seq 32.

- The trajectory: 5 Adam steps with clip 1.0, dense attention and flash
  (the Pallas kernels in interpret mode with 16 x 16 blocks against the
  port's autograd Function on CPU tensors): the 5 losses within 1e-5 and
  the final parameters within atol 5e-5 (rtol 1e-4) at lr 1e-3. Adam's
  normalised update m / (sqrt(v) + 1e-8) turns the last-bit differences of
  a gradient element that is itself near 1e-8 into a visible part of lr:
  the largest such difference seen here is 4.1e-5 (lr / 24), the rest stay
  under 1.1e-5.
- 5 Adafactor steps (factored and full second moments, with and without
  weight decay) at the same tolerances, and its state through
  ``opt_state_from_jax``.
- One step of each added feature against its JAX counterpart, at the
  same tolerances: grad accumulation with a ragged token mask, the chunked
  loss, the NaN skip, the EMA, sgd / adamw / lion, and the LR schedules
  against optax (rtol 1e-6).
- Port only, within 1e-5: remat ``full`` and ``dots`` give the grads of
  ``none``; ``flash_attention_bhsd`` on BHSD views of the projections gives
  the dense BSHD path's logits and grads.
- A reference config with ``onehot_embed`` converts to the port's gather
  embedding and trains the same trajectory.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.ops.pallas.flash_attention import flash_attention_bhsd as jax_flash_bhsd
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_lr_schedule as jax_lr_schedule
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.data import SyntheticTokens
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax, opt_state_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd
from deeplearning_mpi_tpu_torch.train import (
    build_lr_schedule,
    build_optimizer,
    create_train_state,
    make_train_step,
)

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

B, S = 4, 32
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)


def _jax_flash():
    fn = functools.partial(jax_flash_bhsd, block_q=16, block_k=16)
    fn.layout = "bhsd"
    return fn


def _batches(n, seed=0):
    """``n`` batches of the synthetic motif data both packages train on."""
    ds = SyntheticTokens(n * B, S, seed=seed)
    return [np.stack([ds[i * B + j]["tokens"] for j in range(B)]) for i in range(n)]


def _setup(*, attention="dense", opt=("adam", 1e-3), opt_kw=None, loss_chunk=0, ema=False,
           cfg_kw=None, remat="none"):
    """The JAX state and the port's, from the same init."""
    jc = dataclasses.replace(JaxConfig.tiny(), **(cfg_kw or {}))
    jm = JaxLM(config=jc, dtype=jnp.float32,
               attention_fn=_jax_flash() if attention == "flash" else None,
               return_prehead=loss_chunk > 0)
    opt_kw = dict(clip_norm=1.0, **(opt_kw or {}))
    jstate = jax_create_state(jm, jax.random.key(0), jnp.zeros((1, S), jnp.int32),
                              jax_optimizer(opt[0], opt[1], **opt_kw), ema=ema)
    tc = TransformerConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(TransformerConfig)})
    model = TransformerLM(tc, dtype=torch.float32, device="cpu", remat=remat,
                          return_prehead=loss_chunk > 0)
    model.load_state_dict(lm_params_from_jax(jax.device_get(jstate.params)))
    tstate = create_train_state(
        model, build_optimizer(opt[0], opt[1], **opt_kw),
        attention_fn=flash_attention_bhsd if attention == "flash" else None, ema=ema)
    return jstate, tstate


def _assert_params_match(jparams, model, **tol):
    want = lm_params_from_jax(jax.device_get(jparams))
    got = model.state_dict()
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name,
                                   **(tol or PARAM_TOL))


def _run(jstate, tstate, batches, *, jax_kw=None, port_kw=None, extra=None):
    jstep = jax_make_step("lm", donate=False, **(jax_kw or {}))
    tstep = make_train_step("lm", **(port_kw or {}))
    jl, tl = [], []
    for tokens in batches:
        jb = {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in (extra or {}).items()}}
        tb = {"tokens": torch.from_numpy(tokens),
              **{k: torch.as_tensor(v) for k, v in (extra or {}).items()}}
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jstate, tstate, jl, tl, jm, tm


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_five_step_adam_trajectory_matches_jax(attention):
    jstate, tstate = _setup(attention=attention)
    jstate, tstate, jl, tl, _, _ = _run(jstate, tstate, _batches(5))
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tstate.step == 5 and int(jstate.step) == 5
    _assert_params_match(jstate.params, tstate.model)
    for name in ("mu", "nu"):
        opt = jstate.opt_state[1][0]  # chain(clip, adam): adam's ScaleByAdamState
        want = lm_params_from_jax(jax.device_get(getattr(opt, name)))
        for n, t in tstate.opt_state[name].items():
            np.testing.assert_allclose(t.numpy(), want[n].numpy(), atol=1e-7, rtol=1e-4, err_msg=n)


def test_grad_accum_with_ragged_mask_matches_full_batch_and_jax():
    rng = np.random.default_rng(1)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32)
    mask[0] = 0.0  # one chunk row holds no valid token at all
    batches = _batches(2, seed=2)
    jstate, tstate = _setup()
    _, full, _, full_l, _, _ = _run(*_setup(), batches, extra={"mask": mask})
    jstate, tstate, jl, tl, _, _ = _run(jstate, tstate, batches, jax_kw={"grad_accum": 2},
                                        port_kw={"grad_accum": 2}, extra={"mask": mask})
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    np.testing.assert_allclose(tl, full_l, **LOSS_TOL)
    _assert_params_match(jstate.params, tstate.model)
    for name, p in tstate.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), full.model.state_dict()[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


def test_chunked_loss_matches_standard_loss_and_jax():
    batches = _batches(2, seed=3)
    jstate, tstate = _setup(loss_chunk=7)
    jstate, tstate, jl, tl, _, _ = _run(jstate, tstate, batches, jax_kw={"loss_chunk": 7},
                                        port_kw={"loss_chunk": 7})
    _, plain, _, plain_l, _, _ = _run(*_setup(), batches)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    np.testing.assert_allclose(tl, plain_l, **LOSS_TOL)
    _assert_params_match(jstate.params, tstate.model)
    for name, p in tstate.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), plain.model.state_dict()[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("key", ["__loss_scale__", "__grad_scale__"])
def test_non_finite_step_is_skipped_like_jax(key):
    """A NaN-scaled loss skips the update (params, optimizer state and EMA
    as they were) while ``step`` advances; a NaN grad scale under a finite
    loss skips only with ``guard_metrics``."""
    jstate, tstate = _setup(ema=True)
    jstate, tstate, _, _, _, _ = _run(jstate, tstate, _batches(1, seed=4),
                                      jax_kw={"ema_decay": 0.5}, port_kw={"ema_decay": 0.5})
    before = {n: p.clone() for n, p in tstate.model.state_dict().items()}
    opt_before = {n: t.clone() for n, t in tstate.opt_state["mu"].items()}
    count_before = int(tstate.opt_state["count"])
    ema_before = {n: t.clone() for n, t in tstate.ema_params.items()}
    guard = key == "__grad_scale__"
    kw = {"ema_decay": 0.5, "guard_metrics": guard}
    jstate, tstate, _, _, jm, tm = _run(jstate, tstate, _batches(1, seed=5), jax_kw=kw,
                                        port_kw=kw, extra={key: np.float32(np.nan)})
    assert float(tm["finite"]) == float(jm["finite"]) == 0.0
    assert tstate.step == 2 and int(jstate.step) == 2
    assert int(tstate.opt_state["count"]) == count_before
    for n, p in tstate.model.state_dict().items():
        assert torch.equal(p, before[n]), n
    for n, t in tstate.opt_state["mu"].items():
        assert torch.equal(t, opt_before[n]), n
    for n, t in tstate.ema_params.items():
        assert torch.equal(t, ema_before[n]), n
    if guard:
        assert not np.isfinite(float(tm["grad_norm"])) and not np.isfinite(float(jm["grad_norm"]))
    _assert_params_match(jstate.params, tstate.model)


def test_ema_matches_jax():
    jstate, tstate = _setup(ema=True)
    jstate, tstate, _, _, _, _ = _run(jstate, tstate, _batches(3, seed=6),
                                      jax_kw={"ema_decay": 0.9}, port_kw={"ema_decay": 0.9})
    want = lm_params_from_jax(jax.device_get(jstate.ema_params))
    for n, t in tstate.ema_params.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), err_msg=n, **PARAM_TOL)


@pytest.mark.parametrize("opt, kw", [
    (("sgd", 0.1), {"weight_decay": 0.01}),
    (("adamw", 1e-3), {"weight_decay": 0.1}),
    (("lion", 1e-4), {"weight_decay": 0.1}),
], ids=["sgd", "adamw", "lion"])
def test_other_optimizers_match_jax(opt, kw):
    jstate, tstate = _setup(opt=opt, opt_kw=kw)
    jstate, tstate, jl, tl, _, _ = _run(jstate, tstate, _batches(2, seed=7))
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_params_match(jstate.params, tstate.model)


@pytest.mark.parametrize("schedule, warmup, decay", [
    ("constant", 0, 0), ("constant", 5, 0), ("cosine", 3, 20), ("cosine", 0, 20),
    ("linear", 4, 12),
])
def test_lr_schedules_match_optax(schedule, warmup, decay):
    want = jax_lr_schedule(0.3, schedule, warmup_steps=warmup, decay_steps=decay)
    got = build_lr_schedule(0.3, schedule, warmup_steps=warmup, decay_steps=decay)
    if not callable(want):
        assert got == want
        return
    steps = [0, 1, 2, 3, 4, 5, 7, 11, 12, 19, 20, 25]
    values = got(torch.tensor(steps, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(values, [float(want(s)) for s in steps], rtol=1e-6, atol=1e-7)


def _grads(model, tokens, attention_fn=None):
    model.zero_grad()
    logits = model(torch.from_numpy(tokens), attention_fn=attention_fn)
    (logits.float().square().mean() + logits[..., 0].sum()).backward()
    return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _port_model(cfg=None, **kw):
    cfg = cfg or TransformerConfig.tiny()
    return TransformerLM(cfg, dtype=torch.float32, device="cpu", **kw).init_weights(0)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_remat_gives_the_grads_of_none(remat, attention):
    fn = flash_attention_bhsd if attention == "flash" else None
    tokens = _batches(1, seed=8)[0]
    want_logits, want = _grads(_port_model(), tokens, fn)
    got_logits, got = _grads(_port_model(remat=remat), tokens, fn)
    torch.testing.assert_close(got_logits, want_logits, atol=1e-6, rtol=1e-6)
    for n in want:
        torch.testing.assert_close(got[n], want[n], atol=1e-6, rtol=1e-6, msg=n)


@pytest.mark.parametrize("cfg_kw", [{}, {"num_kv_heads": 2, "attention_window": 9}],
                         ids=["mha", "gqa_window"])
def test_bhsd_projection_path_matches_bshd(cfg_kw):
    """flash_attention_bhsd (called on BHSD views of the projections)
    against dense attention (BSHD) on the same weights, and against the flax
    model, which projects straight into BHSD for it."""
    cfg = dataclasses.replace(TransformerConfig.tiny(), **cfg_kw)
    tokens = _batches(1, seed=9)[0]
    want_logits, want = _grads(_port_model(cfg), tokens)
    got_logits, got = _grads(_port_model(cfg), tokens, flash_attention_bhsd)
    torch.testing.assert_close(got_logits, want_logits, atol=1e-5, rtol=1e-5)
    for n in want:
        torch.testing.assert_close(got[n], want[n], atol=1e-5, rtol=1e-5, msg=n)
    jc = dataclasses.replace(JaxConfig.tiny(), **cfg_kw)
    jm = JaxLM(config=jc, dtype=jnp.float32, attention_fn=_jax_flash())
    jparams = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, S), jnp.int32))["params"])
    model = _port_model(cfg)
    model.load_state_dict(lm_params_from_jax(jparams))
    jlogits = jm.apply({"params": jparams}, jnp.asarray(tokens))
    with torch.no_grad():
        tlogits = model(torch.from_numpy(tokens), attention_fn=flash_attention_bhsd)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)


def test_onehot_embed_matches_gather_and_jax():
    """The reference's ``onehot_embed`` (an embedding gradient by matmul)
    needs no counterpart: the port's gather, on the converted parameters,
    follows its trajectory."""
    assert "onehot_embed" not in {f.name for f in dataclasses.fields(TransformerConfig)}
    jstate, tstate = _setup(cfg_kw={"onehot_embed": True})
    jstate, tstate, jl, tl, _, _ = _run(jstate, tstate, _batches(2, seed=11))
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_params_match(jstate.params, tstate.model)


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["plain", "decay"])
def test_five_step_adafactor_trajectory_matches_jax(wd):
    """``optax.adafactor(lr, multiply_by_parameter_scale=False,
    weight_decay_rate=wd or None)`` behind clip 1.0, 5 steps at f32. d_model
    and d_ff 128 give factored moments (two dims >= 128): the embedding
    ``[256, 128]`` and the square SwiGLU weights, whose factors follow the
    reference's ``[in, out]`` layout; the attention weights and norms keep
    full second moments. The optimizer state converts with
    ``opt_state_from_jax`` to the port's."""
    jstate, tstate = _setup(opt=("adafactor", 1e-3), opt_kw={"weight_decay": wd},
                            cfg_kw={"d_model": 128, "d_ff": 128})
    assert tstate.opt_state["v"]["embed.weight"].shape == (1,)
    assert tstate.opt_state["v_row"]["layers.0.mlp.gate_proj.weight"].shape == (128,)
    jstate, tstate, jl, tl, _, _ = _run(jstate, tstate, _batches(5, seed=12))
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_params_match(jstate.params, tstate.model)
    want = opt_state_from_jax(jax.device_get(jstate.opt_state), "adafactor")
    assert int(want["count"]) == int(tstate.opt_state["count"]) == 5
    for key in ("v_row", "v_col", "v"):
        assert set(want[key]) == set(tstate.opt_state[key])
        for n, t in tstate.opt_state[key].items():
            np.testing.assert_allclose(t.numpy(), want[key][n].numpy(), rtol=1e-4, atol=1e-12,
                                       err_msg=f"{key} {n}")
