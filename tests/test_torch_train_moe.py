"""Training the port's MoE LM against ``deeplearning_mpi_tpu``'s, and expert parallelism.

Weights go across with ``lm_params_from_jax`` (the router transposed, the
expert stacks as they are); batches are numpy-seeded tokens fed to both.
float32 on the CPU at ``TransformerConfig.tiny_moe()`` (4 experts, top 2),
batch 4, seq 32, ``aux_weight`` 0.01; the tolerances are
``tests/test_torch_train.py``'s: losses within 1e-5, parameters after Adam
steps within atol 5e-5 (rtol 1e-4), gradients within atol 1e-5 (rtol
1e-4), the dropped fraction within 1e-6.

- The forward's logits and the gradient of ``loss + 0.01 * aux`` against
  ``jax.grad`` of the flax model, router and expert stacks included.
- 3 Adam steps (clip 1.0) against JAX ``make_train_step("lm",
  aux_weight=0.01)``, with ``grad_accum`` 1 and 2 (the aux weight split
  over the chunks, the dropped fraction their mean); the JAX state then
  goes through the JAX ``Checkpointer``, converts and continues one step in
  the port as in JAX. Under remat ``full`` and ``dots`` the MoE step equals
  the plain one (1e-6). A dense model reports no ``moe_dropped_frac``; an MoE
  state saved and restored verified keeps its digests; the trainer logs the
  epoch's dropped fraction.
- Expert parallelism in ONE gloo spawn of 4 ranks (``tests/
  torch_moe_ranks.py``), asserted here case by case: as ``dp 2 x ep 2`` and
  as ``ep 4``, each rank's logits, the load-balance loss (the global
  batch's, not a mean of per-rank values), the step's gradients and one
  Adam step (loss, dropped fraction, parameters) equal one process on the
  global batch within the tolerances above, and every replica of a
  non-expert parameter is bitwise equal across the ranks; the ``dp 2 x ep
  2`` checkpoint restores at ``ep 1`` and at ``ep 4`` to the digests the
  ranks computed. In the same spawn, ranks 0-1 (a subgroup) train a small
  ResNet with BatchNorm under ``grad_accum`` 2 on the loader's rows: the
  loss, gradients and BatchNorm statistics equal JAX's one-device
  accumulated step on the same global batch, float64, within 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_moe_ranks as ranks
from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.moe import collect_aux_loss as jax_aux
from deeplearning_mpi_tpu.models.resnet import BasicBlock as JaxBasicBlock
from deeplearning_mpi_tpu.models.resnet import ResNet as JaxResNet
from deeplearning_mpi_tpu.train import Checkpointer as JaxCheckpointer
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.data import SyntheticTokens
from deeplearning_mpi_tpu_torch.models import moe
from deeplearning_mpi_tpu_torch.models.convert import (
    cnn_variables_from_jax,
    lm_params_from_jax,
    opt_state_from_jax,
)
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy
from deeplearning_mpi_tpu_torch.resilience.integrity import tree_digests
from deeplearning_mpi_tpu_torch.train import (
    Trainer,
    build_optimizer,
    create_train_state,
    make_train_step,
)
from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

B, S = 4, 32
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
AUX = 0.01


def _port_config(jc) -> TransformerConfig:
    return TransformerConfig(**{f.name: getattr(jc, f.name)
                                for f in dataclasses.fields(TransformerConfig)})


def _batches(n, seed=0):
    ds = SyntheticTokens(n * B, S, seed=seed)
    return [np.stack([ds[i * B + j]["tokens"] for j in range(B)]) for i in range(n)]


@pytest.fixture(scope="module")
def jax_init():
    jc = JaxConfig.tiny_moe()
    jm = JaxLM(config=jc, dtype=jnp.float32)
    jstate = jax_create_state(jm, jax.random.key(0), jnp.zeros((1, S), jnp.int32),
                              jax_optimizer("adam", 1e-3, clip_norm=1.0))
    return jc, jm, jstate


def _port_state(jc, params, opt=("adam", 1e-3)):
    model = TransformerLM(_port_config(jc), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    return create_train_state(model, build_optimizer(opt[0], opt[1], clip_norm=1.0))


def _assert_params_match(jparams, model, **tol):
    want = lm_params_from_jax(jax.device_get(jparams))
    got = model.state_dict()
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name,
                                   **(tol or PARAM_TOL))


def test_forward_and_aux_gradient_match_jax(jax_init):
    jc, jm, jstate = jax_init
    tokens = _batches(1, seed=4)[0]

    def objective(params):
        logits, mut = jm.apply({"params": params}, jnp.asarray(tokens),
                               mutable=["moe_losses", "moe_metrics"])
        labels = jnp.asarray(tokens)[:, 1:]
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1).mean()
        return nll + AUX * jax_aux(mut), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(jstate.params)
    model = _port_state(jc, jstate.params).model
    with moe.collecting(model) as sown:
        logits = model(torch.from_numpy(tokens).long())
    total = lm_cross_entropy(logits, torch.from_numpy(tokens)) + AUX * moe.collect_aux_loss(sown)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **LOSS_TOL)
    want = lm_params_from_jax(jax.device_get(jgrads))
    assert set(want) == set(grads) and any("experts_" in n for n in grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_adam_steps_match_jax_and_continue_from_a_jax_checkpoint(
        jax_init, grad_accum, tmp_path):
    jc, jm, jstate = jax_init
    tstate = _port_state(jc, jstate.params)
    jstep = jax_make_step("lm", donate=False, aux_weight=AUX, grad_accum=grad_accum)
    tstep = make_train_step("lm", aux_weight=AUX, grad_accum=grad_accum)
    for tokens in _batches(3, seed=grad_accum):
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm_ = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm_["moe_dropped_frac"]),
                                   float(jm_["moe_dropped_frac"]), atol=1e-6)
    _assert_params_match(jstate.params, tstate.model)
    if grad_accum == 2:
        return
    ck = JaxCheckpointer(tmp_path / "jax")
    ck.save(jstate, epoch=0)
    ck.wait_until_finished() if hasattr(ck, "wait_until_finished") else None
    restored, epoch = ck.restore_verified(jstate)
    ck.close()
    host = jax.device_get(restored)
    cont = _port_state(jc, host.params)
    cont = dataclasses.replace(cont, step=int(host.step),
                               opt_state=opt_state_from_jax(host.opt_state, "adam"))
    tokens = _batches(1, seed=9)[0]
    jstate, _ = jstep(restored, {"tokens": jnp.asarray(tokens)})
    cont, _ = tstep(cont, {"tokens": torch.from_numpy(tokens)})
    assert cont.step == int(jstate.step) == 4
    _assert_params_match(jstate.params, cont.model)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_moe_step_under_remat_equals_the_plain_step(remat):
    """The backward reruns each block under remat: the routed layers must
    record the balance loss again, as in the first run."""
    tokens = torch.from_numpy(_batches(1, seed=5)[0])
    runs = {}
    for policy in ("none", remat):
        model = TransformerLM(TransformerConfig.tiny_moe(), dtype=torch.float32, device="cpu",
                              remat=policy).init_weights(2)
        state = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0))
        _, metrics = make_train_step("lm", aux_weight=AUX)(state, {"tokens": tokens})
        runs[policy] = (metrics, model.state_dict())
    (want, w_sd), (got, g_sd) = runs["none"], runs[remat]
    for key in ("loss", "moe_aux_loss", "moe_dropped_frac"):
        assert float(got[key]) == float(want[key]), key
    for n, t in w_sd.items():
        torch.testing.assert_close(g_sd[n], t, atol=1e-6, rtol=1e-5, msg=n)


def test_dense_reports_no_drop_and_moe_checkpoints_and_logs(tmp_path):
    dense = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    state = create_train_state(dense.init_weights(0), build_optimizer("adam", 1e-3))
    _, metrics = make_train_step("lm", aux_weight=AUX)(state, {"tokens": torch.from_numpy(
        _batches(1)[0])})
    assert "moe_dropped_frac" not in metrics

    model = TransformerLM(TransformerConfig.tiny_moe(), dtype=torch.float32, device="cpu")
    state = create_train_state(model.init_weights(1), build_optimizer("adam", 1e-3), ema=True)
    lines = []

    class Batches:
        def epoch(self, epoch):
            return [{"tokens": torch.from_numpy(t)} for t in _batches(2, seed=epoch)]

    trainer = Trainer(state, aux_weight=AUX, ema_decay=0.9, log=lines.append,
                      checkpointer=Checkpointer(tmp_path / "ck"))
    trainer.fit(Batches(), 1)
    assert 0.0 <= trainer.history[0]["moe_dropped_frac"] <= 1.0
    assert any(line.startswith("Epoch 0: moe_dropped_frac") for line in lines)
    fresh = create_train_state(
        TransformerLM(TransformerConfig.tiny_moe(), dtype=torch.float32, device="cpu"),
        build_optimizer("adam", 1e-3), ema=True)
    restored, epoch = Checkpointer(tmp_path / "ck").restore_verified(fresh)
    assert epoch == 0 and tree_digests(restored.arrays()) == tree_digests(trainer.state.arrays())


# -- expert parallelism and the BatchNorm chunks: one spawn -----------------------
def _jax_bn_reference(images, labels):
    """JAX's one-device classification step under grad_accum 2 (float64) on
    the global batch: the init variables, then the loss, the gradients (read
    from a probe optimizer's state) and the BatchNorm statistics."""
    probe = optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))
    jm = JaxResNet(stage_sizes=(1, 1), block_cls=JaxBasicBlock, num_filters=4, stem="cifar",
                   dtype=jnp.float64)
    js = jax_create_state(jm, jax.random.key(3), jnp.zeros((1, 16, 16, 3), jnp.float64), probe)
    init = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jax.device_get({"params": js.params, "batch_stats": js.batch_stats}))
    js = js.replace(params=init["params"], batch_stats=init["batch_stats"],
                    opt_state=probe.init(init["params"]))
    step = jax_make_step("classification", donate=False, grad_accum=2)
    js, metrics = step(js, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    return init, jax.device_get({"loss": metrics["loss"], "grads": js.opt_state["g"],
                                 "batch_stats": js.batch_stats})


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_init):
    jc, _, jstate = jax_init
    out = tmp_path_factory.mktemp("ep")
    cfg = _port_config(jc)
    moe_sd = lm_params_from_jax(jax.device_get(jstate.params))
    tokens = torch.from_numpy(_batches(1, seed=7)[0])
    images, labels = ranks.bn_inputs()
    with jax.enable_x64(True):
        init, bn_ref = _jax_bn_reference(images, labels)
    bn_sd = cnn_variables_from_jax(init["params"], init["batch_stats"])
    torch.save({"cfg": cfg, "moe_sd": moe_sd, "tokens": tokens, "bn_sd": bn_sd,
                "images": images, "labels": labels}, out / "inputs.pt")
    results = ranks.spawn(out)
    one = ranks.moe_case(cfg, moe_sd, tokens)
    one_ep1 = ranks.moe_case(cfg, moe_sd, tokens, restore_dir=out / "ckpt")
    one_f64 = ranks.moe_case(cfg, moe_sd, tokens, dtype=torch.float64)
    return {"ranks": results, "one": one, "restored_ep1": one_ep1["restored_digests"],
            "bn_ref": bn_ref, "one_f64": one_f64}


@pytest.mark.parametrize("layout", list(ranks.LAYOUTS))
def test_expert_parallel_forward_and_aux_equal_one_process(spawned, layout):
    one = spawned["one"]
    for r, res in enumerate(spawned["ranks"]):
        got = res[layout]
        a, b = got["rows"]
        np.testing.assert_allclose(got["logits"].numpy(), one["logits"][a:b].numpy(),
                                   err_msg=f"rank {r}", **LOSS_TOL)
        np.testing.assert_allclose(got["aux"], one["aux"], rtol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("layout", list(ranks.LAYOUTS))
def test_expert_parallel_gradients_equal_one_process(spawned, layout):
    one = spawned["one"]["grads"]
    for r, res in enumerate(spawned["ranks"]):
        got = res[layout]["grads"]
        assert set(got) == set(one)
        for n in one:
            np.testing.assert_allclose(got[n].numpy(), one[n].numpy(),
                                       err_msg=f"rank {r} {n}", **GRAD_TOL)


@pytest.mark.parametrize("layout", list(ranks.LAYOUTS))
def test_expert_parallel_adam_step_equals_one_process(spawned, layout):
    one = spawned["one"]
    results = [res[layout] for res in spawned["ranks"]]
    for r, got in enumerate(results):
        np.testing.assert_allclose(got["loss"], one["loss"], **LOSS_TOL)
        np.testing.assert_allclose(got["drop"], one["drop"], atol=1e-6)
        np.testing.assert_allclose(got["step_aux"], one["step_aux"], rtol=1e-6)
        for n, p in one["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                       err_msg=f"rank {r} {n}", **PARAM_TOL)
    for n, p in results[0]["local_params"].items():
        if "experts_" not in n:
            for r, got in enumerate(results[1:], 1):
                assert torch.equal(got["local_params"][n], p), f"rank {r} replica of {n}"


def test_expert_parallel_float64_step_equals_one_process(spawned):
    """``dp 2 x ep 2`` in float64 (parameters and compute): the balance
    loss, the loss, every gradient and every updated parameter within 1e-10
    relative of one float64 process, where float32's association noise
    (~1e-7 here) would hide a small fault in the expert group's sums; the
    non-expert replicas bitwise equal."""
    results = [res["dp2_ep2_f64"] for res in spawned["ranks"]]
    assert all(g.dtype == torch.float64 for g in results[0]["grads"].values())
    worst = ranks.relative_errors(results, spawned["one_f64"])
    over = [(k, e) for k, e in worst if e > 1e-10]
    assert not over, f"{len(over)} of {len(worst)} over 1e-10: {over[:10]}"
    assert not ranks.differing_replicas(results)


@pytest.mark.parametrize("onto", ["ep1", "ep4"])
def test_checkpoint_moves_between_expert_shardings(spawned, onto):
    written = spawned["ranks"][0]["dp2_ep2"]["digests"]
    assert all(res["dp2_ep2"]["digests"] == written for res in spawned["ranks"])
    if onto == "ep1":
        assert spawned["restored_ep1"] == written
    else:
        assert all(res["ep4"]["restored_digests"] == written for res in spawned["ranks"])


@pytest.mark.parametrize("rank", [0, 1])
def test_batchnorm_grad_accum_chunks_equal_the_jax_step(spawned, rank):
    got, ref = spawned["ranks"][rank]["bn"], spawned["bn_ref"]
    # Rank r's chunk i is its half of the reference's contiguous chunk i.
    assert got["rows"] == [rank, 2 + rank]
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=1e-7)
    want = cnn_variables_from_jax(ref["grads"], ref["batch_stats"])
    stats = {n: t for n, t in want.items() if n.endswith(("running_mean", "running_var"))}
    for n, t in got["grads"].items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), atol=1e-7, rtol=1e-7, err_msg=n)
    assert set(got["batch_stats"]) == set(stats)
    for n, t in got["batch_stats"].items():
        np.testing.assert_allclose(t.numpy(), stats[n].numpy(), atol=1e-7, rtol=1e-7, err_msg=n)


def test_split_batch_rule_holds_and_rejects_the_unsummed_router(spawned):
    """``torch_moe_ranks.split_batch_rule``, the float32 bar of the four-card
    ``dp 2 x ep 2`` check (``tests/test_torch_gpu.py``), on 4 gloo ranks
    against ``dp 4`` from the same spawn: ``dp 2 x ep 2``'s gradients meet
    it, and the copy of the layer that does not sum the router
    probabilities' gradient over the expert group fails it, on the router
    among others. The parameters after one Adam step are reported, not
    held, here: at these widths ``dp 4``'s worst is 3e-8 (the first Adam
    step sends almost every element lr * sign(g), whatever the noise), and
    the expert stacks' near-zero gradients, which Adam divides by their own
    size, put ``dp 2 x ep 2`` at 2.7e-7."""
    dp4 = [res["dp4"] for res in spawned["ranks"]]
    over, bars = ranks.split_batch_rule([res["dp2_ep2"] for res in spawned["ranks"]], dp4,
                                        spawned["one"])
    wrong, _ = ranks.split_batch_rule([res["dp2_ep2_unsummed"] for res in spawned["ranks"]], dp4,
                                      spawned["one"])
    print("bars", bars, "over", over[:4], "wrong", wrong[:4])
    grads_over = [(k, e) for k, e in over if k[1] == "grads"]
    assert not grads_over, f"{len(grads_over)} over {bars['grads']}: {grads_over[:10]}"
    wrong_grads = [k[2] for k, _ in wrong if k[1] == "grads"]
    assert any("router" in n for n in wrong_grads), wrong[:10]
