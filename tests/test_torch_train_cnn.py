"""The port's classification and segmentation train steps against JAX's.

The weights go across with ``cnn_variables_from_jax`` (seeded numpy
weights in the flax trees' shapes, as ``test_torch_cnn.py`` draws them);
the batches are numpy-seeded and fed to both. On the CPU, ResNet-18 with
``num_filters`` 8 (cifar stem, 32x32) and the UNet with ``features`` (4, 8)
at 16x16, float32 unless said otherwise.

- 3-step trajectories against JAX ``make_train_step``: every loss within
  1e-5, the final parameters and BatchNorm statistics within atol 5e-5
  (rtol 1e-4), the bound ``test_torch_train.py`` states after Adam steps:
  classification with SGD (momentum 0.9, weight decay 1e-5), segmentation
  with Adam and clip 1.0 under each ``seg_loss``. Both compute in float64
  (flax under ``jax.enable_x64``, the port with ``dtype=torch.float64``;
  the losses stay float32 on both sides). In float32 a pre-activation
  within ~1e-6 of a ReLU's kink rounds to opposite sides now and then, and
  at SGD's lr 0.1 one such step moved the parameters 2.5e-4 apart; so
  float32 is held over one step (``test_one_float32_step_matches_jax``);
- ``grad_accum`` 2 with BatchNorm on the duplicated-halves batch of
  ``tests/test_train.py`` (each chunk's statistics equal the whole batch's):
  one step equals JAX's accumulated step and the one-chunk step, and the
  running statistics advance once a chunk as JAX's do;
- the eval step with wrap-padded rows (``__valid__`` 0) equals JAX's loss,
  accuracy / Dice and weight;
- a non-finite loss skips the update: parameters, BatchNorm statistics and
  optimizer state unchanged, the step counted;
- the ``Trainer`` reports accuracy and Dice weighted by the valid rows, and
  a checkpoint carries ``batch_stats`` (the LM's keeps its tree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import UNet as JaxUNet
from deeplearning_mpi_tpu.models import resnet18 as jax_resnet18
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_eval_step as jax_eval_step
from deeplearning_mpi_tpu.train import make_train_step as jax_train_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.models import UNet, resnet18
from deeplearning_mpi_tpu_torch.models.convert import cnn_variables_from_jax
from deeplearning_mpi_tpu_torch.train import (
    Trainer,
    build_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
)

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)


def _weights(v, rng):
    """Seeded numpy params / batch_stats in the shapes of flax variables."""
    def param(path, x):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (rng.normal(size=x.shape) * float(np.std(x))).astype(np.float32)

    def stat(path, x):
        if "mean" in jax.tree_util.keystr(path):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (1 + 0.1 * np.abs(rng.normal(size=x.shape))).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(param, v["params"]),
            jax.tree_util.tree_map_with_path(stat, v["batch_stats"]))


def _setup(task, opt, *, seed=0, f64=False):
    """The JAX state and the port's, from the same weights (``f64``: both
    compute in float64; call under ``jax.enable_x64``)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    if task == "classification":
        jm, shape = jax_resnet18(num_filters=8, stem="cifar", dtype=jdt), (1, 32, 32, 3)
        tm = resnet18(num_filters=8, stem="cifar", dtype=tdt, device="cpu")
    else:
        jm, shape = JaxUNet(features=(4, 8), dtype=jdt), (1, 16, 16, 3)
        tm = UNet(features=(4, 8), dtype=tdt, device="cpu")
    name, lr, kw = opt
    np_dt = np.float64 if f64 else np.float32
    js = jax_create_state(jm, jax.random.key(0), jnp.zeros(shape, np_dt),
                          jax_optimizer(name, lr, **kw))
    params, stats = _weights(jax.device_get({"params": js.params,
                                             "batch_stats": js.batch_stats}), rng)
    as_dt = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, np_dt), tree)  # noqa: E731
    js = js.replace(params=as_dt(params), batch_stats=as_dt(stats))
    js = js.replace(opt_state=js.tx.init(js.params))
    tm.load_state_dict(cnn_variables_from_jax(params, stats), strict=True)
    if f64:
        tm.double()
    return js, create_train_state(tm, build_optimizer(name, lr, **kw))


def _batch(task, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if task == "classification":
        return {"image": rng.normal(size=(n, 32, 32, 3)).astype(dtype),
                "label": rng.integers(0, 10, size=n).astype(np.int32)}
    return {"image": rng.normal(size=(n, 16, 16, 3)).astype(dtype),
            "mask": (rng.random((n, 16, 16)) > 0.5).astype(np.float32)}


def _to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_states_close(js, ts):
    want = cnn_variables_from_jax(jax.device_get(js.params), jax.device_get(js.batch_stats))
    got = ts.model.state_dict()
    assert set(want) == set(got)
    for n in want:
        np.testing.assert_allclose(got[n].double().numpy(), want[n].numpy(), **PARAM_TOL,
                                   err_msg=n)


SGD = ("sgd", 0.1, dict(momentum=0.9, weight_decay=1e-5))
ADAM = ("adam", 1e-3, dict(clip_norm=1.0))


@pytest.mark.parametrize("task,opt,seg_loss", [
    ("classification", SGD, "bce"),
    ("segmentation", ADAM, "bce"),
    ("segmentation", ADAM, "dice"),
    ("segmentation", ADAM, "bce_dice"),
], ids=["classification-sgd", "segmentation-bce", "segmentation-dice", "segmentation-bce_dice"])
def test_trajectory_matches_jax(task, opt, seg_loss):
    with jax.enable_x64(True):
        js, ts = _setup(task, opt, f64=True)
        j_step = jax_train_step(task, donate=False, seg_loss=seg_loss)
        t_step = make_train_step(task, seg_loss=seg_loss)
        for i in range(3):
            batch = _batch(task, 8 if task == "classification" else 4, seed=10 + i,
                           dtype=np.float64)
            js, jm = j_step(js, jax.tree.map(jnp.asarray, batch))
            ts, tm = t_step(ts, _to_port(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
            assert float(tm["finite"]) == float(jm["finite"]) == 1.0
        assert ts.step == int(js.step) == 3
        _assert_states_close(js, ts)


@pytest.mark.parametrize("task,opt", [("classification", SGD), ("segmentation", ADAM)])
def test_one_float32_step_matches_jax(task, opt):
    js, ts = _setup(task, opt)
    batch = _batch(task, 8 if task == "classification" else 4, seed=10)
    js, jm = jax_train_step(task, donate=False)(js, jax.tree.map(jnp.asarray, batch))
    ts, tm = make_train_step(task)(ts, _to_port(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    _assert_states_close(js, ts)


def test_grad_accum_with_batchnorm_duplicated_halves():
    """Each chunk normalises over its own rows; on concat([half, half]) those
    statistics are the whole batch's, so the accumulated step reproduces the
    one-chunk step (JAX's and the port's) while the running statistics
    advance once a chunk, as JAX's do."""
    opt = ("sgd", 1e-2, dict(momentum=0.0))
    half = _batch("segmentation", 4, seed=3)
    batch = {k: np.concatenate([v, v]) for k, v in half.items()}
    js, ts = _setup("segmentation", opt)
    js2, jm2 = jax_train_step("segmentation", donate=False, grad_accum=2)(
        js, jax.tree.map(jnp.asarray, batch))
    ts2, tm2 = make_train_step("segmentation", grad_accum=2)(ts, _to_port(batch))
    np.testing.assert_allclose(float(tm2["loss"]), float(jm2["loss"]), **LOSS_TOL)
    _assert_states_close(js2, ts2)

    js1, ts1 = _setup("segmentation", opt)
    _, tm1 = make_train_step("segmentation")(ts1, _to_port(batch))
    np.testing.assert_allclose(float(tm2["loss"]), float(tm1["loss"]), rtol=1e-6)
    for (n, a), b in zip(ts2.model.named_parameters(), ts1.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5, err_msg=n)


@pytest.mark.parametrize("task", ["classification", "segmentation"])
def test_eval_with_wrap_padded_rows_matches_jax(task):
    js, ts = _setup(task, ADAM)
    batch = _batch(task, 4, seed=5)
    batch["__valid__"] = np.array([1, 1, 1, 0], np.float32)
    want = jax.device_get(jax_eval_step(task)(js, jax.tree.map(jnp.asarray, batch)))
    got = make_eval_step(task)(ts, _to_port(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, err_msg=k)


def test_nonfinite_loss_skips_the_update():
    js, ts = _setup("classification", SGD)
    before = {n: t.clone() for n, t in ts.model.state_dict().items()}
    opt_before = {n: t.clone() for n, t in ts.opt_state["trace"].items()}
    batch = _to_port(_batch("classification", 8, seed=1))
    batch["image"][0, 0, 0, 0] = float("nan")
    ts, metrics = make_train_step("classification")(ts, batch)
    assert float(metrics["finite"]) == 0.0 and ts.step == 1
    for n, t in ts.model.state_dict().items():
        torch.testing.assert_close(t, before[n], atol=0, rtol=0, msg=n)
    for n, t in ts.opt_state["trace"].items():
        torch.testing.assert_close(t, opt_before[n], atol=0, rtol=0)


def _loader(ds, batch, **kw):
    from deeplearning_mpi_tpu_torch.data import Loader

    return Loader(ds, batch, device="cpu", **kw)


@pytest.mark.parametrize("task", ["classification", "segmentation"])
def test_trainer_eval_weights_valid_rows(task):
    """The trainer's eval over a wrap-padded loader equals the mean over the
    real rows alone."""
    from deeplearning_mpi_tpu_torch.data import SyntheticCIFAR10, SyntheticShapesDataset
    from deeplearning_mpi_tpu_torch.data.cifar10 import eval_transform

    _, ts = _setup(task, ADAM)
    if task == "classification":
        ds, kw, key = SyntheticCIFAR10(6, seed=1), {"transform": eval_transform}, "accuracy"
    else:
        ds, kw, key = SyntheticShapesDataset(6, size=16, seed=1), {}, "dice"
    trainer = Trainer(ts, task, log=lambda m: None)
    padded = trainer.evaluate(_loader(ds, 4, shuffle=False, drop_last=False, **kw))
    whole = trainer.evaluate(_loader(ds, 6, shuffle=False, drop_last=False, **kw))
    assert set(padded) == {"loss", key}
    for k in padded:
        np.testing.assert_allclose(padded[k], whole[k], rtol=1e-5, atol=1e-6)


def test_checkpoint_carries_batch_stats(tmp_path):
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    _, ts = _setup("classification", SGD)
    ts, _ = make_train_step("classification")(ts, _to_port(_batch("classification", 8, seed=2)))
    ck = Checkpointer(tmp_path / "ck")
    ck.save(ts, epoch=0)
    assert (tmp_path / "ck" / "0" / "batch_stats.pt").is_file()
    fresh = create_train_state(resnet18(num_filters=8, stem="cifar", device="cpu").init_weights(9),
                               build_optimizer(*SGD[:2], **SGD[2]))
    restored, epoch = ck.restore_verified(fresh)
    assert epoch == 0 and restored.step == 1
    assert tree_digests(restored.arrays()) == tree_digests(ts.arrays())
    only = ck.restore_params_only(create_train_state(
        resnet18(num_filters=8, stem="cifar", device="cpu").init_weights(9), None))
    for n, b in only.model.named_buffers():
        torch.testing.assert_close(b, dict(ts.model.named_buffers())[n], atol=0, rtol=0)
