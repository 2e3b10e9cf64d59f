"""The port's ResNet, UNet and BatchNorm against the flax modules.

Each case draws one set of seeded numpy weights in the flax tree's shapes
(each kernel at its init's scale, BatchNorm scales 1 + N(0, 0.1), biases
and running means N(0, 0.1), running variances 1 + |N(0, 0.1)|), converts
them with ``cnn_variables_from_jax`` and runs both modules on the same
seeded input, float32 on the CPU at small widths (ResNet ``num_filters``
8, UNet ``features`` (4, 8)):

- train-mode logits and the updated batch statistics within atol 1e-5;
  eval-mode logits (running statistics) within atol 1e-5;
- the gradient of ``sum(logits * c)`` (``c`` a fixed random cotangent)
  with respect to every parameter within relative L2 1e-5 per tensor, both
  modules computing in float64 (flax under ``jax.enable_x64``, the port
  with ``dtype=torch.float64``) on the same weights and input.

The gradients are held in float64 because two float32 evaluations of a
ResNet-18 gradient differ by more than the reference's own rounding: flax's
float32 gradient of one BatchNorm bias sits 1.3e-5 (relative L2) from the
float64 one, and a pre-activation of 4e-7 that rounds to the other side of
a ReLU in one of them moves whole tensors by 1e-3. In float64 they agree to
~1e-12, so the bound holds every tensor to the same function.

The imagenet stem runs at 128x128: at 32x32 its last stage is 1x1, so each
BatchNorm there normalises 4 values, and the fast variance ``E[x²] -
E[x]²`` cancels; flax itself then sits up to 1.3e-4 from a float64
evaluation of the same network, and the two float32 evaluations 5e-5 to
1e-4 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import UNet as JaxUNet
from deeplearning_mpi_tpu.models import resnet18 as jax_resnet18
from deeplearning_mpi_tpu_torch.models import UNet, get_model, resnet18, resnet50
from deeplearning_mpi_tpu_torch.models.convert import cnn_variables_from_jax
from deeplearning_mpi_tpu_torch.models.norm import BatchNorm

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ATOL = 1e-5
GRAD_L2 = 1e-5


def _weights(jm, shape, rng):
    """Seeded numpy params and batch_stats in the flax module's tree."""
    v = jax.device_get(jm.init(jax.random.key(0), jnp.zeros(shape), train=False))

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


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _compare(make_jax, make_port, shape, seed=0) -> dict:
    """Run both modules (``make_*(dtype)`` build them) on one seeded input;
    returns the largest logit differences (train and eval mode, float32),
    the batch statistics' (float32) and each gradient's relative L2
    difference (float64)."""
    rng = np.random.default_rng(seed)
    jm, tm = make_jax(jnp.float32), make_port(torch.float32)
    params, stats = _weights(jm, shape, rng)
    sd = cnn_variables_from_jax(params, stats)
    x = rng.normal(size=shape).astype(np.float32)
    out_shape = jax.eval_shape(lambda: jm.apply({"params": params, "batch_stats": stats},
                                                jnp.asarray(x), train=False)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    out, mut = jax.jit(lambda p: jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                          train=True, mutable=["batch_stats"]))(params)
    eval_out = jax.jit(lambda p: jm.apply({"params": p, "batch_stats": stats},
                                          jnp.asarray(x), train=False))(params)
    tm.load_state_dict(sd, strict=True)
    tm.train()
    with torch.no_grad():
        y = tm(torch.from_numpy(x))
    got_stats = {n: b.clone() for n, b in tm.named_buffers()}
    tm.load_state_dict(sd)
    tm.eval()
    with torch.no_grad():
        y_eval = tm(torch.from_numpy(x))
    want_stats = cnn_variables_from_jax({}, jax.device_get(mut["batch_stats"]))

    with jax.enable_x64(True):
        jm64 = make_jax(jnp.float64)
        p64, s64 = jax.tree.map(lambda a: np.asarray(a, np.float64), (params, stats))

        def loss(p):
            out, _ = jm64.apply({"params": p, "batch_stats": s64}, jnp.asarray(x, jnp.float64),
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float64) * cot)

        grads = jax.device_get(jax.jit(jax.grad(loss))(p64))
    tm64 = make_port(torch.float64)
    tm64.load_state_dict(sd)
    tm64.double().train()
    (tm64(torch.from_numpy(x).double()).double() * torch.from_numpy(cot).double()).sum().backward()
    got = dict(tm64.named_parameters())
    return {
        "logits": float(np.abs(np.asarray(out) - y.numpy()).max()),
        "eval_logits": float(np.abs(np.asarray(eval_out) - y_eval.numpy()).max()),
        "stats": max(float((got_stats[n] - w).abs().max()) for n, w in want_stats.items()),
        "grads": {n: _rel_l2(got[n].grad, g)
                  for n, g in cnn_variables_from_jax(grads).items()},
    }


def _check(make_jax, make_port, shape) -> None:
    diff = _compare(make_jax, make_port, shape)
    assert diff["logits"] <= ATOL, diff["logits"]
    assert diff["eval_logits"] <= ATOL, diff["eval_logits"]
    assert diff["stats"] <= ATOL, diff["stats"]
    worst = max(diff["grads"], key=diff["grads"].get)
    assert diff["grads"][worst] <= GRAD_L2, (worst, diff["grads"][worst])


@pytest.mark.parametrize("torch_padding", [False, True], ids=["same", "torch_padding"])
@pytest.mark.parametrize("stem,size", [("imagenet", 128), ("cifar", 32)])
def test_resnet18_matches_flax(stem, size, torch_padding):
    _check(lambda dt: jax_resnet18(num_filters=8, stem=stem, torch_padding=torch_padding, dtype=dt),
           lambda dt: resnet18(num_filters=8, stem=stem, torch_padding=torch_padding, dtype=dt,
                               device="cpu"),
           (4, size, size, 3))


UNETS = {
    "transposed": {},
    "bilinear": {"bilinear": True},
    "reference_topology": {"reference_topology": True},
    "reference_bilinear": {"reference_topology": True, "bilinear": True},
}


@pytest.mark.parametrize("variant", sorted(UNETS))
def test_unet_matches_flax(variant):
    kw = UNETS[variant]
    _check(lambda dt: JaxUNet(features=(4, 8), dtype=dt, **kw),
           lambda dt: UNet(features=(4, 8), dtype=dt, device="cpu", **kw), (2, 16, 16, 3))


def test_unet3d_matches_flax():
    _check(lambda dt: JaxUNet(features=(4, 8), spatial_dims=3, dtype=dt),
           lambda dt: UNet(features=(4, 8), spatial_dims=3, in_channels=1, dtype=dt, device="cpu"),
           (2, 8, 8, 8, 1))


def test_param_counts():
    """torchvision's ResNet-18 / ResNet-50 with a 10-class head."""
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(resnet18(num_classes=10, device="cpu")) == 11_181_642
    assert count(resnet50(num_classes=10, device="cpu")) == 23_528_522


@pytest.mark.parametrize("name,kw", [("resnet18", dict(num_filters=8)),
                                     ("unet", dict(features=(4, 8))),
                                     ("unet_bilinear", dict(features=(4, 8), bilinear=True))])
def test_every_flax_leaf_maps_to_one_tensor(name, kw):
    """Each flax leaf (params and batch_stats) becomes exactly one tensor,
    and they fill every parameter and buffer of the port's model; a leaf
    left over on either side fails the strict load."""
    if name == "resnet18":
        jm, tm, shape = jax_resnet18(**kw), resnet18(device="cpu", **kw), (1, 32, 32, 3)
    else:
        jm, tm, shape = JaxUNet(**kw), UNet(device="cpu", **kw), (1, 16, 16, 3)
    v = jax.device_get(jm.init(jax.random.key(0), jnp.zeros(shape), train=False))
    sd = cnn_variables_from_jax(v["params"], v["batch_stats"])
    n_leaves = len(jax.tree.leaves(v["params"])) + len(jax.tree.leaves(v["batch_stats"]))
    assert len(sd) == n_leaves == len(tm.state_dict())
    assert set(sd) == set(tm.state_dict())
    for n, t in tm.state_dict().items():
        assert sd[n].shape == t.shape, n
    tm.load_state_dict(sd, strict=True)
    extra = dict(sd)
    extra["Dense_1.weight" if name == "resnet18" else "Conv_9.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected"):
        tm.load_state_dict(extra, strict=True)
    short = dict(sd)
    short.pop(sorted(short)[0])
    with pytest.raises(RuntimeError, match="Missing"):
        tm.load_state_dict(short, strict=True)


def test_unet_remat_equals_plain():
    """``remat`` recomputes each DoubleConv in the backward: the logits,
    every gradient and the running statistics (advanced once) equal the
    plain path's."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, 16, 3)).astype(np.float32))
    out = {}
    for remat in (False, True):
        m = UNet(features=(4, 8), remat=remat, device="cpu").init_weights(3)
        y = m(x)
        y.square().sum().backward()
        out[remat] = (y.detach(), {n: p.grad for n, p in m.named_parameters()},
                      {n: b.clone() for n, b in m.named_buffers()})
    torch.testing.assert_close(out[True][0], out[False][0], atol=0, rtol=0)
    for n in out[False][1]:
        torch.testing.assert_close(out[True][1][n], out[False][1][n], atol=1e-6, rtol=1e-6)
    for n in out[False][2]:
        torch.testing.assert_close(out[True][2][n], out[False][2][n], atol=0, rtol=0)


def test_unet_input_checks():
    m = UNet(features=(4, 8), spatial_dims=3, in_channels=1, device="cpu")
    with pytest.raises(ValueError, match=r"expected \[batch, SxSxS, channels\] input for "
                                         r"spatial_dims=3; got shape \(1, 16, 16, 1\)"):
        m(torch.zeros(1, 16, 16, 1))
    with pytest.raises(ValueError, match="divisible by 16"):
        UNet(device="cpu")(torch.zeros(1, 100, 100, 3))


def test_get_model():
    assert get_model("resnet34", num_classes=7, device="cpu").num_classes == 7
    assert get_model("unet", out_classes=2, features=(4, 8), device="cpu").out_classes == 2
    assert get_model("unet3d", features=(4, 8), device="cpu").spatial_dims == 3
    assert get_model("vit_tiny", stem="cifar", dtype=torch.float32, device="cpu").d_model == 192
    with pytest.raises(ValueError, match="unknown model"):
        get_model("lenet")


def test_batchnorm_running_variance_is_biased_like_flax():
    """On 18 samples flax's running variance moves by the biased batch
    variance (torch's own BatchNorm takes the unbiased one)."""
    import flax.linen as fnn

    x = np.random.default_rng(2).normal(size=(18, 3)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(3, device="cpu").train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-7, rtol=1e-6)
    unbiased = torch.nn.BatchNorm1d(3, momentum=0.1).train()
    unbiased(torch.from_numpy(x))
    assert not np.allclose(unbiased.running_var.numpy(), port.running_var.numpy(), atol=1e-4)


def test_bf16_keeps_f32_params_and_logits():
    m = resnet18(num_filters=8, dtype=torch.bfloat16, device="cpu").init_weights(0)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    y = m.train()(torch.randn(2, 32, 32, 3))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
