"""The port's ViT family against ``deeplearning_mpi_tpu/models/vit.py``.

- The seven cases of ``tests/test_vit.py``, written against the port:
  shape and finiteness, bidirectional attention (the last patch moves the
  CLS logits), one set of parameters at two image sizes, an image size the
  patch does not divide, 30 Adam steps that lower the loss, the registry
  (``stem`` dropped) and the factory's defaults.
- ``vit_tiny`` (float32, dense attention, as the reference's
  ``train_resnet`` builds it) on the reference's weights, carried across by
  ``models.convert.vit_params_from_jax``: the logits within 1e-5 and the
  gradient of the mean cross-entropy within 1e-5 relative L2 per tensor of
  JAX's, on 32x32 and on 16x16 images (the same weights: RoPE, not a
  position table). The weights are seeded draws in the flax tree's shapes,
  the CLS token and every bias included (flax's init leaves them zero).
- ``cli.train_resnet --device cpu --arch vit_tiny --synthetic`` exits 0
  with its epoch lines, and refuses ``--torch_padding``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models.vit import vit_tiny as jax_vit_tiny
from deeplearning_mpi_tpu.ops.loss import softmax_cross_entropy as jax_ce
from deeplearning_mpi_tpu_torch.models import get_model
from deeplearning_mpi_tpu_torch.models.convert import vit_params_from_jax
from deeplearning_mpi_tpu_torch.models.vit import ViT, vit_tiny
from deeplearning_mpi_tpu_torch.ops.loss import softmax_cross_entropy

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

#: logits (elementwise) and gradients (relative L2 per tensor) against JAX.
LOGIT_TOL = 1e-5
GRAD_L2 = 1e-5


def _tiny_vit(**kw) -> ViT:
    kw.setdefault("patch_size", 8)  # 32x32 -> 4x4 = 16 patches + CLS
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("head_dim", 8)
    kw.setdefault("d_model", 16)
    kw.setdefault("d_ff", 32)
    kw.setdefault("dtype", torch.float32)
    return ViT(10, device="cpu", **kw).init_weights(0)


def _images(seed: int, shape=(2, 32, 32, 3)) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_forward_shape_and_finite():
    logits = _tiny_vit()(_images(0))
    assert logits.shape == (2, 10) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_attention_is_bidirectional():
    """The CLS token sits at position 0: under a causal mask it would see no
    patch. Perturbing the LAST patch must move the logits."""
    model = _tiny_vit()
    images = _images(1, (1, 32, 32, 3))
    moved = images.clone()
    moved[:, 24:, 24:, :] += 3.0
    with torch.no_grad():
        assert float((model(moved) - model(images)).abs().max()) > 1e-4


def test_resolution_independent_params():
    assert _tiny_vit()(torch.zeros(1, 64, 64, 3)).shape == (1, 10)


def test_non_dividing_image_raises():
    with pytest.raises(ValueError, match="not divisible"):
        _tiny_vit(patch_size=5)(torch.zeros(1, 32, 32, 3))


def test_train_step_decreases_loss():
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    state = create_train_state(_tiny_vit(), build_optimizer("adam", 1e-3, clip_norm=1.0))
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 10, (8,)))}
    step = make_train_step("classification")
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_registry_builds_and_drops_stem():
    model = get_model("vit_tiny", num_classes=10, stem="imagenet", dtype=torch.float32,
                      device="cpu")
    assert isinstance(model, ViT)
    assert model.d_model == 192


def test_factory_defaults():
    m = vit_tiny(device="cpu")
    assert (m.num_layers, m.num_heads, m.patch_size) == (6, 3, 4)


# -- against the reference ------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """JAX's vit_tiny (float32) on seeded weights: logits and gradients of
    the mean cross-entropy at 32x32 and 16x16, B4."""
    jm = jax_vit_tiny(dtype=jnp.float32)
    shapes = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])
    rng = np.random.default_rng(3)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if "bias" in name or "cls" in name:
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (rng.normal(size=x.shape) * float(np.std(x))).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    out = {"params": params}

    def loss(p, images, labels):
        logits = jm.apply({"params": p}, images)
        return jax_ce(logits, labels), logits

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    for size in (32, 16):
        images = rng.normal(size=(4, size, size, 3)).astype(np.float32)
        labels = rng.integers(0, 10, (4,)).astype(np.int32)
        (_, logits), grads = step(params, jnp.asarray(images), jnp.asarray(labels))
        out[size] = {"images": images, "labels": labels, "logits": np.asarray(logits),
                     "grads": vit_params_from_jax(jax.device_get(grads))}
    return out


@pytest.mark.parametrize("size", [32, 16])
def test_vit_tiny_matches_jax(reference, size):
    """Logits within 1e-5 and every gradient within 1e-5 relative L2."""
    model = vit_tiny(dtype=torch.float32, device="cpu")
    model.load_state_dict(vit_params_from_jax(reference["params"]))
    ref = reference[size]
    logits = model(torch.from_numpy(ref["images"]))
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], atol=LOGIT_TOL, rtol=0)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(
        softmax_cross_entropy(logits, torch.from_numpy(ref["labels"]).long()), params)
    assert set(names) == set(ref["grads"])
    worst = max((float((g.double() - ref["grads"][n].double()).norm()
                       / ref["grads"][n].double().norm()), n) for n, g in zip(names, grads))
    assert worst[0] <= GRAD_L2, worst


def test_train_resnet_cli_vit(capsys):
    from deeplearning_mpi_tpu_torch.cli import train_resnet

    assert train_resnet.main(["--device", "cpu", "--arch", "vit_tiny", "--synthetic",
                              "--num_epochs", "1", "--batch_size", "8", "--train_samples", "16",
                              "--optimizer", "adam", "--learning_rate", "1e-3"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^Epoch 0: loss [0-9.]+", out, re.M) and "accuracy" in out, out
    assert train_resnet.main(["--device", "cpu", "--arch", "vit_tiny", "--torch_padding"]) == 1
    assert "CNN numerics" in capsys.readouterr().err
