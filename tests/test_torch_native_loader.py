"""The port's native loader (``data/native.py``, ``csrc/fastloader.cc``) and
the loader's fetch threads (``data/loader.py``) against the reference.

- The native transforms, on the same generator draws, are bitwise the
  reference's numpy transforms (and the port's own numpy copy). The
  reference's native library folds the normalization into ``u8 * scale +
  bias``, which rounds differently: it is held to its own test's bar,
  1e-6, not bitwise.
- Threaded equals single-threaded, bitwise.
- A ``num_workers=k`` epoch yields the batches of ``num_workers=0`` and of
  the reference's ``ShardedLoader`` with fetch threads, for the same seed.
- ``--num_workers`` is accepted by all three trainer CLIs, whose run with
  threads equals the run without.
- The path choice: ``DLMPI_TPU_NO_NATIVE`` or no ``g++`` keeps numpy; a
  ``g++`` that fails raises.

Tightened first: a crop off by one pixel fails the bitwise comparison.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.data import cifar10 as ref_cifar
from deeplearning_mpi_tpu_torch.data import Loader, SyntheticCIFAR10, native
from deeplearning_mpi_tpu_torch.data import cifar10 as cifar
from deeplearning_mpi_tpu_torch.data.loader import prefetch

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native library unavailable (no g++ on PATH)")


def _batch(n=16, seed=0, hw=32):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, hw, hw, 3)).astype(np.uint8),
            "label": rng.integers(0, 10, n).astype(np.int32)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("flip", [True, False])
def test_train_transform_bitwise_the_reference_numpy(seed, flip):
    batch = _batch(seed=seed)
    got = native.train_transform(dict(batch), np.random.default_rng(seed + 100), flip=flip)
    want = ref_cifar.train_transform(dict(batch), np.random.default_rng(seed + 100), flip=flip)
    mine = cifar.train_transform(dict(batch), np.random.default_rng(seed + 100), flip=flip)
    assert got["image"].dtype == np.float32
    np.testing.assert_array_equal(got["image"].view(np.uint32), want["image"].view(np.uint32))
    np.testing.assert_array_equal(got["image"].view(np.uint32), mine["image"].view(np.uint32))
    np.testing.assert_array_equal(got["label"], want["label"])


def test_eval_transform_bitwise_the_reference_numpy():
    batch = _batch(seed=4)
    got = native.eval_transform(dict(batch))["image"]
    np.testing.assert_array_equal(got.view(np.uint32),
                                  ref_cifar.eval_transform(dict(batch))["image"].view(np.uint32))


def test_reference_native_library_within_its_own_bar():
    """The reference's library (``u8 * scale + bias``) on the same draws:
    within 1e-6, its own test's tolerance."""
    from deeplearning_mpi_tpu.data import native as ref_native

    if not ref_native.native_available():
        pytest.skip("the reference's native library did not build")
    batch = _batch(seed=3)
    got = native.train_transform(dict(batch), np.random.default_rng(9))["image"]
    want = ref_native.train_transform(dict(batch), np.random.default_rng(9))["image"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(native.eval_transform(dict(batch))["image"],
                               ref_native.eval_transform(dict(batch))["image"], rtol=0, atol=1e-6)


def test_a_crop_off_by_one_pixel_is_caught():
    """The bar rejects the wrong copy: the same draws with the crop window
    moved one pixel down are not bitwise the numpy transform."""
    batch = _batch(seed=5)
    rng = np.random.default_rng(7)
    n = len(batch["image"])
    ys, xs, flips = rng.integers(0, 9, size=n), rng.integers(0, 9, size=n), rng.random(n) < 0.5
    want = cifar.train_transform(dict(batch), np.random.default_rng(7))["image"]
    right = native.crop_flip_normalize(batch["image"], ys, xs, flips)
    wrong = native.crop_flip_normalize(batch["image"], np.minimum(ys + 1, 8), xs, flips)
    np.testing.assert_array_equal(right, want)
    assert not np.array_equal(wrong, want)


def test_padding_and_flip_semantics():
    images = np.full((1, 32, 32, 3), 255, np.uint8)
    out = native.crop_flip_normalize(images, ys=np.array([0]), xs=np.array([0]),
                                     flips=np.array([0]))
    border = ((np.float32(0) - cifar.CIFAR10_MEAN) / cifar.CIFAR10_STD).astype(np.float32)
    body = ((np.float32(1) - cifar.CIFAR10_MEAN) / cifar.CIFAR10_STD).astype(np.float32)
    np.testing.assert_array_equal(out[0, 0, 0], border)
    np.testing.assert_array_equal(out[0, 10, 10], body)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    base = native.crop_flip_normalize(images, np.array([4, 4]), np.array([4, 4]),
                                      np.array([0, 0]))
    flipped = native.crop_flip_normalize(images, np.array([4, 4]), np.array([4, 4]),
                                         np.array([1, 1]))
    np.testing.assert_array_equal(flipped, base[:, :, ::-1])


def test_threaded_equals_single_thread():
    batch = _batch(n=64, seed=3)
    rng = np.random.default_rng(0)
    ys, xs, flips = rng.integers(0, 9, 64), rng.integers(0, 9, 64), rng.random(64) < 0.5
    np.testing.assert_array_equal(native.normalize(batch["image"], max_threads=1),
                                  native.normalize(batch["image"], max_threads=8))
    np.testing.assert_array_equal(
        native.crop_flip_normalize(batch["image"], ys, xs, flips, max_threads=1),
        native.crop_flip_normalize(batch["image"], ys, xs, flips, max_threads=8))


# -- the loader's fetch threads -------------------------------------------------------

def _epochs(loader, n=2):
    return [{k: v.numpy() for k, v in b.items()} for e in range(n) for b in loader.epoch(e)]


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_threaded_epochs_equal_unthreaded_and_the_reference(workers, drop_last):
    import jax

    from deeplearning_mpi_tpu.data.loader import ShardedLoader
    from deeplearning_mpi_tpu.runtime.mesh import create_mesh

    ds = SyntheticCIFAR10(44, seed=1)
    kw = dict(shuffle=True, seed=11, drop_last=drop_last)
    threaded = _epochs(Loader(ds, 8, transform=native.train_transform, device="cpu",
                              num_workers=workers, **kw))
    plain = _epochs(Loader(ds, 8, transform=cifar.train_transform, device="cpu",
                           num_workers=0, **kw))
    ref = ShardedLoader(ds, 8, create_mesh(devices=jax.devices()[:1]),
                        transform=ref_cifar.train_transform, num_workers=workers, **kw)
    want = [{k: np.asarray(v) for k, v in b.items()} for e in range(2) for b in ref.epoch(e)]
    assert len(threaded) == len(plain) == len(want) == 2 * (44 // 8 if drop_last else 6)
    for got, base, w in zip(threaded, plain, want):
        assert set(got) == set(base) == set(w)
        for k in w:
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)


def test_default_workers_and_abandoned_epoch():
    import os

    ds = SyntheticCIFAR10(40, seed=2)
    loader = Loader(ds, 8, transform=native.train_transform, device="cpu")
    assert loader.num_workers == min(16, (os.cpu_count() or 2) // 2)
    first = next(iter(loader.epoch(0)))  # abandoning the generator closes its pools
    np.testing.assert_array_equal(first["image"].numpy(),
                                  _epochs(Loader(ds, 8, transform=native.train_transform,
                                                 device="cpu", num_workers=0), 1)[0]["image"])


def test_prefetch_keeps_order_and_raises():
    assert list(prefetch(iter(range(20)), size=3)) == list(range(20))

    def boom():
        yield 1
        raise RuntimeError("source failed")

    it = prefetch(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)
    gen = prefetch(iter(range(1000)), size=2)
    assert next(gen) == 0
    gen.close()  # the producer is stopped and joined


# -- the CLIs ------------------------------------------------------------------------

CLI_RUNS = {
    "train_resnet": ["--synthetic", "--num_epochs", "1", "--batch_size", "8", "--train_samples",
                     "24", "--stem", "cifar"],
    "train_unet": ["--synthetic", "--num_epochs", "1", "--batch_size", "2", "--train_samples",
                   "8", "--image_size", "16"],
    "train_lm": ["--num_epochs", "1", "--num_layers", "1", "--num_heads", "2", "--head_dim", "8",
                 "--d_model", "16", "--d_ff", "32", "--seq_len", "16", "--batch_size", "4",
                 "--train_sequences", "20"],
}


@pytest.mark.parametrize("cli", sorted(CLI_RUNS))
def test_num_workers_accepted_by_the_trainer_clis(cli, capsys):
    """``--num_workers 2`` runs and gives the ``--num_workers 0`` run's
    losses; the ResNet CLI's log names the native path and the threads."""
    import importlib

    mod = importlib.import_module(f"deeplearning_mpi_tpu_torch.cli.{cli}")
    argv = ["--device", "cpu", *CLI_RUNS[cli]]

    def losses(workers):
        history = mod.train(argv + ["--num_workers", str(workers)]).history
        return [{k: v for k, v in h.items() if "loss" in k or k in ("accuracy", "dice")}
                for h in history]

    base, threaded = losses(0), losses(2)
    assert threaded == base and any(threaded)
    if cli == "train_resnet":
        out = capsys.readouterr().out
        assert "input pipeline: native C++ transforms" in out and "2 fetch thread(s)" in out


# -- the path choice -----------------------------------------------------------------

@pytest.fixture()
def fresh_native(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    yield


def test_no_native_env_keeps_numpy(fresh_native, monkeypatch):
    monkeypatch.setenv("DLMPI_TPU_NO_NATIVE", "1")
    assert not native.native_available()
    assert "DLMPI_TPU_NO_NATIVE" in native.pipeline_description(0)
    batch = _batch(seed=6)
    np.testing.assert_array_equal(
        native.train_transform(dict(batch), np.random.default_rng(1))["image"],
        cifar.train_transform(dict(batch), np.random.default_rng(1))["image"])


def test_no_compiler_keeps_numpy(fresh_native, monkeypatch):
    monkeypatch.delenv("DLMPI_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.native_available()
    assert "no g++" in native.pipeline_description(3)


def test_a_failing_compiler_raises(fresh_native, monkeypatch, tmp_path):
    monkeypatch.delenv("DLMPI_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "gxx_command",
                        lambda source, out: ["g++", "-x", "c++", "-DNOT_VALID", "/dev/null",
                                             "-fsyntax-only-not-a-flag", "-o", str(out)])
    with pytest.raises(RuntimeError, match="build failed"):
        native.get_library()
