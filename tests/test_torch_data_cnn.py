"""The port's CNN data path, losses and metrics against the JAX package's.

- the CIFAR-10 and segmentation datasets (synthetic, the on-disk pickles, an
  image/mask folder) yield the JAX datasets' examples exactly;
- the numpy transforms draw from the generator as the reference's do: equal
  seeds, equal crops, flips and normalisation;
- rank ``r`` of ``n`` in the port's loader gets exactly the host batch the
  JAX ``ShardedLoader`` assembles for process ``r`` of ``n`` (its row range
  of each global window, transformed with the generator seeded by
  ``(seed, epoch, 1, start)``, ``__valid__`` on wrap-padded rows);
- the segmentation losses, top-1 accuracy and Dice (both-empty = 1.0) equal
  ``ops.loss`` / ``ops.metrics`` within 1e-6, with and without a validity
  mask;
- ``cli.download``: ``--from_file`` ingests a tarball (md5 checked, a
  member that leaves the destination refused), ``--check`` validates the
  CIFAR pickles and an image/mask folder as the JAX CLI's checks do, and a
  download is refused.
"""

import hashlib
import io
import pickle
import subprocess
import sys
import tarfile

import jax
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.data import cifar10 as jax_cifar
from deeplearning_mpi_tpu.data import segmentation as jax_seg
from deeplearning_mpi_tpu.data.loader import ShardedLoader
from deeplearning_mpi_tpu.ops import loss as jax_loss
from deeplearning_mpi_tpu.ops import metrics as jax_metrics
from deeplearning_mpi_tpu.runtime.mesh import create_mesh
from deeplearning_mpi_tpu_torch.data import Loader
from deeplearning_mpi_tpu_torch.data import cifar10 as cifar
from deeplearning_mpi_tpu_torch.data import segmentation as seg
from deeplearning_mpi_tpu_torch.ops import loss, metrics

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)


def _same_examples(a, b, n):
    assert len(a) == len(b)
    for i in range(n):
        ea, eb = a[i], b[i]
        assert set(ea) == set(eb)
        for k in ea:
            np.testing.assert_array_equal(np.asarray(ea[k]), np.asarray(eb[k]))
            assert np.asarray(ea[k]).dtype == np.asarray(eb[k]).dtype


@pytest.mark.parametrize("name,kw", [
    ("SyntheticCIFAR10", dict(n=12, seed=3)),
    ("SyntheticShapesDataset", dict(n=6, size=32, seed=4)),
    ("SyntheticVolumesDataset", dict(n=4, size=16, seed=5)),
])
def test_synthetic_datasets_match(name, kw):
    mod, jmod = (cifar, jax_cifar) if name == "SyntheticCIFAR10" else (seg, jax_seg)
    n = kw.pop("n")
    _same_examples(getattr(mod, name)(n, **kw), getattr(jmod, name)(n, **kw), n)


def test_cifar10_pickles_match(tmp_path):
    rng = np.random.default_rng(0)
    batch_dir = tmp_path / "cifar-10-batches-py"
    batch_dir.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(batch_dir / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, 3).tolist()}, f)
    for train in (True, False):
        _same_examples(cifar.CIFAR10(tmp_path, train=train),
                       jax_cifar.CIFAR10(tmp_path, train=train), 3)
    with pytest.raises(FileNotFoundError, match="--from_file"):
        cifar.CIFAR10(tmp_path / "missing")


def test_segmentation_folder_matches(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"im{i}.png")
        Image.fromarray((rng.random((20, 30)) > 0.5).astype(np.uint8) * 255).save(
            tmp_path / "masks" / f"im{i}_mask.png")
    args = (tmp_path / "images", tmp_path / "masks", 0.5)
    _same_examples(seg.CarvanaDataset(*args), jax_seg.CarvanaDataset(*args), 3)
    _same_examples(seg.SegmentationFolderDataset(*args, mask_suffix="_mask"),
                   jax_seg.SegmentationFolderDataset(*args, mask_suffix="_mask"), 3)


def test_synthetic_path_needs_no_pillow():
    """Pillow is imported by the folder dataset alone: the synthetic data,
    the loader and the CLIs run where it is not installed."""
    code = ("import sys\nsys.modules['PIL'] = None\n"
            "from deeplearning_mpi_tpu_torch.data import SyntheticShapesDataset, SyntheticCIFAR10\n"
            "import deeplearning_mpi_tpu_torch.cli.train_unet, deeplearning_mpi_tpu_torch.cli.train_resnet\n"
            "assert SyntheticShapesDataset(2, size=16)[1]['mask'].shape == (16, 16)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("flip", [True, False])
def test_transforms_draw_like_the_reference(flip):
    ds = cifar.SyntheticCIFAR10(16, seed=2)
    batch = {k: np.stack([ds[i][k] for i in range(16)]) for k in ds[0]}
    got = cifar.train_transform(dict(batch), np.random.default_rng(7), flip=flip)
    want = jax_cifar.train_transform(dict(batch), np.random.default_rng(7), flip=flip)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for k, v in jax_cifar.eval_transform(dict(batch)).items():
        np.testing.assert_array_equal(cifar.eval_transform(dict(batch))[k], v)


def _jax_process_batches(ds, batch, n, rank, *, drop_last, transform):
    """The host batches JAX's ShardedLoader assembles for process ``rank``
    of ``n``: its row range of each global window."""
    loader = ShardedLoader(ds, batch, create_mesh(devices=jax.devices()[:1]), shuffle=True,
                           seed=11, drop_last=drop_last, transform=transform, num_workers=0)
    local = batch // n
    loader.local_row_ranges = [(rank * local, (rank + 1) * local)]
    out = []
    for epoch in (0, 1):
        order = loader._epoch_order(epoch)
        out += [loader._assemble(order, start, epoch) for start in range(0, len(order), batch)]
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_rank_rows_match_the_reference(n, drop_last):
    ds = cifar.SyntheticCIFAR10(22, seed=1)
    for rank in range(n):
        want = _jax_process_batches(ds, 8, n, rank, drop_last=drop_last,
                                    transform=jax_cifar.train_transform)
        loader = Loader(ds, 8, shuffle=True, seed=11, drop_last=drop_last,
                        transform=cifar.train_transform, num_replicas=n, rank=rank, device="cpu")
        got = [b for epoch in (0, 1) for b in loader.epoch(epoch)]
        assert len(got) == len(want) == 2 * loader.steps_per_epoch()
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        Loader(ds, 6, num_replicas=4, device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_loader_accum_chunks_match_the_reference(n):
    """Under grad_accum 2 the ranks' chunk-i rows, concatenated, are the
    reference's global chunk i after the transform: each row keeps the
    augmentation draw of its row in the JAX process's contiguous block."""
    ds = cifar.SyntheticCIFAR10(22, seed=1)
    procs = [_jax_process_batches(ds, 8, n, p, drop_last=True,
                                  transform=jax_cifar.train_transform) for p in range(n)]
    ranks = [[b for epoch in (0, 1) for b in Loader(
        ds, 8, shuffle=True, seed=11, transform=cifar.train_transform, num_replicas=n,
        rank=r, grad_accum=2, device="cpu").epoch(epoch)] for r in range(n)]
    for step in range(len(procs[0])):
        for k in procs[0][step]:
            whole = np.concatenate([procs[p][step][k] for p in range(n)])
            for i, want in enumerate(np.split(whole, 2)):
                got = torch.cat([ranks[r][step][k].chunk(2)[i] for r in range(n)])
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{k} chunk {i}")


def test_loader_ranks_tile_the_global_batch():
    """Without a transform, the ranks' rows concatenate to the one-process
    global batch."""
    ds = seg.SyntheticShapesDataset(10, size=16, seed=2)
    whole = list(Loader(ds, 4, seed=3, drop_last=False, device="cpu").epoch(1))
    parts = [list(Loader(ds, 4, seed=3, drop_last=False, num_replicas=2, rank=r,
                         device="cpu").epoch(1)) for r in range(2)]
    for i, w in enumerate(whole):
        for k in w:
            torch.testing.assert_close(torch.cat([parts[0][i][k], parts[1][i][k]]), w[k],
                                       atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_and_metrics_match(masked):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 8, 8)).astype(np.float32) * 3
    target = (rng.random((4, 8, 8)) > 0.5).astype(np.float32)
    target[1] = 0.0
    pred = (logits > 0).astype(np.float32)
    pred[1] = 0.0  # image 1: both masks empty -> Dice 1.0
    cls_logits = rng.normal(size=(4, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    labels[0] = int(cls_logits[0].argmax())
    where = np.array([1, 1, 0, 1], np.float32) if masked else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jax.numpy.asarray(a)  # noqa: E731
    pairs = [
        (loss.bce_per_image(t(logits), t(target)), jax_loss.bce_per_image(j(logits), j(target))),
        (loss.dice_per_image(t(logits), t(target)), jax_loss.dice_per_image(j(logits), j(target))),
        (loss.sigmoid_binary_cross_entropy(t(logits), t(target), t(where)),
         jax_loss.sigmoid_binary_cross_entropy(j(logits), j(target), j(where))),
        (loss.dice_loss(t(logits), t(target), t(where)),
         jax_loss.dice_loss(j(logits), j(target), j(where))),
        (metrics.top1_accuracy(t(cls_logits), t(labels), t(where)),
         jax_metrics.top1_accuracy(j(cls_logits), j(labels), j(where))),
        (metrics.dice_score(t(pred), t(target), t(where)),
         jax_metrics.dice_score(j(pred), j(target), j(where))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    per_image = metrics.dice_score(t(pred[1:2]), t(target[1:2]))
    assert float(per_image) == 1.0


def _cifar_tarball(path, *, evil=False):
    with tarfile.open(path, "w:gz") as tar:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            blob = pickle.dumps({"data": np.zeros((2, 3072), np.uint8), "labels": [0, 1]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
        if evil:
            info = tarfile.TarInfo("../outside.txt")
            info.size = 1
            tar.addfile(info, io.BytesIO(b"x"))
    return path


def test_download_ingest_and_checks(tmp_path, capsys):
    from deeplearning_mpi_tpu.cli import download as jax_download
    from deeplearning_mpi_tpu_torch.cli import download

    tarball = _cifar_tarball(tmp_path / "c.tar.gz")
    md5 = hashlib.md5(tarball.read_bytes()).hexdigest()
    assert download.main(["cifar10", "--check", "--data_dir", str(tmp_path / "d")]) == 1
    assert download.main(["cifar10", "--from_file", str(tarball), "--data_dir",
                          str(tmp_path / "d")]) == 1  # not the official digest
    assert download.main(["cifar10", "--from_file", str(tarball), "--md5", md5.upper(),
                          "--data_dir", str(tmp_path / "d")]) == 0
    assert download.main(["cifar10", "--check", "--data_dir", str(tmp_path / "d")]) == 0
    assert jax_download.check_cifar10(tmp_path / "d")
    assert len(cifar.CIFAR10(tmp_path / "d")) == 10
    evil = _cifar_tarball(tmp_path / "e.tar.gz", evil=True)
    assert download.main(["cifar10", "--from_file", str(evil), "--md5", "none",
                          "--data_dir", str(tmp_path / "x" / "d")]) == 1
    assert not (tmp_path / "x" / "outside.txt").exists()
    assert download.main(["cifar10", "--data_dir", str(tmp_path / "n")]) == 2
    assert "does not download" in capsys.readouterr().err

    from PIL import Image

    (tmp_path / "s" / "images").mkdir(parents=True)
    (tmp_path / "s" / "masks").mkdir()
    Image.new("RGB", (8, 6)).save(tmp_path / "s" / "images" / "a.png")
    Image.new("L", (8, 6)).save(tmp_path / "s" / "masks" / "a_mask.png")
    for suffix, want in (("_mask", 0), ("", 1)):
        args = ["carvana", "--check", "--data_dir", str(tmp_path / "s"), "--mask_suffix", suffix]
        assert download.main(args) == want
        assert jax_download.check_carvana(tmp_path / "s", mask_suffix=suffix) == (want == 0)
