"""The port's data path and training CLI.

- ``data.lm_text`` gives the JAX package's examples byte for byte;
- ``data.loader.Loader`` gives ``ShardedLoader``'s epoch order (shuffled,
  in order, and with the wrap-padded eval tail and its ``__valid__`` mask)
  on one process;
- ``python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu`` at tiny
  widths exits 0 and its epoch loss falls over 2 epochs; asking for CUDA
  where there is none fails.
"""

import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.data.lm_text import ByteTextDataset as JaxBytes
from deeplearning_mpi_tpu.data.lm_text import SyntheticTokens as JaxSynthetic
from deeplearning_mpi_tpu.data.loader import ShardedLoader
from deeplearning_mpi_tpu_torch.data import ByteTextDataset, Loader, SyntheticTokens

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed, vocab", [(0, 256), (5, 32000)])
def test_synthetic_tokens_match_jax(seed, vocab):
    ours = SyntheticTokens(20, 67, vocab_size=vocab, seed=seed)
    theirs = JaxSynthetic(20, 67, vocab_size=vocab, seed=seed)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        a, b = ours[i]["tokens"], theirs[i]["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_byte_text_dataset_matches_jax(tmp_path):
    path = tmp_path / "text.bin"
    path.write_bytes(bytes(np.random.default_rng(1).integers(0, 256, 1000, dtype=np.uint8)))
    ours, theirs = ByteTextDataset(path, 64), JaxBytes(path, 64)
    assert len(ours) == len(theirs) == 15
    for i in range(len(ours)):
        assert ours[i]["tokens"].tobytes() == theirs[i]["tokens"].tobytes()
    with pytest.raises(ValueError, match="one sequence"):
        ByteTextDataset(path, 2000)


def _sharded(dataset, batch, *, shuffle, seed, drop_last):
    """``ShardedLoader``'s order and assembly on one process, without a
    device mesh (its row range is the whole batch)."""
    return types.SimpleNamespace(
        dataset=dataset, global_batch_size=batch, shuffle=shuffle, seed=seed,
        drop_last=drop_last, transform=None, num_workers=0, local_row_ranges=[(0, batch)],
    )


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, True), (False, False),
                                                (True, False)],
                         ids=["shuffle", "in_order", "eval_tail", "shuffled_tail"])
def test_loader_order_matches_sharded_loader(shuffle, drop_last):
    ds = SyntheticTokens(23, 16, seed=3)
    ref = _sharded(ds, 4, shuffle=shuffle, seed=7, drop_last=drop_last)
    loader = Loader(ds, 4, shuffle=shuffle, seed=7, drop_last=drop_last, device="cpu")
    assert loader.steps_per_epoch() == (5 if drop_last else 6)
    for epoch in (0, 1):
        want = ShardedLoader._epoch_order(ref, epoch)
        np.testing.assert_array_equal(loader.epoch_order(epoch), want)
        batches = list(loader.epoch(epoch))
        assert len(batches) == loader.steps_per_epoch()
        for i, batch in enumerate(batches):
            expect = ShardedLoader._assemble(ref, want, 4 * i, epoch)
            assert set(batch) == set(expect)
            for key, value in expect.items():
                np.testing.assert_array_equal(batch[key].numpy(), value)
    if shuffle:
        assert not np.array_equal(loader.epoch_order(0), loader.epoch_order(1))
    if not drop_last:
        assert batches[-1]["__valid__"].tolist() == [1.0, 1.0, 1.0, 0.0]


TINY = ["--num_layers", "2", "--num_heads", "2", "--head_dim", "8", "--d_model", "16",
        "--d_ff", "32", "--seq_len", "32", "--batch_size", "4", "--train_sequences", "40",
        "--num_epochs", "2", "--learning_rate", "1e-2"]


def _train(*extra, device="cpu"):
    return subprocess.run(
        [sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.train_lm", "--device", device,
         *TINY, *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("extra", [("--attention", "dense"),
                                   ("--attention", "flash", "--remat", "full", "--loss_chunk", "8")],
                         ids=["dense", "flash_remat_chunked"])
def test_train_cli_runs_and_loss_falls(extra):
    out = _train(*extra)
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(x) for x in re.findall(r"^Epoch \d+: loss ([0-9.]+)", out.stdout, re.M)]
    assert len(losses) == 2 and losses[1] < losses[0], out.stdout
    assert "Final eval: loss" in out.stdout


def test_train_cli_refuses_missing_cuda_and_unported_options():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is what a machine without it does")
    out = _train(device="cuda")
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    out = _train("--aot_warmup", "--nproc", "2")
    assert out.returncode != 0 and "not captured yet" in out.stderr
