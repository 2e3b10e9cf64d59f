"""Language-model datasets: byte-level text and synthetic token streams.

The port's own copy of ``deeplearning_mpi_tpu/data/lm_text.py`` (numpy
only): the same windows and the same seeded sequences, so both packages
train on identical data. Examples are ``{"tokens": int32 [seq_len]}``; the
LM loss shifts internally.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class ByteTextDataset:
    """Non-overlapping fixed-length byte windows over a file (vocab 256);
    the trailing partial window is dropped."""

    vocab_size = 256

    def __init__(self, path: str | Path, seq_len: int) -> None:
        data = np.frombuffer(Path(path).read_bytes(), np.uint8)
        n_chunks = len(data) // seq_len
        if n_chunks == 0:
            raise ValueError(f"{path} holds {len(data)} bytes < one sequence of {seq_len}")
        self.chunks = data[: n_chunks * seq_len].reshape(n_chunks, seq_len)

    def __len__(self) -> int:
        return len(self.chunks)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        return {"tokens": self.chunks[index].astype(np.int32)}


class SyntheticTokens:
    """Learnable pseudo-text: each sequence repeats a random 16-token motif
    with 5% noise. Deterministic per (seed, index)."""

    def __init__(self, num_sequences: int, seq_len: int, *, vocab_size: int = 256,
                 seed: int = 0) -> None:
        self.num_sequences = num_sequences
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self.num_sequences

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, index]))
        motif = rng.integers(0, self.vocab_size, 16)
        tokens = np.tile(motif, self.seq_len // 16 + 1)[: self.seq_len]
        noise = rng.random(self.seq_len) < 0.05
        tokens = np.where(noise, rng.integers(0, self.vocab_size, self.seq_len), tokens)
        return {"tokens": tokens.astype(np.int32)}
