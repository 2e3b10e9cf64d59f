"""Single-process batch loader with the reference's batch order.

Port of the order logic of ``deeplearning_mpi_tpu/data/loader.py``'s
``ShardedLoader`` for one process: a per-epoch shuffle seeded by
``SeedSequence([seed, epoch])`` over the whole index space, whole batches
only with ``drop_last`` (the default), and otherwise a tail padded by
wrapping around to the front, its duplicate rows marked 0 in
``__valid__``. So the port trains on the JAX CLI's batches. Batches are
dicts of tensors on ``device``.
"""

from __future__ import annotations

from typing import Iterator, Protocol

import numpy as np
import torch

from deeplearning_mpi_tpu_torch import resolve_device


class ArrayDataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, index: int) -> dict[str, np.ndarray]: ...


class Loader:
    """Iterates batches of ``batch_size`` examples of ``dataset``."""

    def __init__(
        self, dataset: ArrayDataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
        drop_last: bool = True, device: str | torch.device = "cuda",
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = resolve_device(device)

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Index order for this epoch, sized to whole batches."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).permutation(n)
        else:
            order = np.arange(n)
        b = self.batch_size
        if self.drop_last:
            return order[: (n // b) * b]
        short = -n % b
        if short:
            order = np.resize(order, n + short)  # cyclic wrap-pad
        return order

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[dict[str, torch.Tensor]]:
        order = self.epoch_order(epoch)
        for start in range(0, len(order), self.batch_size):
            idx = order[start: start + self.batch_size]
            examples = [self.dataset[int(i)] for i in idx]
            stacked = {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}
            if not self.drop_last:
                pos = np.arange(start, start + self.batch_size)
                stacked["__valid__"] = (pos < len(self.dataset)).astype(np.float32)
            yield {k: torch.from_numpy(v).to(self.device) for k, v in stacked.items()}
