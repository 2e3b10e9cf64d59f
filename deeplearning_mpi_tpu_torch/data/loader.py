"""Batch loader with the reference's batch order, one process or many.

Port of ``deeplearning_mpi_tpu/data/loader.py``'s ``ShardedLoader``: a
per-epoch shuffle seeded by ``SeedSequence([seed, epoch])`` over the whole
index space (the same on every rank), whole GLOBAL batches of
``batch_size`` only with ``drop_last`` (the default), and otherwise a tail
padded by wrapping around to the front, its duplicate rows marked 0 in
``__valid__``. Rank ``r`` of ``num_replicas`` takes rows ``[r*b/n,
(r+1)*b/n)`` of each global window (the reference's data-axis sharding),
and the batch ``transform`` runs on that rank-local stack with a generator
seeded by ``SeedSequence([seed, epoch, 1, start])``, ``start`` the window's
first position. So N ranks train on exactly the batches the JAX CLI feeds
N processes. Batches are dicts of tensors on ``device``.

Not ported: the fetch threads (``num_workers``) and the prefetch queue.
"""

from __future__ import annotations

from typing import Callable, Iterator, Protocol

import numpy as np
import torch

from deeplearning_mpi_tpu_torch import resolve_device


class ArrayDataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, index: int) -> dict[str, np.ndarray]: ...


Transform = Callable[[dict[str, np.ndarray], np.random.Generator], dict[str, np.ndarray]]


class Loader:
    """Iterates this rank's rows of global batches of ``batch_size``
    examples of ``dataset``."""

    def __init__(
        self, dataset: ArrayDataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
        drop_last: bool = True, transform: Transform | None = None, num_replicas: int = 1,
        rank: int = 0, device: str | torch.device = "cuda",
    ) -> None:
        if batch_size % num_replicas:
            raise ValueError(f"global batch {batch_size} not divisible by the "
                             f"data-parallel degree {num_replicas}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.transform = transform
        local = batch_size // num_replicas
        #: this rank's rows ``[start, stop)`` of every global window.
        self.rows = (rank * local, (rank + 1) * local)
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

    def local_batch(self, order: np.ndarray, start: int, epoch: int) -> dict[str, np.ndarray]:
        """This rank's host batch of the window at ``start``: fetched,
        stacked, transformed, and marked valid where not wrap-padded."""
        a, b = self.rows
        examples = [self.dataset[int(i)] for i in order[start + a: start + b]]
        stacked = {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}
        if self.transform is not None:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 1, start]))
            stacked = self.transform(stacked, rng)
        if not self.drop_last:
            pos = np.arange(start + a, start + b)
            stacked["__valid__"] = (pos < len(self.dataset)).astype(np.float32)
        return stacked

    def epoch(self, epoch: int) -> Iterator[dict[str, torch.Tensor]]:
        order = self.epoch_order(epoch)
        for start in range(0, len(order), self.batch_size):
            stacked = self.local_batch(order, start, epoch)
            yield {k: torch.from_numpy(v).to(self.device) for k, v in stacked.items()}
