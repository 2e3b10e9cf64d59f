"""Batch loader with the reference's batch order, one process or many.

Port of ``deeplearning_mpi_tpu/data/loader.py``'s ``ShardedLoader``: a
per-epoch shuffle seeded by ``SeedSequence([seed, epoch])`` over the whole
index space (the same on every rank), whole GLOBAL batches of
``batch_size`` only with ``drop_last`` (the default), and otherwise a tail
padded by wrapping around to the front, its duplicate rows marked 0 in
``__valid__``. ``rank`` / ``num_replicas`` are the process's coordinate on
the mesh's DATA axis and its size (the processes of one expert group share
a coordinate and feed the same rows): rank ``r`` of ``n`` takes rows
``[r*b/n, (r+1)*b/n)`` of each global window (the reference's data-axis
sharding). Under ``grad_accum = A`` it takes instead its share of each of
the reference's ``A`` contiguous global chunks, rows ``i*b/A + r*b/(A*n) +
j`` for ``i < A``, ``j < b/(A*n)``, in that order, so the train step's
``x.chunk(A)[i]`` is its part of the reference's chunk ``i`` (at ``A = 1``
the two are one block). The batch ``transform`` runs, as in the
reference, on a process-local block ``[p*b/n, (p+1)*b/n)`` with a generator
seeded by ``SeedSequence([seed, epoch, 1, start])``, ``start`` the window's
first position, so a row's augmentation draw is the one of its position in
that block. At ``A = 1`` the block is the rank's own rows; under ``A > 1``
the rank fetches and transforms each block that holds one of its rows and
keeps its rows. So N ranks train on exactly the batches the JAX CLI feeds
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
        rank: int = 0, grad_accum: int = 1, device: str | torch.device = "cuda",
    ) -> None:
        if batch_size % num_replicas:
            raise ValueError(f"global batch {batch_size} not divisible by the "
                             f"data-parallel degree {num_replicas}")
        if batch_size % (grad_accum * num_replicas):
            raise ValueError(
                f"global batch {batch_size} not divisible by grad_accum ({grad_accum}) x "
                f"the data-parallel degree ({num_replicas}): each accumulation chunk must "
                "split evenly over the data axis")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.transform = transform
        chunk = batch_size // grad_accum
        share = chunk // num_replicas
        #: this rank's row offsets in every global window (module docstring).
        self.rows = np.concatenate([np.arange(i * chunk + rank * share,
                                              i * chunk + (rank + 1) * share)
                                    for i in range(grad_accum)])
        #: the reference's process-local blocks that hold this rank's rows,
        #: and where each row lies in those blocks stacked in order.
        self.block = batch_size // num_replicas
        self.blocks = np.unique(self.rows // self.block)
        self.pick = (np.searchsorted(self.blocks, self.rows // self.block) * self.block
                     + self.rows % self.block)
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
        if self.transform is None:
            stacked = self._fetch(order[start + self.rows])
        else:
            parts = []
            for p in self.blocks:
                first = start + p * self.block
                rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 1, start]))
                parts.append(self.transform(self._fetch(order[first:first + self.block]), rng))
            stacked = {k: np.concatenate([part[k] for part in parts])[self.pick]
                       for k in parts[0]}
        if not self.drop_last:
            pos = start + self.rows
            stacked["__valid__"] = (pos < len(self.dataset)).astype(np.float32)
        return stacked

    def _fetch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        examples = [self.dataset[int(i)] for i in indices]
        return {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}

    def epoch(self, epoch: int) -> Iterator[dict[str, torch.Tensor]]:
        order = self.epoch_order(epoch)
        for start in range(0, len(order), self.batch_size):
            stacked = self.local_batch(order, start, epoch)
            yield {k: torch.from_numpy(v).to(self.device) for k, v in stacked.items()}
