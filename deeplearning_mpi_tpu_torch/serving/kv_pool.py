"""Paged KV-cache pool: fixed-size blocks, free-list allocation, block tables.

Port of ``deeplearning_mpi_tpu/serving/kv_pool.py`` (host-side accounting
and the reference's opt-in sanitizer hooks, ``analysis.sanitizer``). ONE
preallocated device pool of ``num_blocks`` blocks per layer, a host-side
free list, and a per-sequence block table mapping logical positions to pool
blocks. Block 0 is the reserved scratch block: inactive slots and padded
prefill rows route their writes there.

Invariants (checked by :meth:`PagedKVPool.check`): free + in-use =
``num_blocks - 1``; no block both free and allocated; allocation is
all-or-nothing. Shared blocks (refcount > 1) may not be written. With
``DMT_SANITIZE=1`` at construction, freed blocks are poisoned until
allocated again, so a double free, a use after free, a refcount underflow
and a write to a shared block raise classified ``SanitizerError``s.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Iterable

import torch

from deeplearning_mpi_tpu_torch.analysis import sanitizer as _sanitizer

__all__ = ["PagedKVPool", "SCRATCH_BLOCK", "init_kv_buffers"]

#: Block id reserved for writes that must land nowhere. Never on the free list.
SCRATCH_BLOCK = 0


class PagedKVPool:
    """Free-list allocator over ``num_blocks`` KV blocks of ``block_size``
    token positions each. Host-side accounting only."""

    def __init__(self, num_blocks: int, block_size: int, *, kv_dtype: Any = None) -> None:
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 scratch + 1 usable), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_dtype = kv_dtype
        # Descending so pop() hands out the lowest id first.
        self._free: list[int] = list(range(num_blocks - 1, SCRATCH_BLOCK, -1))
        self._used: set[int] = set()
        # Sparse refcounts: only counts > 1 are stored.
        self._refcount: dict[int, int] = {}
        self.total_allocated = 0
        self.total_freed = 0
        self._fill_epoch: dict[int, int] = {}
        self._scale_epoch: dict[int, int] = {}
        self._san = _sanitizer.KVPoolSanitizer() if _sanitizer.enabled() else None

    @property
    def quantized(self) -> bool:
        """True when the device pools store integer KV + separate scales."""
        return self.kv_dtype is not None and not self.kv_dtype.is_floating_point

    @property
    def capacity(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._used)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` positions."""
        return -(-num_tokens // self.block_size)

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` blocks off the free list, or ``None`` if fewer than
        ``n`` are free (all-or-nothing)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._used.update(blocks)
        self.total_allocated += n
        if self._san is not None:
            self._san.on_alloc(blocks)
        return blocks

    def share(self, blocks: Iterable[int]) -> None:
        """Add one owner to each of ``blocks`` (all already allocated)."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._used:
                raise ValueError(f"sharing block {b} that is not allocated")
        for b in blocks:
            self._refcount[b] = self._refcount.get(b, 1) + 1

    def refcount(self, block: int) -> int:
        """Owners of ``block`` (0 if it is not allocated at all)."""
        if block not in self._used:
            return 0
        return self._refcount.get(block, 1)

    def free(self, blocks: Iterable[int]) -> None:
        """Drop one reference per block; recycle at refcount zero. Freeing
        a block that is not allocated raises (classified by the sanitizer as
        a double free when the block is poisoned)."""
        blocks = list(blocks)
        if self._san is not None:
            self._san.check_free(blocks, self._used)
        recycled = []
        for b in blocks:
            if b not in self._used:
                raise ValueError(f"freeing block {b} that is not allocated")
            rc = self._refcount.get(b, 1)
            if rc < 1:
                msg = (f"refcount underflow on KV block {b}: count {rc} with the block "
                       "still in the used set — a sharer was freed twice or the books were torn")
                if self._san is not None:
                    _sanitizer.trip(_sanitizer.KV_REFCOUNT_UNDERFLOW, msg)
                raise ValueError(msg)
            if rc > 1:
                if rc == 2:
                    self._refcount.pop(b, None)
                else:
                    self._refcount[b] = rc - 1
                continue
            self._refcount.pop(b, None)
            self._used.remove(b)
            self._free.append(b)
            self.total_freed += 1
            self._fill_epoch.pop(b, None)
            self._scale_epoch.pop(b, None)
            recycled.append(b)
        if self._san is not None and recycled:
            self._san.on_free(recycled)

    def _check_cow(self, b: int, kind: str) -> None:
        if self._refcount.get(b, 1) > 1:
            msg = (f"{kind} write recorded against shared KV block {b} (refcount "
                   f"{self._refcount[b]}): the writer skipped copy-on-write and is mutating "
                   "pages other sharers still read")
            if self._san is not None:
                _sanitizer.trip(_sanitizer.KV_COW_VIOLATION, msg)
            raise ValueError(msg)

    def record_fill(self, blocks: Iterable[int]) -> None:
        """Note that KV *data* was scattered into ``blocks`` this step."""
        blocks = list(blocks)
        if self._san is not None:
            self._san.check_touch(blocks, self._used, "data")
        for b in blocks:
            if b == SCRATCH_BLOCK:
                continue
            if b not in self._used:
                raise ValueError(f"recording fill of unallocated block {b}")
            self._check_cow(b, "data")
            self._fill_epoch[b] = self._fill_epoch.get(b, 0) + 1

    def record_scale(self, blocks: Iterable[int]) -> None:
        """Note that *scale* rows were scattered into ``blocks`` (quantized
        pools only)."""
        blocks = list(blocks)
        if self._san is not None:
            self._san.check_touch(blocks, self._used, "scale")
        for b in blocks:
            if b == SCRATCH_BLOCK:
                continue
            if b not in self._used:
                raise ValueError(f"recording scale of unallocated block {b}")
            self._check_cow(b, "scale")
            self._scale_epoch[b] = self._scale_epoch.get(b, 0) + 1

    def reconcile(self, live_blocks: Iterable[int]) -> dict[str, int]:
        """Rebuild the free list from the blocks live sequences still own
        (crash recovery); duplicates count as extra references."""
        counts = Counter(live_blocks)
        live = set(counts)
        if SCRATCH_BLOCK in live:
            raise ValueError("scratch block claimed as live")
        bad = [b for b in live if not (0 < b < self.num_blocks)]
        if bad:
            raise ValueError(f"live block ids out of range: {bad}")
        reclaimed = self._used - live
        adopted = live - self._used
        self.total_freed += len(reclaimed)
        self.total_allocated += len(adopted)
        self._used = set(live)
        self._refcount = {b: c for b, c in counts.items() if c > 1}
        self._free = sorted(set(range(SCRATCH_BLOCK + 1, self.num_blocks)) - live, reverse=True)
        self._fill_epoch = {b: self._fill_epoch.get(b, 0) for b in live}
        if self.quantized:
            self._scale_epoch = dict(self._fill_epoch)
        else:
            self._scale_epoch = {b: self._scale_epoch.get(b, 0) for b in live}
        return {"reclaimed": len(reclaimed), "adopted": len(adopted)}

    def check(self) -> None:
        """Raise AssertionError if any pool invariant is violated."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate ids on the free list"
        assert not (free & self._used), "block both free and allocated"
        assert SCRATCH_BLOCK not in free and SCRATCH_BLOCK not in self._used, (
            "scratch block entered circulation"
        )
        assert len(free) + len(self._used) == self.capacity, (
            f"leak: {len(free)} free + {len(self._used)} used != {self.capacity}"
        )
        stray = (set(self._fill_epoch) | set(self._scale_epoch)) - self._used
        assert not stray, f"write epochs recorded for non-live blocks {stray}"
        rc_stray = set(self._refcount) - self._used
        assert not rc_stray, f"refcounts recorded for non-live blocks {rc_stray}"
        rc_bad = {b: c for b, c in self._refcount.items() if c <= 1}
        assert not rc_bad, f"non-sparse refcounts {rc_bad}"
        if self.quantized:
            torn = [
                b for b in self._used
                if self._fill_epoch.get(b, 0) != self._scale_epoch.get(b, 0)
            ]
            assert not torn, f"stale scales: data/scale write epochs diverge on {torn}"


def init_kv_buffers(
    num_layers: int, num_blocks: int, block_size: int, kv_heads: int,
    head_dim: int, kv_dtype: torch.dtype, device: torch.device | str,
) -> tuple[torch.Tensor, ...]:
    """Zero-initialised device pools ``(k, v)``, each ``[num_layers,
    num_blocks, block_size, kv_heads, head_dim]`` (zeros, never
    ``torch.empty``: a masked weight times a NaN row is NaN). Integer
    storage adds float32 scale pools ``[num_layers, num_blocks, block_size,
    kv_heads]`` initialised to 1."""
    shape = (num_layers, num_blocks, block_size, kv_heads, head_dim)
    k = torch.zeros(shape, dtype=kv_dtype, device=device)
    v = torch.zeros(shape, dtype=kv_dtype, device=device)
    if kv_dtype.is_floating_point:
        return k, v
    sshape = shape[:-1]
    return (k, v, torch.ones(sshape, device=device), torch.ones(sshape, device=device))
