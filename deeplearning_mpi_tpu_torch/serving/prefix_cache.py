"""Radix prefix cache: token prefix -> KV block chain, shared copy-on-write.

Port of ``deeplearning_mpi_tpu/serving/prefix_cache.py`` (pure host-side
Python); its counters are plain attributes here, read by
``ServingEngine.counters`` under the reference's names, and the reference's
registry counters when a ``registry`` is given.

The KV blocks of completed prefills are indexed by their token prefix, so
a later request with the same prefix adopts the blocks instead of
prefilling them again:

- **One trie level is one logical block.** A node's edge is the exact
  ``block_size``-token span one pool block covers. Divergence inside a
  block is partial adoption: the adopter copies the block (copy-on-write,
  ``ServingEngine._phase_cow``) and prefills only the divergent tail.
- **Refcounts, not ownership transfer.** The cache holds one pool
  reference per indexed block (:meth:`PagedKVPool.share`), every adopter
  its own; ``pool.free`` recycles at zero.
- **Frozen spans.** The pool refuses ``record_fill`` / ``record_scale`` on
  a block with refcount > 1, so a cached page is never written in place.
- **LRU eviction** of leaves the cache alone owns (refcount 1), called
  when an allocation fails, before a live request is shed or evicted.

Streams stay token-identical to offline greedy: an adopted block was
written by a completed prefill of the same tokens under the same weights,
and positions from the match point on are prefilled or decoded by the
adopter. Flush the cache when the weights change (:meth:`flush`).
"""

from __future__ import annotations

import zlib
from typing import Any, Sequence

from deeplearning_mpi_tpu_torch.serving.kv_pool import PagedKVPool

__all__ = ["RadixPrefixCache", "prefix_signature"]


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def prefix_signature(tokens: Sequence[int], block_size: int) -> int | None:
    """CRC32 of the first full block span of ``tokens`` (``None`` when the
    prompt has no full block): equal leading blocks, equal signatures, in
    every process (no ``PYTHONHASHSEED`` dependence)."""
    if len(tokens) < block_size:
        return None
    head = ",".join(str(int(t)) for t in tokens[:block_size])
    return zlib.crc32(head.encode("ascii"))


class _Node:
    """One cached block; ``span`` is the token span its pages cover: a full
    node (``len(span) == block_size``) may have ``children`` and
    ``partials``, a partial leaf is the frozen tail of a completed prompt."""

    __slots__ = ("span", "block", "parent", "children", "partials", "last_used")

    def __init__(self, span: tuple[int, ...], block: int, parent: "_Node | None"):
        self.span = span
        self.block = block
        self.parent = parent
        self.children: dict[tuple[int, ...], _Node] = {}
        self.partials: list[_Node] = []
        self.last_used = 0


#: each registry counter's counting attribute
_COUNTERS = {
    "serve_prefix_hits_total": "hits",
    "serve_prefix_tokens_reused_total": "tokens_reused",
    "serve_prefix_cow_copies_total": "cow_copies",
    "serve_prefix_evictions_total": "evictions",
}


class RadixPrefixCache:
    """Block-granularity radix index over completed prompt prefixes."""

    def __init__(self, pool: PagedKVPool, *, registry: Any = None) -> None:
        self.pool = pool
        self.registry = registry
        self.block_size = pool.block_size
        self.root = _Node((), -1, None)
        self._tick = 0
        self.num_nodes = 0
        #: adoptions that landed / tokens they skipped / copy-on-write copies
        #: / blocks pruned (``serve_prefix_{hits,tokens_reused,cow_copies,
        #: evictions}_total`` in the reference's registry)
        self.hits = 0
        self.tokens_reused = 0
        self.cow_copies = 0
        self.evictions = 0
        if registry is not None:
            for name in _COUNTERS:
                registry.counter(name)

    def _inc(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (its canonical schema name) and
        to the attribute that mirrors it."""
        attr = _COUNTERS[name]
        setattr(self, attr, getattr(self, attr) + n)
        if self.registry is not None:
            self.registry.counter(name).inc(n)

    def note_hit(self, tokens_reused: int) -> None:
        """The scheduler's call once an adoption lands (a match that fails
        admission is not a hit)."""
        self._inc("serve_prefix_hits_total")
        self._inc("serve_prefix_tokens_reused_total", tokens_reused)

    def note_cow(self) -> None:
        """The engine's call per completed copy-on-write block copy."""
        self._inc("serve_prefix_cow_copies_total")

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- lookup -------------------------------------------------------------
    def match(self, prompt: Sequence[int]) -> tuple[int, list[int], tuple[int, int] | None]:
        """Longest cached prefix of ``prompt``: ``(fill, chain, partial)``.
        ``fill`` matched tokens (at most ``len(prompt) - 1``: the last
        position is always prefilled, for the first token's logits),
        ``chain`` the fully adopted blocks, ``partial`` ``None`` or
        ``(src_block, lcp_len)``, a block whose first ``lcp_len`` rows match
        and which must be copied before the adopter writes its tail. Shares
        nothing: the caller pins what it adopts."""
        toks = [int(t) for t in prompt]
        limit = len(toks) - 1
        bs = self.block_size
        node = self.root
        chain: list[int] = []
        fill = 0
        while fill + bs <= limit:
            child = node.children.get(tuple(toks[fill:fill + bs]))
            if child is None:
                break
            chain.append(child.block)
            fill += bs
            node = child
            self._touch(node)
        # Partial adoption inside the next block: the best common prefix over
        # this node's partial leaves and its full children's leading rows.
        rest = toks[fill:limit]
        best: _Node | None = None
        best_len = 0
        for pn in node.partials:
            n = _lcp(pn.span, rest)
            if n > best_len:
                best, best_len = pn, n
        for span, child in node.children.items():
            n = _lcp(span, rest)
            if n > best_len:
                best, best_len = child, n
        if best is not None and best_len > 0:
            self._touch(best)
            return fill + best_len, chain, (best.block, best_len)
        return fill, chain, None

    # -- insertion ----------------------------------------------------------
    def insert(self, prompt: Sequence[int], blocks: Sequence[int], frozen: int) -> None:
        """Index the first ``frozen`` positions of ``prompt``, whose KV lives
        in ``blocks`` (the owner's block list). Called at prefill completion
        with ``frozen`` rounded down to a block boundary and at finish with
        the whole prompt (its tail block is frozen only then). Incumbent
        nodes win."""
        bs = self.block_size
        toks = [int(t) for t in prompt[:frozen]]
        node = self.root
        i = 0
        while i + bs <= frozen:
            key = tuple(toks[i:i + bs])
            child = node.children.get(key)
            if child is None:
                b = blocks[i // bs]
                self.pool.share([b])
                child = _Node(key, b, node)
                node.children[key] = child
                self.num_nodes += 1
            self._touch(child)
            node = child
            i += bs
        rem = tuple(toks[i:frozen])
        if not rem:
            return
        b = blocks[i // bs]
        for pn in node.partials:
            n = _lcp(pn.span, rem)
            if n == len(pn.span):
                if len(rem) > len(pn.span):
                    # Ours freezes more rows of the same span: the cache's
                    # reference moves to our block (live adopters keep the
                    # old one alive).
                    self.pool.share([b])
                    self.pool.free([pn.block])
                    pn.block = b
                    pn.span = rem
                self._touch(pn)
                return
            if n == len(rem):
                # An incumbent already freezes a superspan of ours.
                self._touch(pn)
                return
        self.pool.share([b])
        pn = _Node(rem, b, node)
        node.partials.append(pn)
        self.num_nodes += 1
        self._touch(pn)

    # -- eviction / teardown ------------------------------------------------
    def _leaves(self) -> list[_Node]:
        out: list[_Node] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children or child.partials:
                    stack.append(child)
                else:
                    out.append(child)
            out.extend(node.partials)
        return out

    def _remove(self, node: _Node) -> None:
        parent = node.parent
        if parent is None or node.children or node.partials:
            raise ValueError("only a leaf of the trie can be removed")
        if len(node.span) == self.block_size:
            del parent.children[node.span]
        else:
            parent.partials.remove(node)
        self.pool.free([node.block])
        self.num_nodes -= 1

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks by pruning the least recently matched
        leaves the cache alone owns; returns how many were recycled."""
        freed = 0
        while freed < n:
            victim: _Node | None = None
            for leaf in self._leaves():
                if self.pool.refcount(leaf.block) != 1:
                    continue
                if victim is None or leaf.last_used < victim.last_used:
                    victim = leaf
            if victim is None:
                break
            self._remove(victim)
            freed += 1
            self._inc("serve_prefix_evictions_total")
        return freed

    def flush(self) -> int:
        """Drop every cached block (one pool reference each) and reset the
        trie; returns how many references were dropped."""
        blocks = self.referenced_blocks()
        if blocks:
            self.pool.free(blocks)
        self.root = _Node((), -1, None)
        self.num_nodes = 0
        return len(blocks)

    # -- recovery -----------------------------------------------------------
    def referenced_blocks(self) -> list[int]:
        """Every block the cache references, one entry each: crash recovery
        hands them to ``pool.reconcile`` (an insert follows its owner's
        first-token sync, so cached pages are known to have landed)."""
        out: list[int] = []
        stack = list(self.root.children.values()) + list(self.root.partials)
        while stack:
            node = stack.pop()
            out.append(node.block)
            stack.extend(node.children.values())
            stack.extend(node.partials)
        return out

    @property
    def num_blocks_cached(self) -> int:
        return self.num_nodes
