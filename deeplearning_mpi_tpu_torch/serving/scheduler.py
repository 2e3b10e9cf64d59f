"""Continuous-batching scheduler: admission, deadlines, eviction.

A copy of ``deeplearning_mpi_tpu/serving/scheduler.py`` (pure host-side
Python) importing this package's ``kv_pool``; the registry's shed counters
go to a plain dict (``counters``) under the reference's names.

The batching model the offline CLI uses — collect a batch, run it to
completion, collect the next — leaves decode slots idle from the moment
their sequence finishes until the whole batch drains (the straggler tax
grows with batch size and output-length variance). Continuous batching
(Orca-style iteration-level scheduling; the Podracer paper's same
decoupling for RL actors) refills each slot the moment it frees: the
engine's jitted step has a FIXED shape (``max_slots`` rows), and this
scheduler decides, between steps, which request occupies which row.

Policies (deliberately simple, deterministic, and host-side — every one of
them is exercised by ``tests/test_serving.py`` under a fake clock):

- **Bounded queue**: ``submit`` on a full queue sheds the request
  immediately (backpressure at the door beats unbounded memory growth —
  the load-shedding half of admission control).
- **Length admission**: a request whose ``prompt + max_new_tokens`` cannot
  fit a slot's block budget (``max_seq_len``) is rejected at submit; it
  could never complete, so admitting it would only waste KV blocks.
- **Deadlines**: an optional per-request deadline (absolute, same clock as
  the engine's); queued requests past it are shed at the next step —
  serving a reply the client stopped waiting for is pure waste.
- **FCFS admission**: queued requests enter free slots in arrival order,
  each taking its prompt's KV blocks up front (all-or-nothing, so a
  half-admitted request can't deadlock the pool). With a prefix cache
  attached, a matched prompt prefix adopts cached blocks instead of
  allocating + re-prefilling them (``serving/prefix_cache.py``).
- **Per-tenant budgets and priorities** (``tenants=``): a tenant whose
  committed tokens (prompt + max_new over queued + running) would exceed
  its budget is shed at submit with reason ``tenant_budget``; non-zero
  priorities reorder admission (higher first, arrival ties FCFS).
- **Oldest-first eviction on OOM pressure**: when a decoding sequence
  needs one more KV block and the pool is empty, the OLDEST running
  request is shed and its blocks reclaimed. Oldest-first is the
  deterministic, starvation-free choice here: the engine frees the
  largest allocation (oldest ≈ longest), and a fresh request can't be
  starved forever by an earlier long-runner.
- **Bucketed decode-batch formation** (``decode_buckets``): decode cost
  per step is dominated by streaming the weights, so a batch of 2 costs
  nearly what a batch of 16 does — dispatching tiny batches while the
  queue holds admissible work squanders the step. With buckets
  configured (e.g. ``(8, 16, 32)``), :meth:`hold_decode` tells the
  engine to SKIP the decode phase for up to ``max_hold_steps``
  consecutive steps while admission + prefill supply could still grow
  the decode batch toward the largest reachable bucket. Holding never
  changes any request's tokens (decode is delayed, not reordered) and
  cannot livelock: with no supply in sight the hold ends immediately,
  and the step budget bounds it otherwise.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Optional

import numpy as np

from deeplearning_mpi_tpu_torch.serving.kv_pool import PagedKVPool

__all__ = ["Request", "RequestState", "Scheduler", "labeled"]


def labeled(name: str, **labels: str) -> str:
    """The reference registry's labeled counter name, ``name{k="v",...}``
    (keys sorted)."""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    #: Shed by admission control (queue full / too long / deadline) or
    #: evicted under OOM pressure; ``generated`` holds any partial output.
    SHED = "shed"


@dataclasses.dataclass
class Request:
    """One generation request and its full lifecycle record."""

    rid: int
    prompt: np.ndarray  # 1-D int32 token ids
    max_new_tokens: int
    arrival: float = 0.0
    deadline: Optional[float] = None  # absolute time; None = no deadline
    #: multi-tenant accounting/priority key; budgets and priorities are
    #: configured per tenant on the Scheduler, not per request
    tenant: str = "default"

    state: RequestState = RequestState.QUEUED
    #: why a SHED request was shed: "queue_full" | "too_long" | "deadline"
    #: | "evicted" | "spec_overflow" (KV pool could not cover the request's
    #: own next position while assembling a speculative verify batch)
    #: | "tenant_budget" (the tenant's committed-token budget is spent)
    #: | "brownout" (overload ladder: low-priority or tight-deadline
    #: traffic rejected at the door while the fleet is saturated)
    shed_reason: Optional[str] = None
    slot: Optional[int] = None
    blocks: list[int] = dataclasses.field(default_factory=list)
    #: tokens generated so far (the first comes from the prefill logits)
    generated: list[int] = dataclasses.field(default_factory=list)
    #: prompt positions prefilled so far (chunk cursor)
    prefilled: int = 0

    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    #: prefill→decode handoff dwell stamps (disaggregated engines only):
    #: detached from the prefill scheduler / adopted by the decode peer.
    t_detached: Optional[float] = None
    t_adopted: Optional[float] = None
    #: cross-process trace correlation key (the fleet rid, carried over the
    #: JSONL IPC); None falls back to the engine-local rid at span time.
    trace: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def length(self) -> int:
        """Known tokens: prompt + generated."""
        return self.prompt_len + len(self.generated)

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival -> first generated token)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token over the decode phase (first token
        excluded — it belongs to prefill/TTFT)."""
        if self.t_finished is None or self.t_first_token is None:
            return None
        steps = max(len(self.generated) - 1, 1)
        return (self.t_finished - self.t_first_token) / steps


class Scheduler:
    """Slot + queue bookkeeping between engine steps (host-side, no device
    work). The engine calls, in step order: :meth:`shed_expired`,
    :meth:`admit`, :meth:`grow` (per decoding slot), :meth:`finish`."""

    def __init__(
        self,
        pool: PagedKVPool,
        *,
        max_slots: int,
        max_seq_len: int,
        max_queue: int = 64,
        decode_buckets: tuple[int, ...] = (),
        max_hold_steps: int = 4,
        prefix_cache: Any = None,
        tenants: dict[str, dict[str, Any]] | None = None,
        brownout_min_deadline_s: float = 0.25,
        counters: dict[str, int] | None = None,
    ) -> None:
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if any(b < 1 for b in decode_buckets):
            raise ValueError(f"decode_buckets must be >= 1: {decode_buckets}")
        self.pool = pool
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.max_queue = max_queue
        self.decode_buckets = tuple(sorted(decode_buckets))
        self.max_hold_steps = max_hold_steps
        self._hold_steps = 0
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * max_slots
        self.shed_count = 0
        self.evicted_count = 0
        #: ``serve_shed_total`` (plain and by reason) and, for door policy,
        #: ``serve_tenant_shed_total`` by tenant; the engine passes its own
        #: counters dict
        self.counters = counters if counters is not None else {}
        self.counters.setdefault("serve_shed_total", 0)
        #: optional RadixPrefixCache (serving/prefix_cache.py) consulted at
        #: admission; shared with the engine, and in the disaggregated
        #: topology with the sibling role's scheduler.
        self.prefix_cache = prefix_cache
        #: per-tenant config: name -> {"budget_tokens": int (0 = unlimited),
        #: "priority": float (higher admits first)}. Unknown tenants get
        #: unlimited budget at priority 0.
        self.tenants: dict[str, dict[str, Any]] = dict(tenants or {})
        #: overload brownout ladder stage (``set_brownout``): 0 = off,
        #: 1+ = shed lowest-priority tenants at the door, 2+ = the engine
        #: additionally disables speculative drafts, 3 = additionally shed
        #: requests whose deadline budget is under the floor below.
        self.brownout_stage = 0
        self.brownout_min_deadline_s = brownout_min_deadline_s
        #: pending copy-on-write jobs from matched-prefix admissions:
        #: (src_block, dst_block, request). The engine drains this each
        #: step (``_phase_cow``) BEFORE prefilling; src carries an extra
        #: pool reference (pin) until the copy lands or the request dies.
        self.pending_cow: list[tuple[int, int, Request]] = []

    # -- submission ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit to the queue, or shed immediately (returns False)."""
        total = req.prompt_len + req.max_new_tokens
        if total > self.max_seq_len:
            self._shed(req, "too_long")
            return False
        if len(self.queue) >= self.max_queue:
            self._shed(req, "queue_full")
            return False
        if self.brownout_stage >= 1 and self.tenants:
            # Stage 1+: shed only tenants strictly BELOW the top priority
            # tier — paying / deadline-priority tenants keep admitting
            # until capacity itself runs out (queue_full / tenant_budget
            # still apply). With no tiers configured (or all tiers equal)
            # there is no "lowest tenant" to sacrifice and the gate is
            # inert; stages 2-3 still bite via the draft kill-switch and
            # the deadline floor.
            top = max(
                float(c.get("priority", 0.0)) for c in self.tenants.values()
            )
            if self._tenant_priority(req) < top:
                self._shed(req, "brownout")
                return False
        if (
            self.brownout_stage >= 3
            and req.deadline is not None
            and req.deadline - req.arrival < self.brownout_min_deadline_s
        ):
            # Stage 3: raise the deadline floor — a request with almost no
            # SLO budget left would burn prefill only to be deadline-shed;
            # reject it at the door instead.
            self._shed(req, "brownout")
            return False
        budget = int(self.tenants.get(req.tenant, {}).get("budget_tokens", 0))
        if budget > 0:
            committed = self.tenant_tokens_in_flight().get(req.tenant, 0)
            if committed + total > budget:
                self._shed(req, "tenant_budget")
                return False
        req.state = RequestState.QUEUED
        self.queue.append(req)
        return True

    # -- multi-tenancy ------------------------------------------------------
    def tenant_tokens_in_flight(self) -> dict[str, int]:
        """Committed tokens (``prompt + max_new``) per tenant over queued +
        running requests — the quantity budgets are enforced against.
        Committed (not consumed-so-far) makes the budget a worst-case HBM
        and compute bound a tenant cannot exceed by racing submissions."""
        out: dict[str, int] = {}
        for req in list(self.queue) + self.running():
            out[req.tenant] = (
                out.get(req.tenant, 0) + req.prompt_len + req.max_new_tokens
            )
        return out

    def _tenant_priority(self, req: Request) -> float:
        return float(self.tenants.get(req.tenant, {}).get("priority", 0.0))

    def set_brownout(self, stage: int) -> None:
        """Move the overload brownout ladder (0 clears it). Monotonic per
        call site only by convention — the supervisor drives both
        escalation and the clear."""
        self.brownout_stage = int(stage)

    # -- per-step phases ----------------------------------------------------
    def shed_expired(self, now: float) -> list[Request]:
        """Drop queued requests whose deadline has passed."""
        kept: deque[Request] = deque()
        shed = []
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                self._shed(req, "deadline")
                shed.append(req)
            else:
                kept.append(req)
        self.queue = kept
        return shed

    def admit(self, now: float) -> list[Request]:
        """Move queued requests into free slots, each taking its prompt's
        KV blocks up front. Order is arrival (FCFS) unless tenant
        priorities are configured, in which case higher-priority tenants
        admit first (ties broken by arrival, then rid — deterministic).
        Stops at the first request the pool can't serve (skipping ahead
        would starve long prompts). With a prefix cache attached, a
        matched prompt prefix adopts the cached blocks (shared,
        refcounted) and only the private tail is allocated — the request
        enters PREFILL with ``prefilled`` already at the match point."""
        admitted = []
        if any(
            float(cfg.get("priority", 0.0)) != 0.0
            for cfg in self.tenants.values()
        ):
            order = sorted(
                self.queue,
                key=lambda r: (-self._tenant_priority(r), r.arrival, r.rid),
            )
        else:
            order = list(self.queue)
        for req in order:
            if None not in self.slots:
                break
            if not self._admit_one(req, now):
                break  # KV pressure: stays queued, retried next step
            self.queue.remove(req)
            admitted.append(req)
        return admitted

    def _admit_one(self, req: Request, now: float) -> bool:
        """Allocate (or adopt) blocks for ``req`` and seat it. Returns
        False when the pool cannot cover the private tail even after
        evicting unreferenced cache branches."""
        n_total = self.pool.blocks_for(req.prompt_len)
        fill, chain, partial = 0, [], None
        if self.prefix_cache is not None:
            fill, chain, partial = self.prefix_cache.match(req.prompt)
        n_full = fill // self.pool.block_size
        priv = self.pool.alloc(n_total - n_full)
        if priv is None and self.prefix_cache is not None:
            deficit = (n_total - n_full) - self.pool.available
            if self.prefix_cache.evict(deficit) > 0:
                # Eviction may have pruned the very branch we matched (the
                # cache was its sole owner until the share below) — re-match
                # rather than adopt freed blocks.
                fill, chain, partial = self.prefix_cache.match(req.prompt)
                n_full = fill // self.pool.block_size
                priv = self.pool.alloc(n_total - n_full)
        if priv is None:
            return False
        if n_full:
            self.pool.share(chain)
        if partial is not None:
            # Pin the CoW source with an extra reference until the engine
            # copies it into priv[0]; _release unpins if the request dies
            # before the copy runs.
            self.pool.share([partial[0]])
            self.pending_cow.append((partial[0], priv[0], req))
        if fill:
            self.prefix_cache.note_hit(fill)
        slot = self.slots.index(None)
        req.slot = slot
        req.blocks = chain + priv
        req.state = RequestState.PREFILL
        req.prefilled = fill
        req.t_admitted = now
        self.slots[slot] = req
        return True

    def grow(self, req: Request, *, shed_reason: str = "evicted") -> bool:
        """Give ``req`` one more KV block, evicting under OOM pressure.

        Returns False iff ``req`` itself was shed (it was the oldest, or
        eviction could not free a block) — the caller must drop it from
        the step. ``shed_reason`` labels THAT self-shed in
        ``serve_shed_total{reason=...}`` (the speculative engine passes
        ``"spec_overflow"``: the pool could not cover the request while a
        verify batch was being assembled); victims evicted on the way are
        always labeled ``"evicted"``.
        """
        while True:
            blocks = self.pool.alloc(1)
            if blocks is not None:
                req.blocks.extend(blocks)
                return True
            if self.prefix_cache is not None and self.prefix_cache.evict(1):
                continue  # an unreferenced cache branch paid for the block
            victim = self._oldest_running()
            if victim is None or victim is req:
                # Nothing older to evict: shed the requester. (victim is
                # req covers the pathological one-slot pool-exhausted
                # case — self-eviction, not an infinite loop.)
                self.evict(req, reason=shed_reason)
                return False
            self.evict(victim)

    def evict(self, req: Request, *, reason: str = "evicted") -> None:
        """Shed a RUNNING request and reclaim its blocks."""
        self._release(req)
        self._shed(req, reason)
        self.evicted_count += 1

    def shrink(self, req: Request, keep: int) -> list[int]:
        """Return ``req``'s tail blocks past the first ``keep`` to the
        free list and report exactly which ids went back (speculative
        rollback: surplus blocks allocated for rejected proposals). KV
        *content* is never rolled back — garbage rows past the accepted
        prefix sit at positions the next step overwrites before they
        become causally visible (docs/SERVING.md)."""
        tail = req.blocks[keep:]
        if tail:
            self.pool.free(tail)
            del req.blocks[keep:]
        return tail

    def hold_decode(self, n_decoding: int) -> bool:
        """Should the engine skip this step's decode phase to let a larger
        batch form? True only while buckets are configured, the current
        batch is below the largest bucket that admission + prefill supply
        could still reach, and the consecutive-hold budget
        (``max_hold_steps``) has not been spent."""
        if not self.decode_buckets or n_decoding <= 0:
            self._hold_steps = 0
            return False
        free_slots = sum(r is None for r in self.slots)
        prefilling = sum(
            r is not None and r.state is RequestState.PREFILL
            for r in self.slots
        )
        # Upper bound on how large the decode batch could grow if the
        # engine spends steps on supply instead of decode.
        potential = n_decoding + prefilling + min(len(self.queue), free_slots)
        feasible = min(potential, self.max_slots)
        reachable = [b for b in self.decode_buckets if b <= feasible]
        target = max(reachable) if reachable else feasible
        if n_decoding >= target or self._hold_steps >= self.max_hold_steps:
            self._hold_steps = 0
            return False
        self._hold_steps += 1
        return True

    def cancel(self, req: Request) -> bool:
        """Shed ``req`` at the caller's request (hedged-retry dedup: the
        other copy of this request already won). A queued request leaves
        the queue; a running one is evicted and its blocks reclaimed.
        Returns False when ``req`` is already finished or shed — cancels
        race completions by design, and losing that race is a no-op."""
        if req.state is RequestState.QUEUED:
            try:
                self.queue.remove(req)
            except ValueError:
                return False
            self._shed(req, "cancelled")
            return True
        if req.state in (RequestState.PREFILL, RequestState.DECODE):
            self.evict(req, reason="cancelled")
            return True
        return False

    # -- disaggregated handoff ----------------------------------------------
    def detach(self, req: Request) -> None:
        """Vacate ``req``'s slot WITHOUT releasing its KV blocks — the
        prefill half of a disaggregated handoff (``serving/disagg.py``).
        The request keeps its block table, generated tokens, and timing
        record; ownership of the pages travels with it to whichever
        scheduler :meth:`adopt`\\ s it next. Both schedulers must share one
        :class:`PagedKVPool` for that transfer to be meaningful."""
        if req.slot is None:
            raise ValueError(f"detaching request {req.rid} that holds no slot")
        self.slots[req.slot] = None
        req.slot = None

    def adopt(self, req: Request) -> bool:
        """Install a detached request into a free slot — the decode half of
        a disaggregated handoff. No allocation happens: the request arrives
        already owning its blocks (written by the prefill engine through
        the shared pool). Returns False when no slot is free; the caller
        keeps the request in its handoff queue and retries next step."""
        if req.slot is not None:
            raise ValueError(f"adopting request {req.rid} that holds a slot")
        if None not in self.slots:
            return False
        slot = self.slots.index(None)
        req.slot = slot
        self.slots[slot] = req
        return True

    def finish(self, req: Request, now: float) -> None:
        req.t_finished = now
        req.state = RequestState.FINISHED
        self._release(req)

    # -- queries ------------------------------------------------------------
    def running(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def queue_depth(self) -> int:
        return len(self.queue)

    def slots_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def idle(self) -> bool:
        return not self.queue and not any(self.slots)

    # -- internals ----------------------------------------------------------
    def _oldest_running(self) -> Optional[Request]:
        running = self.running()
        return min(running, key=lambda r: r.arrival) if running else None

    def take_pending_cow(self) -> list[tuple[int, int, Request]]:
        """Drain the CoW job list (engine ``_phase_cow``)."""
        jobs, self.pending_cow = self.pending_cow, []
        return jobs

    def clear_pending_cow(self) -> None:
        """Drop pending CoW jobs WITHOUT unpinning (crash recovery only:
        ``pool.reconcile`` is about to rebuild every refcount from ground
        truth, so freeing the pins here would double-count)."""
        self.pending_cow = []

    def _release(self, req: Request) -> None:
        if self.pending_cow:
            # A request dying between admission and its CoW copy must unpin
            # the copy source, or the pin would strand the cached block.
            keep = []
            for src, dst, owner in self.pending_cow:
                if owner is req:
                    self.pool.free([src])
                else:
                    keep.append((src, dst, owner))
            self.pending_cow = keep
        if req.blocks:
            # pool.free is refcount-aware: shared prefix blocks just
            # decrement (the cache / other sharers keep them); private
            # blocks recycle. Evicting one sharer can never release
            # another tenant's live prefix pages.
            self.pool.free(req.blocks)
            # Keep the ids for post-mortem (which blocks did this request
            # hold?) — the reuse-proving test reads them — but hand
            # ownership back: a stale list must not be freeable twice.
            req.blocks = list(req.blocks)
        if req.slot is not None:
            self.slots[req.slot] = None

    def requeue(self, req: Request) -> None:
        """Return a running request to the FRONT of the queue (crash
        recovery): its slot is vacated and its progress reset so the next
        admission prefills from scratch — partially-written KV pages can't
        be trusted after a mid-step crash, and restarting from the prompt
        is what keeps recovered completions bit-identical to offline greedy
        decode. Block ownership is NOT released here; the engine reconciles
        the whole pool in one pass afterwards (``PagedKVPool.reconcile``)."""
        if req.slot is not None:
            self.slots[req.slot] = None
        req.slot = None
        req.blocks = []
        req.generated = []
        req.prefilled = 0
        req.state = RequestState.QUEUED
        req.t_admitted = None
        req.t_first_token = None
        req.t_detached = None
        req.t_adopted = None
        self.queue.appendleft(req)

    def _shed(self, req: Request, reason: str) -> None:
        req.state = RequestState.SHED
        req.shed_reason = reason
        self.shed_count += 1
        names = ["serve_shed_total", labeled("serve_shed_total", reason=reason)]
        if reason in ("tenant_budget", "brownout"):
            names.append(labeled("serve_tenant_shed_total", tenant=req.tenant))
        for name in names:
            self.counters[name] = self.counters.get(name, 0) + 1
