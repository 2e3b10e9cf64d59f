"""Disaggregated prefill / decode serving: two engines, one KV pool.

Port of ``deeplearning_mpi_tpu/serving/disagg.py``. The colocated
:class:`~deeplearning_mpi_tpu_torch.serving.engine.ServingEngine` runs
chunked prefill and batched decode in one step loop, so every prompt chunk
a step spends is a step the decode batch waits. Disaggregation splits the
loop by role:

- :class:`PrefillEngine` runs admission and chunked prefill only (K1 on
  CUDA). A request whose prompt completes (its first token comes from the
  last chunk's logits) is detached from its slot and queued for handoff.
- :class:`DecodeEngine` runs KV growth and batched decode, or the
  speculative propose / verify loop, only (K4 on CUDA). It adopts handed-off
  requests into free slots.
- :class:`DisaggregatedEngine` owns both, drives the handoff between them
  and presents the colocated engine's surface (``submit`` / ``cancel`` /
  ``step`` / ``run_until_idle`` / ``recover`` / ``warmup``).

The handoff moves no KV bytes: both roles are built over one
:class:`~deeplearning_mpi_tpu_torch.serving.kv_pool.PagedKVPool` and one
:class:`~deeplearning_mpi_tpu_torch.serving.engine.KVBuffers` holder, both
allocated once here, before either role captures anything, and never
reallocated (not by the handoff, not by :meth:`DisaggregatedEngine.recover`).
A completed prefill's pages are already where the decode role gathers
them; the handoff moves the block table's ownership.

Over a tensor-parallel model (``serving/engine.py``) the one holder keeps
every rank's pools, and the pool's block ids name the same block in each.

The roles share one model, so a hot weight swap (an in-place copy into its
parameters) reaches both; the shared prefix cache is flushed with it.

Chaos: ``handoff_stall`` wedges the handoff queue, completed prefills piling
up while decode drains what it holds, until the coordinator sees the stuck
queue and books the recovery. ``serve_crash`` fires inside the prefill
role's step; :meth:`DisaggregatedEngine.recover` requeues the in-flight
work of both roles and of the handoff queue through prefill and reconciles
the one pool.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Optional

from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
from deeplearning_mpi_tpu_torch.serving.engine import (
    EngineConfig,
    KVBuffers,
    ServingEngine,
    engine_kv_buffers,
    kv_storage,
)
from deeplearning_mpi_tpu_torch.serving.kv_pool import PagedKVPool, init_kv_buffers
from deeplearning_mpi_tpu_torch.serving.prefix_cache import RadixPrefixCache
from deeplearning_mpi_tpu_torch.serving.scheduler import Request

__all__ = ["DecodeEngine", "DisaggregatedEngine", "PrefillEngine"]


class PrefillEngine(ServingEngine):
    """The prefill role: admission and chunked prefill, never decode. A
    request whose prompt completes and that still has tokens to generate is
    detached from its slot (its blocks travel with it) and appended to
    :attr:`handoff`; one that finishes at its first token retires here."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        kwargs.setdefault("role", "prefill")
        super().__init__(*args, **kwargs)
        #: completed prefills awaiting adoption, oldest first
        self.handoff: deque[Request] = deque()

    def _prefill_complete(self, req: Request) -> None:
        req.t_detached = self._clock()
        self.scheduler.detach(req)
        self.handoff.append(req)

    def step(self) -> list[Request]:
        """Admission, copy-on-write, prefill chunks and the chaos crash
        site; no decode phase."""
        finished: list[Request] = []
        self._phase_admit(self._clock())
        self._phase_cow()
        self._phase_prefill(finished)
        self._phase_chaos()
        self.steps += 1
        self._set_gauges()
        return finished

    def warmup(self) -> dict[str, int]:
        """Nothing to capture: this role runs only the chunked prefill,
        which stays eager (it takes its start and length as host ints)."""
        return {}


class DecodeEngine(ServingEngine):
    """The decode role: KV growth and batched decode (or speculative
    verify) over adopted sequences, never admission or prefill. Its queue
    stays empty: supply arrives only through :meth:`adopt`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        kwargs.setdefault("role", "decode")
        super().__init__(*args, **kwargs)

    def adopt(self, req: Request) -> bool:
        """Install a handed-off request in a free slot (False: full; the
        coordinator retries next step)."""
        return self.scheduler.adopt(req)

    def step(self) -> list[Request]:
        finished: list[Request] = []
        decoding = self._phase_grow()
        self._phase_decode(decoding, finished)
        self.steps += 1
        self._set_gauges()
        return finished


class DisaggregatedEngine:
    """Coordinator over one prefill and one decode engine sharing a KV
    pool, with the colocated engine's public surface. One step advances
    prefill, drains the handoff queue into free decode slots (oldest first,
    stopping at the first refusal), then advances decode: a prompt's last
    chunk and its first decode step land in consecutive steps, as in the
    colocated engine, so the streams are token-identical to it."""

    def __init__(
        self,
        model: TransformerLM,
        engine: EngineConfig | None = None,
        *,
        eos_id: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        draft: TransformerLM | None = None,
        tenants: dict[str, dict[str, Any]] | None = None,
        registry: Any = None,
        tracer: Any = None,
        chaos: Any = None,
    ) -> None:
        engine = engine or EngineConfig()
        storage = kv_storage(engine.kv_dtype)
        self.engine = engine
        self.model = model
        self.config = model.config
        self.chaos = chaos
        self.steps = 0
        self._metrics = registry
        self._clock = clock
        self._stall_observed = False
        self._counters = {"serve_handoffs_total": 0, "serve_handoff_stalls_total": 0}
        # ONE pool and ONE set of device pools for both roles, allocated
        # before either captures a program.
        self.pool = PagedKVPool(engine.num_blocks, engine.block_size, kv_dtype=storage)
        # A tensor-parallel model's pools are one set a rank, shared alike.
        kvh = engine_kv_buffers(model, engine, storage)
        draft_kvh = None
        if engine.spec_k > 0 and draft is not None:
            d = draft.config
            draft_kvh = KVBuffers(init_kv_buffers(
                d.num_layers, engine.num_blocks, engine.block_size, d.kv_heads, d.head_dim,
                storage or draft.dtype, draft.device,
            ))
        # ONE prefix cache over the one pool: prefill inserts the full-block
        # span at prompt completion, decode the frozen tail at finish.
        self.prefix_cache = (RadixPrefixCache(self.pool, registry=registry)
                             if engine.prefix_cache else None)
        common = dict(
            eos_id=eos_id, clock=clock, registry=registry, draft=draft, tenants=tenants,
            tracer=tracer, pool=self.pool, kv_buffers=kvh, draft_kv_buffers=draft_kvh,
            prefix_cache=self.prefix_cache,
        )
        # serve_crash stays with the prefill role (mid-admission, partial
        # prefills in flight); handoff_stall is the coordinator's.
        self.prefill = PrefillEngine(model, engine, chaos=chaos, **common)
        self.decode = DecodeEngine(model, engine, **common)
        if registry is not None:
            registry.gauge("serve_handoff_depth")
            registry.counter("serve_handoffs_total")
            registry.counter("serve_handoff_stalls_total")
            for name in ("serve_queue_depth", "serve_slots_active", "serve_kv_blocks_in_use",
                         "serve_kv_bytes"):
                registry.gauge(name)

    # -- public API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, **kwargs: Any) -> Request:
        """Enqueue one request at the prefill role (the only door in)."""
        return self.prefill.submit(prompt, max_new_tokens, **kwargs)

    def cancel(self, req: Request) -> bool:
        """Shed ``req`` wherever it lives: the prefill queue or slots, the
        handoff queue, or a decode slot."""
        if req in self.prefill.handoff:
            self.prefill.handoff.remove(req)
            if req.blocks:
                self.pool.free(req.blocks)
                req.blocks = list(req.blocks)
            self.prefill.scheduler._shed(req, "cancelled")
            self.prefill._inc("serve_requests_shed")
            return True
        return self.prefill.cancel(req) or self.decode.cancel(req)

    def set_brownout(self, stage: int) -> None:
        """The brownout ladder on both roles (admission is the prefill
        role's; the decode role carries the stage so both read alike)."""
        self.prefill.set_brownout(stage)
        self.decode.set_brownout(stage)

    @property
    def handoff_depth(self) -> int:
        return len(self.prefill.handoff)

    @property
    def captures(self) -> int:
        return self.prefill.captures + self.decode.captures

    @property
    def rank_launches(self) -> list[dict[str, int]]:
        """Each tensor-parallel rank's K1 / K4 launches, both roles'."""
        return [{k: p[k] + d[k] for k in p}
                for p, d in zip(self.prefill.rank_launches, self.decode.rank_launches)]

    @property
    def counters(self) -> dict[str, int]:
        """Both roles' engine counters summed, plus the handoff counters."""
        out = dict(self._counters)
        for role in (self.prefill, self.decode):
            for name, v in role.counters.items():
                out[name] = out.get(name, 0) + v
        if self.prefix_cache is not None:  # one cache: counted once
            for name, v in self.prefill.counters.items():
                if name.startswith("serve_prefix_"):
                    out[name] = v
        return out

    @property
    def decode_steps(self) -> int:
        return self.decode.decode_steps

    @property
    def prefill_chunks(self) -> int:
        return self.prefill.prefill_chunks

    def step(self) -> list[Request]:
        """Prefill step, handoff drain, decode step; returns what finished
        in either role."""
        finished = list(self.prefill.step())
        self._drain_handoff()
        finished.extend(self.decode.step())
        self.steps += 1
        self._set_gauges()
        return finished

    def _drain_handoff(self) -> None:
        if self.chaos is not None and self.chaos.check_handoff_stall(step=self.steps):
            if not self._stall_observed:
                # The wedge: completed prefills stay queued this step.
                self._stall_observed = True
                self._inc("serve_handoff_stalls_total")
                return
            # Second sighting of the stuck queue: restart the transport,
            # book the recovery and drain.
            self.chaos.record_recovery("handoff_stall")
            self._stall_observed = False
        q = self.prefill.handoff
        while q:
            req = q[0]
            if not self.decode.adopt(req):
                break  # decode slots full: retry next step
            req.t_adopted = self._clock()
            q.popleft()
            self._inc("serve_handoffs_total")

    def run_until_idle(self, *, max_steps: int = 100_000) -> list[Request]:
        """Step until both roles and the handoff queue drain; an injected
        crash is recovered in place, as in the colocated engine."""
        from deeplearning_mpi_tpu_torch.resilience.faults import InjectedFault

        finished: list[Request] = []
        steps = 0
        while not self.idle():
            try:
                finished.extend(self.step())
            except InjectedFault as err:
                print(f"serving: {err} — recovering", flush=True)
                self.recover()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"disaggregated engine did not drain within {max_steps} steps")
        return finished

    def idle(self) -> bool:
        return (self.prefill.scheduler.idle() and not self.prefill.handoff
                and self.decode.scheduler.idle())

    def warmup(self) -> dict[str, int]:
        """Each role's own programs, over the shared pools: the decode
        role's CUDA graphs (the prefill role has none to build)."""
        programs = dict(self.prefill.warmup())
        programs.update((f"decode_role_{k}", v) for k, v in self.decode.warmup().items())
        return programs

    def recover(self) -> dict[str, int]:
        """Crash recovery across both roles: vacate every slot, clear the
        handoff queue, requeue everything in flight through prefill (oldest
        first at the queue front) and rebuild the one pool's books from what
        survives (the prefix cache's pages). Every sequence re-prefills
        from its prompt, so recovered streams stay token-identical."""
        pre, dec = self.prefill, self.decode
        inflight = sorted(
            {r.rid: r for r in (*pre.scheduler.running(), *pre.handoff,
                                *dec.scheduler.running())}.values(),
            key=lambda r: (r.arrival, r.rid),
        )
        discarded = sum(len(r.generated) for r in inflight)
        pre.handoff.clear()
        for sched in (pre.scheduler, dec.scheduler):
            for req in list(sched.running()):
                sched.slots[req.slot] = None
                req.slot = None
        for req in reversed(inflight):
            pre.scheduler.requeue(req)
        pre.scheduler.clear_pending_cow()
        dec.scheduler.clear_pending_cow()
        live = self.prefix_cache.referenced_blocks() if self.prefix_cache is not None else []
        stats = self.pool.reconcile(live)
        self.pool.check()
        pre._inc("serve_requeued_total", len(inflight))
        pre._inc("serve_tokens_discarded_total", discarded)
        if self.chaos is not None:
            self.chaos.record_recovery("serve_crash")
        self._set_gauges()
        out = {"requeued": len(inflight), "tokens_discarded": discarded, **stats}
        print(f"serving: recovered — requeued {out['requeued']} in-flight request(s) "
              f"through prefill, reclaimed {stats['reclaimed']} KV block(s), discarded "
              f"{discarded} token(s)", flush=True)
        return out

    # -- telemetry -----------------------------------------------------------
    def _inc(self, name: str, amount: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + amount
        if self._metrics is not None and amount:
            self._metrics.counter(name).inc(amount)

    def _set_gauges(self) -> None:
        m = self._metrics
        if m is None:
            return
        # The combined (unlabeled) view; each role keeps its role=... gauges.
        m.gauge("serve_handoff_depth").set(self.handoff_depth)
        m.gauge("serve_queue_depth").set(self.prefill.scheduler.queue_depth())
        m.gauge("serve_slots_active").set(self.prefill.scheduler.slots_active()
                                          + self.decode.scheduler.slots_active())
        m.gauge("serve_kv_blocks_in_use").set(self.pool.in_use)
        m.gauge("serve_kv_bytes").set(self.prefill._kvh.nbytes)
