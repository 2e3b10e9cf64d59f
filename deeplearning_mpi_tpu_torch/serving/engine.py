"""Serving engine: a batched decode step and chunked prefill over paged KV.

Port of ``deeplearning_mpi_tpu/serving/engine.py``. Requests arrive and
finish independently; a host-side loop swaps sequences in and out of
``max_slots`` decode rows between steps. Each step: admit queued requests
into free slots (adopting cached prefix blocks), copy the partially
adopted blocks (copy-on-write), run one ``prefill_chunk``-wide chunk for
every PREFILL slot, grow each DECODE slot's KV cover (evicting the oldest
under pressure), then one batched decode step over every DECODE slot, or
with ``spec_k > 0`` one draft propose loop and one verify step. The phases
are methods (``_phase_*``) so the disaggregated roles (``serving/disagg.py``)
each run the subset they own against this one implementation.

:class:`PagedForward` computes ``TransformerLM`` numerics over paged block
tables by reusing the model's own submodules (norms, projections, RoPE,
MLP, head): the model's :class:`KVCache` has one fill index for the whole
batch, while each engine slot sits at its own length. The decode step
scatters each slot's new K/V through its block table (inactive slots write
to the scratch block), gathers each slot's pages into a ``[S, L, Hkv, D]``
view, and attends with ``batched_decode_attention`` — K4 on CUDA
(``EngineConfig.use_kernel`` defaults to True here; the reference defaults
to its einsum). The chunked prefill attends its chunk over the slot's
gathered pages through K1 on CUDA (the chunk's queries at their absolute
rows of a square ``[1, start + C, H, D]`` call, the rows before them zero);
the reference's, and the port's on the CPU, is the masked matmul. The pools are
updated in place (the reference donates and rebinds them).

int8 KV pools (``EngineConfig.kv_dtype="int8"``) store ``ops.quant``'s
scheme: int8 rows plus one float32 scale per (token, head), written in the
same step. On CUDA the decode step hands K4 the gathered int8 pages and
their gathered scales (K4 factors the scales out of both dots); elsewhere,
and in the prefill and verify steps on every device, the gather
dequantizes, as the reference does. The radix prefix cache
(``serving/prefix_cache.py``), the draft model (``serving/speculative.py``)
and the multi-token verify step are the reference's. :meth:`ServingEngine.warmup`
captures the decode, verify and draft decode steps as CUDA graphs, one per
gather width (``compiler/aot.py``); the chunked prefill stays eager.

Telemetry, as the reference's: with a ``registry`` (a
``telemetry.MetricsRegistry``) the engine keeps the reference's counters
there as well as in :attr:`ServingEngine.counters` (the same values), the
``serve_ttft_s`` / ``serve_tpot_s`` histograms, and the queue-depth,
active-slot, KV-block and KV-byte gauges (labeled ``role=...`` in a
disaggregated pair, whose coordinator keeps the unlabeled view), plus the
prefix cache's; with a ``tracer`` (a ``telemetry.SpanRecorder``)
each finished request's ``request`` / ``queue`` / ``prefill`` /
``handoff`` (disaggregated only) / ``decode`` spans, derived from its own
timestamps so they tile arrival to finish, and an ``engine_step`` /
``prefill_chunk`` event trail. Without
either, each hook is one ``is not None`` test. The reference counts XLA
compiles in ``serve_compile_total``; the port counts the programs
:meth:`ServingEngine.warmup` captures (an eager step compiles nothing).

Sanitizer (``DMT_SANITIZE=1`` at construction, ``analysis.sanitizer``):
the engine mirrors trips into its registry, and once :meth:`warmup` has
run a tick of ``serve_compile_total`` (a capture) trips the retrace
tripwire, as does a decode, verify or draft step at a gather width warmup
did not capture (it would run eagerly: the port's latency spike). The
chunked prefill is eager by design and never trips.

Chaos: with a ``chaos`` injector a planned ``serve_crash`` raises
mid-step, after admission and prefill changed the books and the pools;
:meth:`ServingEngine.run_until_idle` recovers in place
(:meth:`ServingEngine.recover`) and books the recovery. ``pool`` /
``kv_buffers`` / ``draft_kv_buffers`` / ``prefix_cache`` inject shared
block accounting and device pools: the disaggregation seam.

Greedy-only, dense models only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.analysis import sanitizer as _sanitizer
from deeplearning_mpi_tpu_torch.compiler.aot import CapturedProgram, WarmProgram
from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
from deeplearning_mpi_tpu_torch.ops.attention import (
    NEG_INF,
    _f32_matmul,
    batched_decode_attention,
    dense_attention,
    repeat_kv,
)
from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention
from deeplearning_mpi_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from deeplearning_mpi_tpu_torch.serving.kv_pool import (
    SCRATCH_BLOCK,
    PagedKVPool,
    init_kv_buffers,
)
from deeplearning_mpi_tpu_torch.serving.prefix_cache import RadixPrefixCache
from deeplearning_mpi_tpu_torch.serving.scheduler import (
    Request,
    RequestState,
    Scheduler,
)

__all__ = [
    "EngineConfig", "KVBuffers", "PagedForward", "ServingEngine", "chunk_attention",
    "kv_storage",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape/policy knobs."""

    #: decode rows per step; also the number of concurrent sequences
    max_slots: int = 4
    #: token positions per KV block
    block_size: int = 16
    #: pool blocks per layer, scratch block included
    num_blocks: int = 64
    #: block-table width = admission ceiling (``max_blocks_per_seq *
    #: block_size`` positions, prompt + generation)
    max_blocks_per_seq: int = 8
    #: prompt positions prefilled per slot per engine step
    prefill_chunk: int = 16
    #: bounded request queue (admission control)
    max_queue: int = 64
    #: batched decode attention through K4 (True), the masked-matmul
    #: schedule (False), or K4 on CUDA / matmul on CPU (None)
    use_kernel: bool | None = True
    #: draft proposals verified per sequence per engine step (0 = plain
    #: decode); ``spec_k > 0`` needs a draft model
    spec_k: int = 0
    #: decode-batch formation buckets and hold budget (see Scheduler)
    decode_buckets: tuple[int, ...] = ()
    max_hold_steps: int = 4
    #: KV storage by name: None = the model's compute dtype, ``"int8"`` =
    #: int8 rows plus float32 scales (lossy: streams are held to an
    #: acceptance rate, not token identity)
    kv_dtype: str | None = None
    #: radix prefix cache with copy-on-write adoption
    prefix_cache: bool = False

    @property
    def max_seq_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size


def kv_storage(name: str | None) -> torch.dtype | None:
    """``EngineConfig.kv_dtype`` as the pools' storage dtype: None (the
    compute dtype) or ``torch.int8``. Another integer type raises
    NotImplementedError, as in the reference (the scheme is int8
    symmetric); any other name ValueError."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if dtype == torch.int8:
        return dtype
    if isinstance(dtype, torch.dtype) and not dtype.is_floating_point:
        raise NotImplementedError(
            f"integer KV storage supports int8 only, got {name} (ops.quant.quantize_kv "
            "is an int8 symmetric scheme)"
        )
    raise ValueError(f"kv_dtype must be None or 'int8', got {name!r}")


class KVBuffers:
    """Holder for the device KV pools an engine steps over: ``(k, v)``, plus
    ``(k_scale, v_scale)`` for int8 storage."""

    __slots__ = ("bufs",)

    def __init__(self, bufs: tuple[torch.Tensor, ...]) -> None:
        self.bufs = bufs

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.bufs)


def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Round ``n`` up to the next power of two, clamped to ``cap``."""
    b = 1
    while b < max(int(n), 1):
        b *= 2
    return min(b, int(cap)) if cap is not None else b


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: int, *,
                    window: int | None = None) -> torch.Tensor:
    """A prefill chunk's causal attention through K1's square call: the
    chunk's queries ``[1, C, H, D]`` (absolute positions ``start ..
    start + C - 1``) over the slot's pages ``[1, L, H, D]`` (position
    order). K1 takes one sequence length for q, k and v, so the queries sit
    at their own rows of a ``[1, S, H, D]`` call, ``S = start + C``, the
    rows before them zero. No chunk row sees a key past ``start + C - 1``,
    so the pages are cut to ``S`` rows, or padded with zero rows where the
    chunk runs past them; a chunk row sees exactly the keys at positions up
    to its own, as in ``dense_attention(..., q_offset=start)``. K1 still
    computes the ``start`` zero rows' causal triangle."""
    C, L = q.shape[1], k.shape[1]
    S = start + C
    q_full = q.new_zeros((q.shape[0], S, *q.shape[2:]))
    q_full[:, start:] = q
    if S > L:
        pad = k.new_zeros((k.shape[0], S - L, *k.shape[2:]))
        k, v = torch.cat([k, pad], dim=1), torch.cat([v, pad], dim=1)
    else:
        k, v = k[:, :S], v[:, :S]
    out = flash_attention(q_full, k, v, causal=True, window=window)
    return out[:, start:]


class PagedForward:
    """``TransformerLM`` numerics over paged KV block tables, through the
    model's own submodules. One per model: the engine's for the target,
    the speculative decoder's for the draft. ``kv_dtype`` is the pools'
    storage (:func:`kv_storage`: None, the compute dtype, or int8)."""

    def __init__(self, model: TransformerLM, engine: EngineConfig, *,
                 kv_dtype: torch.dtype | None = None) -> None:
        self.model = model
        self.config = model.config
        self.engine = engine
        self.quantized = kv_dtype is not None

    # -- paged scatter / gather (the storage format's seam) -----------------
    def _scatter(self, kv, layer: int, bid, off, k, v) -> None:
        """Write this step's K/V rows (``[..., Hkv, D]``) through the block
        table at ``layer``, in place; int8 storage writes the rows' scales
        in the same step."""
        if not self.quantized:
            k_pool, v_pool = kv
            k_pool[layer, bid, off] = k.to(k_pool.dtype)
            v_pool[layer, bid, off] = v.to(v_pool.dtype)
            return
        k_pool, v_pool, k_scale, v_scale = kv
        (qk, sk), (qv, sv) = quantize_kv(k), quantize_kv(v)
        k_pool[layer, bid, off] = qk
        v_pool[layer, bid, off] = qv
        k_scale[layer, bid, off] = sk
        v_scale[layer, bid, off] = sv

    def _gather(self, kv, layer: int, tables: torch.Tensor, rows: int, *, raw: bool = False):
        """Each row's pages in position order, ``[rows, L, Hkv, D]``, in the
        compute dtype; int8 storage dequantizes here unless ``raw``, which
        returns the int8 pages and their ``[rows, L, Hkv]`` scales."""
        c = self.config
        shape = (rows, -1, c.kv_heads, c.head_dim)
        if not self.quantized:
            k_pool, v_pool = kv
            return k_pool[layer][tables].reshape(shape), v_pool[layer][tables].reshape(shape)
        k_pool, v_pool, k_scale, v_scale = kv
        k, v = k_pool[layer][tables].reshape(shape), v_pool[layer][tables].reshape(shape)
        ks, vs = k_scale[layer][tables].reshape(shape[:3]), v_scale[layer][tables].reshape(shape[:3])
        if raw:
            return k, v, ks, vs
        dtype = self.model.dtype
        return dequantize_kv(k, ks, dtype), dequantize_kv(v, vs, dtype)

    def copy_block(self, kv, src: int, dst: int) -> None:
        """Copy every pool's pages of block ``src`` into ``dst``, all layers,
        scales included, in place: the prefix cache's copy-on-write."""
        for buf in kv:
            buf[:, dst] = buf[:, src]

    # -- decode step --------------------------------------------------------
    @torch.no_grad()
    def decode_logits(
        self,
        kv: tuple[torch.Tensor, ...],
        tables: torch.Tensor,   # [S, MB] int64 block ids (0-padded)
        lengths: torch.Tensor,  # [S] int64 known tokens (prompt + generated)
        tokens: torch.Tensor,   # [S] int64 token fed this step (position len-1)
        active: torch.Tensor,   # [S] bool
        *,
        use_kernel: bool | None = True,
    ) -> torch.Tensor:
        """One batched decode step; returns each slot's float32 logits
        ``[S, V]``. int8 pools reach K4 as int8 pages and scales on CUDA
        (unless ``use_kernel`` is False); elsewhere they are dequantized in
        the gather and attended by the masked matmul."""
        model, e = self.model, self.engine
        S, BS = tables.shape[0], e.block_size
        MB = tables.shape[1]
        x = model.embed_tokens(tokens)[:, None, :]  # [S, 1, d]
        pos = torch.clamp(lengths - 1, min=0)[:, None]  # [S, 1] absolute
        p = pos[:, 0]
        rows = torch.arange(S, device=tables.device)
        # Inactive slots route their (garbage) writes to the scratch block.
        bid = torch.where(
            active, tables[rows, torch.clamp(p // BS, max=MB - 1)], SCRATCH_BLOCK
        )
        off = p % BS
        # Row b attends its own prefix 0..lengths[b]-1; -1 = inactive row.
        idx = torch.where(active, lengths - 1, -1).to(torch.int32)
        window = self.config.attention_window or None
        raw = self.quantized and tables.is_cuda and use_kernel is not False
        if self.quantized and not raw:
            use_kernel = False
        for i, block in enumerate(model.layers):
            q, k, v = block.attn.project(block.attn_norm(x), pos)
            self._scatter(kv, i, bid, off, k[:, 0], v[:, 0])
            if raw:
                k_seq, v_seq, k_scale, v_scale = self._gather(kv, i, tables, S, raw=True)
                ctx = batched_decode_attention(
                    q, k_seq, v_seq, idx, window=window, use_kernel=True,
                    k_scale=k_scale, v_scale=v_scale,
                )
            else:
                k_seq, v_seq = self._gather(kv, i, tables, S)
                ctx = batched_decode_attention(
                    q, k_seq, v_seq, idx, window=window, use_kernel=use_kernel
                )
            x = x + block.attn.output(ctx)
            x = x + block.mlp(block.mlp_norm(x))
        return model.head(model.final_norm(x)[:, 0])  # [S, V] f32

    def decode_step(self, kv, tables, lengths, tokens, active, *,
                    use_kernel: bool | None = True) -> torch.Tensor:
        """One batched decode step; returns each slot's greedy next token."""
        logits = self.decode_logits(kv, tables, lengths, tokens, active, use_kernel=use_kernel)
        return torch.argmax(logits, dim=-1)

    # -- chunked prefill ----------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(
        self,
        kv: tuple[torch.Tensor, ...],
        table: torch.Tensor,   # [MB] int64 this slot's block table (0-padded)
        tokens: torch.Tensor,  # [C] int64 prompt chunk (0-padded past n_valid)
        start: int,            # absolute position of tokens[0]
        n_valid: int,          # real rows in the chunk
        *,
        use_kernel: bool | None = True,
    ) -> torch.Tensor:
        """One prompt chunk for one slot; returns the last valid row's
        float32 logits ``[V]``. On CUDA (unless ``use_kernel`` is False)
        the chunk attends through K1 (:func:`chunk_attention`); elsewhere
        through the masked matmul."""
        model, c, e = self.model, self.config, self.engine
        BS, C = e.block_size, tokens.shape[0]
        L = table.shape[0] * BS
        rep = c.num_heads // c.kv_heads
        x = model.embed_tokens(tokens)[None]  # [1, C, d]
        offs = torch.arange(C, device=tokens.device)
        pos = (start + offs)[None]  # [1, C] absolute
        p = torch.clamp(start + offs, max=L - 1)
        bid = torch.where(offs < n_valid, table[p // BS], SCRATCH_BLOCK)
        off = p % BS
        window = c.attention_window or None
        kernel = tokens.is_cuda and use_kernel is not False
        for i, block in enumerate(model.layers):
            q, k, v = block.attn.project(block.attn_norm(x), pos)
            self._scatter(kv, i, bid, off, k[0], v[0])
            k_seq, v_seq = self._gather(kv, i, table[None], 1)
            # The chunk's queries see earlier chunks' pages plus this chunk's
            # own rows; stale rows of a recycled block sit after the last
            # valid query and are causally masked.
            k_seq, v_seq = repeat_kv(k_seq, rep), repeat_kv(v_seq, rep)
            if kernel:
                ctx = chunk_attention(q, k_seq, v_seq, start, window=window)
            else:
                ctx = dense_attention(q, k_seq, v_seq, causal=True, window=window,
                                      q_offset=start)
            x = x + block.attn.output(ctx)
            x = x + block.mlp(block.mlp_norm(x))
        x_last = model.final_norm(x)[0, n_valid - 1]
        return model.head(x_last)

    # -- verify step (speculative decoding) ---------------------------------
    @torch.no_grad()
    def verify_step(
        self,
        kv: tuple[torch.Tensor, ...],
        tables: torch.Tensor,   # [S, MB] int64 block ids (0-padded)
        lengths: torch.Tensor,  # [S] int64 known tokens before this step
        tokens: torch.Tensor,   # [S, W] int64: last known token + proposals
        n_live: torch.Tensor,   # [S] int64 fed rows per slot (proposals + 1)
        active: torch.Tensor,   # [S] bool
    ) -> torch.Tensor:
        """One batched multi-token forward over the paged pools: row ``s``
        feeds ``tokens[s, i]`` at absolute position ``lengths[s] - 1 + i``,
        writes its K/V there and attends its causal prefix. Returns the
        greedy tokens ``[S, W]``: ``[s, i]`` is the target's choice for
        position ``lengths[s] + i``, what a plain decode step would emit
        after the first ``i`` proposals. The mask is built in absolute
        coordinates with a per-row offset; scores and softmax are float32,
        masked to ``NEG_INF``, and an all-masked row is zeroed, as in
        ``dense_attention``."""
        model, c, e = self.model, self.config, self.engine
        S, MB, BS = tables.shape[0], tables.shape[1], e.block_size
        W = tokens.shape[1]
        L = MB * BS
        rep = c.num_heads // c.kv_heads
        scale = c.head_dim**-0.5
        x = model.embed_tokens(tokens)  # [S, W, d]
        offs = torch.arange(W, device=tokens.device)[None]  # [1, W]
        pos = torch.clamp(lengths - 1, min=0)[:, None] + offs  # [S, W] absolute
        p = torch.clamp(pos, max=L - 1)
        row_valid = active[:, None] & (offs < n_live[:, None])  # [S, W]
        bid = torch.where(row_valid, torch.gather(tables, 1, p // BS), SCRATCH_BLOCK)
        off = p % BS
        k_pos = torch.arange(L, device=tokens.device)
        # [S, 1, W, L]: key j is visible to query i of row s iff j <= pos[s, i].
        valid = (k_pos[None, None, None, :] <= pos[:, None, :, None]) & row_valid[:, None, :, None]
        window = c.attention_window or None
        if window is not None:
            valid &= pos[:, None, :, None] - k_pos[None, None, None, :] < window
        any_valid = valid.any(dim=-1, keepdim=True)
        for i, block in enumerate(model.layers):
            q, k, v = block.attn.project(block.attn_norm(x), pos)
            self._scatter(kv, i, bid, off, k, v)
            k_seq, v_seq = self._gather(kv, i, tables, S)
            k_seq, v_seq = repeat_kv(k_seq, rep), repeat_kv(v_seq, rep)
            # [S, H, W, L] scores in f32.
            scores = _f32_matmul(q.transpose(1, 2), k_seq.permute(0, 2, 3, 1)) * scale
            scores = torch.where(valid, scores, NEG_INF)
            weights = torch.where(any_valid, torch.softmax(scores, dim=-1), 0.0)
            ctx = _f32_matmul(weights.to(v_seq.dtype), v_seq.transpose(1, 2))
            x = x + block.attn.output(ctx.transpose(1, 2).to(q.dtype))
            x = x + block.mlp(block.mlp_norm(x))
        logits = model.head(model.final_norm(x))  # [S, W, V] f32
        return torch.argmax(logits, dim=-1)


#: the reference's engine counters (``serve_*`` and ``spec_*``), kept at 0
#: until they move
_COUNTERS = (
    "serve_requests_submitted", "serve_requests_admitted", "serve_requests_completed",
    "serve_requests_shed", "serve_tokens_generated", "serve_prefill_chunks",
    "serve_decode_steps", "serve_requeued_total", "serve_tokens_discarded_total",
    "serve_compile_total", "serve_decode_held_steps",
)
_SPEC_COUNTERS = (
    "spec_proposed_total", "spec_accepted_total", "spec_rollback_total",
    "spec_verify_steps", "spec_draft_steps", "spec_degraded_total",
    "spec_blocks_rolled_back_total",
)


class ServingEngine:
    """Continuous-batching engine over a :class:`TransformerLM` (its device
    and compute dtype are the engine's). ``clock`` is injectable.

    ``draft`` (required iff ``engine.spec_k > 0``) is the draft model of
    speculative decoding, a dense ``TransformerLM`` sharing the target's
    vocab; usually the target's first layers
    (``models.transformer.self_draft``). ``tenants`` configures the
    scheduler's per-tenant budgets and priorities. ``chaos`` (a
    ``resilience.ChaosInjector``) fires ``serve_crash`` mid-step.

    ``pool`` / ``kv_buffers`` / ``draft_kv_buffers`` / ``prefix_cache``
    inject SHARED block accounting, device pools and prefix cache: a
    prefill-only and a decode-only engine built over the same ones hand a
    sequence over by moving its block table, the pages already in place
    (``serving/disagg.py``). Omitted, the engine owns them. ``role`` names
    the engine's half of such a pair: its gauges carry ``role=...`` and its
    events the role.
    """

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
        role: str | None = None,
        pool: PagedKVPool | None = None,
        kv_buffers: KVBuffers | None = None,
        draft_kv_buffers: KVBuffers | None = None,
        prefix_cache: RadixPrefixCache | None = None,
    ) -> None:
        engine = engine or EngineConfig()
        if model.config.moe_experts > 0:
            raise NotImplementedError(
                "serving engine is dense-MLP only: MoE capacity routing makes a token's "
                "output depend on co-batched strangers, which breaks the engine's "
                "request-independence contract")
        if engine.num_blocks - 1 < engine.max_blocks_per_seq:
            raise ValueError(
                f"pool capacity ({engine.num_blocks - 1} blocks) below "
                f"max_blocks_per_seq ({engine.max_blocks_per_seq}): a "
                "maximum-length request could never be admitted"
            )
        if engine.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {engine.spec_k}")
        if engine.spec_k > 0 and draft is None:
            raise ValueError(
                "spec_k > 0 needs a draft model: pass draft= (models.transformer."
                "self_draft builds one from the target's own first N layers)"
            )
        storage = kv_storage(engine.kv_dtype)
        self.model = model
        self.config = model.config
        self.engine = engine
        self.eos_id = eos_id
        self.device = model.device
        self._clock = clock
        self.chaos = chaos
        self.role = role
        #: the reference's counters by name (see :attr:`counters`)
        self._counters: dict[str, int] = dict.fromkeys(_COUNTERS, 0)
        if engine.spec_k > 0:
            self._counters.update(dict.fromkeys(_SPEC_COUNTERS, 0))
        self._metrics = registry
        # None unless a SpanRecorder was given: each hook is one pointer test.
        self._tracer = tracer
        self._kv_dtype_name = str(storage or model.dtype).replace("torch.", "")
        if pool is None:
            pool = PagedKVPool(engine.num_blocks, engine.block_size, kv_dtype=storage)
        elif (pool.num_blocks, pool.block_size) != (engine.num_blocks, engine.block_size):
            raise ValueError(
                f"injected pool geometry {pool.num_blocks}x{pool.block_size} does not "
                f"match engine config {engine.num_blocks}x{engine.block_size}"
            )
        self.pool = pool
        # An injected cache (one over a shared pool) implies the cache is on.
        if prefix_cache is None and engine.prefix_cache:
            prefix_cache = RadixPrefixCache(self.pool, registry=registry)
        self.prefix_cache = prefix_cache
        self.scheduler = Scheduler(
            self.pool,
            max_slots=engine.max_slots,
            max_seq_len=engine.max_seq_len,
            max_queue=engine.max_queue,
            decode_buckets=engine.decode_buckets,
            max_hold_steps=engine.max_hold_steps,
            prefix_cache=self.prefix_cache,
            tenants=tenants,
            counters=self._counters,
            registry=registry,
        )
        if registry is not None:
            self._register(registry)
        self._kvh = kv_buffers if kv_buffers is not None else KVBuffers(init_kv_buffers(
            self.config.num_layers, engine.num_blocks, engine.block_size,
            self.config.kv_heads, self.config.head_dim, storage or model.dtype, self.device,
        ))
        self._fwd = PagedForward(model, engine, kv_dtype=storage)
        self._spec = None
        if engine.spec_k > 0:
            from deeplearning_mpi_tpu_torch.serving.speculative import SpeculativeDecoder

            self._spec = SpeculativeDecoder(draft, target_config=self.config, engine=engine,
                                            kv_dtype=storage, kv_buffers=draft_kv_buffers)
        #: brownout stage 2+ suspends speculative drafts (plain decode emits
        #: the same tokens)
        self.spec_suspended = False
        self._decode_fn: Callable[..., torch.Tensor] = self._eager_decode
        self._verify_fn: Callable[..., torch.Tensor] = self._eager_verify
        #: programs :meth:`warmup` built (CUDA graphs on the card); traffic
        #: never adds one
        self.captures = 0
        # Armed by warmup(): with the sanitizer on, a capture or an eager
        # decode-path fallback afterwards is a retrace trip.
        self._warmed = False
        self._sanitize = _sanitizer.enabled()
        if self._sanitize:
            _sanitizer.attach_registry(registry)
        self._next_rid = 0
        self.steps = 0

    @property
    def _kv(self) -> tuple[torch.Tensor, ...]:
        return self._kvh.bufs

    @property
    def counters(self) -> dict[str, int]:
        """The reference's counters: ``serve_*`` (``serve_shed_total`` by
        reason from the scheduler), ``spec_*`` with a draft, and the prefix
        cache's ``serve_prefix_*`` counters and gauges."""
        out = dict(self._counters)
        c = self.prefix_cache
        if c is not None:
            out.update({
                "serve_prefix_hits_total": c.hits,
                "serve_prefix_tokens_reused_total": c.tokens_reused,
                "serve_prefix_cow_copies_total": c.cow_copies,
                "serve_prefix_evictions_total": c.evictions,
                "serve_prefix_nodes": c.num_nodes,
                "serve_prefix_blocks": c.num_blocks_cached,
            })
        return out

    @property
    def decode_steps(self) -> int:
        return self._counters["serve_decode_steps"]

    @property
    def prefill_chunks(self) -> int:
        return self._counters["serve_prefill_chunks"]

    def _inc(self, name: str, amount: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + amount
        if self._metrics is not None and amount:
            self._metrics.counter(name).inc(amount)
        if self._sanitize and name == "serve_compile_total":
            # Counter first, tripwire second: a tripped capture still shows
            # up in serve_compile_total for the post-mortem.
            _sanitizer.check_compile_tick(post_warmup=self._warmed, what="serving program captured")

    def _guarded(self, eager: Callable[..., torch.Tensor], what: str) -> Callable[..., torch.Tensor]:
        """A warmed program's eager fallback; with the sanitizer on, a call
        after warmup (a width warmup did not capture) trips first."""
        if not self._sanitize:
            return eager

        def fallback(*args: Any) -> torch.Tensor:
            _sanitizer.check_compile_tick(
                post_warmup=self._warmed, what=f"{what} at a gather width warmup did not capture "
                f"(eager fallback, width {args[0].shape[1]})")
            return eager(*args)

        return fallback

    # -- telemetry -----------------------------------------------------------
    def _register(self, registry: Any) -> None:
        """Create the reference's instruments, so a record lists them at 0."""
        from deeplearning_mpi_tpu_torch.telemetry.registry import labeled

        for name in _COUNTERS:
            if name != "serve_decode_held_steps" or self.engine.decode_buckets:
                registry.counter(name)
        for name in ("serve_queue_depth", "serve_slots_active", "serve_kv_blocks_in_use",
                     "serve_kv_bytes"):
            registry.gauge(self._role_name(name))
        registry.gauge(labeled("serve_kv_bytes", dtype=self._kv_dtype_name))
        for name in ("serve_ttft_s", "serve_tpot_s", "serve_compile_seconds"):
            registry.histogram(name)
        if self.engine.spec_k > 0:
            for name in _SPEC_COUNTERS:
                registry.counter(name)
        if self.prefix_cache is not None:
            registry.gauge("serve_prefix_nodes")
            registry.gauge("serve_prefix_blocks")

    def _role_name(self, name: str) -> str:
        """A gauge's name for this engine: ``role=...``-labeled in a
        disaggregated pair (two engines share one registry), plain
        otherwise."""
        if self.role is None:
            return name
        from deeplearning_mpi_tpu_torch.telemetry.registry import labeled

        return labeled(name, role=self.role)

    def _set_gauges(self) -> None:
        m = self._metrics
        if m is None:
            return
        from deeplearning_mpi_tpu_torch.telemetry.registry import labeled

        m.gauge(self._role_name("serve_queue_depth")).set(self.scheduler.queue_depth())
        m.gauge(self._role_name("serve_slots_active")).set(self.scheduler.slots_active())
        m.gauge(self._role_name("serve_kv_blocks_in_use")).set(self.pool.in_use)
        nbytes = self._kvh.nbytes
        m.gauge(self._role_name("serve_kv_bytes")).set(nbytes)
        m.gauge(labeled("serve_kv_bytes", dtype=self._kv_dtype_name)).set(nbytes)
        if self.prefix_cache is not None:
            m.gauge("serve_prefix_nodes").set(self.prefix_cache.num_nodes)
            m.gauge("serve_prefix_blocks").set(self.prefix_cache.num_blocks_cached)
        if self.scheduler.tenants:
            inflight = self.scheduler.tenant_tokens_in_flight()
            for tenant in self.scheduler.tenants:
                m.gauge(labeled("serve_tenant_tokens_in_flight", tenant=tenant)).set(
                    inflight.get(tenant, 0))

    def _trace_request(self, req: Request, now: float) -> None:
        """The request's phase spans from its own lifecycle stamps, written
        once at retirement: ``queue`` (arrival -> admitted), ``prefill``
        (-> first token), in a disaggregated pair ``handoff`` (detached ->
        adopted), ``decode`` (-> finished) under a ``request`` root span, so
        the phases tile arrival -> finish."""
        tr = self._tracer
        trace = req.trace or f"rid{req.rid}"
        root = tr.record_span("request", req.arrival, now, trace=trace, rid=req.rid,
                              tenant=req.tenant, tokens=len(req.generated),
                              prompt_len=req.prompt_len)
        if req.t_admitted is not None:
            tr.record_span("queue", req.arrival, req.t_admitted, trace=trace, parent=root.sid)
            if req.t_first_token is not None:
                tr.record_span("prefill", req.t_admitted, req.t_first_token, trace=trace,
                               parent=root.sid)
        decode_t0 = req.t_first_token
        if req.t_detached is not None and req.t_adopted is not None:
            tr.record_span("handoff", req.t_detached, req.t_adopted, trace=trace,
                           parent=root.sid)
            decode_t0 = req.t_adopted
        if decode_t0 is not None:
            tr.record_span("decode", decode_t0, now, trace=trace, parent=root.sid,
                           tokens=len(req.generated))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- programs (eager until warmup) ---------------------------------------
    def _eager_decode(self, tables, lengths, tokens, active) -> torch.Tensor:
        return self._fwd.decode_step(
            self._kv, *(self._tensor(a) for a in (tables, lengths, tokens, active)),
            use_kernel=self.engine.use_kernel,
        )

    def _eager_verify(self, tables, lengths, tokens, n_live, active) -> torch.Tensor:
        return self._fwd.verify_step(
            self._kv, *(self._tensor(a) for a in (tables, lengths, tokens, n_live, active))
        )

    def _gather_widths(self) -> list[int]:
        """Every width :meth:`_gather_width` can emit, ascending."""
        mb = self.engine.max_blocks_per_seq
        out, w = [], 1
        while w < mb:
            out.append(w)
            w *= 2
        return out + [mb]

    def warmup(self) -> dict[str, int]:
        """Build every decode-path program before traffic.

        For each gather width (:meth:`_gather_widths`) this captures the
        target decode step, and with a draft the verify step and the
        draft's decode step, as CUDA graphs on one shared graph pool, over
        static input buffers (tables of that width, lengths, tokens,
        ``n_live``, active). Each is run once eagerly first, with every row
        inactive (its writes land in the scratch block). Afterwards a step
        copies its host arrays into the buffers and replays; a width that
        was not captured runs eagerly. The chunked prefill stays eager: it
        takes its ``start`` and ``n_valid`` as Python ints. On the CPU the
        same buffers are built and each program runs once eagerly, with no
        capture. Returns the number of programs built by kind."""
        e, S = self.engine, self.engine.max_slots
        cuda = self.device.type == "cuda"
        pool = torch.cuda.graph_pool_handle() if cuda else None
        stream = torch.cuda.Stream(self.device) if cuda else None

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def capture(fn, inputs) -> CapturedProgram:
            self.captures += 1
            t0 = time.perf_counter()
            program = CapturedProgram(fn, inputs, pool=pool, stream=stream)
            self._inc("serve_compile_total")
            if self._metrics is not None:
                self._metrics.histogram("serve_compile_seconds").observe(
                    time.perf_counter() - t0)
            return program

        def width(tables, *_):
            return tables.shape[1]

        slots = (zeros(S), zeros(S), zeros(S, dtype=torch.bool))
        decode, verify = {}, {}
        for w in self._gather_widths():
            decode[w] = capture(
                lambda t, n, tok, a: self._fwd.decode_step(self._kv, t, n, tok, a,
                                                           use_kernel=e.use_kernel),
                (zeros(S, w), *slots),
            )
            if self._spec is not None:
                verify[w] = capture(
                    lambda t, n, tok, live, a: self._fwd.verify_step(self._kv, t, n, tok, live, a),
                    (zeros(S, w), zeros(S), zeros(S, e.spec_k + 1), zeros(S),
                     zeros(S, dtype=torch.bool)),
                )
        self._decode_fn = WarmProgram(decode, self._guarded(self._eager_decode, "decode step"),
                                      width)
        built = {"decode": len(decode)}
        if self._spec is not None:
            self._verify_fn = WarmProgram(verify, self._guarded(self._eager_verify, "verify step"),
                                          width)
            built["verify"] = len(verify)
            built["draft_decode"] = self._spec.warmup(
                {w: (zeros(S, w), *slots) for w in self._gather_widths()}, capture, width,
                fallback=self._guarded(self._spec._eager_decode, "draft decode step"),
            )
        if cuda:
            torch.cuda.synchronize(self.device)
        self._warmed = True
        return built

    # -- public API ---------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        deadline: Optional[float] = None,
        arrival: Optional[float] = None,
        tenant: str = "default",
        trace: Optional[str] = None,
    ) -> Request:
        """Enqueue one request (or shed it at the door — check
        ``req.state``). ``prompt`` is a 1-D int sequence; ``trace`` keys its
        spans (a fleet's global rid) instead of the engine-local rid."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        req = Request(
            rid=self._next_rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            arrival=self._clock() if arrival is None else arrival,
            deadline=deadline,
            tenant=tenant,
            trace=trace,
        )
        self._next_rid += 1
        self._inc("serve_requests_submitted")
        if not self.scheduler.submit(req):
            self._inc("serve_requests_shed")
        return req

    def cancel(self, req: Request) -> bool:
        """Shed ``req`` wherever it lives (the other copy of a hedged
        request won); False when it already finished or was shed."""
        if self.scheduler.cancel(req):
            self._inc("serve_requests_shed")
            return True
        return False

    def set_brownout(self, stage: int) -> None:
        """The overload ladder: stage 1+ sheds the lowest-priority tenants
        at the door, 2+ also suspends speculative drafts, 3 raises the
        deadline floor (the door policy is the scheduler's)."""
        self.scheduler.set_brownout(stage)
        self.spec_suspended = stage >= 2

    def step(self) -> list[Request]:
        """One engine iteration: shed expired -> admit -> copy-on-write ->
        one prefill chunk per PREFILL slot -> grow/evict -> one batched
        decode (or propose + verify) step -> retire. Returns the requests
        that finished this step."""
        finished: list[Request] = []
        self._phase_admit(self._clock())
        self._phase_cow()
        self._phase_prefill(finished)
        self._phase_chaos()
        self._phase_decode(self._phase_grow(), finished)
        self.steps += 1
        self._set_gauges()
        if self._tracer is not None:
            self._tracer.event("engine_step", step=self.steps, role=self.role or "colocated",
                               finished=len(finished))
        return finished

    def run_until_idle(self, *, max_steps: int = 100_000) -> list[Request]:
        """Step until queue and slots drain; returns everything finished.
        An injected crash is recovered in place (:meth:`recover`) and the
        loop goes on: each planned fault fires once. Requests that finished
        in a crashed step stay finished on their own objects (the step's
        return value was lost with the exception)."""
        from deeplearning_mpi_tpu_torch.resilience.faults import InjectedFault

        finished: list[Request] = []
        steps = 0
        while not self.scheduler.idle():
            try:
                finished.extend(self.step())
            except InjectedFault as err:
                print(f"serving: {err} — recovering", flush=True)
                self.recover()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain within {max_steps} steps")
        return finished

    def recover(self) -> dict[str, int]:
        """Crash recovery: requeue every in-flight sequence (it restarts from
        its prompt, so recovered streams stay token-identical to offline
        greedy) and rebuild the pool's books from what survives: the prefix
        cache's pages, which were inserted only after their owner's
        first-token sync. Pending copy-on-write pins are dropped without a
        free (the reconcile recounts every reference). The draft's pools
        need nothing: re-prefill rewrites them through the same tables."""
        inflight = sorted(self.scheduler.running(), key=lambda r: (r.arrival, r.rid))
        discarded = sum(len(r.generated) for r in inflight)
        for req in reversed(inflight):
            self.scheduler.requeue(req)
        self.scheduler.clear_pending_cow()
        live = self.prefix_cache.referenced_blocks() if self.prefix_cache is not None else []
        stats = self.pool.reconcile(live)
        self.pool.check()
        self._inc("serve_requeued_total", len(inflight))
        self._inc("serve_tokens_discarded_total", discarded)
        if self.chaos is not None:
            self.chaos.record_recovery("serve_crash")
        self._set_gauges()
        out = {"requeued": len(inflight), "tokens_discarded": discarded, **stats}
        print(f"serving: recovered — requeued {out['requeued']} in-flight request(s), "
              f"reclaimed {stats['reclaimed']} KV block(s), discarded {discarded} "
              "token(s)", flush=True)
        return out

    # -- step phases ---------------------------------------------------------
    def _phase_admit(self, now: float) -> list[Request]:
        self._inc("serve_requests_shed", len(self.scheduler.shed_expired(now)))
        admitted = self.scheduler.admit(now)
        self._inc("serve_requests_admitted", len(admitted))
        return admitted

    def _phase_cow(self) -> None:
        """Copy each partially adopted cached block into its adopter's
        private block before the adopter's first prefill chunk reads or
        writes it; the source's pin is dropped either way."""
        if self.prefix_cache is None:
            return
        for src, dst, req in self.scheduler.take_pending_cow():
            if req.state is RequestState.PREFILL:
                self._fwd.copy_block(self._kv, src, dst)
                if self._spec is not None:
                    # The draft's pools ride the same block tables.
                    self._spec.copy_block(src, dst)
                self._record_writes([dst])
                self.prefix_cache.note_cow()
            self.pool.free([src])

    def _phase_prefill(self, finished: list[Request]) -> None:
        for req in list(self.scheduler.running()):
            if req.state is RequestState.PREFILL:
                self._prefill_one(req, finished)

    def _phase_chaos(self) -> None:
        """The ``serve_crash`` site: mid-step, after admission and prefill
        changed the books and the pools, the state :meth:`recover` must
        untangle."""
        if self.chaos is not None:
            self.chaos.check_serve_crash(step=self.steps)

    def _phase_grow(self) -> list[Request]:
        """Mandatory KV growth for every DECODE slot: feeding a token at
        position length-1 needs blocks_for(length) blocks before the step.
        With a draft, a pool that cannot cover the verify batch sheds the
        requester as ``spec_overflow``."""
        shed_reason = "spec_overflow" if self._spec is not None else "evicted"
        for req in list(self.scheduler.running()):
            if req.state is not RequestState.DECODE:
                continue
            while len(req.blocks) < self.pool.blocks_for(req.length):
                if not self.scheduler.grow(req, shed_reason=shed_reason):
                    self._inc("serve_requests_shed")
                    break
        return [r for r in self.scheduler.running() if r.state is RequestState.DECODE]

    def _phase_decode(self, decoding: list[Request], finished: list[Request]) -> None:
        if decoding and self.scheduler.hold_decode(len(decoding)):
            self._inc("serve_decode_held_steps")
            decoding = []
        if decoding:
            if self._spec is not None and not self.spec_suspended:
                self._spec_decode(decoding, finished)
            else:
                self._plain_decode(decoding, finished)

    def _gather_width(self, blocks_held: int) -> int:
        """Block-table width for this step: the power-of-two bucket covering
        the widest live row, so shallow fills gather O(bucket) KV."""
        return pow2_bucket(max(blocks_held, 1), cap=self.engine.max_blocks_per_seq)

    def _plain_decode(self, decoding: list[Request], finished: list[Request]) -> None:
        e = self.engine
        tables = np.zeros((e.max_slots, e.max_blocks_per_seq), np.int64)
        lengths = np.zeros((e.max_slots,), np.int64)
        tokens = np.zeros((e.max_slots,), np.int64)
        active = np.zeros((e.max_slots,), bool)
        for req in decoding:
            s = req.slot
            tables[s, : len(req.blocks)] = req.blocks
            lengths[s] = req.length
            tokens[s] = req.generated[-1]
            active[s] = True
        tables = tables[:, : self._gather_width(max(len(r.blocks) for r in decoding))]
        next_tok = self._decode_fn(tables, lengths, tokens, active)
        BS = e.block_size
        self._record_writes({req.blocks[(req.length - 1) // BS] for req in decoding})
        self._inc("serve_decode_steps")
        next_np = next_tok.cpu().numpy()  # dmt-lint: disable=DMT003 — THE audited sync: one sampled-token fetch per decode step (EOS/retire decisions are host-side)
        now = self._clock()
        for req in decoding:
            tok = int(next_np[req.slot])
            req.generated.append(tok)
            self._inc("serve_tokens_generated")
            if self._done(req, tok):
                self._finish(req, now, finished)

    def _spec_decode(self, decoding: list[Request], finished: list[Request]) -> None:
        """One speculative iteration: plan each slot's proposal budget
        (extra KV from the free list only: a speculative tail never evicts
        a peer), run the draft's propose loop, verify the batch in one step,
        emit the longest exact-greedy-match prefix plus the target's own
        next token, and roll surplus tail blocks back to the free list."""
        e = self.engine
        K, BS = e.spec_k, e.block_size
        tables = np.zeros((e.max_slots, e.max_blocks_per_seq), np.int64)
        lengths = np.zeros((e.max_slots,), np.int64)
        last = np.zeros((e.max_slots,), np.int64)
        n_prop = np.zeros((e.max_slots,), np.int64)
        active = np.zeros((e.max_slots,), bool)
        for req in decoding:
            s = req.slot
            # Never propose past the request's remaining budget.
            n = min(K, req.max_new_tokens - len(req.generated) - 1)
            if n > 0:
                # Verify writes positions length-1 .. length-1+n.
                need = self.pool.blocks_for(req.length + n) - len(req.blocks)
                if need > 0:
                    got = self.pool.alloc(need)
                    if got is None and self.prefix_cache is not None:
                        # Unreferenced cache branches go before the budget.
                        if self.prefix_cache.evict(need - self.pool.available):
                            got = self.pool.alloc(need)
                    if got is not None:
                        req.blocks.extend(got)
                    else:
                        n = min(n, len(req.blocks) * BS - req.length)
                        self._inc("spec_degraded_total")
            tables[s, : len(req.blocks)] = req.blocks
            lengths[s] = req.length
            last[s] = req.generated[-1]
            n_prop[s] = max(n, 0)
            active[s] = True
        tables = tables[:, : self._gather_width(max(len(r.blocks) for r in decoding))]
        props, draft_steps = self._spec.propose(tables, lengths, last, n_prop, active)
        self._inc("spec_draft_steps", draft_steps)
        tokens = np.zeros((e.max_slots, K + 1), np.int64)
        tokens[:, 0] = last
        tokens[:, 1:] = props
        greedy = self._verify_fn(tables, lengths, tokens, n_prop + 1, active)
        touched: set[int] = set()
        for req in decoding:
            n_fed = int(n_prop[req.slot]) + 1
            lo = (req.length - 1) // BS
            hi = min((req.length - 1 + n_fed - 1) // BS, len(req.blocks) - 1)
            touched.update(req.blocks[lo : hi + 1])
        self._record_writes(touched)
        self._inc("serve_decode_steps")
        self._inc("spec_verify_steps")
        greedy_np = greedy.cpu().numpy()  # [S, W]  # dmt-lint: disable=DMT003 — the audited verify fetch: exact-match acceptance runs on the host
        now = self._clock()
        for req in decoding:
            s = req.slot
            n_p = int(n_prop[s])
            g = greedy_np[s]
            # g[i] is the target's token after the first i proposals.
            n = 0
            while n < n_p and int(props[s, n]) == int(g[n]):
                n += 1
            emitted = 0
            for i in range(n + 1):
                tok = int(g[i])
                req.generated.append(tok)
                self._inc("serve_tokens_generated")
                if i < n:
                    emitted += 1
                if self._done(req, tok):
                    self._finish(req, now, finished)
                    break
            self._inc("spec_proposed_total", n_p)
            self._inc("spec_accepted_total", emitted)
            self._inc("spec_rollback_total", n_p - emitted)
            if req.state is RequestState.DECODE:
                # Keep the cover the next step's growth would demand; K/V
                # past the accepted prefix is overwritten before it becomes
                # causally visible.
                freed = self.scheduler.shrink(req, self.pool.blocks_for(req.length))
                self._inc("spec_blocks_rolled_back_total", len(freed))

    def _prefill_one(self, req: Request, finished: list[Request]) -> None:
        e = self.engine
        start = req.prefilled
        n_valid = min(e.prefill_chunk, req.prompt_len - start)
        chunk = np.zeros((e.prefill_chunk,), np.int64)
        chunk[:n_valid] = req.prompt[start : start + n_valid]
        table = np.zeros((e.max_blocks_per_seq,), np.int64)
        table[: len(req.blocks)] = req.blocks
        last_logits = self._fwd.prefill_chunk(
            self._kv, self._tensor(table), self._tensor(chunk), start, n_valid,
            use_kernel=e.use_kernel,
        )
        self._record_writes(
            req.blocks[start // e.block_size : (start + n_valid - 1) // e.block_size + 1]
        )
        if self._spec is not None:
            # The draft ingests the same chunk through the same table.
            self._spec.prefill_chunk(table, chunk, start, n_valid)
        self._inc("serve_prefill_chunks")
        if self._tracer is not None:
            self._tracer.event("prefill_chunk", trace=req.trace or f"rid{req.rid}",
                               start=start, n=n_valid, role=self.role or "colocated")
        req.prefilled += n_valid
        if req.prefilled < req.prompt_len:
            return
        # Prompt ingested: the first token comes from the last-row logits.
        tok = int(torch.argmax(last_logits))  # dmt-lint: disable=DMT003 — audited: the first token must reach the host to enter req.generated
        req.state = RequestState.DECODE
        req.generated.append(tok)
        req.t_first_token = self._clock()
        self._inc("serve_tokens_generated")
        if self._metrics is not None and req.ttft is not None:
            self._metrics.histogram("serve_ttft_s").observe(req.ttft)
        if self.prefix_cache is not None:
            # The full prompt blocks are frozen from here on (the request
            # writes positions >= prompt_len only); the sync above proves
            # their writes landed. The tail block is indexed at finish.
            n_full = req.prompt_len // e.block_size
            if n_full:
                self.prefix_cache.insert(req.prompt, req.blocks, n_full * e.block_size)
        if self._done(req, tok):
            self._finish(req, req.t_first_token, finished)
        else:
            self._prefill_complete(req)

    def _prefill_complete(self, req: Request) -> None:
        """Hook: ``req`` finished its prompt (first token emitted) and enters
        DECODE. A no-op here; the disaggregated prefill role hands the
        sequence, block table and all, to its decode peer."""

    def _record_writes(self, blocks: Iterable[int]) -> None:
        """Log a step's KV writes against the pool's per-block epochs; data
        and scales move together on int8 pools (``pool.check``)."""
        blocks = [b for b in blocks if b != SCRATCH_BLOCK]
        self.pool.record_fill(blocks)
        if self.pool.quantized:
            self.pool.record_scale(blocks)

    def _done(self, req: Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            return True
        return len(req.generated) >= req.max_new_tokens

    def _finish(self, req: Request, now: float, finished: list[Request]) -> None:
        if self.prefix_cache is not None and req.prompt_len % self.engine.block_size:
            # The prompt's tail block is frozen only now; index it before the
            # release drops the request's own reference.
            self.prefix_cache.insert(req.prompt, req.blocks, req.prompt_len)
        self.scheduler.finish(req, now)
        finished.append(req)
        self._inc("serve_requests_completed")
        if self._metrics is not None and req.tpot is not None:
            self._metrics.histogram("serve_tpot_s").observe(req.tpot)
        if self._tracer is not None:
            self._trace_request(req, now)
