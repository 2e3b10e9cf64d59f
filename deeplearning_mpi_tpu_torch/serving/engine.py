"""Serving engine: a batched decode step and chunked prefill over paged KV.

Port of ``deeplearning_mpi_tpu/serving/engine.py``. Requests arrive and
finish independently; a host-side loop swaps sequences in and out of
``max_slots`` decode rows between steps. Each step: admit queued requests
into free slots, run one ``prefill_chunk``-wide chunk for every PREFILL
slot, grow each DECODE slot's KV cover (evicting the oldest under
pressure), then one batched decode step over every DECODE slot.

:class:`PagedForward` computes ``TransformerLM`` numerics over paged block
tables by reusing the model's own submodules (norms, projections, RoPE,
MLP, head): the model's :class:`KVCache` has one fill index for the whole
batch, while each engine slot sits at its own length. The decode step
scatters each slot's new K/V through its block table (inactive slots write
to the scratch block), gathers each slot's pages into a ``[S, L, Hkv, D]``
view, and attends with ``batched_decode_attention`` — K4 on CUDA
(``EngineConfig.use_kernel`` defaults to True here; the reference defaults
to its einsum). The pools are updated in place (the reference donates and
rebinds them).

Greedy-only, dense models only. Not in this slice: speculative decoding,
the prefix cache, disaggregation, int8 KV pools, tracing, chaos, the
metrics registry and compile warmup.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
from deeplearning_mpi_tpu_torch.ops.attention import (
    batched_decode_attention,
    dense_attention,
    repeat_kv,
)
from deeplearning_mpi_tpu_torch.serving.kv_pool import (
    SCRATCH_BLOCK,
    PagedKVPool,
    init_kv_buffers,
)
from deeplearning_mpi_tpu_torch.serving.scheduler import (
    Request,
    RequestState,
    Scheduler,
)

__all__ = ["EngineConfig", "KVBuffers", "PagedForward", "ServingEngine"]


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
    #: decode-batch formation buckets and hold budget (see Scheduler)
    decode_buckets: tuple[int, ...] = ()
    max_hold_steps: int = 4

    @property
    def max_seq_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size


class KVBuffers:
    """Holder for the device KV pools ``(k, v)`` an engine steps over."""

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


class PagedForward:
    """``TransformerLM`` numerics over paged KV block tables, through the
    model's own submodules."""

    def __init__(self, model: TransformerLM, engine: EngineConfig) -> None:
        self.model = model
        self.config = model.config
        self.engine = engine

    def _scatter(self, kv, layer: int, bid, off, k, v) -> None:
        """Write this step's K/V rows (``[N, Hkv, D]``) through the block
        table at ``layer``, in place."""
        k_pool, v_pool = kv
        k_pool[layer, bid, off] = k.to(k_pool.dtype)
        v_pool[layer, bid, off] = v.to(v_pool.dtype)

    def _gather(self, kv, layer: int, tables: torch.Tensor, rows: int):
        """Each row's pages in position order: ``[rows, L, Hkv, D]``."""
        c = self.config
        k_pool, v_pool = kv
        shape = (rows, -1, c.kv_heads, c.head_dim)
        return k_pool[layer][tables].reshape(shape), v_pool[layer][tables].reshape(shape)

    @torch.no_grad()
    def decode_step(
        self,
        kv: tuple[torch.Tensor, ...],
        tables: torch.Tensor,   # [S, MB] int64 block ids (0-padded)
        lengths: torch.Tensor,  # [S] int64 known tokens (prompt + generated)
        tokens: torch.Tensor,   # [S] int64 token fed this step (position len-1)
        active: torch.Tensor,   # [S] bool
        *,
        use_kernel: bool | None = True,
    ) -> torch.Tensor:
        """One batched decode step; returns each slot's greedy next token."""
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
        for i, block in enumerate(model.layers):
            q, k, v = block.attn.project(block.attn_norm(x), pos)
            self._scatter(kv, i, bid, off, k[:, 0], v[:, 0])
            k_seq, v_seq = self._gather(kv, i, tables, S)
            ctx = batched_decode_attention(
                q, k_seq, v_seq, idx, window=window, use_kernel=use_kernel
            )
            x = x + block.attn.output(ctx)
            x = x + block.mlp(block.mlp_norm(x))
        logits = model.head(model.final_norm(x)[:, 0])  # [S, V] f32
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def prefill_chunk(
        self,
        kv: tuple[torch.Tensor, ...],
        table: torch.Tensor,   # [MB] int64 this slot's block table (0-padded)
        tokens: torch.Tensor,  # [C] int64 prompt chunk (0-padded past n_valid)
        start: int,            # absolute position of tokens[0]
        n_valid: int,          # real rows in the chunk
    ) -> torch.Tensor:
        """One prompt chunk for one slot; returns the last valid row's
        float32 logits ``[V]``."""
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
        for i, block in enumerate(model.layers):
            q, k, v = block.attn.project(block.attn_norm(x), pos)
            self._scatter(kv, i, bid, off, k[0], v[0])
            k_seq, v_seq = self._gather(kv, i, table[None], 1)
            # The chunk's queries see earlier chunks' pages plus this chunk's
            # own rows; stale rows of a recycled block sit after the last
            # valid query and are causally masked.
            ctx = dense_attention(
                q, repeat_kv(k_seq, rep), repeat_kv(v_seq, rep),
                causal=True, window=window, q_offset=start,
            )
            x = x + block.attn.output(ctx)
            x = x + block.mlp(block.mlp_norm(x))
        x_last = model.final_norm(x)[0, n_valid - 1]
        return model.head(x_last)


class ServingEngine:
    """Continuous-batching engine over a :class:`TransformerLM` (its device
    and compute dtype are the engine's). ``clock`` is injectable."""

    def __init__(
        self,
        model: TransformerLM,
        engine: EngineConfig | None = None,
        *,
        eos_id: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        engine = engine or EngineConfig()
        if engine.num_blocks - 1 < engine.max_blocks_per_seq:
            raise ValueError(
                f"pool capacity ({engine.num_blocks - 1} blocks) below "
                f"max_blocks_per_seq ({engine.max_blocks_per_seq}): a "
                "maximum-length request could never be admitted"
            )
        self.model = model
        self.config = model.config
        self.engine = engine
        self.eos_id = eos_id
        self.device = model.device
        self._clock = clock
        self.pool = PagedKVPool(engine.num_blocks, engine.block_size)
        self.scheduler = Scheduler(
            self.pool,
            max_slots=engine.max_slots,
            max_seq_len=engine.max_seq_len,
            max_queue=engine.max_queue,
            decode_buckets=engine.decode_buckets,
            max_hold_steps=engine.max_hold_steps,
        )
        self._kvh = KVBuffers(init_kv_buffers(
            self.config.num_layers, engine.num_blocks, engine.block_size,
            self.config.kv_heads, self.config.head_dim, model.dtype, self.device,
        ))
        self._fwd = PagedForward(model, engine)
        self._next_rid = 0
        self.steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0

    @property
    def _kv(self) -> tuple[torch.Tensor, ...]:
        return self._kvh.bufs

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- public API ---------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        deadline: Optional[float] = None,
        arrival: Optional[float] = None,
    ) -> Request:
        """Enqueue one request (or shed it at the door — check
        ``req.state``). ``prompt`` is a 1-D int sequence."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        req = Request(
            rid=self._next_rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            arrival=self._clock() if arrival is None else arrival,
            deadline=deadline,
        )
        self._next_rid += 1
        self.scheduler.submit(req)
        return req

    def step(self) -> list[Request]:
        """One engine iteration: shed expired -> admit -> one prefill chunk
        per PREFILL slot -> grow/evict -> one batched decode step -> retire.
        Returns the requests that finished this step."""
        finished: list[Request] = []
        self._phase_admit(self._clock())
        self._phase_prefill(finished)
        self._phase_decode(self._phase_grow(), finished)
        self.steps += 1
        return finished

    def run_until_idle(self, *, max_steps: int = 100_000) -> list[Request]:
        """Step until queue and slots drain; returns everything finished."""
        finished: list[Request] = []
        steps = 0
        while not self.scheduler.idle():
            finished.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain within {max_steps} steps")
        return finished

    # -- step phases ---------------------------------------------------------
    def _phase_admit(self, now: float) -> list[Request]:
        self.scheduler.shed_expired(now)
        return self.scheduler.admit(now)

    def _phase_prefill(self, finished: list[Request]) -> None:
        for req in list(self.scheduler.running()):
            if req.state is RequestState.PREFILL:
                self._prefill_one(req, finished)

    def _phase_grow(self) -> list[Request]:
        """Mandatory KV growth for every DECODE slot: feeding a token at
        position length-1 needs blocks_for(length) blocks before the step."""
        for req in list(self.scheduler.running()):
            if req.state is not RequestState.DECODE:
                continue
            while len(req.blocks) < self.pool.blocks_for(req.length):
                if not self.scheduler.grow(req):
                    break
        return [r for r in self.scheduler.running() if r.state is RequestState.DECODE]

    def _phase_decode(self, decoding: list[Request], finished: list[Request]) -> None:
        if decoding and self.scheduler.hold_decode(len(decoding)):
            decoding = []
        if decoding:
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
        next_tok = self._fwd.decode_step(
            self._kv, self._tensor(tables), self._tensor(lengths),
            self._tensor(tokens), self._tensor(active), use_kernel=e.use_kernel,
        )
        BS = e.block_size
        self._record_writes({req.blocks[(req.length - 1) // BS] for req in decoding})
        self.decode_steps += 1
        next_np = next_tok.cpu().numpy()  # the one host sync per decode step
        now = self._clock()
        for req in decoding:
            tok = int(next_np[req.slot])
            req.generated.append(tok)
            if self._done(req, tok):
                self._finish(req, now, finished)

    def _prefill_one(self, req: Request, finished: list[Request]) -> None:
        e = self.engine
        start = req.prefilled
        n_valid = min(e.prefill_chunk, req.prompt_len - start)
        chunk = np.zeros((e.prefill_chunk,), np.int64)
        chunk[:n_valid] = req.prompt[start : start + n_valid]
        table = np.zeros((e.max_blocks_per_seq,), np.int64)
        table[: len(req.blocks)] = req.blocks
        last_logits = self._fwd.prefill_chunk(
            self._kv, self._tensor(table), self._tensor(chunk), start, n_valid
        )
        self._record_writes(
            req.blocks[start // e.block_size : (start + n_valid - 1) // e.block_size + 1]
        )
        self.prefill_chunks += 1
        req.prefilled += n_valid
        if req.prefilled < req.prompt_len:
            return
        # Prompt ingested: the first token comes from the last-row logits.
        tok = int(torch.argmax(last_logits))
        req.state = RequestState.DECODE
        req.generated.append(tok)
        req.t_first_token = self._clock()
        if self._done(req, tok):
            self._finish(req, req.t_first_token, finished)

    def _record_writes(self, blocks: Iterable[int]) -> None:
        self.pool.record_fill([b for b in blocks if b != SCRATCH_BLOCK])

    def _done(self, req: Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            return True
        return len(req.generated) >= req.max_new_tokens

    def _finish(self, req: Request, now: float, finished: list[Request]) -> None:
        self.scheduler.finish(req, now)
        finished.append(req)
