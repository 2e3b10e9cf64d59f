"""Draft-model speculative decoding for the paged serving engine.

Port of ``deeplearning_mpi_tpu/serving/speculative.py``. A cheap draft
model proposes ``spec_k`` tokens per sequence and the target scores all
``spec_k + 1`` positions in one batched forward
(``PagedForward.verify_step``). The engine is greedy-only, so acceptance is
exact greedy match: a proposal is kept iff it equals the target's own
argmax there, and the emitted stream equals plain greedy decode for any
draft; a poor draft costs throughput, never tokens.

The draft is a dense ``TransformerLM`` sharing the target's vocab, usually
the target's first layers (``models.transformer.self_draft``). It keeps
its own paged pools, in the target's storage dtype, written through the
same block tables and free list as the target's, so one allocation covers
both models and eviction and rollback need nothing of their own. On CUDA
its decode steps run K4, as the target's do (the reference keeps its draft
on the einsum because its kernel dispatch is tuned per shape; the port
sends every CUDA decode step to K4, which computes the same function).

The draft's KV rule: before a propose loop at known length ``L``, the
draft's cache holds positions ``0..L-2`` (``L-1`` belongs to the token fed
next). The prompt comes from :meth:`SpeculativeDecoder.prefill_chunk`,
run beside the target's. Propose step ``j`` writes position ``L-1+j``; the
loop runs one step past the last proposal it collects (``j = n_prop``), so
a fully accepted round still leaves position ``L'-2`` written. A rejected
tail's positions are overwritten at the step in which each first becomes
causally visible.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.compiler.aot import WarmProgram
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.serving.kv_pool import init_kv_buffers

__all__ = ["SpeculativeDecoder"]


class SpeculativeDecoder:
    """The draft side: the draft model, its paged pools and programs. The
    engine drives it with host arrays shaped like its own slot-indexed
    decode inputs; :meth:`propose` is also the seam tests replace to script
    proposal streams (the verify step guards correctness either way)."""

    def __init__(
        self,
        draft: TransformerLM,
        *,
        target_config: TransformerConfig,
        engine: Any,  # EngineConfig (engine.py imports this module)
        kv_dtype: torch.dtype | None = None,
        kv_buffers: Any = None,
    ) -> None:
        if not isinstance(draft, TransformerLM):
            raise NotImplementedError("the draft model must be a dense TransformerLM")
        if draft.config.vocab_size != target_config.vocab_size:
            raise ValueError(
                "draft and target must share one tokenizer: vocab "
                f"{draft.config.vocab_size} != {target_config.vocab_size}"
            )
        from deeplearning_mpi_tpu_torch.serving.engine import KVBuffers, PagedForward

        c = draft.config
        self.model = draft
        self.engine = engine
        self.spec_k = engine.spec_k
        self.device = draft.device
        self._fwd = PagedForward(draft, engine, kv_dtype=kv_dtype)
        # Injected: the pools a disaggregated pair's two roles share.
        self._kvh = kv_buffers if kv_buffers is not None else KVBuffers(init_kv_buffers(
            c.num_layers, engine.num_blocks, engine.block_size, c.kv_heads, c.head_dim,
            kv_dtype or draft.dtype, self.device,
        ))
        self._decode_fn: Callable[..., torch.Tensor] = self._eager_decode

    @property
    def _kv(self) -> tuple[torch.Tensor, ...]:
        return self._kvh.bufs

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _eager_decode(self, tables, lengths, tokens, active) -> torch.Tensor:
        # use_kernel=None: K4 on CUDA, the masked matmul on the CPU (the
        # reference's draft schedule there).
        return self._fwd.decode_step(
            self._kv, *(self._tensor(a) for a in (tables, lengths, tokens, active)),
            use_kernel=None,
        )

    def warmup(self, inputs: dict[int, tuple], capture: Callable, key: Callable,
               fallback: Callable | None = None) -> int:
        """Build the draft decode step's program for each gather width
        (``inputs``: width -> example inputs) through the engine's
        ``capture``; ``fallback`` (default the eager step) runs a width not
        built. Returns how many were built."""
        self._decode_fn = WarmProgram(
            {w: capture(lambda t, n, tok, a: self._fwd.decode_step(self._kv, t, n, tok, a,
                                                                   use_kernel=None), args)
             for w, args in inputs.items()},
            fallback or self._eager_decode, key,
        )
        return len(inputs)

    # -- engine hooks --------------------------------------------------------
    def copy_block(self, src: int, dst: int) -> None:
        """Mirror the target pools' copy-on-write copy (same block ids: the
        tables are shared)."""
        self._fwd.copy_block(self._kv, src, dst)

    def prefill_chunk(self, table: np.ndarray, chunk: np.ndarray, start: int,
                      n_valid: int) -> None:
        """Ingest one prompt chunk into the draft's pools (same chunk, same
        table); the logits are dropped: the target's prefill emits the first
        token."""
        self._fwd.prefill_chunk(self._kv, self._tensor(table), self._tensor(chunk), start,
                                n_valid)

    def propose(
        self,
        tables: np.ndarray,   # [S, MB] int64 block tables (0-padded)
        lengths: np.ndarray,  # [S] int64 known tokens per slot
        last: np.ndarray,     # [S] int64 each slot's last known token
        n_prop: np.ndarray,   # [S] int64 proposal budget per slot (<= K)
        active: np.ndarray,   # [S] bool
    ) -> tuple[np.ndarray, int]:
        """Run the draft autoregressively for one engine step: step ``j``
        feeds each active row's current token at position ``lengths - 1 +
        j`` and takes the draft's argmax as proposal ``j``. A row whose
        budget is spent goes inactive; the loop runs through ``j =
        max(n_prop)``, one step past the last proposal collected (the KV
        rule in the module docstring). Returns the ``[S, K]`` proposals and
        the number of draft steps."""
        S, K = tables.shape[0], self.spec_k
        props = np.zeros((S, K), np.int64)
        cur = np.asarray(last, np.int64).copy()
        rows = np.asarray(active, bool)
        budget = np.asarray(n_prop, np.int64)
        last_j = int(budget[rows].max()) if rows.any() else 0
        steps = 0
        for j in range(min(last_j, K) + 1):
            act = rows & (j <= budget)
            out = self._decode_fn(tables, np.asarray(lengths + j, np.int64), cur, act)
            steps += 1
            out_np = out.cpu().numpy()  # dmt-lint: disable=DMT003 — the draft's one audited fetch per propose step: proposals feed the host-side accept loop
            if j < K:
                take = act & (j < budget)
                props[take, j] = out_np[take]
            cur = np.where(act, out_np, cur)
        return props, steps
