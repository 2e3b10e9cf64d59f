"""Decoder-only Transformer LM, in PyTorch: training and inference forward.

Port of ``deeplearning_mpi_tpu/models/transformer.py``: RoPE (split halves,
cos/sin in float32 cast to the activation dtype), RMSNorm (eps 1e-6, f32
accumulation), multi-head attention with grouped K/V heads and an optional
sliding window, SwiGLU, pre-norm blocks and a tied (or untied) head.
Parameters are float32; ``dtype`` is the compute dtype every projection
casts both operands to, as flax ``Dense(dtype=...)`` does.

Three modes, chosen by the arguments of :meth:`TransformerLM.forward`:

- full sequence (``cache=None``): attention by ``attention_fn`` (default
  :func:`~deeplearning_mpi_tpu_torch.ops.attention.dense_attention`);
- prefill (``cache`` empty, several tokens): K/V written into the cache,
  the chunk attends within itself with ``attention_fn`` (K1 on CUDA when
  ``models.generate.prefill`` passes it);
- decode (one token): K/V appended at ``cache.index`` and attended over
  the filled prefix with ``decode_attention``.

An ``attention_fn`` marked ``gqa_native`` (the sequence-parallel
schedules of ``parallel/``) gets the grouped K/V, as in the reference
(``attention_fn_accepts_gqa``); any other gets them repeated to the query
heads. Under sequence parallelism the model runs one shard of the sequence,
its global ``positions`` given (RoPE), and the schedule attends across the
shards. An ``attention_fn`` carrying ``.layout == "bhsd"`` (the port's
``flash_attention_bhsd``) is called on ``[B, H, S, D]`` views of the
projections and its context viewed back: its kernels read element strides,
so the views cost no copy (the reference projects straight into that layout,
``_ProjToBHSD`` / ``_ProjFromBHSD``, because its TPU kernel cannot).

Training options, as in the reference: ``remat`` (``"none"``, ``"full"``:
each block under ``torch.utils.checkpoint``; ``"dots"``: a selective
checkpoint that saves the matmul outputs) and ``return_prehead`` (final-norm
activations and the tied head kernel for ``ops.loss.chunked_lm_loss``). The
reference config's ``onehot_embed`` has no counterpart: it changes only how
the embedding's gradient is computed, never the parameters, so a config
that sets it converts to the same model.

Inference option: ``quantized=True`` builds every block projection as an
``ops.quant.QuantDense`` (int8 kernel, per-output scale), loaded from
``ops.quant.quantize_lm_params`` of a trained state dict; the BHSD
training layout is refused for it, as in the reference.

Speculative decoding's drafts: :func:`draft_config` and
:func:`truncate_lm_params` as in the reference (the latter on the numpy
param tree ``models.convert`` takes), and :func:`self_draft`, the target's
first blocks as a model of their own on its device and dtype.

Mixture of experts: ``moe_experts > 0`` swaps every block's SwiGLU for
a routed ``models.moe.MoEMLP`` (top-k or expert-choice routing, fixed
capacity; its load-balance loss and dropped fraction are read through
``models.moe.collecting``). ``expert_shards`` keeps only this process's
experts (``parallel/expert_parallel.py``). An MoE model has no int8 or
draft counterpart, as in the reference.

Tensor parallelism: ``tp`` (``parallel.tensor_parallel.GroupTP`` or
``LockstepTP``) shards the model by the reference's rule: each block's
attention and SwiGLU become Megatron pairs (``TPPair``: the plain modules
at H/tp, Hkv/tp heads and d_ff/tp, one all-reduce each), the embedding (and
an untied head) is stored as its shards and gathered whole once a forward,
and the norms are replicated. The attention core, K1-K3 on the card, runs
at the rank's local heads; the :class:`KVCache` holds each rank's Hkv/tp
heads (:meth:`TransformerLM.new_cache`). Under MoE each expert's d_ff is
split over the model group (the reference's ``ep_spec``), the router
replicated. A tensor-parallel model has no int8 or draft counterpart.

Sequence parallelism of an MoE model: ``seq`` (a ``parallel.seq_common``
``GroupRing`` or ``LockstepRing``) routes each block's sharded sequence as
the whole sequence's (``models.moe``).

The explicit :class:`KVCache` replaces flax's mutable ``cache``
collection.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from deeplearning_mpi_tpu_torch import resolve_device
from deeplearning_mpi_tpu_torch.models.moe import mlp_from_config
from deeplearning_mpi_tpu_torch.ops.attention import (
    decode_attention,
    dense_attention,
    repeat_kv,
)

# (q, k, v [B,S,H,D], causal=..., [window=...]) -> context [B,S,H,D]
AttentionFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Size knobs for :class:`TransformerLM`; the defaults are the 110M
    model, ``tiny()`` the test config (same values as the reference)."""

    vocab_size: int = 32_000
    num_layers: int = 12
    num_heads: int = 12
    #: grouped-query attention: K/V heads (None = num_heads). Must divide
    #: num_heads.
    num_kv_heads: int | None = None
    head_dim: int = 64
    d_model: int = 768
    d_ff: int = 2048
    tied_embeddings: bool = True
    #: sliding-window attention (0 = unlimited); a model property honoured
    #: by the full-sequence, prefill and decode paths alike.
    attention_window: int = 0
    #: routed MoE MLP in every block (0 = dense SwiGLU); the load-balance
    #: loss weight is a trainer knob, not a model field.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    #: 'token_choice' (top-k + balance loss) or 'expert_choice' (each
    #: expert takes its top-C tokens; routing sees the whole sequence).
    moe_routing: str = "token_choice"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=256, num_layers=2, num_heads=4, head_dim=8,
            d_model=32, d_ff=64,
        )

    @staticmethod
    def tiny_moe(num_experts: int = 4) -> "TransformerConfig":
        return dataclasses.replace(TransformerConfig.tiny(), moe_experts=num_experts)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over ``[B, S, H, D]`` (D even), rotating
    the two halves of D (not interleaved pairs). Angles and cos/sin are
    computed in float32 and cast to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class RMSNorm(nn.Module):
    """Root-mean-square norm, f32 accumulation (f64 for f64 input), learned scale."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        normed = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(x.dtype)


class Dense(nn.Module):
    """Bias-free projection with flax ``Dense(dtype=...)`` numerics: both
    operands cast to the compute dtype, f32 weights untouched."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


def _dense(quantized: bool, dtype: torch.dtype) -> Callable[[int, int], nn.Module]:
    """The block projections' constructor, ``(in, out) -> module``: one
    definition, so Attention and SwiGLU cannot differ in it."""
    if quantized:
        from deeplearning_mpi_tpu_torch.ops.quant import QuantDense

        return lambda n_in, n_out: QuantDense(n_in, n_out, dtype)
    return lambda n_in, n_out: Dense(n_in, n_out, dtype)


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V buffers ``[B, max_len, Hkv, D]`` (zero-initialised:
    the dense decode path reads every row, and 0 x NaN is NaN) plus the
    number of filled positions ``index``. Under tensor parallelism a
    layer's entry is the list of each rank's ``[B, max_len, Hkv/tp, D]``
    buffer, on the rank's device (:meth:`rank` gives rank ``i`` its own)."""

    k: list
    v: list
    index: int = 0

    @staticmethod
    def empty(
        config: TransformerConfig, batch: int, max_len: int,
        dtype: torch.dtype, device: torch.device | str, tp=None,
    ) -> "KVCache":
        """A zero cache; with ``tp`` each rank's heads on each rank's device."""
        if tp is None:
            shape = (batch, max_len, config.kv_heads, config.head_dim)
            zeros = lambda: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        else:
            shape = (batch, max_len, config.kv_heads // tp.size, config.head_dim)
            zeros = lambda: [torch.zeros(shape, dtype=dtype, device=d)  # noqa: E731
                             for d in tp.devices]
        return KVCache(k=[zeros() for _ in range(config.num_layers)],
                       v=[zeros() for _ in range(config.num_layers)])

    @property
    def max_len(self) -> int:
        k = self.k[0]
        return (k[0] if isinstance(k, list) else k).shape[1]

    def rank(self, i: int) -> "KVCache":
        """Rank ``i``'s buffers of a tensor-parallel cache (the same tensors,
        written in place; the index read, not advanced)."""
        return KVCache(k=[x[i] for x in self.k], v=[x[i] for x in self.v], index=self.index)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "KVCache":
        """A cache of ``fn`` of every buffer (a batch-dim op: beam search's
        fan-out and reorder); the index kept."""
        leaf = lambda x: [fn(t) for t in x] if isinstance(x, list) else fn(x)  # noqa: E731
        return KVCache(k=[leaf(x) for x in self.k], v=[leaf(x) for x in self.v],
                       index=self.index)


class Attention(nn.Module):
    """Multi-head self-attention with RoPE, grouped K/V heads and an
    optional sliding window; ``causal=False`` attends both ways over the
    full sequence (an encoder's: ViT)."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype,
                 quantized: bool = False, causal: bool = True) -> None:
        super().__init__()
        c = config
        self.causal = causal
        if c.num_heads % c.kv_heads:
            raise ValueError(
                f"num_kv_heads ({c.kv_heads}) must divide num_heads ({c.num_heads})"
            )
        self.num_heads, self.kv_heads, self.head_dim = c.num_heads, c.kv_heads, c.head_dim
        self.window = c.attention_window or None
        self.quantized = quantized
        dense = _dense(quantized, dtype)
        self.q_proj = dense(c.d_model, c.num_heads * c.head_dim)
        self.k_proj = dense(c.d_model, c.kv_heads * c.head_dim)
        self.v_proj = dense(c.d_model, c.kv_heads * c.head_dim)
        self.out_proj = dense(c.num_heads * c.head_dim, c.d_model)

    def project(
        self, x: torch.Tensor, positions: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q ``[B, S, H, D]`` and k, v ``[B, S, Hkv, D]``, RoPE applied."""
        batch, seq, _ = x.shape
        q = self.q_proj(x).reshape(batch, seq, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(batch, seq, self.kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(batch, seq, self.kv_heads, self.head_dim)
        return apply_rope(q, positions), apply_rope(k, positions), v

    def output(self, ctx: torch.Tensor) -> torch.Tensor:
        batch, seq = ctx.shape[:2]
        return self.out_proj(ctx.reshape(batch, seq, self.num_heads * self.head_dim))

    def _window_kw(self) -> dict:
        return {"window": self.window} if self.window else {}

    def full(self, q, k, v, attention_fn: AttentionFn | None) -> torch.Tensor:
        rep = self.num_heads // self.kv_heads
        attn = attention_fn or dense_attention
        if getattr(attn, "gqa_native", False):
            # The sequence-parallel schedules take GROUPED K/V: they move
            # Hkv heads and repeat after the hop.
            return attn(q, k, v, causal=self.causal, **self._window_kw())
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
        if getattr(attn, "layout", "bshd") == "bhsd":
            if self.quantized:
                raise ValueError(
                    "quantized attention supports the BSHD path only (the BHSD layout "
                    "is a training-path optimization; quantization is inference-only)"
                )
            ctx = attn(*(t.transpose(1, 2) for t in (q, k, v)), causal=self.causal,
                       **self._window_kw())
            return ctx.transpose(1, 2)
        return attn(q, k, v, causal=self.causal, **self._window_kw())

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor, *,
        cache: KVCache | None = None, layer: int = 0,
        attention_fn: AttentionFn | None = None,
    ) -> torch.Tensor:
        q, k, v = self.project(x, positions)
        if cache is None:
            return self.output(self.full(q, k, v, attention_fn))
        seq, i = x.shape[1], cache.index
        k_buf, v_buf = cache.k[layer], cache.v[layer]
        # In-place cache write (the reference returns new buffers).
        k_buf[:, i:i + seq] = k.to(k_buf.dtype)
        v_buf[:, i:i + seq] = v.to(v_buf.dtype)
        if seq != 1:
            # Prefill on an empty cache: the chunk attends within itself.
            return self.output(self.full(q, k, v, attention_fn))
        return self.output(decode_attention(q, k_buf, v_buf, i, window=self.window))


class SwiGLU(nn.Module):
    """Gated MLP: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 quantized: bool = False) -> None:
        super().__init__()
        dense = _dense(quantized, dtype)
        self.gate_proj = dense(d_model, d_ff)
        self.up_proj = dense(d_model, d_ff)
        self.down_proj = dense(d_ff, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(norm(x)); x + mlp(norm(x)). The
    MLP is routed (``models.moe.MoEMLP``) when ``config.moe_experts > 0``.
    ``causal`` as the reference's ``Block``: False for an encoder stack."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype,
                 quantized: bool = False, expert_shards=None, tp=None, tp_plan=None,
                 causal: bool = True, seq=None) -> None:
        super().__init__()
        if tp_plan is not None:
            from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import TPPair
        self.attn_norm = RMSNorm(config.d_model)
        if tp_plan is not None and tp_plan.attention:
            local = dataclasses.replace(config, num_heads=config.num_heads // tp.size,
                                        num_kv_heads=config.kv_heads // tp.size)
            self.attn = TPPair([Attention(local, dtype, causal=causal) for _ in tp.ranks], tp)
        else:
            self.attn = Attention(config, dtype, quantized, causal)
        self.mlp_norm = RMSNorm(config.d_model)
        if config.moe_experts > 0:
            self.mlp = mlp_from_config(config, config.d_model, config.d_ff, dtype, expert_shards,
                                       tp if tp_plan is not None and tp_plan.experts else None,
                                       seq)
        elif tp_plan is not None and tp_plan.mlp:
            self.mlp = TPPair([SwiGLU(config.d_model, config.d_ff // tp.size, dtype)
                               for _ in tp.ranks], tp)
        else:
            self.mlp = SwiGLU(config.d_model, config.d_ff, dtype, quantized)

    def forward(self, x, positions, *, cache=None, layer=0, attention_fn=None):
        x = x + self.attn(
            self.attn_norm(x), positions, cache=cache, layer=layer,
            attention_fn=attention_fn,
        )
        return x + self.mlp(self.mlp_norm(x))


#: Matmul outputs the ``"dots"`` remat policy keeps (the reference's
#: ``jax.checkpoint_policies.checkpoint_dots``); everything else is recomputed.
_DOT_OPS = {
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
}


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "full", "dots")


def run_block(block: Block, x, positions, attention_fn, remat: str) -> torch.Tensor:
    """One block of a full-sequence forward under the ``remat`` policy
    (none while grad is off)."""
    if remat == "none" or not torch.is_grad_enabled():
        return block(x, positions, attention_fn=attention_fn)
    context_fn = (
        functools.partial(create_selective_checkpoint_contexts, _save_dots)
        if remat == "dots" else None
    )
    kw = {} if context_fn is None else {"context_fn": context_fn}
    # A block draws no random numbers: there is no generator state to
    # replay, and a CUDA-graph capture could not read it.
    return checkpoint(block, x, positions, use_reentrant=False, preserve_rng_state=False,
                      attention_fn=attention_fn, **kw)


class TransformerLM(nn.Module):
    """Causal LM: token embed -> N blocks -> final norm -> float32 logits.

    Weights are float32 and uninitialised until :meth:`init_weights` or
    ``load_state_dict``; ``device`` defaults to CUDA (raises without it).
    ``remat`` applies to the full-sequence (training) forward with grad
    enabled; ``return_prehead`` makes that forward return ``(final-norm
    activations, head kernel [d, V])`` for the chunked loss (tied
    embeddings only). ``quantized`` builds the int8 inference model
    (``ops.quant``); ``expert_shards`` (``parallel.expert_parallel``) keeps
    this process's share of an MoE model's experts; ``tp``
    (``parallel.tensor_parallel``) shards the model over a model group, or
    over all its ranks in this process, on ``tp.devices`` (``device`` is
    then ignored); ``seq`` routes an MoE model's sharded sequence."""

    def __init__(
        self, config: TransformerConfig, *, dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda", remat: str = "none",
        return_prehead: bool = False, quantized: bool = False, expert_shards=None, tp=None,
        seq=None,
    ) -> None:
        super().__init__()
        tp = tp if tp is not None and tp.size > 1 else None
        if quantized and (config.moe_experts > 0 or tp is not None):
            raise ValueError("--quantize int8 supports single-device dense models "
                             "(not --tp or --moe_experts yet)")
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r} (expected one of {REMAT_POLICIES})")
        if return_prehead and not config.tied_embeddings:
            raise ValueError(
                "return_prehead requires tied_embeddings (the chunked loss "
                "takes the embedding as the head kernel)"
            )
        plan = None
        if tp is not None:
            from deeplearning_mpi_tpu_torch.parallel import tensor_parallel

            plan = tensor_parallel.plan(config, tp.size)
            device = tp.devices[0]
        self.config, self.dtype = config, dtype
        self.remat, self.return_prehead = remat, return_prehead
        self.expert_shards = expert_shards if config.moe_experts > 0 else None
        self.tp, self.tp_plan = tp, plan
        if plan is not None and plan.embed:
            self.embed = tensor_parallel.ShardedTable(
                (config.vocab_size, config.d_model), plan.dims["embed.weight"], tp)
        else:
            self.embed = nn.Embedding(config.vocab_size, config.d_model)
        self.layers = nn.ModuleList(Block(config, dtype, quantized, self.expert_shards, tp, plan,
                                          seq=seq) for _ in range(config.num_layers))
        self.final_norm = RMSNorm(config.d_model)
        if config.tied_embeddings:
            self.lm_head = None
        elif plan is not None and plan.lm_head:
            self.lm_head = tensor_parallel.ShardedTable(
                (config.vocab_size, config.d_model), plan.dims["lm_head.weight"], tp)
        else:
            self.lm_head = Dense(config.d_model, config.vocab_size, dtype)
        self.to(resolve_device(device))
        self.tp_layout = None
        if tp is not None:
            tensor_parallel.place_shards(self, tp)
            self.tp_layout = tensor_parallel.layout(self, plan)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "TransformerLM":
        """Seeded random init with the reference's distributions (embedding
        normal(0.02), projections and router LeCun truncated normal, norms
        ones), drawn on the CPU so every device gets the same weights. An
        expert stack is drawn whole, ``[E, in, out]``, and this process
        keeps its slice, so every expert sharding holds the same model; a
        tensor-parallel model draws the whole model's leaves in its order
        and keeps its shards."""
        from deeplearning_mpi_tpu_torch.parallel.expert_parallel import is_expert_leaf

        gen = torch.Generator().manual_seed(seed)
        leaves = (self.named_parameters() if self.tp is None
                  else ((n, torch.empty(s, device="meta")) for n, s in self.tp_plan.shapes.items()))
        drawn = {}
        for name, p in leaves:
            expert = is_expert_leaf(name, p)
            shape = (self.config.moe_experts, *p.shape[1:]) if expert else p.shape
            host = torch.empty(shape)
            if name.endswith("scale"):
                host.fill_(1.0)
            elif name == "embed.weight":
                host.normal_(0.0, 0.02, generator=gen)
            else:
                # Dense weight [out, in]: fan_in is the input width. An expert
                # stack [E, in, out]: flax counts the leading E as receptive
                # field, so fan_in is E * in.
                fan_in = shape[0] * shape[1] if expert else shape[1]
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(host, std=std, a=-2 * std, b=2 * std, generator=gen)
            if expert and self.expert_shards is not None:
                host = self.expert_shards.local(host)
            if self.tp is None:
                p.copy_(host)
            else:
                drawn[name] = host
        if self.tp is not None:
            for name, t in self.tp_layout.local(drawn).items():
                self.get_parameter(name).copy_(t)
        return self

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The whole model's parameters (the shards of a tensor-parallel
        model gathered: a collective over its model group), detached."""
        params = {n: p.detach() for n, p in self.named_parameters()}
        return params if self.tp_layout is None else self.tp_layout.gather(params)

    def new_cache(self, batch: int, max_len: int,
                  device: torch.device | str | None = None) -> KVCache:
        """An empty :class:`KVCache` for this model: each rank's heads on its
        device when the attention is split over ``tp``."""
        split = self.tp_plan is not None and self.tp_plan.attention
        return KVCache.empty(self.config, batch, max_len, self.dtype,
                             self.device if device is None else device,
                             tp=self.tp if split else None)

    def _table(self) -> torch.Tensor:
        """The embedding table whole (gathered from its shards under TP)."""
        if isinstance(self.embed, nn.Embedding):
            return self.embed.weight
        return self.embed.full()

    def embed_tokens(self, tokens: torch.Tensor, table: torch.Tensor | None = None) -> torch.Tensor:
        table = self._table() if table is None else table
        return F.embedding(tokens, table.to(self.dtype))

    def head(self, x: torch.Tensor, table: torch.Tensor | None = None) -> torch.Tensor:
        """Final-norm activations -> float32 logits (float64 in a float64
        model; tied: ``x @ E^T`` in the compute dtype, as flax ``Embed.attend``,
        with ``table`` the embedding when the caller holds it whole). An untied
        vocab-parallel head gathers its weight."""
        if self.lm_head is None:
            table = self._table() if table is None else table
            logits = x.to(self.dtype) @ table.to(self.dtype).T
        elif isinstance(self.lm_head, Dense):
            logits = self.lm_head(x)
        else:
            logits = F.linear(x.to(self.dtype), self.lm_head.full().to(self.dtype))
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def forward(
        self,
        tokens: torch.Tensor,
        positions: torch.Tensor | None = None,
        *,
        cache: KVCache | None = None,
        attention_fn: AttentionFn | None = None,
        return_hidden: bool = False,
    ) -> torch.Tensor:
        """Logits ``[B, S, V]`` (or, with ``return_hidden``, the final-norm
        activations ``[B, S, d_model]``; with the model's ``return_prehead``
        and no cache, ``(activations, head kernel)``). With ``cache``: a
        multi-token call prefills an EMPTY cache, a one-token call decodes
        at ``cache.index``; either way the cache advances by ``S``."""
        batch, seq = tokens.shape
        if cache is not None:
            if seq != 1 and cache.index != 0:
                raise ValueError(
                    f"multi-token cache writes are prefill on an empty cache only "
                    f"(cache.index={cache.index}); decode feeds one token per step"
                )
            if cache.index + seq > cache.max_len:
                raise ValueError(
                    f"cache holds {cache.max_len} positions; writing {seq} at "
                    f"{cache.index} overflows it"
                )
        if positions is None:
            start = cache.index if cache is not None else 0
            positions = torch.arange(start, start + seq, device=tokens.device)
            positions = positions[None].expand(batch, seq)
        table = self._table()  # gathered once a forward under TP
        x = self.embed_tokens(tokens, table)
        for i, block in enumerate(self.layers):
            if cache is None:
                x = run_block(block, x, positions, attention_fn, self.remat)
            else:
                x = block(x, positions, cache=cache, layer=i, attention_fn=attention_fn)
        if cache is not None:
            cache.index += seq
        x = self.final_norm(x)
        if return_hidden:
            return x
        if self.return_prehead and cache is None:
            return x, table.T
        return self.head(x, table if self.lm_head is None else None)


def draft_config(config: TransformerConfig, num_layers: int, **overrides) -> TransformerConfig:
    """A draft-model config derived from a target's: same vocab (draft and
    target must share a tokenizer), fewer layers, any width knob
    overridable. The default, depth-only truncation pairs with
    :func:`truncate_lm_params` / :func:`self_draft` for a "self-draft"
    made of the target's own weights."""
    if not 1 <= num_layers <= config.num_layers:
        raise ValueError(
            f"draft num_layers must be in [1, {config.num_layers}], got {num_layers}"
        )
    if config.moe_experts > 0:
        raise ValueError("draft models must be dense (no MoE)")
    return dataclasses.replace(config, num_layers=num_layers, **overrides)


def truncate_lm_params(params: dict, num_layers: int) -> dict:
    """Self-draft params from the reference's param tree (numpy leaves, as
    ``models.convert.lm_params_from_jax`` takes it): the embedding, the
    first ``num_layers`` blocks, the final norm and an untied ``lm_head``,
    referenced, not copied."""
    if f"layer_{num_layers - 1}" not in params:
        raise ValueError(f"target params hold fewer than {num_layers} layers")
    keep = {"embed", "final_norm", "lm_head"} | {f"layer_{i}" for i in range(num_layers)}
    return {k: v for k, v in params.items() if k in keep}


def self_draft(target: TransformerLM, num_layers: int) -> TransformerLM:
    """The target's embedding, first ``num_layers`` blocks, final norm and
    head as a :class:`TransformerLM` of :func:`draft_config`'s shape, on
    the target's device and in its compute dtype. The modules are the
    target's own (shared, not copied), as :func:`truncate_lm_params` shares
    the reference's arrays."""
    draft = TransformerLM(draft_config(target.config, num_layers), dtype=target.dtype,
                          device="meta")
    draft.embed = target.embed
    draft.layers = nn.ModuleList(list(target.layers)[:num_layers])
    draft.final_norm = target.final_norm
    draft.lm_head = target.lm_head
    return draft
