"""Autoregressive generation with a KV cache — the LM inference path.

Port of ``deeplearning_mpi_tpu/models/generate.py``: one batched
:func:`prefill` forward over the prompt (K1 on CUDA, dense attention on the
CPU, as the reference picks flash only on its accelerator), then
:func:`decode_tokens` one token at a time. The reference's ``lax.scan``
becomes a Python loop; its ``jax.random`` keys become a
``torch.Generator`` (the two give different numbers from one seed, so
sampled streams differ across packages — greedy ones do not).

Ragged prompts (``prompt_lens`` / ``shared_prefix``) and beam search come
in a later slice.
"""

from __future__ import annotations

import torch

from deeplearning_mpi_tpu_torch.models.transformer import KVCache, TransformerLM


def filter_logits(
    logits: torch.Tensor, *, temperature: float = 1.0, top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Temperature-scaled float32 logits with the top-k, then top-p, filters
    applied (removed tokens at ``-inf``) — the distribution
    :func:`sample_logits` draws from."""
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        # Keep a token while the mass BEFORE it is < top_p; the top token is
        # always kept (top_p <= 0 means argmax only).
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        threshold = torch.where(keep, desc, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= threshold, logits, float("-inf"))
    return logits


def sample_logits(
    logits: torch.Tensor, generator: torch.Generator | None = None, *,
    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
) -> torch.Tensor:
    """Token ids ``[B]`` from ``[B, V]`` logits: ``temperature == 0`` is
    greedy argmax (first maximum on ties, as ``jnp.argmax``); otherwise a
    draw from :func:`filter_logits`'s distribution with ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(
        filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p), dim=-1
    )
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _prefill_attention_fn(device: torch.device):
    """K1 on CUDA; dense attention (the model default) on the CPU."""
    if device.type == "cuda":
        from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention

        return flash_attention
    return None


@torch.no_grad()
def prefill(
    model: TransformerLM, prompt: torch.Tensor, *, total_len: int,
    attention_fn=None, last_logits_only: bool = True,
) -> tuple[KVCache, torch.Tensor]:
    """Fill a fresh ``total_len`` KV cache with ``prompt`` ``[B, P]`` in one
    forward. Returns ``(cache, logits)``: the last position's ``[B, V]``
    logits (the head runs on that row only), or all ``[B, P, V]`` with
    ``last_logits_only=False``."""
    if attention_fn is None:
        attention_fn = _prefill_attention_fn(prompt.device)
    cache = KVCache.empty(
        model.config, prompt.shape[0], total_len, model.dtype, prompt.device
    )
    x = model(prompt, cache=cache, attention_fn=attention_fn, return_hidden=True)
    if last_logits_only:
        return cache, model.head(x[:, -1])
    return cache, model.head(x)


def first_token(
    logits: torch.Tensor, generator: torch.Generator | None = None, *,
    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
    eos_id: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample the first generated token from the prefill's ``[B, V]``
    logits; returns ``(token, done)``."""
    tok = sample_logits(logits, generator, temperature=temperature, top_k=top_k, top_p=top_p)
    done = tok == eos_id if eos_id is not None else torch.zeros_like(tok, dtype=torch.bool)
    return tok, done


@torch.no_grad()
def decode_tokens(
    model: TransformerLM, cache: KVCache, first: torch.Tensor, *,
    steps: int, generator: torch.Generator | None = None,
    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
    eos_id: int | None = None, done: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode ``steps - 1`` model steps from a filled cache. ``first``
    ``[B]`` is the token at position ``cache.index`` (already sampled);
    returns ``[B, steps]``. Rows in ``done`` (or that sample ``eos_id``)
    emit ``eos_id`` from then on."""
    if steps < 1:
        raise ValueError(f"decode_tokens needs steps >= 1, got {steps}")
    if done is None:
        done = torch.zeros_like(first, dtype=torch.bool)
    out = [first]
    tok = first
    for _ in range(steps - 1):
        logits = model(tok[:, None].long(), cache=cache)
        nxt = sample_logits(
            logits[:, 0], generator, temperature=temperature, top_k=top_k, top_p=top_p
        )
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


@torch.no_grad()
def generate(
    model: TransformerLM, prompt: torch.Tensor, *, max_new_tokens: int,
    generator: torch.Generator | None = None, temperature: float = 1.0,
    top_k: int = 0, top_p: float = 1.0, eos_id: int | None = None,
) -> torch.Tensor:
    """``[B, P]`` prompt -> ``[B, P + max_new_tokens]`` (prompt included):
    one :func:`prefill`, then :func:`decode_tokens`."""
    if max_new_tokens < 1:
        return prompt
    cache, logits = prefill(model, prompt, total_len=prompt.shape[1] + max_new_tokens)
    first, done = first_token(
        logits, generator, temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id
    )
    new = decode_tokens(
        model, cache, first, steps=max_new_tokens, generator=generator,
        temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id, done=done,
    )
    return torch.cat([prompt, new.to(prompt.dtype)], dim=1)
