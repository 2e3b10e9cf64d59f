"""Autoregressive generation with a KV cache — the LM inference path.

Port of ``deeplearning_mpi_tpu/models/generate.py``: one batched
:func:`prefill` forward over the prompt (K1 on CUDA, dense attention on the
CPU, as the reference picks flash only on its accelerator), then
:func:`decode_tokens` one token at a time. The reference's ``lax.scan``
becomes a Python loop; its ``jax.random`` keys become a
``torch.Generator`` (the two give different numbers from one seed, so
sampled streams differ across packages — greedy ones do not).

Ragged prompts (``prompt_lens``) feed each row's prompt one position at a
time and switch to its own samples at its own length; ``shared_prefix``
prefills the positions every row shares in one batched forward first.
:func:`beam_search` folds the beams into the batch (``B * W`` rows of one
cache, each step's survivors gathering their parents' cache rows).

A tensor-parallel model (``models.transformer``'s ``tp``) runs every path
at its ranks' local heads: K1 per rank for the prefill, K4 per rank for
each decode step.

An MoE model (``moe_experts > 0``) prefills stepwise, as the reference
does: one batched forward would route the whole prompt through the experts
at once, and capacity contention between prompt positions can drop tokens
the position-by-position decode walk keeps. So every caller of
:func:`prefill` (greedy, ``shared_prefix``, beam seeding) fills the cache
with single-token decode steps at positions ``0..P-1`` (K4 on CUDA, never
K1).
"""

from __future__ import annotations

import torch

from deeplearning_mpi_tpu_torch.models.moe import top_k as _top_k
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
    forward (an MoE model: :func:`_prefill_stepwise`). Returns ``(cache,
    logits)``: the last position's ``[B, V]`` logits (the head runs on that
    row only), or all ``[B, P, V]`` with ``last_logits_only=False``."""
    if model.config.moe_experts > 0:
        return _prefill_stepwise(model, prompt, total_len=total_len,
                                 last_logits_only=last_logits_only)
    if attention_fn is None:
        attention_fn = _prefill_attention_fn(prompt.device)
    cache = model.new_cache(prompt.shape[0], total_len, prompt.device)
    x = model(prompt, cache=cache, attention_fn=attention_fn, return_hidden=True)
    if last_logits_only:
        return cache, model.head(x[:, -1])
    return cache, model.head(x)


@torch.no_grad()
def _prefill_stepwise(
    model: TransformerLM, prompt: torch.Tensor, *, total_len: int, last_logits_only: bool = True,
) -> tuple[KVCache, torch.Tensor]:
    """The MoE prefill: :func:`prefill`'s contract, the cache filled by
    single-token decode steps at positions ``0..P-1``, so each position is
    routed as the decode walk routes it."""
    cache = model.new_cache(prompt.shape[0], total_len, prompt.device)
    logits = [model(prompt[:, i:i + 1], cache=cache)[:, 0] for i in range(prompt.shape[1])]
    if last_logits_only:
        return cache, logits[-1]
    return cache, torch.stack(logits, dim=1)


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
    prompt_lens: torch.Tensor | None = None, shared_prefix: int = 0,
) -> torch.Tensor:
    """``[B, P]`` prompt -> ``[B, P + max_new_tokens]`` (prompt included).

    Uniform prompts: one :func:`prefill`, then :func:`decode_tokens`.
    ``prompt_lens`` (``[B]``) batches prompts right-padded to the longest:
    each row feeds its prompt and switches to its own samples at its OWN
    length (pad bytes are never fed), so a short row keeps generating to
    the end of the window — slice row ``b`` at ``prompt_lens[b] +
    max_new_tokens``. ``shared_prefix`` (at most ``min(prompt_lens)``,
    known on the host) prefills that many positions in one forward and
    steps only from there; greedy output is the same for every prefix.
    ``eos_id``: a row that samples it emits it from then on (prompt
    occurrences do not count)."""
    if prompt_lens is not None:
        return _generate_ragged(
            model, prompt, prompt_lens, max_new_tokens=max_new_tokens, generator=generator,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
            shared_prefix=shared_prefix,
        )
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


@torch.no_grad()
def _generate_ragged(
    model: TransformerLM, prompt: torch.Tensor, prompt_lens, *, max_new_tokens: int,
    generator: torch.Generator | None, temperature: float, top_k: int, top_p: float,
    eos_id: int | None, shared_prefix: int,
) -> torch.Tensor:
    """The reference's per-row-switch scan: one decode step per position
    from ``shared_prefix`` on; see :func:`generate`."""
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    plens = torch.as_tensor(prompt_lens, device=prompt.device).long()
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    start = int(shared_prefix)
    if start > 0:
        # The prefix's last logits give the carry the stepwise walk would
        # have at ``start``: used only by rows whose whole prompt is the
        # prefix, with the EOS done-seed gated to those rows.
        cache, logits = prefill(model, prompt[:, :start], total_len=total)
        prev, done = first_token(logits, generator, eos_id=eos_id, **sample)
        done = done & (plens == start)
    else:
        cache = model.new_cache(batch, total, prompt.device)
        prev = torch.zeros(batch, dtype=torch.int32, device=prompt.device)
        done = torch.zeros(batch, dtype=torch.bool, device=prompt.device)
    prev = prev.to(prompt.dtype)
    consumed = []
    for i in range(start, total):
        tok = torch.where(i < plens, prompt[:, min(i, prompt_len - 1)], prev)
        consumed.append(tok)
        if i == total - 1:
            break  # the next sample would lie outside the window
        logits = model(tok[:, None].long(), cache=cache)
        nxt = sample_logits(logits[:, 0], generator, **sample).to(prompt.dtype)
        if eos_id is not None:
            # Row b chooses position i+1's token from i >= plens[b] - 1 on.
            sampled_eos = (nxt == eos_id) & (i >= plens - 1)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | sampled_eos
        prev = nxt
    return torch.cat([prompt[:, :start], torch.stack(consumed, dim=1)], dim=1)


@torch.no_grad()
def beam_search(
    model: TransformerLM, prompt: torch.Tensor, *, max_new_tokens: int, num_beams: int,
    eos_id: int | None = None, length_penalty: float = 0.0,
) -> torch.Tensor:
    """Beam-search decode: ``[B, P]`` prompt -> ``[B, P + max_new_tokens]``,
    the best beam of each row. Deterministic.

    One :func:`prefill` at batch ``B``; the cache fans out to ``B * W`` rows
    (row b's beams are rows ``b*W .. b*W + W-1``). The first step's ``W``
    beams are the top ``W`` of beam 0's candidates (a ``[0, -inf, ...]``
    bias over the ``[W, V]`` table, so ``W > V`` leaves dead beams that are
    never picked). Each later step scores all ``W * V`` continuations,
    keeps the top ``W`` and gathers each survivor's parent cache rows.
    ``eos_id``: a finished beam's only continuation is EOS at no cost, so
    its score freezes; ``length_penalty`` α then ranks final beams by
    ``score / len**α``, ``len`` counting generated tokens through the first
    EOS. Without ``eos_id`` all beams have one length and α is refused.
    """
    if eos_id is None and length_penalty != 0.0:
        raise ValueError(
            "length_penalty requires eos_id: without EOS every beam has the same length "
            "and the penalty cannot change the ranking"
        )
    batch, prompt_len = prompt.shape
    if max_new_tokens < 1:
        return prompt
    total, beams, device = prompt_len + max_new_tokens, num_beams, prompt.device
    neg = -1e30
    cache_b, last_logits = prefill(model, prompt, total_len=total)
    cache = cache_b.map(lambda x: x.repeat_interleave(beams, 0))
    logp0 = torch.log_softmax(last_logits.float(), dim=-1)
    vocab = logp0.shape[-1]
    seed = torch.full((batch, beams, vocab), neg, device=device)
    seed[:, 0] = logp0
    scores, seed_idx = _top_k(seed.reshape(batch, beams * vocab), beams)
    tok = seed_idx % vocab
    finished = (tok == eos_id if eos_id is not None
                else torch.zeros(batch, beams, dtype=torch.bool, device=device))
    lengths = torch.ones(batch, beams, dtype=torch.int32, device=device)
    identity = torch.arange(beams, device=device).expand(batch, beams)
    row_base = torch.arange(batch, device=device)[:, None] * beams
    if eos_id is not None:
        eos_row = torch.full((vocab,), neg, device=device)
        eos_row[eos_id] = 0.0
    consumed, parents = [], []
    for i in range(prompt_len, total):
        consumed.append(tok)
        if i == total - 1:
            parents.append(identity)  # a selection here would lie outside the window
            break
        logits = model(tok.reshape(batch * beams, 1), cache=cache)
        logprobs = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(batch, beams, vocab)
        if eos_id is not None:
            logprobs = torch.where(finished[..., None], eos_row, logprobs)
        scores, top_idx = _top_k((scores[:, :, None] + logprobs).reshape(batch, -1), beams)
        parent = top_idx // vocab
        tok = top_idx % vocab
        if eos_id is not None:
            parent_fin = torch.gather(finished, 1, parent)
            lengths = torch.gather(lengths, 1, parent) + (~parent_fin).to(torch.int32)
            finished = parent_fin | (tok == eos_id)
        flat = (row_base + parent).reshape(-1)
        # A batch-dim gather: under tensor parallelism each rank's heads
        # follow their rows, the head split untouched.
        cache = cache.map(lambda x: x.index_select(0, flat.to(x.device)))
        parents.append(parent)
    # Survivors reorder every step: walk each final beam's ancestry back,
    # mapping the beam into the earlier frame before reading its token.
    beam, gen = identity, []
    for tok_t, parent_t in zip(reversed(consumed), reversed(parents)):
        beam = torch.gather(parent_t, 1, beam)
        gen.append(torch.gather(tok_t, 1, beam))
    gen = torch.stack(gen[::-1], dim=-1)  # [B, W, max_new]
    ranks = scores
    if eos_id is not None and length_penalty != 0.0:
        ranks = scores / lengths.clamp(min=1).float() ** length_penalty
    best = torch.argmax(ranks, dim=1)
    new = gen[torch.arange(batch, device=device), best]
    return torch.cat([prompt, new.to(prompt.dtype)], dim=1)
