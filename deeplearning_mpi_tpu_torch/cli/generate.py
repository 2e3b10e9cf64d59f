"""Text generation from a checkpoint of the port's ``cli.train_lm``.

Port of ``deeplearning_mpi_tpu/cli/generate.py``: restore the weights of a
checkpoint (params-only: the optimizer state is never read, so no
optimizer flag is needed; ``--ema`` decodes the averaged weights), check
the ``arch.json`` sidecar, and decode byte tokens (vocab 256) with the
KV-cached path (``models/generate.py``): K1 prefills and K4 decodes on the
card. ``--prompts_file`` decodes one prompt per line as one ragged batch
(the shared prefix ``min(lengths)`` prefilled in one forward), one output
line per prompt; ``--num_beams N > 1`` runs beam search on one prompt;
``--quantize int8`` converts the block weights after restore (dense models
only). An MoE checkpoint (``--moe_experts``) prefills stepwise, every
prompt position a decode step (K4 on the card). ``--tp N`` decodes the
Megatron-sharded model in one process (``parallel.tensor_parallel``'s
``LockstepTP``): shard ``i`` on ``cuda:i`` (every shard on the CPU with
``--device cpu``), K1 and K4 per rank at its local heads; fewer visible
cards than ``N`` is refused, as is ``--quantize int8`` with it.

    python -m deeplearning_mpi_tpu_torch.cli.generate --model_dir /tmp/lm \\
        --num_layers 2 --num_heads 2 --head_dim 8 --d_model 16 --d_ff 32 \\
        --prompt "ab" --max_new_tokens 8 --greedy [--device cpu]

Model-shape flags must match the training run: the checkpoint stores
tensors, not the architecture.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.utils.config import ema_decay


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="generate",
                                     description="Generate text from a train_lm checkpoint.")
    model = parser.add_argument_group(
        "model (MUST match the training run — the checkpoint stores tensors, not architecture)")
    model.add_argument("--seq_len", type=int, default=512,
                       help="accepted for flag-compatibility with train_lm; unused")
    model.add_argument("--num_layers", type=int, default=4)
    model.add_argument("--num_heads", type=int, default=8)
    model.add_argument("--num_kv_heads", type=int, default=0)
    model.add_argument("--head_dim", type=int, default=32)
    model.add_argument("--d_model", type=int, default=256)
    model.add_argument("--d_ff", type=int, default=1024)
    model.add_argument("--attention_window", type=int, default=0)
    model.add_argument("--moe_experts", type=int, default=0,
                       help="0 = dense SwiGLU MLP; N: the routed MoE of the training run")
    model.add_argument("--moe_top_k", type=int, default=2)
    model.add_argument("--moe_routing", default="token_choice",
                       choices=("token_choice", "expert_choice"))
    model.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                       help="compute dtype (the checkpoint's weights are float32)")
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--model_filename", default="lm")
    parser.add_argument("--ema", type=ema_decay, default=0.0,
                        help="nonzero: decode the EMA weights of an --ema run (the value "
                        "is unused)")
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch to load (default: latest)")
    gen = parser.add_argument_group("generation")
    gen.add_argument("--prompt", default="",
                     help="UTF-8 prompt (byte tokens); empty = byte 0")
    gen.add_argument("--prompts_file", default=None,
                     help="one prompt per line, decoded as one ragged batch; one output "
                     "line per prompt (sampling only)")
    gen.add_argument("--max_new_tokens", type=int, default=128)
    gen.add_argument("--temperature", type=float, default=1.0)
    gen.add_argument("--top_k", type=int, default=0)
    gen.add_argument("--top_p", type=float, default=1.0)
    gen.add_argument("--greedy", action="store_true", help="argmax decoding")
    gen.add_argument("--num_beams", type=int, default=1,
                     help="N > 1: beam search over N beams (deterministic; sampling flags "
                     "ignored)")
    gen.add_argument("--eos_id", type=int, default=-1,
                     help="byte that ends a row or beam (EOS-padded to the full length); "
                     "-1 = off")
    gen.add_argument("--length_penalty", type=float, default=0.0,
                     help="beam ranking score / len**alpha; needs --eos_id")
    gen.add_argument("--random_seed", type=int, default=0)
    gen.add_argument("--quantize", default="none", choices=("none", "int8"),
                     help="int8: weight-only int8 block projections, converted after "
                     "restore")
    gen.add_argument("--time", action="store_true",
                     help="print throughput to stderr: an untimed pass, then a timed one; "
                     "uniform sampling splits prefill from decode tokens/s, beam and "
                     "ragged runs report stepped positions/s")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    from deeplearning_mpi_tpu_torch.utils.config import add_not_applicable

    add_not_applicable(parser, "platform", "n_virtual_devices")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: the Megatron-sharded model in one "
                        "process, shard i on cuda:i")
    return parser


@dataclasses.dataclass
class Generated:
    """What a run produced: ``tokens`` ``[rows, P + max_new_tokens]``, each
    row's prompt length, and the ``--time`` figures."""

    tokens: np.ndarray
    prompt_lens: np.ndarray
    max_new_tokens: int
    timing: dict[str, float] | None = None

    def windows(self) -> list[np.ndarray]:
        """Each row cut at its own prompt length + ``max_new_tokens`` (a
        short ragged row keeps generating to the end of the batch's window)."""
        return [row[: n + self.max_new_tokens] for row, n in zip(self.tokens, self.prompt_lens)]


def _argv_error(args) -> str | None:
    """The argv checks, made before any restore."""
    if args.tp < 1:
        return f"--tp must be >= 1, got {args.tp}"
    if args.quantize == "int8" and (args.tp > 1 or args.moe_experts > 0):
        return ("--quantize int8 supports single-device dense models (not --tp or "
                "--moe_experts yet)")
    eos_id = args.eos_id if args.eos_id >= 0 else None
    if eos_id is not None and eos_id > 255:
        return (f"--eos_id {eos_id} is outside the byte vocab (0-255) — it could never be "
                "emitted, silently disabling stopping")
    if args.length_penalty != 0.0 and eos_id is None:
        return ("--length_penalty requires --eos_id: without EOS every beam has the same "
                "length and the penalty cannot change the ranking")
    if args.length_penalty != 0.0 and args.num_beams <= 1:
        return "--length_penalty only applies to --num_beams > 1"
    if args.prompts_file and args.prompt:
        return "--prompt and --prompts_file are mutually exclusive"
    if args.prompts_file and args.num_beams > 1:
        return "--prompts_file batches the sampling path; --num_beams is single-prompt"
    return None


def _read_prompts(path: str) -> list[str]:
    try:
        lines = Path(path).read_text(encoding="utf-8").splitlines()
    except OSError as e:
        raise SystemExit(f"cannot read --prompts_file: {e}") from e
    blank = [n for n, line in enumerate(lines, 1) if not line.strip()]
    if blank:
        raise SystemExit(f"{path}: blank prompt line(s) {blank[:5]} — every line must be a "
                         "prompt (one output line per input line)")
    if not lines:
        raise SystemExit(f"{path} has no prompts")
    return lines


def tp_ranks(args, device: torch.device):
    """``--tp``'s ``LockstepTP`` (None at 1): shard ``i`` on ``cuda:i``, or
    every shard on the CPU; refused when fewer cards are visible, as the
    reference refuses fewer devices (never several shards on one card)."""
    if args.tp == 1:
        return None
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP

    if device.type == "cpu":
        return LockstepTP(args.tp, "cpu")
    have = torch.cuda.device_count()
    if have < args.tp:
        raise SystemExit(f"--tp {args.tp} needs {args.tp} devices, have {have}: one shard a card "
                         "(--device cpu puts every shard on the CPU)")
    return LockstepTP(args.tp, [torch.device("cuda", i) for i in range(args.tp)])


def load_model(args, device: torch.device):
    """The restored model (``utils.config.restore_lm``), sharded with
    ``--tp``, int8 with ``--quantize int8``; refusals raise ``SystemExit``."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.utils.config import restore_lm

    cfg = TransformerConfig(
        vocab_size=256, num_layers=args.num_layers, num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads or None, head_dim=args.head_dim,
        d_model=args.d_model, d_ff=args.d_ff, attention_window=args.attention_window,
        moe_experts=args.moe_experts, moe_top_k=args.moe_top_k, moe_routing=args.moe_routing,
    )
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = restore_lm(cfg, dtype=dtype, device=device, model_dir=args.model_dir,
                       model_filename=args.model_filename, epoch=args.epoch, ema=args.ema > 0,
                       tp=tp_ranks(args, device))
    if args.quantize == "int8":
        from deeplearning_mpi_tpu_torch.ops.quant import quantize_lm_params

        qmodel = TransformerLM(cfg, dtype=dtype, device=device, quantized=True)
        qmodel.load_state_dict(quantize_lm_params(model.state_dict()))
        model = qmodel
    return model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv: list[str] | None = None) -> Generated:
    """Parse ``argv``, restore and decode; refusals raise ``SystemExit``
    with their message."""
    args = build_parser().parse_args(argv)
    err = _argv_error(args)
    if err:
        raise SystemExit(err)
    prompt_texts = _read_prompts(args.prompts_file) if args.prompts_file else [args.prompt]
    from deeplearning_mpi_tpu_torch import resolve_device
    from deeplearning_mpi_tpu_torch.models.generate import (
        beam_search,
        decode_tokens,
        first_token,
        generate,
        prefill,
    )

    device = resolve_device(args.device)
    model = load_model(args, device)
    eos_id = args.eos_id if args.eos_id >= 0 else None
    rows = [np.frombuffer(t.encode("utf-8") or b"\x00", np.uint8).astype(np.int64)
            for t in prompt_texts]
    lens = np.array([len(r) for r in rows])
    padded = np.zeros((len(rows), int(lens.max())), np.int64)
    for b, r in enumerate(rows):
        padded[b, : len(r)] = r
    prompt = torch.from_numpy(padded).to(device)
    # A uniform batch takes the prefill + decode path; a ragged one steps
    # only past the shared prefix.
    ragged = int(lens.min()) != int(lens.max())
    sample = dict(temperature=0.0 if args.greedy else args.temperature,
                  top_k=0 if args.greedy else args.top_k,
                  top_p=1.0 if args.greedy else args.top_p)

    def generator():
        return torch.Generator(device=device).manual_seed(args.random_seed)

    if args.num_beams > 1:
        def call():
            return beam_search(model, prompt, max_new_tokens=args.max_new_tokens,
                               num_beams=args.num_beams, eos_id=eos_id,
                               length_penalty=args.length_penalty)
    else:
        def call():
            return generate(model, prompt, max_new_tokens=args.max_new_tokens,
                            generator=generator(), eos_id=eos_id,
                            prompt_lens=torch.from_numpy(lens) if ragged else None,
                            shared_prefix=int(lens.min()) if ragged else 0, **sample)

    timing = None
    split = args.time and args.num_beams == 1 and not ragged
    if split and args.max_new_tokens < 2:
        print("--time needs --max_new_tokens >= 2 for the prefill/decode split (the first "
              "token comes from the prefill) — running untimed", file=sys.stderr)
        split = False
    if split:
        # Prefill and decode timed apart, each after an untimed pass; the
        # generator's draws are generate()'s, so the text is the untimed run's.
        p_len, batch = prompt.shape[1], prompt.shape[0]

        def timed(fn):
            fn()
            _sync(device)
            t0 = time.perf_counter()
            result = fn()
            _sync(device)
            return result, time.perf_counter() - t0

        total = p_len + args.max_new_tokens
        (cache, logits), dt_pre = timed(lambda: prefill(model, prompt, total_len=total))
        cache_index = cache.index

        def decode():
            gen = generator()
            first, done = first_token(logits, gen, eos_id=eos_id, **sample)
            cache.index = cache_index  # the untimed pass advanced it
            return decode_tokens(model, cache, first, steps=args.max_new_tokens,
                                 generator=gen, eos_id=eos_id, done=done, **sample)

        new, dt_dec = timed(decode)
        out = torch.cat([prompt, new.to(prompt.dtype)], dim=1)
        steps = args.max_new_tokens - 1  # the first token came from the prefill
        timing = {"prefill_tokens": batch * p_len, "prefill_s": dt_pre,
                  "decode_steps": batch * steps, "decode_s": dt_dec,
                  "decode_tokens_per_s": batch * steps / dt_dec}
        print(f"prefill: {batch * p_len} tokens in {dt_pre:.3f}s = "
              f"{batch * p_len / dt_pre:.1f} tokens/s | decode: {batch * steps} steps in "
              f"{dt_dec:.3f}s = {timing['decode_tokens_per_s']:.1f} tokens/s",
              file=sys.stderr)
    else:
        out = call()
    if args.time and not split and (args.num_beams > 1 or ragged):
        _sync(device)
        t0 = time.perf_counter()
        out = call()
        _sync(device)
        dt = time.perf_counter() - t0
        # Count only the stepped positions: beam search prefills the whole
        # prompt, the ragged batch its shared prefix.
        start = prompt.shape[1] if args.num_beams > 1 else int(lens.min())
        positions = out.shape[0] * (prompt.shape[1] + args.max_new_tokens - start)
        timing = {"positions": positions, "seconds": dt, "positions_per_s": positions / dt}
        print(f"scan: {positions} sequential positions ({args.max_new_tokens} new; {start} "
              f"prefix positions prefilled in one batched forward) in {dt:.3f}s = "
              f"{positions / dt:.1f} positions/s", file=sys.stderr)
    return Generated(tokens=out.cpu().numpy(), prompt_lens=lens,
                     max_new_tokens=args.max_new_tokens, timing=timing)


def main(argv: list[str] | None = None) -> int:
    try:
        result = run(argv)
    except SystemExit as refusal:
        if not isinstance(refusal.code, str):
            raise
        print(refusal.code, file=sys.stderr)
        return 1
    for row in result.windows():
        print(row.astype(np.uint8).tobytes().decode("utf-8", errors="replace"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
