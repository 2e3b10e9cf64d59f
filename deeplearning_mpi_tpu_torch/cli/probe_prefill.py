"""The engine's prefill-chunk attention on one GPU, three ways: the masked
matmul, K1's square call over the slot's pages, and K1's call cut at the
chunk's last row (``serving.engine.chunk_attention``).

    python3 deeplearning_mpi_tpu_torch/cli/probe_prefill.py [--out FILE]

On ``chip_smoke.py``'s phase-5 model (the 110M ``TransformerConfig()``,
float32, TF32 off), engine and trace it
1. times each way's attention call, by CUDA events, at every chunk the trace
   prefills (128-row chunks over 1024 page rows) and prints the sum over
   the trace's chunks and the model's layers;
2. replays the trace on a fresh eager engine for each way, in the order
   matmul, square, cut, cut, square, matmul, holds every stream to offline
   greedy and prints TTFT p50 / p95 and the replay's wall time.
Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
ARMS = ("matmul", "square", "cut")


def square_chunk_attention(q, k, v, start, *, window=None):
    """K1 over the whole ``[1, max(L, start + C), H, D]`` square: the
    chunk's rows at their positions, every page row kept."""
    import torch

    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention

    C, L = q.shape[1], k.shape[1]
    S = max(L, start + C)
    q_full = q.new_zeros((q.shape[0], S, *q.shape[2:]))
    q_full[:, start:start + C] = q
    if S > L:
        pad = k.new_zeros((k.shape[0], S - L, *k.shape[2:]))
        k, v = torch.cat([k, pad], dim=1), torch.cat([v, pad], dim=1)
    return flash_attention(q_full, k, v, causal=True, window=window)[:, start:start + C]


def attention_fn(arm: str):
    from deeplearning_mpi_tpu_torch.ops.attention import dense_attention
    from deeplearning_mpi_tpu_torch.serving.engine import chunk_attention

    if arm == "matmul":
        return lambda q, k, v, start: dense_attention(q, k, v, causal=True, q_offset=start)
    return square_chunk_attention if arm == "square" else chunk_attention


def engine_for(arm: str, model, engine_cfg):
    """A fresh engine whose prefill chunks attend the ``arm`` way."""
    from deeplearning_mpi_tpu_torch.serving import ServingEngine
    from deeplearning_mpi_tpu_torch.serving import engine as engine_mod

    engine = ServingEngine(model, engine_cfg)
    prefill = engine._fwd.prefill_chunk

    def chunk(*args, **kw):
        if arm == "matmul":
            return prefill(*args, **{**kw, "use_kernel": False})
        real = engine_mod.chunk_attention
        engine_mod.chunk_attention = attention_fn(arm)
        try:
            return prefill(*args, **kw)
        finally:
            engine_mod.chunk_attention = real

    engine._fwd.prefill_chunk = chunk
    return engine


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="also write the result JSON here")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_prefill: CUDA is not available", file=sys.stderr)
        return 1
    from deeplearning_mpi_tpu_torch.cli.serve_lm import latency_report, offline_greedy, replay
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.serving import EngineConfig

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig()
    engine_cfg = EngineConfig(**cs.SERVE_ENGINE)
    C, L = engine_cfg.prefill_chunk, engine_cfg.max_blocks_per_seq * engine_cfg.block_size
    result = {"card": cs.gpu_name_and_power(), "chunk": C, "pages": L, "layers": cfg.num_layers}

    # 1. Each way's attention call at every chunk of the trace.
    starts = [s for n in cs.SERVE_PROMPTS for s in range(0, n, C)]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q = torch.randn(1, C, cfg.num_heads, cfg.head_dim, generator=gen, device="cuda")
    k, v = (torch.randn(1, L, cfg.num_heads, cfg.head_dim, generator=gen, device="cuda")
            for _ in range(2))
    per_start = {arm: {} for arm in ARMS}
    for start in sorted(set(starts)):
        want = attention_fn("matmul")(q, k, v, start)
        for arm in ARMS:
            fn = attention_fn(arm)
            err = float((fn(q, k, v, start) - want).abs().max())
            per_start[arm][start] = {"ms": cs.time_ms(lambda: fn(q, k, v, start)),
                                     "max_abs_err_vs_matmul": err}
    result["attention"] = {
        arm: {"per_start": per_start[arm],
              "trace_ms": cfg.num_layers * sum(per_start[arm][s]["ms"] for s in starts)}
        for arm in ARMS
    }
    for arm in ARMS:
        print(f"prefill attention {arm}: {result['attention'][arm]['trace_ms']:.4f} ms over the "
              f"trace's {len(starts)} chunks x {cfg.num_layers} layers; per start " + ", ".join(
                  f"{s}: {r['ms']:.4f} ms (err {r['max_abs_err_vs_matmul']:.2e})"
                  for s, r in per_start[arm].items()), flush=True)

    # 2. The trace end to end, each way on a fresh eager engine.
    model = TransformerLM(cfg, dtype=torch.float32, device="cuda").init_weights(args.seed)
    entries = cs.serve_trace(cfg.vocab_size, args.seed)
    expects = [offline_greedy(model, e["prompt"], e["max_new"], None) for e in entries]
    replay(engine_for("cut", model, engine_cfg), entries)  # warm the allocator and kernels
    result["replays"] = []
    for arm in (*ARMS, *reversed(ARMS)):
        reqs, wall_s = replay(engine_for(arm, model, engine_cfg), entries)
        torch.cuda.synchronize()
        rep = latency_report(reqs, wall_s)
        equal = [r.generated for r in reqs] == expects
        result["replays"].append({"arm": arm, "equal_to_offline_greedy": equal, **rep})
        print(f"replay {arm}: ttft p50 {rep['ttft_p50_s']:.4f} s, p95 {rep['ttft_p95_s']:.4f} s, "
              f"tpot p50 {rep['tpot_p50_s']:.4f} s, wall {wall_s:.3f} s, streams equal to "
              f"offline greedy: {equal}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    ok = all(r["equal_to_offline_greedy"] for r in result["replays"])
    print(json.dumps({"card": result["card"], "ok": ok,
                      "trace_attention_ms": {a: result["attention"][a]["trace_ms"] for a in ARMS},
                      "ttft_p50_s": {a: [r["ttft_p50_s"] for r in result["replays"]
                                         if r["arm"] == a] for a in ARMS}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
