"""The fleet drills' model, engine, trace and parity check, shared by
``test_torch_fleet.py`` and ``test_torch_fleet_scale.py``."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

#: the reference drills' model and engine (``tools/fleet_drill.py``)
MODEL_SPEC = {"vocab_size": 256, "num_layers": 2, "num_heads": 2, "num_kv_heads": None,
              "head_dim": 16, "d_model": 64, "d_ff": 128, "attention_window": 0}
ENGINE_SPEC = {"max_slots": 3, "block_size": 8, "num_blocks": 32, "max_blocks_per_seq": 6,
               "prefill_chunk": 8, "max_queue": 64}
SEED, SWAP_SEED = 0, 1


def trace(n_burst: int, n_trickle: int, *, dt: float = 0.05, max_new: int = 8) -> list[dict]:
    rng = np.random.default_rng(7)
    entries = []
    for i in range(n_burst + n_trickle):
        n = int(rng.integers(3, 21))
        entries.append({"arrival": 0.0 if i < n_burst else (i - n_burst + 1) * dt,
                        "prompt": [int(t) for t in rng.integers(1, 256, size=n)],
                        "max_new": max_new, "deadline": 0.0})
    return entries


def check_parity(result, swap_seed=None) -> int:
    models = {}
    for rid, rec in sorted(result.requests.items()):
        v = rec["version"]
        if v not in models:
            models[v] = TransformerLM(TransformerConfig(**MODEL_SPEC), dtype=torch.float32,
                                      device="cpu").init_weights(SEED if v == 0 else swap_seed)
        expect = offline_greedy(models[v], np.asarray(rec["prompt"], np.int32), rec["max_new"],
                                None)
        assert rec["tokens"] == expect, f"rid {rid} (version {v}) diverged"
    return len(result.requests)
