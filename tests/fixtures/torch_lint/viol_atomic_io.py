"""Seeded DMT004: non-atomic JSON write in an IO-critical scope."""
# dmt-lint: scope=resilience
import json

import torch


def write_state(path, step: torch.Tensor):
    path.write_text(json.dumps({"step": int(step)}))  # seeded: DMT004 — torn-file hazard
