"""Seeded DMT003: an unaudited host-device sync inside a marked hot loop."""


def decode_loop(step, tokens):  # dmt-lint: hot-loop
    total = 0.0
    for tok in tokens:
        logits = step(tok)
        total += logits.max().item()  # seeded: DMT003 — per-step device fetch
    return total
