"""Seeded DMT007: a metric name missing from the canonical schema."""


def record(registry, loss):
    registry.gauge("train_compile_secs").set(loss)  # seeded: DMT007 — typo'd name
