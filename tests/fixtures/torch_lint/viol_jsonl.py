"""Seeded DMT005: raw write-mode open of a JSONL stream outside JsonlSink."""


def start_stream(path):
    return open(path / "steps.jsonl", "a")  # seeded: DMT005 — a second writer
