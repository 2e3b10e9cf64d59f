"""Seeded DMT008: direct wall-clock read in a clock-pure policy scope."""
# dmt-lint: scope=policy
import time


def admit(queue, deadline):
    now = time.monotonic()  # seeded: DMT008 — breaks fake-clock replay
    return [r for r in queue if r.deadline is None or r.deadline > now]
