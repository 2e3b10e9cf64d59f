"""Seeded DMT006: survivors computed AFTER the teardown kill."""


def teardown(workers):
    for w in workers:
        w.kill()
    return [w for w in workers if w.is_alive()]  # seeded: DMT006 — an empty world
