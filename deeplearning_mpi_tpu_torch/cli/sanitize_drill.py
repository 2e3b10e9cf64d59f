"""Sanitizer drill: inject the bugs the runtime sanitizer exists to catch.

    python -m deeplearning_mpi_tpu_torch.cli.sanitize_drill --device cpu
    python -m deeplearning_mpi_tpu_torch.cli.sanitize_drill            # on the card

Port of the reference's ``tools/sanitize_drill.py``, run with
``DMT_SANITIZE=1`` (set here before anything is built: the sanitizer is
read when a pool, engine or checkpointer is constructed). Six injections,
each a past bug class, each of which must raise ``SanitizerError``, be
counted exactly once under its class and be mirrored into the registry:

- **KV double free** — free the same blocks twice;
- **KV use after free** — record a data write against freed blocks;
- **KV refcount underflow** — tear a shared block's count below one and
  free it;
- **KV copy-on-write violation** — record a write against a block with
  refcount > 1 (a prefix-cache sharer skipping the copy);
- **capture after warmup** — a warmed engine (tiny LM on ``--device``)
  serves a request with zero trips, then a second ``warmup()`` captures a
  program again (the port's retrace); the eager fallback at a gather width
  warmup did not capture trips the same class;
- **donation canary** — a checkpoint save of a tiny train state during
  which an in-place ``add_`` reaches the hashed tensor.

The clean paths (a full alloc / fill / share / free cycle, the warmed
request, a clean save) must trip nothing. Prints ``sanitize-smoke OK`` and
exits 0 only if every injection is caught and classified.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Callable


class Drill:
    """The drill's checks and their outcomes."""

    def __init__(self) -> None:
        self.failures: list[str] = []
        #: injection -> (trip class, count before, count after)
        self.injections: dict[str, tuple[str, int, int]] = {}

    def check(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def expect_trip(self, counter: str, what: str, fn: Callable[[], object], registry) -> None:
        """Run ``fn``: it must raise SanitizerError classified as
        ``counter``, counted once, and mirrored into ``registry``."""
        from deeplearning_mpi_tpu_torch.analysis import sanitizer

        before = sanitizer.trip_counts().get(counter, 0)
        mirrored = registry.counter(counter).value
        try:
            fn()
        except sanitizer.SanitizerError as err:
            after = sanitizer.trip_counts().get(counter, 0)
            self.injections[what] = (counter, before, after)
            self.check(counter in str(err), f"{what}: classified as {counter}")
            self.check(after == before + 1, f"{what}: trip counted once ({before}->{after})")
            self.check(registry.counter(counter).value == mirrored + 1,
                       f"{what}: mirrored into the registry")
            return
        self.check(False, f"{what}: SanitizerError was NOT raised")


def drill_kv_pool(d: Drill, registry) -> None:
    from deeplearning_mpi_tpu_torch.analysis import sanitizer
    from deeplearning_mpi_tpu_torch.serving.kv_pool import PagedKVPool

    print("kv-pool poisoning:")
    pool = PagedKVPool(8, 4)
    blocks = pool.alloc(2)
    pool.free(blocks)
    d.expect_trip(sanitizer.KV_DOUBLE_FREE, "double free", lambda: pool.free(blocks), registry)
    stale = pool.alloc(2)
    pool.free(stale)
    d.expect_trip(sanitizer.KV_USE_AFTER_FREE, "use after free",
                  lambda: pool.record_fill(stale), registry)
    # A count below one on a block still in the used set is what a sharer
    # freed twice leaves behind; the next free must classify it.
    torn = pool.alloc(1)
    pool._refcount[torn[0]] = 0
    d.expect_trip(sanitizer.KV_REFCOUNT_UNDERFLOW, "refcount underflow",
                  lambda: pool.free(torn), registry)
    del pool._refcount[torn[0]]
    pool.free(torn)
    shared = pool.alloc(1)
    pool.share(shared)
    d.expect_trip(sanitizer.KV_COW_VIOLATION, "write to a shared block without copy-on-write",
                  lambda: pool.record_fill(shared), registry)
    pool.free(shared)  # the cache's reference (count 2 -> 1) ...
    pool.record_fill(shared)  # ... sole owner again: writes are legal
    pool.free(shared)
    before = dict(sanitizer.trip_counts())
    again = pool.alloc(3)
    pool.record_fill(again)
    pool.share(again[:1])
    pool.free(again)
    pool.free(again[:1])
    pool.alloc(1)
    pool.check()
    d.check(sanitizer.trip_counts() == before, "clean alloc/fill/share/free cycle trips nothing")


def drill_retrace(d: Drill, registry, device: str) -> None:
    import numpy as np
    import torch

    from deeplearning_mpi_tpu_torch.analysis import sanitizer
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, RequestState, ServingEngine

    print(f"retrace tripwire ({device}):")
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32,
                          device=device).init_weights(0)
    e = EngineConfig(max_slots=2, block_size=8, num_blocks=16, max_blocks_per_seq=4,
                     prefill_chunk=8, max_queue=8)
    eng = ServingEngine(model, e, registry=registry)
    eng.warmup()
    before = sanitizer.trip_counts().get(sanitizer.RETRACE_TRIPS, 0)
    req = eng.submit(np.arange(1, 9, dtype=np.int32), 4)
    eng.run_until_idle()
    d.check(req.state is RequestState.FINISHED, "warmed engine served a request")
    d.check(sanitizer.trip_counts().get(sanitizer.RETRACE_TRIPS, 0) == before,
            "zero trips across the warmed request")
    d.expect_trip(sanitizer.RETRACE_TRIPS, "capture after warmup", eng.warmup, registry)
    # The port's other retrace: a gather width warmup never captured (the
    # widths are pow2 buckets 1/2/4; bucket dispatch cannot emit 3) runs
    # the decode step eagerly.
    S = e.max_slots
    rogue = (np.zeros((S, 3), np.int64), np.zeros(S, np.int64), np.zeros(S, np.int64),
             np.zeros(S, bool))
    d.expect_trip(sanitizer.RETRACE_TRIPS, "eager decode at an uncaptured width",
                  lambda: eng._decode_fn(*rogue), registry)


def drill_donation_canary(d: Drill, registry, device: str) -> None:
    import torch

    from deeplearning_mpi_tpu_torch.analysis import sanitizer
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_mpi_tpu_torch.train.trainer import build_optimizer

    print(f"donation canary ({device}):")
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32,
                          device=device).init_weights(0)
    state = create_train_state(model, build_optimizer("adam", 1e-3))
    with tempfile.TemporaryDirectory(prefix="sanitize-canary-") as tmp:
        ckpt = Checkpointer(tmp)
        before = dict(sanitizer.trip_counts())
        ckpt.save(state, epoch=0)
        d.check(sanitizer.trip_counts() == before, "a clean save verifies")
        leaf = sanitizer.canary_tensor(state)[0]
        write = ckpt._write

        def racing_write(arrays, epoch, *, corrupt=False):
            # The aliasing race in miniature: the next step's in-place
            # update lands on the live tensor while this save writes it.
            sanitizer.canary_tensor(state)[1].add_(1)
            write(arrays, epoch, corrupt=corrupt)

        ckpt._write = racing_write
        d.expect_trip(sanitizer.DONATION_TRIPS, f"in-place add_ on {leaf} mid-save",
                      lambda: ckpt.save(state, epoch=1), registry)


def run(device: str) -> Drill:
    """Every injection on ``device``; the sanitizer's trips are reset first
    and its registry detached after."""
    from deeplearning_mpi_tpu_torch.analysis import sanitizer
    from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry

    os.environ["DMT_SANITIZE"] = "1"
    sanitizer.reset_trips()
    registry = MetricsRegistry()
    sanitizer.attach_registry(registry)
    d = Drill()
    try:
        drill_kv_pool(d, registry)
        drill_retrace(d, registry, device)
        drill_donation_canary(d, registry, device)
    finally:
        sanitizer.attach_registry(None)
    d.trips = sanitizer.trip_counts()
    return d


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="sanitize_drill", description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    d = run(args.device)
    print(f"trip counts: {d.trips}")
    if d.failures:
        print(f"sanitize-smoke FAILED ({len(d.failures)}):", file=sys.stderr)
        for f in d.failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("sanitize-smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
