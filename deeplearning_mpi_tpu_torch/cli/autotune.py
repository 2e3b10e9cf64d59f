"""Offline tuner: search the whole-step schedule and the speculative depth,
write a tuning DB.

Port of ``tools/autotune.py``::

    # the train step's schedule (remat x grad_accum x overlap) for a shape
    python -m deeplearning_mpi_tpu_torch.cli.autotune --db tuned.json --step 8x2048
    # the speculative depth for a 1-layer self-draft of the tiny config
    python -m deeplearning_mpi_tpu_torch.cli.autotune --db tuned.json --spec_k 1
    # consume it
    python -m deeplearning_mpi_tpu_torch.cli.train_lm --tuned_step tuned.json ...
    python -m deeplearning_mpi_tpu_torch.cli.serve_lm --tuning_db tuned.json --draft_layers 1 ...
    python -m deeplearning_mpi_tpu_torch.cli.autotune --selftest --device cpu

Every candidate is held to its oracle before it may win (a step schedule
to the untuned step's loss trajectory), so the DB makes runs faster, never
different (``compiler/autotune.py``). ``--attn_shape``, ``--decode_shape``
and ``--decode_buckets`` exit 1: the port's kernels have no block or
schedule to tune (``compiler.autotune.KERNEL_TUNING_NA``). ``--step``
tunes the reference's tiny step config (1 layer at d 64), as
``tools/autotune.py`` does.

``--selftest`` runs tiny shapes: tunes two step candidates (one must be
rejected for its numbers), round-trips the DB, shows that the tuned
step's losses equal the default step's, that a corrupt DB consults to
None, that the kernel-shape tuners raise, and tunes and round-trips
``spec_k``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch


def _parse_shape(spec: str, what: str, ndims: int, example: str) -> tuple[int, ...]:
    try:
        dims = tuple(int(d) for d in spec.lower().split("x"))
        if len(dims) != ndims or any(d <= 0 for d in dims):
            raise ValueError
    except ValueError:
        raise SystemExit(f"bad {what} '{spec}': want {ndims} positive dims like {example}")
    return dims


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="autotune", description=__doc__.split("\n")[0])
    parser.add_argument("--db", default="tuned.json",
                        help="tuning DB to create or update (entries of other keys are kept)")
    parser.add_argument("--step", action="append", default=[], metavar="BxS",
                        help="LM train-step shape (global batch x seq) to tune the whole-step "
                        "schedule for (repeatable)")
    parser.add_argument("--step_model", default="lm", help="model family for --step entries")
    parser.add_argument("--grad_accums", default="1,2",
                        help="comma-separated grad-accum factors of the --step search space")
    parser.add_argument("--verify_steps", type=int, default=5,
                        help="optimizer steps per --step candidate for the loss-trajectory check")
    parser.add_argument("--spec_k", type=int, default=None, metavar="DRAFT_LAYERS",
                        help="race engines per proposal depth k for a DRAFT_LAYERS-layer "
                        "self-draft of the tiny config and record the winner")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--repeats", type=int, default=3,
                        help="timing repeats per candidate (the median wins)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    for flag in ("attn_shape", "decode_shape", "decode_buckets"):
        parser.add_argument(f"--{flag}", action="append", default=[],
                            help="not tuned in the port (exits 1 with the reason)")
    parser.add_argument("--blocks", default=None, help="not tuned in the port")
    parser.add_argument("--heads", type=int, default=None, help="not tuned in the port")
    parser.add_argument("--selftest", action="store_true",
                        help="tiny-shape end-to-end check of the tuners and the DB")
    return parser


def selftest(device: str) -> int:
    """The tiny-shape acceptance loop; CPU-safe, seconds."""
    from deeplearning_mpi_tpu_torch.compiler import autotune
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig
    from deeplearning_mpi_tpu_torch.train import make_train_step

    ok = True

    def check(cond: bool, label: str) -> None:
        nonlocal ok
        print(("PASS " if cond else "FAIL ") + label, file=sys.stderr)
        ok = ok and cond

    def dropping(cand, state):
        # A wrong schedule: grad_accum 2 over the first half of the batch.
        step = make_train_step("lm", grad_accum=2)
        return lambda st, b: step(st, {k: v[: v.shape[0] // 2] for k, v in b.items()})

    with tempfile.TemporaryDirectory(prefix="dmt_tune_") as td:
        db_path = Path(td) / "tuning.json"
        db = autotune.TuningDB(db_path)
        shape = (4, 16)
        kw = dict(batch_size=shape[0], seq_len=shape[1], steps=3, repeats=1, device=device)
        step_params = autotune.tune_step_schedule(
            "lm", db=db, candidates=[{"remat": "none", "grad_accum": 1, "overlap": False},
                                     {"remat": "dots", "grad_accum": 2, "overlap": False}], **kw)
        check(step_params.get("remat") in ("none", "dots"), f"step schedule tuned: {step_params}")
        wrong = autotune.tune_step_schedule(
            "lm", candidates=[{"remat": "none", "grad_accum": 2, "overlap": False}],
            step_factory=dropping, **kw)
        check(wrong == {}, "a schedule that drops a chunk is rejected for its numbers")
        db.save()
        back = autotune.tuned_step_schedule("lm", shape, None, db=autotune.TuningDB.load(db_path))
        check(back == step_params, f"step entry round-trips: {back}")
        entry = db.entries[autotune.step_tuning_key("lm", shape, None, torch.float32, device)]
        default = _trajectory(device, shape)
        tuned = _trajectory(device, shape, autotune.TuningDB.load(db_path))
        same = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(tuned, default))
        check(same, f"the tuned step's losses equal the default step's: {tuned} / {default}")
        check(len(entry["candidates"]) == 2, "every candidate recorded")
        corrupt = Path(td) / "corrupt.json"
        corrupt.write_text("{not json")
        check(autotune.tuned_step_schedule("lm", shape, None,
                                           db=autotune.TuningDB.load(corrupt)) is None,
              "corrupt DB consult degrades to None, never raises")
        for tuner in (autotune.tune_flash_attention, autotune.tune_flash_decode,
                      autotune.tune_decode_buckets):
            try:
                tuner((1, 64, 2, 16))
                check(False, f"{tuner.__name__} raises")
            except NotImplementedError as err:
                check("n/a" in str(err), f"{tuner.__name__} raises: n/a")
        spec = autotune.tune_spec_k(draft_layers=1, db=db, candidates=(0, 2), num_requests=2,
                                    max_new_tokens=8, device=device)
        check(spec.get("spec_k") in (0, 2), f"spec_k tuned: {spec}")
        db.save()
        autotune.set_default_db(autotune.TuningDB.load(db_path))
        try:
            back = autotune.tuned_spec_k(TransformerConfig.tiny(), 1, torch.float32)
            check(back == spec, f"spec_k entry round-trips: {back}")
        finally:
            autotune.set_default_db(None)
    print("tune-smoke " + ("OK" if ok else "FAILED"), file=sys.stderr)
    return 0 if ok else 1


def _trajectory(device: str, shape: tuple[int, int], db=None) -> list[float]:
    """Three steps of the tuner's default model through a ``Trainer``, the
    schedule of ``db`` applied (remat to the model, the rest by
    ``Trainer.apply_tuned_step``): the losses."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.compiler.autotune import tuned_step_schedule
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    cfg = TransformerConfig(vocab_size=256, num_layers=1, num_heads=2, head_dim=32,
                            d_model=64, d_ff=256)
    params = tuned_step_schedule("lm", shape, None, db=db) if db is not None else None
    remat = params["remat"] if params else "none"
    model = TransformerLM(cfg, device=device, remat=remat).init_weights(0)
    trainer = Trainer(create_train_state(model, build_optimizer("adam", 1e-2)), "lm",
                      log=lambda msg: None)
    if db is not None:
        trainer.apply_tuned_step(db, model="lm", batch_size=shape[0], seq_len=shape[1])
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(3):
        batch = {"tokens": torch.from_numpy(rng.integers(0, 256, shape)).to(device),
                 "mask": torch.from_numpy(rng.integers(0, 2, shape).astype(np.float32))
                 .to(device)}
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from deeplearning_mpi_tpu_torch import resolve_device
    from deeplearning_mpi_tpu_torch.compiler import autotune

    na = [f"--{f}" for f in ("attn_shape", "decode_shape", "decode_buckets")
          if getattr(args, f)] + [f"--{f}" for f in ("blocks", "heads")
                                  if getattr(args, f) is not None]
    if na:
        print(f"{', '.join(na)}: {autotune.KERNEL_TUNING_NA}", file=sys.stderr)
        return 1
    device = resolve_device(args.device)
    if args.selftest:
        return selftest(device.type)
    if not (args.step or args.spec_k is not None):
        print("nothing to tune: pass --spec_k and/or --step (or --selftest)", file=sys.stderr)
        return 1
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    db = autotune.TuningDB.load(args.db)
    print(f"backend: {device.type}, DB: {args.db} ({len(db)} existing entries)",
          file=sys.stderr)
    if args.spec_k is not None:
        params = autotune.tune_spec_k(draft_layers=args.spec_k, dtype=dtype, db=db,
                                      device=device)
        print(f"spec_k (draft_layers={args.spec_k}): {params}", file=sys.stderr)
    for spec in args.step:
        batch, seq = _parse_shape(spec, "--step", 2, "8x2048")
        grad_accums = tuple(int(g) for g in args.grad_accums.split(","))
        params = autotune.tune_step_schedule(
            args.step_model, batch_size=batch, seq_len=seq, dtype=dtype, db=db,
            candidates=autotune.step_candidates(1, grad_accums=grad_accums),
            steps=args.verify_steps, repeats=args.repeats, device=device)
        print(f"step {args.step_model} {spec}: {params or 'no viable candidate'}",
              file=sys.stderr)
    db.save()
    print(f"wrote {args.db}: {len(db)} entries", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
