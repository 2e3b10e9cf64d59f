"""Shared CLI helpers: the ``--ema`` type, the architecture sidecar, the LR
flags, the ``--resume`` / ``--eval_only`` restore and the inference restore.

The port's copy of the parts of ``deeplearning_mpi_tpu/utils/config.py``
its CLIs use, with the reference's contracts: ``arch.json`` beside the
checkpoint refuses a tree-invisible architecture mismatch (a forgotten
``--attention_window`` changes no tensor shape) at every start;
``--eval_only`` is resume-or-die; ``--resume`` is lenient about a missing
or an all-corrupt history, and restores the newest step that verifies.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
from pathlib import Path
from typing import Any, Callable

import torch

from deeplearning_mpi_tpu_torch.resilience.integrity import (
    CheckpointCorruption,
    atomic_write_json,
)


def ema_decay(value: str) -> float:
    """argparse type for ``--ema``: a decay in [0, 1). At 1.0 the average
    would stay frozen at its random init while every eval reports it."""
    f = float(value)
    if not 0.0 <= f < 1.0:
        raise argparse.ArgumentTypeError(
            f"--ema must be in [0, 1), got {f} (it is a decay; 0 disables)"
        )
    return f


def save_arch(cfg: Any, ckpt_dir: str | Path) -> None:
    """Write the model config (a dataclass) as ``arch.json`` beside the
    checkpoint, atomically."""
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    atomic_write_json(path / "arch.json", dataclasses.asdict(cfg))


def arch_mismatch_error(cfg: Any, ckpt_dir: str | Path) -> str | None:
    """The refusal message when ``cfg`` differs from the directory's
    ``arch.json``; None when they match or there is no sidecar. Only the
    fields present in the file are compared."""
    path = Path(ckpt_dir) / "arch.json"
    if not path.is_file():
        return None
    saved = json.loads(path.read_text())
    current = dataclasses.asdict(cfg)
    lines = [f"{key}: checkpoint={saved[key]!r}, flags={current[key]!r}"
             for key in saved if key in current and saved[key] != current[key]]
    if not lines:
        return None
    return ("checkpoint architecture does not match the flags:\n  " + "\n  ".join(lines)
            + f"\n(sidecar: {path}; pass matching flags, or use a fresh --model_dir to train "
            "a different architecture)")


def build_lr(args: argparse.Namespace, steps_per_epoch: int) -> Any:
    """The LR flags as ``build_optimizer`` takes them: a bare float for a
    constant LR without warmup, else a schedule over the planned steps.
    ``--eval_only`` builds the same one, as the reference does, so the
    restore template has the training run's state tree."""
    from deeplearning_mpi_tpu_torch.train.trainer import build_lr_schedule

    return build_lr_schedule(args.learning_rate, args.lr_schedule,
                             warmup_steps=args.warmup_steps,
                             decay_steps=steps_per_epoch * args.num_epochs)


def restore_for_start(
    args: argparse.Namespace, checkpointer: Any, state: Any, log: Callable[[str], None],
) -> tuple[Any, int]:
    """The ``--resume`` / ``--eval_only`` restore; returns ``(state,
    start_epoch)``. Both restore the newest step that verifies
    (``Checkpointer.restore_verified``)."""
    latest = checkpointer.latest_epoch()
    if getattr(args, "eval_only", False):
        if latest is None:
            raise SystemExit(f"--eval_only: no checkpoint under {checkpointer.directory}")
        state, epoch = checkpointer.restore_verified(state)
        log(f"eval-only: restored verified epoch {epoch} (step {state.step})")
        return state, epoch + 1
    if args.resume:
        if latest is None:
            log(f"--resume: no checkpoint under {checkpointer.directory}; starting fresh")
            return state, 0
        try:
            state, epoch = checkpointer.restore_verified(state)
        except CheckpointCorruption as err:
            log(f"--resume: {err}; starting fresh")
            return state, 0
        log(f"resumed from verified epoch {epoch} (step {state.step})")
        return state, epoch + 1
    return state, 0


def restore_lm(
    cfg: Any, *, dtype: torch.dtype, device: torch.device, model_dir: str | Path,
    model_filename: str = "lm", epoch: int | None = None, ema: bool = False,
):
    """A ``TransformerLM`` of ``cfg`` with the weights of a ``train_lm``
    checkpoint, for inference: the arch sidecar checked, a params-only
    restore (no optimizer needed), the EMA weights when ``ema``. Refusals
    raise ``SystemExit`` with one line."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    ckpt_dir = Path(model_dir) / model_filename
    if not ckpt_dir.is_dir():
        raise SystemExit(f"no checkpoint found under {ckpt_dir}")
    err = arch_mismatch_error(cfg, ckpt_dir)
    if err:
        raise SystemExit(err)
    model = TransformerLM(cfg, dtype=dtype, device=device)
    template = create_train_state(model, None, ema=ema)
    try:
        state = Checkpointer(ckpt_dir).restore_params_only(template, epoch=epoch)
    except (OSError, ValueError, RuntimeError, pickle.UnpicklingError) as e:
        at = f" epoch {epoch}" if epoch is not None else ""
        raise SystemExit(f"failed to restore from {ckpt_dir}{at}: {e}") from e
    if state.ema_params is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state.ema_params[n])
    return model
