"""Checkpoint, verified restore and resume of the train state.

Port of ``deeplearning_mpi_tpu/train/checkpoint.py``'s ``Checkpointer``
without orbax: each saved epoch is a directory ``<dir>/<epoch>/`` holding
one ``torch.save`` file per top-level key of :meth:`TrainState.arrays`
(``params.pt``, ``opt_state.pt``, ``step.pt`` and, only when present,
``batch_stats.pt`` and ``ema_params.pt``), on the reference's protocol:

- **Atomic steps.** A step is written into a temporary sibling, every file
  fsynced, and renamed into place with ``os.replace``: a kill mid-save
  leaves the previous step intact, never a half-written latest.
- **Integrity manifests.** After the rename, ``manifest-<epoch>.json``
  beside the step holds a sha256 per file (:func:`dir_digests`);
  :meth:`Checkpointer.restore_verified` re-hashes BEFORE ``torch.load``
  reads a byte and walks back past steps that fail. A step without a
  manifest restores unverified.
- **Last-known-good pin.** ``last_good.json`` names the newest save that
  still hashes clean when re-read after the save, with a monotonic
  ``generation``: :meth:`Checkpointer.rollback_to_last_good` restores the
  pin, deletes every younger step and bumps the generation, and a pin
  whose generation goes backward within one process is refused (the
  anti-rollback fence).
- **Retention** keeps the newest ``max_to_keep`` steps plus the pin.

Loading is ``torch.load(weights_only=True, map_location=<the template's
device>)``, and every name, shape and dtype must equal the template's: the
counterpart of orbax's tree-mismatch error (a ``--resume`` with another
optimizer, a missing ``--ema``). :meth:`Checkpointer.save` copies the
state to the host and writes it before it returns, so the next step's
in-place update cannot reach this epoch's files (the reference's async
serializer had to barrier for the same reason).

Under data parallelism every rank holds the same replicated state: with a
live process group rank 0 alone writes (and pins, prunes, rolls back) and
every rank waits at a barrier after a save, so no rank reads a step before
it is whole. Every rank restores from the shared directory. Under expert
parallelism rank 0 holds only its experts: every rank gathers the full
expert stacks (parameters, moments, EMA; ``TrainState.arrays``) before rank
0 writes, and a restore keeps each rank's slice, so the files, their
digests and the manifests are those of the whole model. A state's tensors
do not depend on the world size or the expert sharding, so a save restores
on any (:meth:`Checkpointer.restore_elastic`). A pipelined LM's save (``--pp
S``) holds the reference's layout: each stage leaf stacked ``[S, ...]``
(``stages.block_{j}.*``), gathered over the pipe group before rank 0
writes, so it restores under the same ``S`` at any data-parallel degree
and in either pipe form; ``arch.json`` records ``S`` and refuses another.
The composed layouts save the same whole trees: ``--pp x --tp`` gathers
each stage's model shards and then stacks the stages, ``--ep x --tp``
gathers the expert slices and then each expert's d_ff, so a ``pp 2 x tp 2``
save restores in one process over ``LockstepPipe(2)`` and an ``ep 2 x tp
2`` save into the flat model (``arch.json``'s ``layout`` records the
degrees a run trained under and is not compared).

Not ported: the chaos hook.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from deeplearning_mpi_tpu_torch.resilience.integrity import (
    CheckpointCorruption,
    atomic_write_json,
    dir_digests,
    read_manifest,
    write_manifest,
)
from deeplearning_mpi_tpu_torch.train.state import TrainState

#: the top-level keys of :meth:`TrainState.arrays`, one file each.
KEYS = ("step", "params", "opt_state", "batch_stats", "ema_params")


class CheckpointMismatch(ValueError):
    """A saved tree differs from the restore template in a name, a shape or
    a dtype."""


#: What a step that cannot be read raises: a torn or flipped file
#: (``torch.load``'s unpickling and zip errors), a template mismatch.
_UNREADABLE = (OSError, RuntimeError, EOFError, pickle.UnpicklingError, CheckpointMismatch)


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu")


def _check_like(template: Any, loaded: Any, path: str) -> None:
    """Refuse a loaded tree whose structure, shapes or dtypes differ from
    the template's."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(template) != set(loaded):
            have = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise CheckpointMismatch(
                f"{path}: checkpoint holds {have}, the template {sorted(template)} "
                "(another optimizer, --ema setting or model?)"
            )
        for key in template:
            _check_like(template[key], loaded[key], f"{path}[{key!r}]")
        return
    if not isinstance(loaded, torch.Tensor):
        raise CheckpointMismatch(f"{path}: checkpoint holds {type(loaded).__name__}, not a tensor")
    if loaded.shape != template.shape or loaded.dtype != template.dtype:
        raise CheckpointMismatch(
            f"{path}: checkpoint {tuple(loaded.shape)} {loaded.dtype}, template "
            f"{tuple(template.shape)} {template.dtype}"
        )


def _writer() -> bool:
    """Whether this process writes: rank 0 of a live group, or a lone process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Save and restore the full train state under ``directory``, one step
    directory per epoch; see the module docstring for the protocol."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        #: anti-rollback fence: the highest pin generation seen; None until
        #: the pin file is first read.
        self._generation: int | None = None

    # -- layout -------------------------------------------------------------
    def step_dir(self, epoch: int) -> Path:
        return self.directory / str(epoch)

    def all_steps(self) -> list[int]:
        """Committed epochs, oldest first (temporaries are not digits)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_epoch(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _delete(self, epoch: int) -> None:
        if not _writer():
            return
        shutil.rmtree(self.step_dir(epoch), ignore_errors=True)

    # -- save ---------------------------------------------------------------
    def save(self, state: TrainState, *, epoch: int) -> None:
        """Write ``state`` as epoch ``epoch``: temp dir, fsync, rename, then
        the manifest; pin it if it re-hashes clean; prune. With a live
        group rank 0 writes and every rank waits for it (after every rank
        gathered its expert stacks, when they are sharded)."""
        arrays = state.arrays()
        if _writer():
            self._write(arrays, epoch)
        _barrier()

    def _write(self, arrays: dict[str, Any], epoch: int) -> None:
        arrays = _to_host(arrays)
        tmp = self.directory / f"tmp-{epoch}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        for key, tree in arrays.items():
            with open(tmp / f"{key}.pt", "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())
        _fsync_dir(tmp)
        final = self.step_dir(epoch)
        if final.exists():  # a re-save of this epoch (e.g. after a rollback)
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        write_manifest(self.directory, epoch, dir_digests(final))
        # Pin by re-hashing: only a save whose bytes still match its
        # manifest becomes the last-known-good.
        manifest = read_manifest(self.directory, epoch)
        if manifest is not None and dir_digests(final) == manifest:
            self._pin(epoch)
        self._prune_retained(keep_also=epoch)

    # -- last-known-good pin + retention ------------------------------------
    def _pin_path(self) -> Path:
        return self.directory / "last_good.json"

    def _load_pin(self) -> dict | None:
        """Read ``last_good.json`` through the anti-rollback fence: a
        generation older than one this process has seen means the pin was
        swapped for a stale copy."""
        try:
            data = json.loads(self._pin_path().read_text())
        except (OSError, ValueError):
            return None
        if not isinstance(data, dict) or "epoch" not in data:
            return None
        gen = int(data.get("generation", 0))
        if self._generation is not None and gen < self._generation:
            raise CheckpointCorruption(
                f"anti-rollback fence: on-disk last-good generation {gen} is older "
                f"than this process's {self._generation} — {self._pin_path()} was "
                "replaced with a stale pin"
            )
        self._generation = gen
        return data

    def _pin(self, epoch: int) -> None:
        if not _writer():
            return
        atomic_write_json(self._pin_path(), {"epoch": epoch, "generation": self._generation or 0})

    def last_good_epoch(self) -> int | None:
        """The pinned digest-verified epoch, or None (no pin yet)."""
        pin = self._load_pin()
        return int(pin["epoch"]) if pin is not None else None

    def _prune_retained(self, *, keep_also: int) -> None:
        """Keep the newest ``max_to_keep`` steps and ALWAYS the pin: a run
        whose younger saves are all corrupt can still roll back to it."""
        if not self.max_to_keep:
            return
        steps = sorted(set(self.all_steps()) | {keep_also})
        keep = set(steps[-self.max_to_keep:])
        pin = self.last_good_epoch()
        if pin is not None:
            keep.add(pin)
        for step in steps:
            if step not in keep:
                self._delete(step)
        self._prune_manifests(keep_also=keep_also)

    def _prune_manifests(self, *, keep_also: int | None = None) -> None:
        """Drop the manifests of retired steps (the pin's stays)."""
        if not _writer():
            return
        keep = set(self.all_steps())
        if keep_also is not None:
            keep.add(keep_also)
        pin = self.last_good_epoch()
        if pin is not None:
            keep.add(pin)
        for mf in self.directory.glob("manifest-*.json"):
            try:
                epoch = int(mf.stem.split("-", 1)[1])
            except (IndexError, ValueError):
                continue
            if epoch not in keep:
                mf.unlink(missing_ok=True)

    # -- restore ------------------------------------------------------------
    def _load(self, epoch: int, template: TrainState, keys: tuple[str, ...]) -> dict[str, Any]:
        """``torch.load`` the files ``keys`` of a step onto the template's
        device, each checked against the template's tree."""
        want = template.arrays()
        device = next(template.model.parameters()).device
        step_dir = self.step_dir(epoch)
        out: dict[str, Any] = {}
        for key in keys:
            path = step_dir / f"{key}.pt"
            if key not in want:
                if path.exists():
                    raise CheckpointMismatch(
                        f"epoch {epoch} holds {key!r}, which the template does not track"
                    )
                continue
            if not path.exists():
                raise CheckpointMismatch(f"epoch {epoch} has no {key!r} (the template has one)")
            loaded = torch.load(path, map_location=device, weights_only=True)
            _check_like(want[key], loaded, f"[{key!r}]")
            out[key] = loaded
        return out

    def _restore(self, epoch: int, template: TrainState) -> TrainState:
        return template.fill(self._load(epoch, template, KEYS))

    def _note_corrupt(self, epoch: int, why: str) -> None:
        print(f"checkpoint epoch {epoch} CORRUPT — rolling back ({why})", flush=True)

    def restore_verified(self, template: TrainState) -> tuple[TrainState, int]:
        """Restore the newest step that passes digest verification, walking
        backward past corrupt ones; returns ``(state, epoch)``.

        Per step, newest first, the files are re-hashed against the
        manifest FIRST — a mismatch never reaches ``torch.load`` — and a
        load that raises anyway (torn file, template mismatch) counts the
        same. A step without a manifest restores unverified. Exhausting
        every step raises :class:`CheckpointCorruption`: starting over is
        the caller's decision.
        """
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        for epoch in steps:
            manifest = read_manifest(self.directory, epoch)
            if manifest is not None:
                actual = dir_digests(self.step_dir(epoch))
                if actual != manifest:
                    bad = sorted(set(manifest) ^ set(actual)
                                 | {k for k in manifest if actual.get(k) != manifest[k]})
                    self._note_corrupt(epoch, f"digest mismatch in {len(bad)} file(s), "
                                              f"e.g. {bad[0]}")
                    continue
            try:
                state = self._restore(epoch, template)
            except _UNREADABLE as err:
                self._note_corrupt(epoch, f"restore failed: {err}")
                continue
            pin = self._load_pin()
            if pin is not None and epoch < int(pin["epoch"]):
                # The walk landed below the pin: the pinned step failed
                # since its save. Re-pin what restored, so retention keeps it.
                self._pin(epoch)
            return state, epoch
        raise CheckpointCorruption(
            f"no checkpoint under {self.directory} survived verification (tried epochs {steps})"
        )

    def restore_elastic(self, template: TrainState) -> tuple[TrainState, int]:
        """:meth:`restore_verified` onto a template for ANOTHER world size
        or expert sharding than the one that saved; ``(state, epoch)``. No
        saved tensor's shape depends on either (the reference re-shards each
        leaf as it reads; here the template keeps its slice of each expert
        stack), and the loader's global order is a function of ``(seed,
        epoch)`` alone, so the resumed world sees the global batches a clean
        run at its size would."""
        return self.restore_verified(template)

    def rollback_to_last_good(self, template: TrainState) -> tuple[TrainState, int]:
        """Restore the pinned last-known-good step, DELETE every younger
        step and bump the anti-rollback generation; returns ``(state,
        epoch)``. A missing or corrupt pin falls back to the verified walk."""
        state: TrainState | None = None
        epoch: int | None = None
        pin = self._load_pin()
        if pin is not None and int(pin["epoch"]) in set(self.all_steps()):
            epoch = int(pin["epoch"])
            manifest = read_manifest(self.directory, epoch)
            if manifest is None or dir_digests(self.step_dir(epoch)) == manifest:
                try:
                    state = self._restore(epoch, template)
                except _UNREADABLE as err:
                    self._note_corrupt(epoch, f"restore failed: {err}")
            else:
                self._note_corrupt(epoch, "pinned step no longer hashes clean")
        if state is None:
            state, epoch = self.restore_verified(template)
        for step in sorted(self.all_steps(), reverse=True):
            if step > epoch:
                print(f"rollback: discarding checkpoint epoch {step} (younger than "
                      f"last-good {epoch})", flush=True)
                self._delete(step)
        self._prune_manifests(keep_also=epoch)
        self._generation = (self._generation or 0) + 1
        self._pin(epoch)
        return state, epoch

    def _resolve_epoch(self, epoch: int | None) -> int:
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        if not self.step_dir(epoch).is_dir():
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} under {self.directory}")
        return epoch

    def restore(self, template: TrainState, *, epoch: int | None = None) -> TrainState:
        """Restore ``epoch`` (default: the latest), unverified, into the
        template (a fresh state: it supplies the model, optimizer and
        device)."""
        return self._restore(self._resolve_epoch(epoch), template)

    def restore_params_only(self, template: TrainState, *, epoch: int | None = None) -> TrainState:
        """Restore the weights (``params``, ``step``, the BatchNorm
        ``batch_stats`` of a CNN and, when the template tracks one,
        ``ema_params``) WITHOUT opening the optimizer state's
        file, so serving needs no optimizer at all.

        The EMA guard holds in BOTH directions, against the step's files,
        before any byte is read: a template without an EMA would silently
        serve the raw last-step weights of an EMA run, and a template with
        one would keep its own fresh copy against an EMA-less checkpoint.
        """
        epoch = self._resolve_epoch(epoch)
        saved = {p.stem for p in self.step_dir(epoch).glob("*.pt")}
        if template.ema_params is not None and "ema_params" not in saved:
            raise ValueError(
                "checkpoint has no EMA weights (trained without --ema) but the restore "
                "template tracks an EMA — drop --ema"
            )
        if template.ema_params is None and "ema_params" in saved:
            raise ValueError(
                "checkpoint carries EMA weights (trained with --ema) but the restore "
                "template has none — pass --ema to serve the averaged weights"
            )
        return template.fill(self._load(epoch, template,
                                        ("step", "params", "batch_stats", "ema_params")))
