"""Shared CLI helpers: the ``--ema`` type, the architecture sidecar, the LR
flags, the ``--resume`` / ``--eval_only`` restore and the inference restore;
for the data-parallel trainers the topology, training, observability and
resilience flags, the runtime set-up (``--debug_nans`` included), the
telemetry and the heartbeat (:func:`build_observability`), the chaos
injector and the guardrail policy (:func:`build_chaos`,
:func:`build_guardrails`), the run log, the supervised run
(:func:`execute`: auto-resume, rollback, preemption) and the local
launcher (``--nproc``).

The port's copy of the parts of ``deeplearning_mpi_tpu/utils/config.py``
its CLIs use, with the reference's contracts: ``arch.json`` beside the
checkpoint refuses a tree-invisible architecture mismatch (a forgotten
``--attention_window`` changes no tensor shape) at every start;
``--eval_only`` is resume-or-die; ``--resume`` is lenient about a missing
or an all-corrupt history, and restores the newest step that verifies.
A flag of a layer the port does not have yet refuses to run and names its
ROADMAP item; none is ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
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


def save_arch(cfg: Any, ckpt_dir: str | Path, *, pipeline_stages: int = 1,
              layout: dict[str, int] | None = None) -> None:
    """Write the LM config (a dataclass) and its ``pipeline_stages``
    (``--pp``: a pipelined checkpoint stacks its blocks by stage) as
    ``arch.json`` beside the checkpoint, atomically; ``layout`` (the mesh
    degrees the run trained under) is recorded as ``layout`` and never
    compared: the expert, tensor, sequence and data layouts save the same
    whole tree, which restores under any other."""
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    extra = {} if layout is None else {"layout": layout}
    atomic_write_json(path / "arch.json",
                      {**dataclasses.asdict(cfg), "pipeline_stages": pipeline_stages, **extra})


def arch_mismatch_error(cfg: Any, ckpt_dir: str | Path, *,
                        pipeline_stages: int = 1) -> str | None:
    """The refusal message when ``cfg`` or the stage count differs from the
    directory's ``arch.json``; None when they match or there is no sidecar.
    Only the fields present in the file are compared (a sidecar from before
    the stage count was recorded has none)."""
    path = Path(ckpt_dir) / "arch.json"
    if not path.is_file():
        return None
    saved = json.loads(path.read_text())
    current = {**dataclasses.asdict(cfg), "pipeline_stages": pipeline_stages}
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


def build_optimizer_from_flags(args: argparse.Namespace, train_loader: Any, *,
                               momentum: float = 0.9, clip_norm: float | None = None) -> Any:
    """``--optimizer``, ``--weight_decay`` and the LR flags as the
    trainers' optimizer, scheduled over the loader's steps."""
    from deeplearning_mpi_tpu_torch.train.trainer import build_optimizer

    return build_optimizer(args.optimizer, build_lr(args, train_loader.steps_per_epoch()),
                           momentum=momentum, weight_decay=args.weight_decay,
                           clip_norm=clip_norm)


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
    model_filename: str = "lm", epoch: int | None = None, ema: bool = False, tp: Any = None,
):
    """A ``TransformerLM`` of ``cfg`` with the weights of a ``train_lm``
    checkpoint, for inference: the arch sidecar checked, a params-only
    restore (no optimizer needed), the EMA weights when ``ema``; with
    ``tp`` (``parallel.tensor_parallel.LockstepTP``) each rank keeps its
    shards of the whole checkpoint. Refusals raise ``SystemExit`` with one
    line."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    ckpt_dir = Path(model_dir) / model_filename
    if not ckpt_dir.is_dir():
        raise SystemExit(f"no checkpoint found under {ckpt_dir}")
    err = arch_mismatch_error(cfg, ckpt_dir)
    if err:
        raise SystemExit(err)
    try:
        model = TransformerLM(cfg, dtype=dtype, device=device, tp=tp)
    except ValueError as e:
        raise SystemExit(str(e)) from e
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


# -- the data-parallel trainers' flags ---------------------------------------
#: Flags of layers not ported yet: flag -> (value that means "off", ROADMAP item).
UNPORTED_FLAGS: dict[str, tuple] = {}

#: The reference's flags that have no meaning on PyTorch: flag -> reason.
NOT_APPLICABLE = {
    "platform": "the reference picks a JAX backend (cpu/tpu); the port's --device "
                "(cuda/cpu) says where it runs",
    "n_virtual_devices": "the reference splits the host CPU into virtual XLA devices; "
                         "PyTorch has none — --nproc spawns gloo ranks instead",
    "use_kernel": "the reference chooses between its Pallas decode kernel and an einsum; "
                  "the port's engine always runs K4 on the card",
}


class _NotApplicable(argparse.Action):
    """A reference flag the port refuses by name: exit 2 with the reason."""

    def __init__(self, option_strings, dest, **kwargs) -> None:
        kwargs.setdefault("nargs", "?")
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None) -> None:
        parser.exit(2, f"{parser.prog}: {option_string} is not applicable to the PyTorch port: "
                       f"{NOT_APPLICABLE[self.dest]}\n")


def add_not_applicable(parser: argparse.ArgumentParser, *flags: str) -> None:
    """Accept each of the reference's ``flags`` (``NOT_APPLICABLE``) only to
    refuse it with its reason (exit 2), never as an unrecognized flag."""
    for flag in flags:
        parser.add_argument(f"--{flag}", action=_NotApplicable, default=None,
                            help=f"n/a on PyTorch: {NOT_APPLICABLE[flag]}")


def add_topology_flags(parser: argparse.ArgumentParser) -> None:
    """The reference's topology flags (``--coordinator`` as ``host:port`` or
    an ``init_method`` URL such as ``file:///tmp/rdzv``) plus the port's
    ``--device`` and ``--nproc`` (spawn that many local processes)."""
    group = parser.add_argument_group("topology")
    group.add_argument("--coordinator", default=None,
                       help="rendezvous: host:port or an init_method URL (tcp://, file://)")
    group.add_argument("--num_processes", type=int, default=None, help="world size")
    group.add_argument("--process_id", type=int, default=None, help="this process's rank")
    group.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="cuda: NCCL, one card a process; cpu: gloo")
    group.add_argument("--nproc", type=int, default=1,
                       help="spawn this many local processes, joined through a file store")
    group.add_argument("--dp", type=int, default=-1,
                       help="data-parallel degree (-1: every process)")
    group.add_argument("--ep", type=int, default=1,
                       help="expert-parallel degree: the MoE experts split over this many "
                       "processes of one data coordinate")
    group.add_argument("--sp", type=int, default=1,
                       help="sequence-parallel degree: each process of a seq group runs its "
                       "S/sp slice of the same rows (train_lm --attention ring|ulysses)")
    group.add_argument("--tp", type=int, default=1,
                       help="tensor-parallel degree (train_lm): the Megatron-sharded LM over "
                       "this many processes of one data coordinate")
    group.add_argument("--pp", type=int, default=1,
                       help="pipeline-parallel degree (train_lm): the LM's blocks in this many "
                       "GPipe stages, one a process of one data coordinate")
    group.add_argument("--zero", action="store_true",
                       help="ZeRO-1: the optimizer moments sharded over the data group")
    group.add_argument("--zero_overlap", action="store_true",
                       help="ZeRO-1 with the bucketed reduce-scatter schedule (falls back to "
                       "--zero, the reason logged, where it does not apply)")
    add_not_applicable(parser, "platform")
    group.add_argument("--tuned_step", default=None, metavar="DB",
                       help="tuning DB (cli.autotune --step) whose step|... entry, if present "
                       "for this model/shape/mesh/dtype, sets remat/grad_accum/overlap (train_lm); "
                       "a missing or corrupt DB keeps the flag defaults and says so")


def add_training_flags(
    parser: argparse.ArgumentParser, *, num_epochs: int, batch_size: int, learning_rate: float,
    random_seed: int, model_filename: str, optimizer: str = "adam", weight_decay: float = 0.0,
) -> None:
    """The reference's training flags, names and defaults (``--batch_size``
    is the GLOBAL batch). Without ``--model_dir`` nothing is written."""
    group = parser.add_argument_group("training")
    group.add_argument("--num_epochs", type=int, default=num_epochs)
    group.add_argument("--batch_size", type=int, default=batch_size, help="GLOBAL batch size")
    group.add_argument("--learning_rate", type=float, default=learning_rate)
    group.add_argument("--optimizer", default=optimizer,
                       choices=("sgd", "adam", "adamw", "adafactor", "lion"))
    group.add_argument("--weight_decay", type=float, default=weight_decay)
    group.add_argument("--lr_schedule", default="constant", choices=("constant", "cosine", "linear"))
    group.add_argument("--warmup_steps", type=int, default=0)
    group.add_argument("--grad_accum", type=int, default=1)
    group.add_argument("--random_seed", type=int, default=random_seed)
    group.add_argument("--ema", type=ema_decay, default=0.0)
    group.add_argument("--model_dir", default=None,
                       help="save checkpoints under <model_dir>/<model_filename> "
                       "(default: none are written)")
    group.add_argument("--model_filename", default=model_filename)
    group.add_argument("--resume", action="store_true")
    group.add_argument("--eval_only", action="store_true")
    group.add_argument("--keep_checkpoints", type=int, default=3)
    group.add_argument("--eval_every", type=int, default=10)
    group.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    add_observability_flags(group)
    add_resilience_flags(group)
    group.add_argument("--num_workers", type=int, default=None,
                       help="the loader's fetch threads (default: half the host's cores, at "
                       "most 16; 0 = synchronous); the reference's DataLoader num_workers "
                       "knob (resnet/main.py:100)")


def add_resilience_flags(group: Any) -> None:
    """The reference's resilience flags: ``--max_restarts`` /
    ``--restart_delay_s`` (auto-resume, :func:`execute`), ``--chaos`` (a
    fault plan, :func:`build_chaos`), ``--guardrails`` / ``--digest_every``
    (:func:`build_guardrails`)."""
    group.add_argument("--max_restarts", type=int, default=0,
                       help="auto-resume from the newest checkpoint that verifies this many "
                       "times on failure (0 = fail immediately; needs --model_dir)")
    group.add_argument("--restart_delay_s", type=float, default=5.0,
                       help="base seconds before an auto-resume restart (exponential backoff "
                       "with deterministic jitter)")
    group.add_argument("--chaos", default=None,
                       help="deterministic fault-injection plan, e.g. 'nan_grad@step:7,"
                       "loader_stall@batch:3,kill@step:12,corrupt_ckpt@epoch:1'; every fault "
                       "fires once and is booked in fault_injected_total / recovery_total / "
                       "rollback_total ($DMT_CHAOS is the fallback)")
    group.add_argument("--guardrails", action="store_true",
                       help="judge every step's loss / grad norm / finite flag (one host read a "
                       "step); a poisoned verdict rolls back to the pinned last-known-good "
                       "checkpoint and replays (pair with --max_restarts)")
    group.add_argument("--digest_every", type=int, default=0,
                       help="with --guardrails: every N steps a sha256 of sampled replicated "
                       "parameters rides the heartbeat for the pod's digest vote (0 = off)")


def build_chaos(args: argparse.Namespace) -> Any:
    """``--chaos`` (or ``$DMT_CHAOS``) as a ``ChaosInjector``, None when no
    plan is set; a kind the training workload has no hook for (a serving
    kind) raises ``SystemExit`` naming the workload, before anything runs."""
    from deeplearning_mpi_tpu_torch.resilience.faults import (
        TRAIN_KINDS,
        ChaosInjector,
        validate_plan_kinds,
    )

    try:
        injector = ChaosInjector.from_spec(getattr(args, "chaos", None))
        if injector is not None:
            validate_plan_kinds(
                ",".join(f"{s.kind}@{s.unit}:{s.at}" for s in injector.plan.specs),
                TRAIN_KINDS, workload="training")
    except ValueError as err:
        raise SystemExit(f"--chaos: {err}") from err
    return injector


def build_guardrails(args: argparse.Namespace) -> Any:
    """``--guardrails`` / ``--digest_every`` as a ``GuardrailPolicy``, or
    None (no policy: the trainer reads nothing on the host a step)."""
    if not getattr(args, "guardrails", False):
        return None
    from deeplearning_mpi_tpu_torch.resilience.guardrails import GuardrailConfig, GuardrailPolicy

    return GuardrailPolicy(GuardrailConfig(digest_every=getattr(args, "digest_every", 0) or 0))


def chaos_loader(trainer: Any, loader: Any) -> Any:
    """Under a chaos plan: the injector bound to the trainer's registry
    (backfilled) and the train loader wrapped in the stall watchdog
    (``resilience.ResilientLoader``, the same batches); else ``loader``."""
    if trainer.chaos is None:
        return loader
    from deeplearning_mpi_tpu_torch.resilience.watchdog import ResilientLoader

    trainer.chaos.bind_registry(trainer.metrics)
    return ResilientLoader(loader, chaos=trainer.chaos, logger=trainer)


def add_observability_flags(group: Any) -> None:
    """The reference's telemetry flags: ``--log_dir`` (the run log and its
    ``.metrics.jsonl`` sidecar; nothing written without it),
    ``--profile_dir`` (a ``torch.profiler`` Chrome trace of steps 3-5),
    ``--metrics_dir`` (``metrics.jsonl``: every step / epoch / eval
    record), ``--metrics_every`` and ``--debug_nans``."""
    group.add_argument("--log_dir", default=None,
                       help="write the run log (training_log_<stamp>.log) and its "
                       ".metrics.jsonl sidecar here (default: print only)")
    group.add_argument("--profile_dir", default=None,
                       help="write a torch.profiler Chrome trace of steps 3-5 here")
    group.add_argument("--metrics_dir", "--metrics-dir", default=None,
                       help="write telemetry records (per-step scalars, epoch stats, "
                       "MFU / memory / collective bytes) as metrics.jsonl here; render "
                       "with tools/metrics_report.py")
    group.add_argument("--metrics_every", "--metrics-every", type=int, default=1,
                       help="record every Nth step's scalars (0 = per-step records off; "
                       "epoch records always flow)")
    group.add_argument("--debug_nans", action="store_true",
                       help="raise at the first non-finite module output, naming the "
                       "module, and detect anomalies in the backward (a sync a module)")


def reject_unported(args: argparse.Namespace) -> None:
    """Refuse (``SystemExit``) any flag of a layer the port lacks, and
    ``--sp`` where nothing shards the sequence."""
    for flag, (off, item) in UNPORTED_FLAGS.items():
        if getattr(args, flag, off) != off:
            raise SystemExit(f"--{flag} is not ported yet (ROADMAP {item})")
    if getattr(args, "tuned_step", None) and not hasattr(args, "d_model"):
        raise SystemExit("--tuned_step: step tuning covers the 'lm' task only (train_lm), as "
                         "the reference's tune_step_schedule does; refused here rather than "
                         "ignored (ROADMAP Queue 1 item 9.1b)")
    sp = getattr(args, "sp", 1)
    if sp < 1:
        raise SystemExit(f"--sp must be >= 1, got {sp}")
    if sp > 1 and getattr(args, "attention", None) not in ("ring", "ulysses"):
        raise SystemExit(f"--sp {sp} shards the LM's sequence: it needs train_lm's "
                         "--attention ring or ulysses")
    reject_tp(args)
    reject_pp(args)
    if (args.resume or args.eval_only) and args.model_dir is None:
        raise SystemExit("--resume and --eval_only need --model_dir")
    build_chaos(args)  # a kind without a training hook is refused here


def reject_tp(args: argparse.Namespace) -> None:
    """Refuse (``SystemExit``) the ``--tp`` combinations this port leaves
    out; the reference runs each of them (ROADMAP Queue 1 item 8.6).
    ``--tp`` with ``--moe_experts`` / ``--ep``, ``--sp``, ``--pp`` and
    adafactor runs."""
    tp = getattr(args, "tp", 1)
    if tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {tp}")
    if tp == 1:
        return
    if not hasattr(args, "d_model"):
        raise SystemExit("--tp in train_resnet / train_unet is not ported yet (ROADMAP Queue 1 "
                         "item 8.6: tensor parallelism of the convolutions)")
    sizes = {"num_heads": args.num_heads, "kv_heads": args.num_kv_heads or args.num_heads,
             "d_ff": args.d_ff, "d_model": args.d_model}
    bad = [f"{k} {v}" for k, v in sizes.items() if v % tp]
    if bad:
        raise SystemExit(f"--tp {tp} must divide {', '.join(bad)}: the port splits whole heads "
                         "and widths (ROADMAP Queue 1 item 8.6: the reference splits H*D)")


#: Why ``--pp`` refuses a sequence-parallel attention: the reference
#: raises on it. Its pipeline is a ``shard_map`` manual over ``pipe`` only,
#: and the ring's and Ulysses' ``shard_map`` over ``seq`` inside a stage is
#: refused by its JAX (0.9) when the step is traced.
PP_SEQ_REASON = (
    "the reference raises on it: its ring / Ulysses shard_map over 'seq' nested inside the "
    "pipeline's shard_map over 'pipe' is refused by JAX ('The context mesh ... should match "
    "the mesh passed to shard_map')")


def reject_pp(args: argparse.Namespace) -> None:
    """Refuse (``SystemExit``) the ``--pp`` combinations this port leaves
    out: the CNNs over a pipe axis, and a sequence-parallel attention
    inside the stages, which the reference itself raises on
    (:data:`PP_SEQ_REASON`; ROADMAP Queue 1 item 8.6). ``--pp`` with
    ``--tp``, ``--ep``, ``--zero`` / ``--zero_overlap`` and adafactor
    runs."""
    pp = getattr(args, "pp", 1)
    if pp < 1:
        raise SystemExit(f"--pp must be >= 1, got {pp}")
    if pp == 1:
        return
    if not hasattr(args, "d_model"):
        raise SystemExit("--pp in train_resnet / train_unet is not ported yet (ROADMAP Queue 1 "
                         "item 8.6: the CNNs over a pipe axis)")
    if getattr(args, "sp", 1) != 1 or getattr(args, "attention", None) in ("ring", "ulysses"):
        raise SystemExit(f"--pp with --sp / --attention ring|ulysses is refused: {PP_SEQ_REASON} "
                         "(ROADMAP Queue 1 item 8.6)")


def setup_runtime(args: argparse.Namespace):
    """``bootstrap.init`` from the topology flags (and anomaly detection
    under ``--debug_nans``), then the mesh (data x pipe x expert x seq x
    model) when a group is live; returns ``(topology, mesh, data group)``
    (mesh and group None for one process without a coordinator)."""
    import torch.distributed as dist

    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh, data_group

    topo = bootstrap.init(args.coordinator, args.num_processes, args.process_id,
                          device=args.device)
    if getattr(args, "debug_nans", False):
        from deeplearning_mpi_tpu_torch.utils.profiling import nan_debug_mode

        # The backward half; the forward hooks go on the model in
        # build_observability.
        nan_debug_mode(True)
    sp, tp, pp = getattr(args, "sp", 1), getattr(args, "tp", 1), getattr(args, "pp", 1)
    if not dist.is_initialized():
        if args.dp not in (-1, 1) or args.ep != 1 or sp != 1 or tp != 1 or pp != 1:
            raise SystemExit(f"--dp {args.dp} --pp {pp} --ep {args.ep} --sp {sp} --tp {tp} "
                             f"needs {max(args.dp, 1) * pp * args.ep * sp * tp} processes")
        return topo, None, None
    mesh = create_mesh(MeshSpec(data=args.dp, pipe=pp, expert=args.ep, seq=sp, model=tp),
                       device=topo.device.type)
    return topo, mesh, data_group(mesh)


def _without_flag(argv: list[str], flag: str) -> list[str]:
    out, skip = [], False
    for arg in argv:
        if skip:
            skip = False
        elif arg == flag:
            skip = True
        elif not arg.startswith(flag + "="):
            out.append(arg)
    return out


def launch_local(module: str, argv: list[str], nproc: int) -> int:
    """Run ``python -m module argv`` as ``nproc`` local processes joined
    through a file store in a fresh temporary directory (no port), as
    torchrun would: rank ``r`` gets ``--process_id r`` and ``LOCAL_RANK=r``.
    Waits for all; if one fails the others are stopped. Returns the worst
    exit code."""
    if any(a == "--coordinator" or a.startswith("--coordinator=") for a in argv):
        raise SystemExit("--nproc spawns its own rendezvous; drop --coordinator")
    rdzv = tempfile.mkdtemp(prefix="dmt-rdzv-")
    child = _without_flag(argv, "--nproc") + [
        "--coordinator", f"file://{rdzv}/store", "--num_processes", str(nproc)]
    procs = [subprocess.Popen([sys.executable, "-m", module, *child, "--process_id", str(r)],
                              env={**os.environ, "LOCAL_RANK": str(r)})
             for r in range(nproc)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(rdzv, ignore_errors=True)
    return max(abs(p.returncode) for p in procs)


@dataclasses.dataclass
class Run:
    """A data-parallel training run, built and not yet run.
    ``state_factory`` builds a fresh initial state (the auto-resume's
    start when no checkpoint verifies)."""

    args: argparse.Namespace
    trainer: Any
    train_loader: Any
    eval_loader: Any
    start_epoch: int
    state_factory: Callable[[], Any] | None = None


def run_logger(args: argparse.Namespace, topo: Any) -> Any:
    """The run's ``RunLogger`` (rank 0 prints; with ``--log_dir`` it also
    writes the log file and its sidecar), with the system and the
    hyperparameters logged first, as the reference's CLIs do."""
    from deeplearning_mpi_tpu_torch.utils.logging import RunLogger

    logger = RunLogger(getattr(args, "log_dir", None))
    if logger.path is not None:
        logger.log_system_information(topo.device)
        logger.log_hyperparameters(vars(args))
    return logger


def _dist_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def build_observability(args: argparse.Namespace, trainer: Any, *,
                        flops_per_step: float | None = None,
                        issued_flops_per_step: float | None = None,
                        comm_bytes_per_step: float | None = None) -> None:
    """Attach the profiler, the heartbeat and the telemetry of the shared
    flags, as the reference's ``build_observability``. With ``--log_dir`` a
    ``resilience.Heartbeat`` beats into ``<log_dir>/heartbeat.json`` (rank
    0), or under a pod supervisor (``$DMT_HEARTBEAT_DIR``) every rank into
    ``heartbeat-<rank>.json`` there, every ``$DMT_HEARTBEAT_INTERVAL_S``
    (10 s by default). ``--metrics_dir`` adds a
    JSONL sink to the trainer's registry on rank 0 only (every rank
    computes the same records); ``flops_per_step`` /
    ``issued_flops_per_step`` / ``comm_bytes_per_step`` are the CLI's
    analytic counts. Without a comm count, the data-parallel gradient
    all-reduce is derived from the model's whole parameters
    (``telemetry.comms.param_count``) and the data group's size.
    ``--debug_nans`` hooks every module of the model."""
    from deeplearning_mpi_tpu_torch.runtime.bootstrap import is_coordinator
    from deeplearning_mpi_tpu_torch.telemetry import comms
    from deeplearning_mpi_tpu_torch.telemetry.registry import JsonlSink
    from deeplearning_mpi_tpu_torch.utils.profiling import Profiler, nan_debug_mode

    if getattr(args, "profile_dir", None):
        trainer.profiler = Profiler(args.profile_dir)
    if getattr(args, "log_dir", None):
        from deeplearning_mpi_tpu_torch.resilience.cluster import (
            ENV_HEARTBEAT_DIR,
            ENV_HEARTBEAT_INTERVAL,
        )
        from deeplearning_mpi_tpu_torch.resilience.supervisor import Heartbeat
        from deeplearning_mpi_tpu_torch.runtime.collectives import world_size

        hb_dir = os.environ.get(ENV_HEARTBEAT_DIR)
        if hb_dir or is_coordinator():
            rank = 0 if world_size() == 1 else _dist_rank()
            path = (Path(hb_dir) / f"heartbeat-{rank}.json" if hb_dir
                    else Path(args.log_dir) / "heartbeat.json")
            interval_s = float(os.environ.get(ENV_HEARTBEAT_INTERVAL, "10.0"))
            trainer.heartbeat = Heartbeat(path, interval_s=interval_s).start()
    metrics_dir = getattr(args, "metrics_dir", None)
    if metrics_dir and is_coordinator():
        trainer.metrics.add_sink(JsonlSink(Path(metrics_dir) / "metrics.jsonl"))
    trainer.metrics_every = getattr(args, "metrics_every", trainer.metrics_every)
    if flops_per_step is not None:
        trainer.flops_per_step = flops_per_step
    if issued_flops_per_step is not None:
        trainer.issued_flops_per_step = issued_flops_per_step
    if comm_bytes_per_step is None and trainer.comm_bytes_per_step is None:
        comm_bytes_per_step = comms.dp_grad_allreduce_bytes(
            comms.param_count(trainer.state.model), trainer.world, zero=trainer.zero)
    if comm_bytes_per_step is not None:
        trainer.comm_bytes_per_step = comm_bytes_per_step
    if getattr(args, "debug_nans", False):
        nan_debug_mode(True, trainer.state.model)


def build_run(args: argparse.Namespace, topo: Any, group: Any, *, task: str,
              model: Any, tx: Any, train_loader: Any, eval_loader: Any,
              seg_loss: str = "bce", model_factory: Callable[[], Any] | None = None) -> Run:
    """The train state, the checkpointer (with ``--model_dir``), the
    ``--resume`` / ``--eval_only`` restore, the :class:`Trainer` with the
    chaos plan and guardrail policy of the flags, the train loader under
    :func:`chaos_loader`, and (from ``model_factory``, a fresh model) the
    run's ``state_factory``."""
    from deeplearning_mpi_tpu_torch.train import Trainer, create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    logger = run_logger(args, topo)
    log = logger.log
    chaos = build_chaos(args)
    state = create_train_state(model, tx, ema=args.ema > 0)
    checkpointer, start_epoch = None, 0
    if args.model_dir is not None:
        checkpointer = Checkpointer(Path(args.model_dir) / args.model_filename,
                                    max_to_keep=args.keep_checkpoints, chaos=chaos)
        state, start_epoch = restore_for_start(args, checkpointer, state, log)
    trainer = Trainer(state, task, eval_every=args.eval_every, grad_accum=args.grad_accum,
                      seg_loss=seg_loss, ema_decay=args.ema, logger=logger,
                      checkpointer=checkpointer, group=group, zero=args.zero,
                      zero_overlap=args.zero_overlap, chaos=chaos,
                      guardrails=build_guardrails(args))
    state_factory = None if model_factory is None else (
        lambda: create_train_state(model_factory(), tx, ema=args.ema > 0))
    return Run(args, trainer, chaos_loader(trainer, train_loader), eval_loader, start_epoch,
               state_factory)


def _recover(trainer: Any, checkpointer: Any, state_factory: Callable[[], Any] | None,
             restart_epoch: int) -> int:
    """The state for an auto-resume attempt, taken in through
    ``Trainer.adopt`` (in place: a captured step keeps its storages);
    returns the epoch to start from. A pending guardrail rollback restores
    the pinned last-known-good (``Checkpointer.rollback_to_last_good``;
    before any save, a fresh init), rejoins its step count and counts
    ``guard_rollback_total``. A crash restores the newest step that
    verifies (a fresh init when every step is corrupt, or none was saved)
    and books the injected kill's recovery."""
    from deeplearning_mpi_tpu_torch.resilience.integrity import CheckpointCorruption

    pending = trainer.pending_rollback
    if pending is not None:
        trainer.pending_rollback = None
        if checkpointer is not None and checkpointer.latest_epoch() is not None:
            state, epoch = checkpointer.rollback_to_last_good(trainer.state)
            trainer.adopt(state)
            restart_epoch = epoch + 1
        else:  # poisoned before the first save: a fresh init is the last good
            trainer.adopt(state_factory())
            restart_epoch = 0
        trainer._global_step = trainer.state.step
        trainer.metrics.counter("guard_rollback_total").inc()
        trainer.log(f"guardrail rollback: restored last-good state (step "
                    f"{trainer._global_step}); replaying from epoch {restart_epoch} "
                    f"(poison region {pending.region})")
        return restart_epoch
    if checkpointer is not None and checkpointer.latest_epoch() is not None:
        try:
            state, epoch = checkpointer.restore_verified(trainer.state)
            trainer.adopt(state)
            # The VERIFIED epoch wins over the supervisor's latest + 1: a
            # walk past a corrupted newest step re-trains what it skipped.
            restart_epoch = epoch + 1
        except CheckpointCorruption as err:
            trainer.log(f"restart: {err}; restarting from a fresh init")
            trainer.adopt(state_factory())
            restart_epoch = 0
    elif state_factory is not None:
        trainer.adopt(state_factory())
    if trainer.chaos is not None:
        trainer.chaos.record_recovery("kill")  # a no-op unless a kill fired
    return restart_epoch


def execute(run: Run) -> Any:
    """Train (or, with ``--eval_only``, evaluate once); returns the
    trainer. As the reference's ``execute_training``: ``--max_restarts N``
    (with a checkpointer) runs ``fit`` under ``run_with_auto_resume``, each
    retry restored by :func:`_recover` (a crash from the newest verified
    step, a guardrail rollback from the pinned last-known-good) and delayed
    by ``--restart_delay_s``'s backoff; ``--max_restarts`` without a
    ``state_factory`` raises. SIGTERM ends training after the current
    epoch with a final checkpoint (``Preempted``: a clean exit, never a
    restart). At the end: the heartbeat stopped (its last beat written),
    the profiler's window closed, one ``run_summary`` record of every
    instrument (the chaos books among them) emitted, the injector's summary
    logged, and the telemetry sinks closed."""
    from deeplearning_mpi_tpu_torch.resilience import (
        GracefulShutdown,
        Preempted,
        run_with_auto_resume,
    )

    trainer, args = run.trainer, run.args
    max_restarts = getattr(args, "max_restarts", 0)
    checkpointer = trainer.checkpointer
    try:
        if args.eval_only:
            trainer.report_eval(trainer.evaluate(run.eval_loader))
            return trainer
        if max_restarts > 0 and run.state_factory is None:
            raise ValueError("--max_restarts requires a state_factory")
        attempts = 0

        def fit(restart_epoch: int) -> Any:
            nonlocal attempts
            attempts += 1
            if attempts > 1:
                restart_epoch = _recover(trainer, checkpointer, run.state_factory, restart_epoch)
            return trainer.fit(run.train_loader, args.num_epochs, eval_loader=run.eval_loader,
                               start_epoch=max(run.start_epoch, restart_epoch))

        with GracefulShutdown() as shutdown:
            trainer.shutdown = shutdown
            try:
                if max_restarts > 0 and checkpointer is not None:
                    run_with_auto_resume(fit, checkpointer, max_restarts=max_restarts,
                                         logger=trainer,
                                         restart_delay_s=getattr(args, "restart_delay_s", 5.0),
                                         registry=trainer.metrics)
                else:
                    fit(run.start_epoch)
            except Preempted as p:
                trainer.log(f"exiting after preemption ({p})")
        return trainer
    finally:
        if trainer.heartbeat is not None:
            trainer.heartbeat.stop()
        if trainer.profiler is not None:
            trainer.profiler.stop()
        trainer.metrics.emit("run_summary", trainer.metrics.snapshot())
        if trainer.chaos is not None:
            trainer.log(trainer.chaos.summary())
        trainer.metrics.close()


def cli_main(module: str, parse: Callable[[list[str]], argparse.Namespace],
             train: Callable[[list[str]], Any], argv: list[str] | None) -> int:
    """The data-parallel CLIs' ``main``: refuse unported flags, spawn
    ``--nproc`` local processes, or run ``train(argv)`` here and leave the
    group after it. A refusal prints its message and returns 1."""
    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        args = parse(argv)
        reject_unported(args)
        if args.nproc > 1:
            return launch_local(module, argv, args.nproc)
        try:
            train(argv)
        finally:
            bootstrap.shutdown()
    except SystemExit as refusal:
        if not isinstance(refusal.code, str):
            raise
        print(refusal.code, file=sys.stderr)
        return 1
    return 0
