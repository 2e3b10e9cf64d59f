"""Transformer LM training, dense or MoE, with checkpoint and resume.

Port of ``deeplearning_mpi_tpu/cli/train_lm.py``: the same model, training
and data flags (names and defaults), vocab 256, the 90/10 train/eval split
and the same batch order (``data.loader.Loader``), so the port trains on
the JAX CLI's batches. ``--attention flash`` selects
``flash_attention_bhsd`` (K1 forward, K2/K3 backward on CUDA; the model
hands it ``[B, H, S, D]`` views of its projections). Adam with clip 1.0 by
default.

``--moe_experts N`` trains the routed MoE LM (``--moe_top_k``,
``--moe_routing``; ``--moe_aux_weight`` weighs the load-balance loss, 0.01
by default) and logs the epoch's ``moe_dropped_frac``. ``expert_choice``
routing ranks the whole sequence, so it leaks future tokens into a causal
LM: the parser refuses it without ``--allow_acausal_routing``.

One process a device, as the data-parallel CLIs (``utils.config``'s
topology flags, ``--nproc N`` local processes): ``--dp`` ranks split each
global batch, and ``--ep`` ranks of one data coordinate split the experts
(``parallel/expert_parallel.py``); rank 0 logs and writes.

``--attention ring`` / ``ulysses`` select the sequence-parallel schedules
(``parallel/``) over the mesh's seq group: ``--sp N`` processes of a data
coordinate load the same rows and each runs its ``S/N`` slice of them
through the model, gradients summed over the seq group and averaged over
data. On CUDA the ring runs K1 a rotation forward and K2/K3 backward
(``parallel.ring_flash``) and Ulysses K1 on whole sequences; on the CPU both
take their plain inners. Beside ``--moe_experts`` (and ``--ep``) each
block routes its shard as the whole sequence (``models.moe``: positions
across the shards, capacity from the whole length, the balance loss over
the whole rows).

``--tp N`` shards the model over the mesh's model axis, the process-group
form of ``parallel/tensor_parallel.py``: ``N`` processes of a data
coordinate load the same rows and each holds its shards of the Megatron
pairs (H/N heads, d_ff/N) and of the embedding; on the card K1-K3 run at
the local heads. ``--dp M --tp N`` takes ``M * N`` processes. ``--zero``
keeps each rank's slice of the optimizer moments over the data group (the
reference's placement on its whole leaves, beside any other axis) and
``--zero_overlap`` runs the bucketed ZeRO-1 schedule (``parallel/zero.py``;
with another axis above 1, or without data parallelism, it falls back to
``--zero`` and logs why). ``--tp`` composes with ``--moe_experts`` /
``--ep`` (each expert's d_ff split over the model group, the reference's
``ep_spec``), with ``--sp`` (ring or Ulysses at each model rank's local
heads) and with ``--pp`` (Megatron blocks inside each stage); it refuses
widths it does not divide (ROADMAP Queue 1 item 8.6). Adafactor factors
and clips the reference's whole leaves under every axis
(``parallel/leaves.py``). ``--loss_chunk`` composes with ``--sp``: each
shard chunks its own slice of the loss.

``--pp S`` trains the pipelined LM (``models/pipeline_lm.py``): the blocks
in ``S`` GPipe stages, one a process of a data coordinate (the process-group
form of ``parallel/pipeline.py``), each global batch's rows (of each
``--grad_accum`` chunk) split into ``--microbatches`` microbatches. ``--dp
M --pp S`` takes ``M * S`` processes; every rank of a pipe group loads the
same rows and the last stage's loss is logged. Its checkpoint stacks each
block leaf over the stages, and ``arch.json`` records ``S``: a resume
takes the same ``--pp`` at any ``--dp``, ``--tp`` or ``--ep``. ``--pp``
composes with ``--ep`` (each stage's experts over the expert group),
``--zero`` / ``--zero_overlap`` and adafactor; it refuses ``--sp`` /
``--attention ring|ulysses``, on which the reference itself raises (ROADMAP
Queue 1 item 8.6). ``arch.json`` records every axis's degree under
``layout``.

With ``--model_dir`` the trainer saves the full state (weights, optimizer
state, step, EMA) every ``--eval_every`` epochs and after the last into
``<model_dir>/<model_filename>/<epoch>/``, beside an ``arch.json`` sidecar
that every later start checks (``train/checkpoint.py``). ``--resume``
continues from the newest step that verifies (a missing or all-corrupt
history starts fresh); ``--eval_only`` restores it and runs one eval pass
(no checkpoint is an error). Without ``--model_dir`` nothing is written.
SIGTERM ends training after the current epoch with a final checkpoint.

    python -m deeplearning_mpi_tpu_torch.cli.train_lm --attention flash --dtype bfloat16
    python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --num_layers 2 \\
        --num_heads 2 --head_dim 8 --d_model 16 --d_ff 32 --seq_len 32 --batch_size 4 \\
        --train_sequences 40 --num_epochs 2 --model_dir /tmp/lm [--resume | --eval_only]
    python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --nproc 4 --dp 2 --ep 2 \
        --moe_experts 4 --num_layers 2 --num_heads 2 --head_dim 8 --d_model 16 --d_ff 32 \
        --seq_len 32 --batch_size 4 --train_sequences 40 --num_epochs 1
    python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --nproc 4 --sp 4 \
        --attention ring --num_layers 2 --num_heads 4 --head_dim 8 --d_model 32 --d_ff 64 \
        --seq_len 32 --batch_size 4 --train_sequences 40 --num_epochs 1
    python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --nproc 4 --dp 2 --tp 2 \
        --zero --num_layers 2 --num_heads 4 --head_dim 16 --d_model 32 --d_ff 64 \
        --seq_len 32 --batch_size 4 --train_sequences 40 --num_epochs 1

    python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --nproc 2 --pp 2 \
        --microbatches 2 --num_layers 2 --num_heads 2 --head_dim 8 --d_model 16 --d_ff 32 \
        --seq_len 32 --batch_size 4 --train_sequences 40 --num_epochs 1

The composed layouts on four CPU ranks (``--pp 2 --tp 2``, ``--tp 2 --sp 2
--attention ring|ulysses``, ``--moe_experts 4 --ep 2 --sp 2 --attention
ring``, ``--moe_experts 4 --ep 2 --tp 2``, ``--moe_experts 4 --pp 2 --ep
2``, ``--dp 2 --ep 2 --zero`` and the like)::

    python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --nproc 4 --pp 2 --tp 2 \
        --microbatches 2 --num_layers 2 --num_heads 4 --num_kv_heads 2 --head_dim 16 \
        --d_model 32 --d_ff 64 --seq_len 32 --batch_size 4 --train_sequences 40 --num_epochs 1

Telemetry as the reference's (``utils/config.py`` ``build_observability``):
``--log_dir`` (the run log and its ``.metrics.jsonl`` sidecar),
``--metrics_dir`` / ``--metrics_every`` (``metrics.jsonl``, rendered by
``tools/metrics_report.py``), ``--profile_dir`` (a ``torch.profiler``
trace of steps 3-5, K1-K3 under their C++ names) and ``--debug_nans``. The
epoch record's MFU counts the global batch's model FLOPs
(``telemetry/flops.py``, remat's recompute as ``mfu_issued``) over every
process, and ``comm_bytes_per_step`` adds up the reference's collective
bytes of the run's axes: the gradient all-reduce of the whole model over
data, the ring's or Ulysses' exchanges over seq, the pipeline's shifts and
the MoE dispatch over expert (``telemetry/comms.py``).

``--aot_warmup`` captures the train step on one real batch before the
first epoch (``Trainer.warmup``: one CUDA graph of the whole step on the
card, replayed every step; on the CPU the same static-buffer program runs
eagerly). It covers one process without a parallel axis, dense or MoE;
every other layout is refused (ROADMAP Queue 1 item 9.1b).
``--tuned_step DB`` applies the DB's ``step|...`` entry for this shape
(``cli.autotune --step``): remat, ``--grad_accum`` and ``--zero_overlap``,
set before anything is built; a missing, corrupt or entry-less DB keeps
the flags and says so.

Resilience as the reference's (``utils/config.py``, ``resilience/``):
``--max_restarts N`` / ``--restart_delay_s`` restart a crashed run from
the newest checkpoint that verifies (a fresh init when none does);
``--chaos PLAN`` (or ``$DMT_CHAOS``) injects the planned faults (a kind
without a training hook exits 1 naming the workload) and wraps the train
loader in the stall watchdog; ``--guardrails`` judges every step's loss and
gradient norm and rolls a poisoned run back to the pinned last-known-good
checkpoint, ``--digest_every N`` publishing parameter digests on the
heartbeat (``--log_dir``) for ``cli.launch_pod``'s vote. Under
``--aot_warmup`` a restart or a rollback loads the restored state into the
captured step's storages (``Trainer.adopt``).

    python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --num_layers 2 \
        --num_heads 2 --head_dim 8 --d_model 16 --d_ff 32 --seq_len 32 --batch_size 4 \
        --train_sequences 40 --num_epochs 3 --eval_every 1 --model_dir /tmp/lm \
        --chaos kill@step:12,corrupt_ckpt@epoch:1,loader_stall@batch:1 --max_restarts 2
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from deeplearning_mpi_tpu_torch.utils import config
from deeplearning_mpi_tpu_torch.utils.config import ema_decay

MODULE = "deeplearning_mpi_tpu_torch.cli.train_lm"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="train_lm", description=__doc__.split("\n")[0])
    config.add_topology_flags(parser)
    train = parser.add_argument_group("training")
    train.add_argument("--num_epochs", type=int, default=10)
    train.add_argument("--batch_size", type=int, default=32)
    train.add_argument("--learning_rate", type=float, default=3e-4)
    train.add_argument("--optimizer", default="adam",
                       choices=("sgd", "adam", "adamw", "adafactor", "lion"))
    train.add_argument("--weight_decay", type=float, default=0.0)
    train.add_argument("--lr_schedule", default="constant", choices=("constant", "cosine", "linear"))
    train.add_argument("--warmup_steps", type=int, default=0)
    train.add_argument("--grad_accum", type=int, default=1)
    train.add_argument("--num_workers", type=int, default=None,
                       help="the loader's fetch threads (default: half the host's cores, at "
                       "most 16; 0 = synchronous)")
    train.add_argument("--random_seed", type=int, default=0)
    train.add_argument("--ema", type=ema_decay, default=0.0)
    train.add_argument("--eval_every", type=int, default=10,
                       help="epochs between evals and checkpoints")
    train.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    config.add_observability_flags(train)
    config.add_resilience_flags(train)
    model = parser.add_argument_group("model")
    model.add_argument("--seq_len", type=int, default=512)
    model.add_argument("--num_layers", type=int, default=4)
    model.add_argument("--num_heads", type=int, default=8)
    model.add_argument("--num_kv_heads", type=int, default=0)
    model.add_argument("--head_dim", type=int, default=32)
    model.add_argument("--d_model", type=int, default=256)
    model.add_argument("--d_ff", type=int, default=1024)
    model.add_argument("--attention_window", type=int, default=0)
    model.add_argument("--remat", nargs="?", const="full", default="none",
                       choices=("none", "dots", "full"))
    model.add_argument("--attention", default="dense", choices=("dense", "flash", "ring", "ulysses"))
    model.add_argument("--loss_chunk", type=int, default=0)
    model.add_argument("--aot_warmup", action="store_true",
                       help="capture the train step on a sample batch before the first epoch "
                       "(one CUDA graph on the card; on the CPU the same static-buffer program "
                       "runs eagerly): --nproc 1 without a parallel axis, dense or MoE")
    model.add_argument("--microbatches", type=int, default=4,
                       help="GPipe microbatches when --pp > 1 (bubble fraction = "
                       "(pp-1)/(M+pp-1))")
    model.add_argument("--moe_experts", type=int, default=0,
                       help="0 = dense SwiGLU MLP; N swaps in a routed MoE MLP per block")
    model.add_argument("--moe_top_k", type=int, default=2)
    model.add_argument("--moe_routing", default="token_choice",
                       choices=("token_choice", "expert_choice"),
                       help="token_choice = top-k + balance aux loss; expert_choice = each "
                       "expert takes its top-C tokens (routing sees the whole sequence)")
    model.add_argument("--moe_aux_weight", type=float, default=0.01)
    model.add_argument("--allow_acausal_routing", action="store_true",
                       help="acknowledge that --moe_routing expert_choice leaks future "
                       "tokens into this causal LM's training")
    data = parser.add_argument_group("data")
    data.add_argument("--text_file", default=None,
                      help="train on this file's bytes (vocab 256); default: synthetic motifs")
    data.add_argument("--train_sequences", type=int, default=512)
    ckpt = parser.add_argument_group("checkpoint")
    ckpt.add_argument("--model_dir", default=None,
                      help="save checkpoints under <model_dir>/<model_filename> "
                      "(default: none are written)")
    ckpt.add_argument("--model_filename", default="lm")
    ckpt.add_argument("--keep_checkpoints", type=int, default=3,
                      help="retention: the newest N checkpoints (and the pinned last-good)")
    ckpt.add_argument("--resume", action="store_true",
                      help="continue from the newest checkpoint that verifies "
                      "(weights, optimizer state and step: pass the same --optimizer "
                      "and --ema)")
    ckpt.add_argument("--eval_only", action="store_true",
                      help="restore the newest checkpoint that verifies, run one eval "
                      "pass and exit")
    return parser


def parse(argv: list[str] | None):
    """Parse ``argv``; an acausal routing without its acknowledgement is a
    parser error (exit 2), as in the reference."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.moe_experts > 0 and args.moe_routing == "expert_choice"
            and not args.allow_acausal_routing):
        parser.error(
            "--moe_routing expert_choice leaks future tokens into causal LM training "
            "(routing ranks the whole sequence) and routes differently under KV-cached "
            "decode. Pass --allow_acausal_routing to proceed anyway, or use "
            "--moe_routing token_choice.")
    if args.aot_warmup and not args.eval_only:
        layout = [flag for flag, on in (
            ("--nproc", args.nproc > 1), ("--coordinator", args.coordinator is not None),
            ("--dp", args.dp not in (-1, 1)), ("--pp", args.pp > 1), ("--ep", args.ep > 1),
            ("--sp", args.sp > 1), ("--tp", args.tp > 1),
            ("--attention ring|ulysses", args.attention in ("ring", "ulysses")),
            ("--zero", args.zero), ("--zero_overlap", args.zero_overlap)) if on]
        if layout:
            parser.error(f"--aot_warmup captures the step of one process without a parallel "
                         f"axis; {', '.join(layout)} is not captured yet (ROADMAP Queue 1 item "
                         "9.1b)")
    return args


class _Slice:
    """Contiguous view of a dataset: the train/eval split."""

    def __init__(self, dataset, start: int, stop: int) -> None:
        self.dataset, self.start, self.stop = dataset, start, stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, index: int):
        return self.dataset[self.start + index]


def train(argv: list[str] | None = None):
    """Parse ``argv``, join the group, build the run and train (or, with
    ``--eval_only``, evaluate); returns the ``Trainer``. A refusal
    (unported option, an architecture mismatch, ``--eval_only`` with no
    checkpoint) raises ``SystemExit`` with its message."""
    args = parse(argv)
    config.reject_unported(args)
    if args.ep > 1 and not args.moe_experts:
        raise SystemExit("--ep > 1 shards MoE experts: it needs --moe_experts")
    from deeplearning_mpi_tpu_torch.data import ByteTextDataset, Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.runtime.mesh import (
        data_rank,
        data_size,
        expert_shards,
        mesh_layout,
        pipe_shards,
        seq_ring,
        seq_shards,
        tp_shards,
    )
    from deeplearning_mpi_tpu_torch.telemetry.flops import (
        transformer_issued_flops,
        transformer_train_flops,
    )
    from deeplearning_mpi_tpu_torch.train import Trainer, create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    topo, mesh, group = config.setup_runtime(args)
    from deeplearning_mpi_tpu_torch.resilience.supervisor import preflight

    preflight(model_dir=args.model_dir, log_dir=args.log_dir, global_batch_size=args.batch_size,
              mesh=mesh, grad_accum=args.grad_accum)
    device = topo.device
    logger = config.run_logger(args, topo)
    log = logger.log
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.tuned_step:
        # Before anything is built: remat is a model property and grad_accum
        # shapes the loader. A missing or corrupt DB or an untuned shape keeps
        # the flag defaults.
        from deeplearning_mpi_tpu_torch.compiler.autotune import TuningDB, tuned_step_schedule

        tuned = tuned_step_schedule("lm", (args.batch_size, args.seq_len), mesh, dtype,
                                    db=TuningDB.load(args.tuned_step))
        if tuned:
            args.remat = tuned.get("remat", args.remat)
            if tuned.get("grad_accum"):
                args.grad_accum = int(tuned["grad_accum"])
            if "overlap" in tuned:
                args.zero_overlap = bool(tuned["overlap"])
            log(f"tuned step schedule ({args.tuned_step}): {tuned}")
        else:
            log(f"no step tuning for this shape in {args.tuned_step}; using flag defaults")
    if args.text_file:
        dataset = ByteTextDataset(args.text_file, args.seq_len)
    else:
        dataset = SyntheticTokens(args.train_sequences, args.seq_len, seed=args.random_seed)
    n_eval = max(1, len(dataset) // 10)
    train_ds = _Slice(dataset, 0, len(dataset) - n_eval)
    eval_ds = _Slice(dataset, len(dataset) - n_eval, len(dataset))
    ranks = {"num_replicas": data_size(mesh), "rank": data_rank(mesh)}
    # Under --pp each chunk is cut into microbatches: a rank takes its share
    # of each of the reference's contiguous microbatches, so the MoE
    # balance loss of a microbatch is the reference's under --dp too.
    chunks = args.grad_accum * (args.microbatches if args.pp > 1 else 1)
    train_loader = Loader(train_ds, args.batch_size, shuffle=True, seed=args.random_seed,
                          grad_accum=chunks, device=device, num_workers=args.num_workers,
                          **ranks)
    eval_loader = Loader(eval_ds, args.batch_size, shuffle=False, drop_last=False,
                         device=device, num_workers=args.num_workers, **ranks)

    attention_fn = None
    if args.attention == "flash":
        from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd

        attention_fn = flash_attention_bhsd
    elif args.attention in ("ring", "ulysses"):
        from deeplearning_mpi_tpu_torch.parallel import (
            make_ring_attention_fn,
            make_ulysses_attention_fn,
        )

        make = make_ring_attention_fn if args.attention == "ring" else make_ulysses_attention_fn
        # Without a group: one process, a ring of one.
        attention_fn = make(mesh) if mesh is not None else make(sp=1)
    cfg = TransformerConfig(
        vocab_size=256, num_layers=args.num_layers, num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads or None, head_dim=args.head_dim,
        d_model=args.d_model, d_ff=args.d_ff, attention_window=args.attention_window,
        moe_experts=args.moe_experts, moe_top_k=args.moe_top_k, moe_routing=args.moe_routing,
    )
    chaos = config.build_chaos(args)
    checkpointer = None
    if args.model_dir is not None:
        ckpt_dir = Path(args.model_dir) / args.model_filename
        # Checked at every start: a fresh run into a directory of another
        # architecture must not re-stamp the sidecar under its epochs.
        err = config.arch_mismatch_error(cfg, ckpt_dir, pipeline_stages=args.pp)
        if err:
            raise SystemExit(err)
        if not args.eval_only and topo.is_coordinator:
            config.save_arch(cfg, ckpt_dir, pipeline_stages=args.pp, layout=mesh_layout(mesh))
        checkpointer = Checkpointer(ckpt_dir, max_to_keep=args.keep_checkpoints, chaos=chaos)

    def build_model():
        if args.pp > 1:
            from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM

            model = PipelinedLM(cfg, num_stages=args.pp, num_microbatches=args.microbatches,
                                dtype=dtype, device=device, remat=args.remat,
                                return_prehead=args.loss_chunk > 0,
                                pipe=pipe_shards(mesh, device), tp=tp_shards(mesh, device),
                                expert_shards=expert_shards(mesh))
        else:
            model = TransformerLM(cfg, dtype=dtype, device=device, remat=args.remat,
                                  return_prehead=args.loss_chunk > 0,
                                  expert_shards=expert_shards(mesh), tp=tp_shards(mesh, device),
                                  seq=seq_ring(mesh))
        return model.init_weights(args.random_seed)

    try:
        model = build_model()
    except ValueError as e:  # a width the tensor-parallel rule would split unevenly, a
        raise SystemExit(str(e)) from e  # depth the stages do not divide
    tx = config.build_optimizer_from_flags(args, train_loader, clip_norm=1.0)

    def state_factory():
        """A fresh initial state (auto-resume's start when no step verifies)."""
        return create_train_state(build_model(), tx, attention_fn=attention_fn,
                                  ema=args.ema > 0)

    state = create_train_state(model, tx, attention_fn=attention_fn, ema=args.ema > 0)
    start_epoch = 0
    if checkpointer is not None:
        state, start_epoch = config.restore_for_start(args, checkpointer, state, log)
    n_params = sum(p.numel() for p in model.parameters())
    moe = (f", MoE {args.moe_experts} experts top-{args.moe_top_k} {args.moe_routing} over "
           f"--ep {args.ep}" if args.moe_experts else "")
    log(f"train_lm: {n_params} params on this process{moe}, {len(train_ds)} train / "
        f"{len(eval_ds)} eval sequences of {args.seq_len}, {train_loader.steps_per_epoch()} "
        f"steps/epoch, attention {args.attention} (--sp {args.sp}), --tp {args.tp}"
        f"{f', --pp {args.pp} x {args.microbatches} microbatches' if args.pp > 1 else ''}"
        f"{' --zero_overlap' if args.zero_overlap else ' --zero' if args.zero else ''}, "
        f"{args.dtype}, on {device}, {topo.num_processes} process(es) "
        f"({topo.backend or 'no group'})")
    trainer = Trainer(state, "lm", eval_every=args.eval_every,
                      aux_weight=args.moe_aux_weight if args.moe_experts else 0.0,
                      grad_accum=args.grad_accum, loss_chunk=args.loss_chunk,
                      ema_decay=args.ema, logger=logger, checkpointer=checkpointer,
                      group=group, seq=seq_shards(mesh), zero=args.zero,
                      zero_overlap=args.zero_overlap, chaos=chaos,
                      guardrails=config.build_guardrails(args))
    config.build_observability(
        args, trainer, flops_per_step=transformer_train_flops(cfg, args.batch_size, args.seq_len),
        issued_flops_per_step=transformer_issued_flops(cfg, args.batch_size, args.seq_len,
                                                       remat=args.remat),
        comm_bytes_per_step=comm_bytes(args, mesh, model, dtype))
    if args.aot_warmup and not args.eval_only:
        # One real batch fixes the shapes; warmup does not train. The raw
        # loader's: a planned loader fault must not fire here.
        trainer.warmup(next(iter(train_loader.epoch(start_epoch))))
    return config.execute(config.Run(args, trainer, config.chaos_loader(trainer, train_loader),
                                     eval_loader, start_epoch, state_factory))


def comm_bytes(args, mesh, model, dtype: torch.dtype) -> float:
    """The reference CLI's collective bytes a step a device
    (``cli/train_lm.py``): the whole model's gradient all-reduce over data
    (ZeRO-1's reduce-scatter and all-gather under ``--zero``), plus the
    ring's or Ulysses' exchanges over seq, the GPipe shifts over pipe and
    the MoE dispatch and combine over expert, at the run's activation
    dtype."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_size, pipe_size, seq_size
    from deeplearning_mpi_tpu_torch.telemetry import comms

    dp, sp, pp, ep = data_size(mesh), seq_size(mesh), pipe_size(mesh), args.ep
    batch_local = max(args.batch_size // max(dp, 1), 1)
    total = comms.dp_grad_allreduce_bytes(comms.param_count(model), dp, zero=args.zero)
    kw = dict(kv_heads=args.num_kv_heads or None, num_layers=args.num_layers, dtype=dtype)
    if args.attention == "ulysses":
        total += comms.ulysses_attention_bytes(batch_local, max(args.seq_len // sp, 1),
                                               args.num_heads, args.head_dim, sp, **kw)
    elif args.attention == "ring":
        total += comms.ring_attention_bytes(batch_local, max(args.seq_len // sp, 1),
                                            args.num_heads, args.head_dim, sp, **kw)
    if pp > 1:
        total += comms.pipeline_bytes(
            (max(batch_local // args.microbatches, 1), args.seq_len, args.d_model),
            args.microbatches, pp, dtype=dtype)
    if args.moe_experts and ep > 1:
        total += comms.moe_dispatch_bytes(batch_local * args.seq_len, args.d_model, ep,
                                          top_k=args.moe_top_k, num_layers=args.num_layers,
                                          dtype=dtype)
    return total


def main(argv: list[str] | None = None) -> int:
    return config.cli_main(MODULE, parse, train, argv)


if __name__ == "__main__":
    sys.exit(main())
