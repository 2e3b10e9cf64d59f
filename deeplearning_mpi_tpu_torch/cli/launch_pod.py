"""Elastic pod launcher: the port's ``torchrun``.

Port of ``deeplearning_mpi_tpu/cli/launch_pod.py``: wraps a training
command in the :class:`~..resilience.pod.PodSupervisor`: one worker process
a rank, pod-level liveness from the ranks' heartbeats, and on a rank loss an
elastic re-form onto the survivors (a smaller world, a fresh rendezvous,
resumed from the newest checkpoint that verifies).

    python -m deeplearning_mpi_tpu_torch.cli.launch_pod --num_processes 2 \\
        --pod_dir /tmp/pod --chaos rank_kill@step:6 -- \\
        python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --resume \\
        --model_dir /tmp/pod/models --log_dir /tmp/pod/logs --eval_every 1 ...

Everything after ``--`` is the worker command, run once a rank with the
rendezvous (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``),
heartbeat (``DMT_HEARTBEAT_DIR``; the worker needs ``--log_dir``) and
chaos (``DMT_CHAOS``) variables set. The worker MUST pass ``--resume``. On
CUDA each rank takes card ``PROCESS_ID`` modulo the cards it sees. Exit
status: 0 when every rank of the final world exits 0; 1 when the pod fails
(survivors below ``--min_world_size``, or the restart budget spent); 2 with
no worker command.
"""

from __future__ import annotations

import argparse
import sys

from deeplearning_mpi_tpu_torch.resilience.pod import PodFailure, PodSupervisor


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="launch_pod", description=__doc__.split("\n")[0])
    p.add_argument("--num_processes", type=int, required=True,
                   help="initial world size (one worker process a rank)")
    p.add_argument("--pod_dir", required=True,
                   help="supervisor state: heartbeats, per-rank logs, pod_metrics.jsonl, the "
                   "journal and the quarantine ledger")
    p.add_argument("--chaos", default=None,
                   help="chaos spec forwarded to the workers as $DMT_CHAOS; rank_kill / "
                   "rank_hang / bitflip entries are booked here")
    p.add_argument("--heartbeat_deadline_s", type=float, default=60.0,
                   help="a progress stall past this is a hung rank")
    p.add_argument("--heartbeat_interval_s", type=float, default=1.0,
                   help="the workers' heartbeat cadence ($DMT_HEARTBEAT_INTERVAL_S)")
    p.add_argument("--spawn_grace_s", type=float, default=120.0,
                   help="startup window before a rank that never progressed counts as hung")
    p.add_argument("--poll_interval_s", type=float, default=0.5)
    p.add_argument("--min_world_size", type=int, default=1,
                   help="fail the pod rather than re-form below this")
    p.add_argument("--max_pod_restarts", type=int, default=2)
    p.add_argument("--straggler_factor", type=float, default=4.0,
                   help="flag a rank whose progress age exceeds this multiple of the median "
                   "inter-progress interval")
    p.add_argument("--ckpt_dir", default=None,
                   help="the workers' checkpoint directory (<model_dir>/<model_filename>): "
                   "after a digest-vote conviction the saves past the divergence are pruned")
    p.add_argument("worker_cmd", nargs=argparse.REMAINDER,
                   help="worker command (after --); it must pass --resume")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.worker_cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("launch_pod: no worker command given (after --)", file=sys.stderr)
        return 2
    sup = PodSupervisor(
        cmd, args.num_processes, args.pod_dir, chaos=args.chaos,
        heartbeat_deadline_s=args.heartbeat_deadline_s,
        heartbeat_interval_s=args.heartbeat_interval_s, spawn_grace_s=args.spawn_grace_s,
        poll_interval_s=args.poll_interval_s, min_world_size=args.min_world_size,
        max_pod_restarts=args.max_pod_restarts, straggler_factor=args.straggler_factor,
        ckpt_dir=args.ckpt_dir,
    )
    try:
        result = sup.run()
    except PodFailure:
        return 1
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
