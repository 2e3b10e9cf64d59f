"""The distributed smoke test: rendezvous, broadcast, ring and all-reduce.

Port of ``deeplearning_mpi_tpu/cli/hello_world.py`` (the original repo's
first program): every process joins the group (NCCL with ``--device
cuda``, gloo with ``--device cpu``) and runs ``runtime.hello_world``'s
three checks; exit 0 when all pass on every rank.

    python -m deeplearning_mpi_tpu_torch.cli.hello_world --device cpu --nproc 4
    torchrun --nproc_per_node 8 -m deeplearning_mpi_tpu_torch.cli.hello_world
    python -m deeplearning_mpi_tpu_torch.cli.hello_world --coordinator file:///tmp/rdzv \\
        --num_processes 1 --process_id 0          # one card, NCCL at world size 1

With one process and no coordinator the group is joined through a file
store in a temporary directory.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hello_world", description=__doc__.split("\n")[0])
    parser.add_argument("--coordinator", default=None,
                        help="rendezvous: host:port or an init_method URL (tcp://, file://)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: NCCL, one card a process; cpu: gloo")
    parser.add_argument("--nproc", type=int, default=1,
                        help="spawn this many local processes, joined through a file store")
    parser.add_argument("--timeout_s", type=float, default=None,
                        help="bound on the rendezvous and each collective")
    return parser


def run(argv: list[str] | None = None):
    """Join the group, run the checks, leave; returns the result."""
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.hello_world import run_hello_world

    args = build_parser().parse_args(argv)
    lone = (args.coordinator is None and not os.environ.get("COORDINATOR_ADDRESS")
            and not os.environ.get("MASTER_ADDR") and (args.num_processes or 1) == 1)
    rdzv = tempfile.mkdtemp(prefix="dmt-rdzv-") if lone else None
    try:
        topo = bootstrap.init(f"file://{rdzv}/store" if lone else args.coordinator,
                              1 if lone else args.num_processes, 0 if lone else args.process_id,
                              device=args.device, timeout_s=args.timeout_s)
        print(f"[process {topo.process_id}/{topo.num_processes}] platform={topo.platform} "
              f"backend={topo.backend} local_devices={topo.local_device_count} "
              f"global_devices={topo.global_device_count}", flush=True)
        result = run_hello_world(device=topo.device)
        print(f"hello_world {'OK' if result.ok else 'FAILED'}: n_devices={result.n_devices} "
              f"broadcast={'ok' if result.broadcast_ok else 'FAIL'} "
              f"ring={'ok' if result.ring_ok else 'FAIL'} "
              f"psum={'ok' if result.psum_ok else 'FAIL'}", flush=True)
        return result
    finally:
        bootstrap.shutdown()
        if rdzv is not None:
            shutil.rmtree(rdzv, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    from deeplearning_mpi_tpu_torch.utils import config

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.nproc > 1:
        return config.launch_local("deeplearning_mpi_tpu_torch.cli.hello_world", argv, args.nproc)
    return 0 if run(argv).ok else 1


if __name__ == "__main__":
    sys.exit(main())
