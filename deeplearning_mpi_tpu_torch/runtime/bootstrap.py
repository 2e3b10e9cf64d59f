"""Process bootstrap and topology: ``torch.distributed`` rendezvous.

Port of ``deeplearning_mpi_tpu/runtime/bootstrap.py``. The reference wraps
``jax.distributed.initialize`` (one process a host); the port runs one
process a device, as the original repo's torchrun launch did, and joins
them with ``torch.distributed.init_process_group``: NCCL when the caller
asks for ``cuda``, gloo when it asks for ``cpu``. The backend follows the
device the caller names; it is never guessed, and gloo never stands in for
a failed NCCL init.

The topology comes from the arguments, else from the reference's variables,
else from torchrun's:

=====================  ======================  ===========================
argument               the reference's env     torchrun's env
=====================  ======================  ===========================
``coordinator_address``  ``COORDINATOR_ADDRESS``  ``MASTER_ADDR:MASTER_PORT``
``num_processes``        ``NUM_PROCESSES``        ``WORLD_SIZE``
``process_id``           ``PROCESS_ID``           ``RANK``
(the card)               —                        ``LOCAL_RANK``
=====================  ======================  ===========================

A coordinator is ``host:port`` (a TCP rendezvous, as the reference's) or an
``init_method`` URL (``tcp://...``, ``file:///path`` for a store in a file,
which needs no port). One process with no coordinator needs no rendezvous
and joins no group. The reference's ``set_virtual_cpu_devices`` has no
counterpart: the port's CPU ranks are processes (gloo), not fake devices.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import platform as _platform
import socket
from typing import Any

import torch
import torch.distributed as dist

from deeplearning_mpi_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Topology:
    """The process's place after :func:`init`: its rank, the world, its
    card and the backend that joins them (None: no group)."""

    process_id: int
    num_processes: int
    local_rank: int
    local_device_count: int
    global_device_count: int
    platform: str
    backend: str | None
    coordinator_address: str | None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def device(self) -> torch.device:
        """This process's device: its card on CUDA, else the CPU."""
        if self.platform == "cuda":
            return torch.device("cuda", self.local_rank)
        return torch.device("cpu")


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def init_method_for(coordinator_address: str) -> str:
    """``host:port`` as a TCP ``init_method``; a URL as it is."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
    *,
    timeout_s: float | None = None,
) -> Topology:
    """Join the process group and return the topology.

    ``device`` selects the backend: ``cuda`` -> NCCL (each process on card
    ``LOCAL_RANK``, set before the init), ``cpu`` -> gloo. A run with more
    than one process, or with a coordinator, rendezvouses there;
    ``timeout_s`` bounds the rendezvous and every collective after it (the
    backend's default when None). Calling it again while a group is live
    returns the live topology.
    """
    dev = resolve_device(device)
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS") or None
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    local_rank = _env_int("LOCAL_RANK")

    multi_process = coordinator_address is not None or (num_processes or 1) > 1
    if multi_process and not dist.is_initialized():
        if coordinator_address is None:
            raise ValueError(
                f"{num_processes} processes need a coordinator (--coordinator / "
                "COORDINATOR_ADDRESS / MASTER_ADDR) to rendezvous"
            )
        if num_processes is None or process_id is None:
            raise ValueError(
                "a rendezvous needs the world size and this process's rank "
                "(--num_processes / NUM_PROCESSES / WORLD_SIZE and --process_id / "
                "PROCESS_ID / RANK)"
            )
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            if local_rank is None:
                local_rank = process_id % torch.cuda.device_count()
            torch.cuda.set_device(local_rank)
        kw: dict[str, Any] = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend, init_method=init_method_for(coordinator_address),
                                world_size=num_processes, rank=process_id, **kw)
    elif dev.type == "cuda" and local_rank is not None:
        torch.cuda.set_device(local_rank)
    return topology(dev, coordinator_address)


def topology(device: str | torch.device = "cpu",
             coordinator_address: str | None = None) -> Topology:
    """The topology as it stands: the live group's backend names the
    platform; with no group, ``device`` does (one process)."""
    live = dist.is_initialized()
    backend = dist.get_backend() if live else None
    if backend is not None:
        platform = "cuda" if backend == "nccl" else "cpu"
    else:
        platform = torch.device(device).type
    world = dist.get_world_size() if live else 1
    return Topology(
        process_id=dist.get_rank() if live else 0,
        num_processes=world,
        local_rank=torch.cuda.current_device() if platform == "cuda" else 0,
        local_device_count=torch.cuda.device_count() if platform == "cuda" else 1,
        global_device_count=world,
        platform=platform,
        backend=backend,
        coordinator_address=coordinator_address,
    )


def shutdown() -> None:
    """Leave the process group, if one is live. Idempotent: a second call,
    or one after a direct ``destroy_process_group``, does nothing, and a
    later :func:`init` joins afresh."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    """True on rank 0, and in a process that joined no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def get_system_information(device: str | torch.device = "cpu") -> dict[str, Any]:
    """Host and device inventory for the run log."""
    topo = topology(device)
    return {
        "hostname": socket.gethostname(),
        "python_version": _platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": topo.platform,
        "backend": topo.backend,
        "device_kind": (torch.cuda.get_device_name(topo.local_rank) if topo.platform == "cuda"
                        else _platform.processor() or _platform.machine()),
        "process_id": topo.process_id,
        "num_processes": topo.num_processes,
        "local_device_count": topo.local_device_count,
        "global_device_count": topo.global_device_count,
    }
