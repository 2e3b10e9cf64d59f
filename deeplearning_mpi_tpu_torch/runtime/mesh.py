"""The device mesh: five named axes over the process group.

Port of ``deeplearning_mpi_tpu/runtime/mesh.py``. The axis names and
``MeshSpec.resolve``'s arithmetic and errors are the reference's;
:func:`create_mesh` builds a ``torch.distributed.device_mesh.DeviceMesh``
with those names (one process a device); every axis may exceed 1. The
reference's
``order_devices_for_mesh`` (multi-slice TPU placement) has no counterpart
on GPUs.

The data axis is the reference's ``batch_sharding``: a global batch of
``B`` rows is cut into ``data`` contiguous blocks, and the process at data
coordinate ``r`` holds rows ``[r*B/n, (r+1)*B/n)`` (:func:`batch_rows`).
Tokens are replicated over ``expert``, as in the reference: the processes
of one expert group share a data coordinate and feed the same rows, and
each holds its share of the MoE experts (:func:`expert_shards`). Rows are
replicated over ``seq`` as well (the reference's ``batch_sharding`` splits
the batch over ``data`` only): every process of a seq group loads the same
whole rows and keeps its ``S / seq`` slice of the sequence through the
model (``parallel.seq_common.SeqShards``). A parameter replica is shared by
the processes of one data x seq plane (:func:`replica_group`): their
gradients are summed over ``seq`` and averaged over ``data``. Rows are
replicated over ``model`` too: the processes of one model group hold the
shards of one replica's weights (``parallel.tensor_parallel``,
:func:`tp_shards`) and run the same rows; a replica's data group is the
processes of its model coordinate. Rows are replicated over ``pipe`` as
well: the processes of one pipe group each hold one stage of the pipelined
LM (``parallel.pipeline.GroupPipe``, :func:`pipe_shards`) and load the same
rows; a stage's data group is the processes of its pipe coordinate.

Two axes compose by these groups alone (``get_group`` of each axis is the
processes that differ only on it): under ``pipe x model`` a stage's sends
go over the pipe group of this process's model coordinate, and its
Megatron sums over the model group of its stage; under ``seq x model`` the
ring or Ulysses runs over the seq group of each model coordinate, at that
rank's local heads, and the replica plane (data x seq) is taken at each
model coordinate; under ``expert x seq`` and ``expert x model`` the MoE
layer's combine sums over the expert group of this process's seq or model
coordinate, its routing over the seq group, its ``down`` partials over the
model group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_DATA = "data"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"

#: All mesh axes, outermost first (the reference's order).
MESH_AXES = (AXIS_DATA, AXIS_PIPE, AXIS_EXPERT, AXIS_SEQ, AXIS_MODEL)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Requested parallelism degrees. ``data=-1`` means "all remaining devices"."""

    data: int = -1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int, int]:
        fixed = self.pipe * self.expert * self.seq * self.model
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by "
                    f"pipe*expert*seq*model={fixed}"
                )
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh {data}x{self.pipe}x{self.expert}x{self.seq}x{self.model}"
                f" = {total} != device count {n_devices}"
            )
        return (data, self.pipe, self.expert, self.seq, self.model)


def create_mesh(spec: MeshSpec | None = None, *, device: str | torch.device = "cuda") -> DeviceMesh:
    """The canonical 5-axis mesh over the live process group.

    With no spec every process is on ``data`` (the original repo's DDP
    world). ``device`` is the mesh's device type (``cuda`` for NCCL,
    ``cpu`` for gloo). Raises without a live group.
    """
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a live process group (runtime.bootstrap.init "
                           "with a coordinator)")
    spec = spec or MeshSpec()
    shape = spec.resolve(dist.get_world_size())
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=MESH_AXES)


def data_group(mesh: DeviceMesh | None) -> dist.ProcessGroup | None:
    """The process group of the data axis (None: no mesh, one process)."""
    return None if mesh is None else mesh.get_group(AXIS_DATA)


def data_size(mesh: DeviceMesh | None) -> int:
    """The data-parallel degree (1: no mesh)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(AXIS_DATA))


def data_rank(mesh: DeviceMesh | None) -> int:
    """This process's coordinate on the data axis (0: no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(AXIS_DATA)


def seq_group(mesh: DeviceMesh | None) -> dist.ProcessGroup | None:
    """The process group of the seq axis (None: no mesh, one process)."""
    return None if mesh is None else mesh.get_group(AXIS_SEQ)


def seq_size(mesh: DeviceMesh | None) -> int:
    """The sequence-parallel degree (1: no mesh)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(AXIS_SEQ))


def seq_rank(mesh: DeviceMesh | None) -> int:
    """This process's coordinate on the seq axis (0: no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(AXIS_SEQ)


def model_group(mesh: DeviceMesh | None) -> dist.ProcessGroup | None:
    """The process group of the model axis (None: no mesh, one process)."""
    return None if mesh is None else mesh.get_group(AXIS_MODEL)


def model_size(mesh: DeviceMesh | None) -> int:
    """The tensor-parallel degree (1: no mesh)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(AXIS_MODEL))


def model_rank(mesh: DeviceMesh | None) -> int:
    """This process's coordinate on the model axis (0: no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(AXIS_MODEL)


def pipe_group(mesh: DeviceMesh | None) -> dist.ProcessGroup | None:
    """The process group of the pipe axis (None: no mesh, one process)."""
    return None if mesh is None else mesh.get_group(AXIS_PIPE)


def pipe_size(mesh: DeviceMesh | None) -> int:
    """The pipeline-parallel degree (1: no mesh)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(AXIS_PIPE))


def pipe_rank(mesh: DeviceMesh | None) -> int:
    """This process's coordinate on the pipe axis, its stage (0: no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(AXIS_PIPE)


def replica_group(mesh: DeviceMesh | None) -> dist.ProcessGroup | None:
    """The processes that share this process's parameter replica: its data x
    seq plane of the mesh (the same expert, pipe and model coordinates). The
    data group itself when ``seq`` is 1. Built from the mesh's coordinates:
    one ``dist.new_group`` a plane, every process taking part in each (the
    call is collective), once a mesh: the group is kept on the mesh."""
    if mesh is None or seq_size(mesh) == 1:
        return data_group(mesh)
    if getattr(mesh, "_replica_group", None) is None:
        planes = mesh.mesh.permute(1, 2, 4, 0, 3).reshape(-1, data_size(mesh) * seq_size(mesh))
        for plane in planes.tolist():
            group = dist.new_group(plane)
            if dist.get_rank() in plane:
                mesh._replica_group = group
    return mesh._replica_group


def seq_shards(mesh: DeviceMesh | None):
    """This process's place on the seq axis for the train step
    (``parallel.seq_common.SeqShards``); None without a mesh or at seq
    size 1."""
    from deeplearning_mpi_tpu_torch.parallel.seq_common import SeqShards

    if seq_size(mesh) == 1:
        return None
    return SeqShards(seq_group(mesh), seq_size(mesh), seq_rank(mesh), replica_group(mesh),
                     data_size(mesh))


def seq_ring(mesh: DeviceMesh | None):
    """This process's seq group as the routing of an MoE model over a
    sharded sequence reads it (``parallel.seq_common.GroupRing``); None
    without a mesh or at seq size 1."""
    from deeplearning_mpi_tpu_torch.parallel.seq_common import GroupRing

    return None if seq_size(mesh) == 1 else GroupRing(seq_group(mesh))


def mesh_layout(mesh: DeviceMesh | None) -> dict[str, int]:
    """The degree of every axis (all 1 without a mesh)."""
    if mesh is None:
        return {axis: 1 for axis in MESH_AXES}
    return {axis: mesh.size(i) for i, axis in enumerate(MESH_AXES)}


def tp_shards(mesh: DeviceMesh | None, device: str | torch.device | None = None):
    """This process's place in its model group, the process-group form of
    tensor parallelism (``parallel.tensor_parallel.GroupTP``) on ``device``
    (default: the mesh's device type, this process's current card); None
    without a mesh or at model size 1."""
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import GroupTP

    if model_size(mesh) == 1:
        return None
    if device is None:
        device = mesh.device_type
        if device == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    return GroupTP(model_group(mesh), device)


def pipe_shards(mesh: DeviceMesh | None, device: str | torch.device | None = None):
    """This process's stage in its pipe group, the process-group form of
    pipeline parallelism (``parallel.pipeline.GroupPipe``) on ``device``
    (default: the mesh's device type, this process's current card); None
    without a mesh or at pipe size 1."""
    from deeplearning_mpi_tpu_torch.parallel.pipeline import GroupPipe

    if pipe_size(mesh) == 1:
        return None
    if device is None:
        device = mesh.device_type
        if device == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    return GroupPipe(pipe_group(mesh), device)


def expert_shards(mesh: DeviceMesh | None):
    """This process's share of the MoE experts along the expert axis
    (``parallel.expert_parallel.ExpertShards``); None without a mesh or at
    expert size 1."""
    from deeplearning_mpi_tpu_torch.parallel.expert_parallel import ExpertShards

    if mesh is None:
        return None
    size = mesh.size(MESH_AXES.index(AXIS_EXPERT))
    if size == 1:
        return None
    return ExpertShards(mesh.get_group(AXIS_EXPERT), size, mesh.get_local_rank(AXIS_EXPERT))


def local_batch_size(global_batch_size: int, mesh: DeviceMesh | None) -> int:
    """Rows of a global batch this process supplies: ``global / data``."""
    n_data = data_size(mesh)
    if global_batch_size % n_data != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by data-parallel "
            f"degree {n_data}"
        )
    return global_batch_size // n_data


def batch_rows(global_batch_size: int, mesh: DeviceMesh | None) -> tuple[int, int]:
    """This process's rows ``[start, stop)`` of every global batch."""
    local = local_batch_size(global_batch_size, mesh)
    r = data_rank(mesh)
    return r * local, (r + 1) * local
