"""Checkpoint integrity (digests, manifests, atomic writes) and graceful
preemption — the parts of the reference's ``resilience`` package the
checkpointed trainer needs."""

from deeplearning_mpi_tpu_torch.resilience.integrity import (  # noqa: F401
    CheckpointCorruption,
    atomic_write_json,
    corrupt_checkpoint,
    dir_digests,
    manifest_path,
    read_manifest,
    tree_digests,
    write_manifest,
)
from deeplearning_mpi_tpu_torch.resilience.preemption import (  # noqa: F401
    GracefulShutdown,
    Preempted,
)
