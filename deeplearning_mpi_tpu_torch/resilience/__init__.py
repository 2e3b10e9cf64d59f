"""The resilience layer: deterministic fault injection and verified recovery.

The port of ``deeplearning_mpi_tpu/resilience/``, in two halves that test
each other:

- the **chaos harness** (:mod:`.faults`): a deterministic
  :class:`FaultPlan` whose :class:`ChaosInjector` fires each fault once at
  its planned trigger through hooks in the trainer's step, the loader, the
  checkpointer and the pod supervisor;
- the **hardening** that must survive every planned fault: checkpoint
  manifests and rollback to the verified step (:mod:`.integrity`,
  ``train/checkpoint.py``), graceful SIGTERM (:mod:`.preemption`), the
  loader watchdog (:mod:`.watchdog`), the supervised restart loop and the
  heartbeat (:mod:`.supervisor`), the numerics guardrails
  (:mod:`.guardrails`) and the elastic pod (:mod:`.cluster`,
  :mod:`.pod`).

Every fault and recovery goes through the telemetry registry; a balanced
run has ``fault_injected_total == recovery_total + rollback_total``.
"""

from deeplearning_mpi_tpu_torch.resilience.faults import (  # noqa: F401
    AUTOSCALE_KINDS,
    CONTROLPLANE_KINDS,
    DISAGG_KINDS,
    FLEET_KINDS,
    GUARD_KINDS,
    SERVE_KINDS,
    TRAIN_KINDS,
    ChaosInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    InjectedKill,
    fleet_entries,
    validate_plan_kinds,
)
from deeplearning_mpi_tpu_torch.resilience.guardrails import (  # noqa: F401
    DigestVote,
    GuardrailConfig,
    GuardrailPolicy,
    QuarantineLedger,
    RollbackRequested,
    Verdict,
    param_digest,
)
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
from deeplearning_mpi_tpu_torch.resilience.pod import (  # noqa: F401
    LivenessTracker,
    PodFailure,
    PodResult,
    PodSupervisor,
)
from deeplearning_mpi_tpu_torch.resilience.preemption import (  # noqa: F401
    GracefulShutdown,
    Preempted,
)
from deeplearning_mpi_tpu_torch.resilience.supervisor import (  # noqa: F401
    Heartbeat,
    TrainingFailure,
    preflight,
    restart_delay,
    run_with_auto_resume,
)
from deeplearning_mpi_tpu_torch.resilience.watchdog import ResilientLoader  # noqa: F401

__all__ = [
    "AUTOSCALE_KINDS",
    "CONTROLPLANE_KINDS",
    "ChaosInjector",
    "CheckpointCorruption",
    "DISAGG_KINDS",
    "DigestVote",
    "FLEET_KINDS",
    "FaultPlan",
    "FaultSpec",
    "GUARD_KINDS",
    "GracefulShutdown",
    "GuardrailConfig",
    "GuardrailPolicy",
    "Heartbeat",
    "InjectedFault",
    "InjectedKill",
    "LivenessTracker",
    "PodFailure",
    "PodResult",
    "PodSupervisor",
    "Preempted",
    "QuarantineLedger",
    "ResilientLoader",
    "RollbackRequested",
    "SERVE_KINDS",
    "TRAIN_KINDS",
    "TrainingFailure",
    "Verdict",
    "atomic_write_json",
    "corrupt_checkpoint",
    "dir_digests",
    "fleet_entries",
    "manifest_path",
    "param_digest",
    "preflight",
    "read_manifest",
    "restart_delay",
    "run_with_auto_resume",
    "tree_digests",
    "validate_plan_kinds",
    "write_manifest",
]
