"""Back-compat shim, as the reference's ``train/resilience.py``: the
supervisor's names live in :mod:`deeplearning_mpi_tpu_torch.resilience`
(``supervisor.py``); this module keeps the old import path."""

from deeplearning_mpi_tpu_torch.resilience.supervisor import (  # noqa: F401
    Heartbeat,
    TrainingFailure,
    preflight,
    run_with_auto_resume,
)

__all__ = ["Heartbeat", "TrainingFailure", "preflight", "run_with_auto_resume"]
