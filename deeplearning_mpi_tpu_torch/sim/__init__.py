"""Million-user load harness: seeded trace generation, a fake-clock
fleet simulator over the *real* serving policy objects, and a
deterministic policy-parameter sweep. Port of ``deeplearning_mpi_tpu/sim``.

Entry points: :func:`~deeplearning_mpi_tpu_torch.sim.traces.generate_entries`
(multi-tenant workload traces in the ``serve_lm`` JSONL replay schema),
:class:`~deeplearning_mpi_tpu_torch.sim.simulator.FleetSimulator` (whole-day
traces in seconds, no engines spawned), and
:func:`~deeplearning_mpi_tpu_torch.sim.search.run_sweep` (SLO-per-chip scored
parameter search writing winners to the autotune DB). Drilled by
``python -m deeplearning_mpi_tpu_torch.cli.sim_drill``.
"""

from deeplearning_mpi_tpu_torch.sim.simulator import (
    FleetSimulator,
    ServiceModel,
    SimConfig,
    SimResult,
)
from deeplearning_mpi_tpu_torch.sim.search import (
    SweepResult,
    apply_params,
    default_grid,
    run_sweep,
)
from deeplearning_mpi_tpu_torch.sim.traces import (
    FlashCrowd,
    TenantSpec,
    TraceConfig,
    generate_entries,
    tenant_policies,
    to_fleet_entries,
    trace_digest,
    write_jsonl,
)

__all__ = [
    "FlashCrowd",
    "FleetSimulator",
    "ServiceModel",
    "SimConfig",
    "SimResult",
    "SweepResult",
    "TenantSpec",
    "TraceConfig",
    "apply_params",
    "default_grid",
    "generate_entries",
    "run_sweep",
    "tenant_policies",
    "to_fleet_entries",
    "trace_digest",
    "write_jsonl",
]
