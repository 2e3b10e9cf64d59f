"""Continuous-batching serving: paged KV pool, scheduler, prefix cache,
speculative decoding, the engine, its disaggregated prefill / decode form,
and the supervised replica fleet (router, autoscaler, supervisor)."""

from deeplearning_mpi_tpu_torch.serving.autoscaler import (  # noqa: F401
    AutoscalerConfig,
    AutoscalerPolicy,
    LoadForecaster,
    LoadSignal,
    ReplicaView,
    build_load_signal,
)
from deeplearning_mpi_tpu_torch.serving.disagg import (  # noqa: F401
    DecodeEngine,
    DisaggregatedEngine,
    PrefillEngine,
)
from deeplearning_mpi_tpu_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    KVBuffers,
    PagedForward,
    ServingEngine,
)
from deeplearning_mpi_tpu_torch.serving.fleet import (  # noqa: F401
    FleetFailure,
    FleetResult,
    FleetSupervisor,
)
from deeplearning_mpi_tpu_torch.serving.kv_pool import (  # noqa: F401
    SCRATCH_BLOCK,
    PagedKVPool,
    init_kv_buffers,
)
from deeplearning_mpi_tpu_torch.serving.prefix_cache import (  # noqa: F401
    RadixPrefixCache,
    prefix_signature,
)
from deeplearning_mpi_tpu_torch.serving.router import Router  # noqa: F401
from deeplearning_mpi_tpu_torch.serving.scheduler import (  # noqa: F401
    Request,
    RequestState,
    Scheduler,
)
from deeplearning_mpi_tpu_torch.serving.speculative import SpeculativeDecoder  # noqa: F401

__all__ = [
    "AutoscalerConfig",
    "AutoscalerPolicy",
    "DecodeEngine",
    "DisaggregatedEngine",
    "EngineConfig",
    "FleetFailure",
    "FleetResult",
    "FleetSupervisor",
    "KVBuffers",
    "LoadForecaster",
    "LoadSignal",
    "PagedForward",
    "PagedKVPool",
    "PrefillEngine",
    "RadixPrefixCache",
    "ReplicaView",
    "Request",
    "RequestState",
    "Router",
    "SCRATCH_BLOCK",
    "Scheduler",
    "ServingEngine",
    "SpeculativeDecoder",
    "build_load_signal",
    "init_kv_buffers",
    "prefix_signature",
]
