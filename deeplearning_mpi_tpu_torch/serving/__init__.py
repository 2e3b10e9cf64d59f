"""Continuous-batching serving: paged KV pool, scheduler, prefix cache,
speculative decoding, engine."""

from deeplearning_mpi_tpu_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    KVBuffers,
    PagedForward,
    ServingEngine,
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
from deeplearning_mpi_tpu_torch.serving.scheduler import (  # noqa: F401
    Request,
    RequestState,
    Scheduler,
)
