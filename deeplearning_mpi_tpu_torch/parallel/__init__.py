"""Parallel schedules beyond data parallelism: expert parallelism
(``parallel.expert_parallel``) and sequence parallelism (ring attention with
the plain or the kernel inner, Ulysses all-to-all; ``parallel.seq_common``)."""

from deeplearning_mpi_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attention_fn,
    ring_attention,
)
from deeplearning_mpi_tpu_torch.parallel.ring_flash import ring_flash_attention  # noqa: F401
from deeplearning_mpi_tpu_torch.parallel.ulysses import (  # noqa: F401
    make_ulysses_attention_fn,
    ulysses_attention,
)
