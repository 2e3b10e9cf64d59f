"""Parallel schedules beyond data parallelism: expert parallelism
(``parallel.expert_parallel``), sequence parallelism (ring attention with
the plain or the kernel inner, Ulysses all-to-all; ``parallel.seq_common``),
tensor parallelism and ZeRO-1 (``parallel.tensor_parallel``,
``parallel.zero``) and the GPipe schedule (``parallel.pipeline``)."""

from deeplearning_mpi_tpu_torch.parallel.pipeline import (  # noqa: F401
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
)
from deeplearning_mpi_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attention_fn,
    ring_attention,
)
from deeplearning_mpi_tpu_torch.parallel.ring_flash import ring_flash_attention  # noqa: F401
from deeplearning_mpi_tpu_torch.parallel.ulysses import (  # noqa: F401
    make_ulysses_attention_fn,
    ulysses_attention,
)
