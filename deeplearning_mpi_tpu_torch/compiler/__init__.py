"""The compiler layer: warmup by CUDA-graph capture, the tuning DB, the
kernel build cache.

Port of ``deeplearning_mpi_tpu/compiler/``, the owner of every
compile-time policy:

- :mod:`~deeplearning_mpi_tpu_torch.compiler.aot`: capture programs before
  traffic (``ServingEngine.warmup`` and ``Trainer.warmup`` route here);
- :mod:`~deeplearning_mpi_tpu_torch.compiler.autotune`: the exact-key
  tuning DB and the step-schedule and speculative-depth tuners;
- :mod:`~deeplearning_mpi_tpu_torch.compiler.cache`: the kernel build
  cache of ``build/torch_kernels/`` (content keys, digest manifest,
  quarantine, LRU eviction, hit / miss counters).

The reference's names with a counterpart are exported here; what has none
(``compile_program``'s cost analysis, ``abstractify``, ``WarmupRegistry``,
the persistent-cache ``enable``, ``donation_safe``, the kernel-shape
tuners) is written down in each module.
"""

from deeplearning_mpi_tpu_torch.compiler.aot import (
    CapturedProgram,
    CapturedStep,
    WarmProgram,
)
from deeplearning_mpi_tpu_torch.compiler.autotune import (
    TuningDB,
    default_db,
    set_default_db,
    tune_spec_k,
    tune_step_schedule,
)
from deeplearning_mpi_tpu_torch.compiler.cache import CompileCache, kernel_cache

__all__ = [
    "CapturedProgram",
    "CapturedStep",
    "CompileCache",
    "TuningDB",
    "WarmProgram",
    "default_db",
    "kernel_cache",
    "set_default_db",
    "tune_spec_k",
    "tune_step_schedule",
]
