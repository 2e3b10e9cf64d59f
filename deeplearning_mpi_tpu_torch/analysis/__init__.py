"""Static analysis and the runtime sanitizer for the port's contracts.

Port of ``deeplearning_mpi_tpu/analysis``: :mod:`~.passes` holds the
AST rules (``python -m deeplearning_mpi_tpu_torch.analysis.lint``, its own
suppression file ``lint_suppressions.txt`` beside it), and
:mod:`~.sanitizer` the opt-in runtime sanitizer (``DMT_SANITIZE=1``): KV
block poisoning, the retrace tripwire after warmup, and the donation
canary around a checkpoint save.
"""

from deeplearning_mpi_tpu_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    load_suppressions,
    run_lint,
)
from deeplearning_mpi_tpu_torch.analysis.sanitizer import SanitizerError, enabled

__all__ = [
    "Finding",
    "Rule",
    "SanitizerError",
    "SourceFile",
    "enabled",
    "load_suppressions",
    "run_lint",
]
