"""Telemetry: the metrics registry and its sinks, trace annotations, spans,
and the derived accounting (analytic FLOPs -> MFU, device memory,
collective bytes). Port of the reference's ``telemetry/``, with its names,
record shapes and span file format, so the reference's readers
(``tools/metrics_report.py``, ``tools/trace_report.py``) render the port's
output unchanged.

By the question each answers:

- :mod:`.registry`: *what happened*: counters, gauges, histograms; a
  step's scalars buffered on the card without a sync; canonical JSONL
  records.
- :mod:`.trace`: *where time went*: named ranges on the profiler's and
  NVTX's timelines.
- :mod:`.spans`: *what happened to this request or step*: spans with a
  correlation key, one JSONL file a process with its clock offset, and the
  crash flight recorder.
- :mod:`.flops`: *how fast it could have been*: analytic FLOPs and MFU
  against the card's published peak.
- :mod:`.memory`: *how close to the memory wall*: the CUDA allocator's
  stats.
- :mod:`.comms`: *what crossed the wires*: collective bytes from shapes and
  axis sizes.
- :mod:`.schema`: the names all of these may emit.
"""

from deeplearning_mpi_tpu_torch.telemetry.registry import (
    InMemorySink,
    JsonlSink,
    LoggerSink,
    MetricsRegistry,
    TensorBoardSink,
    labeled,
)
from deeplearning_mpi_tpu_torch.telemetry.spans import Span, SpanRecorder
from deeplearning_mpi_tpu_torch.telemetry.trace import annotate, annotate_fn

__all__ = [
    "InMemorySink",
    "JsonlSink",
    "LoggerSink",
    "MetricsRegistry",
    "Span",
    "SpanRecorder",
    "TensorBoardSink",
    "annotate",
    "annotate_fn",
    "labeled",
]
