"""Seeded DMT002: a wall clock read inside a function captured into a CUDA
graph runs once, at capture."""
import time

from deeplearning_mpi_tpu_torch.compiler.aot import CapturedProgram


def stamped(x):
    t = time.perf_counter()  # seeded: DMT002 — frozen at capture, every replay reuses it
    return x + t


def build(example):
    return CapturedProgram(stamped, (example,))
