"""Seeded DMT001: a captured program's static output read after the next
replay rewrote it."""
from deeplearning_mpi_tpu_torch.compiler.aot import CapturedProgram


def decode_twice(fn, inputs, a, b):
    program = CapturedProgram(fn, inputs)
    first = program(a)
    second = program(b)
    return first.sum() + second.sum()  # seeded: DMT001 — `first` is the static output, rewritten
