"""Clean fixture: near-miss patterns in PyTorch idiom every rule must NOT flag."""
import json
import time

import torch

from deeplearning_mpi_tpu_torch.compiler.aot import CapturedProgram


def decode_twice(fn, inputs, a, b):
    program = CapturedProgram(fn, inputs)
    first = program(a).clone()  # cloned before the next replay
    first = first + 0  # rebound: no longer the static output
    second = program(b)
    return first.sum() + second.sum()


def scaled(x, scale):
    return x * scale  # host values arrive as inputs, not frozen inside


def build(example, scale):
    t0 = time.perf_counter()  # outside the captured function
    program = CapturedProgram(scaled, (example, scale))
    return program, time.perf_counter() - t0


def cold_path(logits):
    return logits.max().item()  # not a hot scope: no marker, no hot path


def write_report(path, payload):
    path.write_text(json.dumps(payload))  # not IO-critical: no scope marker


def record(registry, loss: torch.Tensor):
    registry.counter("serve_decode_steps")  # canonical schema name
    registry.gauge("train_compile_seconds").set(loss)


def stop(workers):
    alive = [w for w in workers if w.poll() is None]
    for w in workers:
        w.kill()  # liveness was snapshotted BEFORE the kill
    return alive
