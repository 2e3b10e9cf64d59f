"""Distributed smoke test: rendezvous and transport before any training.

Port of ``deeplearning_mpi_tpu/runtime/hello_world.py``, the three checks
over the process group (NCCL on the card, gloo on the CPU):

1. **Broadcast fan-out**: rank 0's payload reaches every rank
   (:func:`broadcast_from`), counted by an all-reduce.
2. **Ring transport**: after ONE :func:`ring_shift` rank ``i`` must hold
   rank ``i-1``'s value — the load-bearing check, which an identity "shift"
   fails (a full round trip alone is satisfied by identity) — then the
   full round trip returns each rank its own value.
3. **All-reduce**: the sum of the ranks is ``n(n-1)/2``.

Every check ends in an all-reduced count, so every rank reports the same
result.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from deeplearning_mpi_tpu_torch.runtime import collectives


@dataclasses.dataclass(frozen=True)
class HelloWorldResult:
    n_devices: int
    broadcast_ok: bool
    ring_ok: bool
    psum_ok: bool

    @property
    def ok(self) -> bool:
        return self.broadcast_ok and self.ring_ok and self.psum_ok


def run_hello_world(group: dist.ProcessGroup | None = None, payload: float = 42.0, *,
                    device: str | torch.device | None = None) -> HelloWorldResult:
    """Run the three checks over ``group`` (default: the world). The
    tensors live on ``device``: by default the card for NCCL, else the CPU."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(group) == "nccl" else torch.device("cpu")
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    x = torch.tensor(float(idx), device=device)

    mine = torch.tensor(payload if idx == 0 else 0.0, device=device)
    received = collectives.broadcast_from(mine, src=0, group=group)
    n_received = collectives.all_reduce_sum((received == payload).float(), group)

    v = collectives.ring_shift(x, group)
    one_shift_ok = bool(v == (idx - 1) % n)
    for _ in range(n - 1):
        v = collectives.ring_shift(v, group)
    ring_here = torch.tensor(float(one_shift_ok and bool(v == x)), device=device)
    n_round_tripped = collectives.all_reduce_sum(ring_here, group)

    total = collectives.all_reduce_sum(x, group)
    return HelloWorldResult(
        n_devices=n,
        broadcast_ok=int(n_received) == n,
        ring_ok=int(n_round_tripped) == n,
        psum_ok=int(total) == n * (n - 1) // 2,
    )
