"""Live device-memory accounting from the CUDA caching allocator.

Port of the reference's ``telemetry/memory.py``: ``device_memory_stats``
maps ``torch.cuda.memory_stats`` onto the reference's names
(``allocated_bytes.all.current`` -> ``bytes_in_use``,
``allocated_bytes.all.peak`` -> ``peak_bytes_in_use``, which is what
``torch.cuda.max_memory_allocated`` reads) and takes ``bytes_limit`` from
``torch.cuda.mem_get_info`` (the card's total memory). On the CPU there is
no device allocator to meter: everything returns None and the records
simply lack the HBM columns; memory numbers are never invented.

The reference's process 0 sees every local chip and reports the most
loaded one. A process of the port sees its own card, so :func:`hbm_usage`
takes a ``group``: the ranks then exchange their three numbers (one small
all-gather) and every rank reports the rank whose ``bytes_in_use`` is the
largest.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch


def device_memory_stats(device: Any) -> dict[str, float] | None:
    """One CUDA device's allocator stats under the reference's names (plus
    the allocator's own keys), or None where there is no card."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    try:
        stats = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
    except (RuntimeError, AssertionError):
        return None
    if not stats:
        return None
    out = {k: float(v) for k, v in stats.items() if isinstance(v, (int, float))}
    out["bytes_in_use"] = float(stats.get("allocated_bytes.all.current", 0))
    out["peak_bytes_in_use"] = float(stats.get("allocated_bytes.all.peak", 0))
    out["bytes_limit"] = float(total)
    return out


def _summary(stats: dict[str, float]) -> dict[str, float]:
    out = {"hbm_bytes_in_use": stats.get("bytes_in_use", 0.0)}
    limit = stats.get("bytes_limit")
    if limit:
        out["hbm_bytes_limit"] = limit
        out["hbm_utilization"] = out["hbm_bytes_in_use"] / limit
    peak = stats.get("peak_bytes_in_use")
    if peak is not None:
        out["hbm_peak_bytes"] = peak
    return out


def hbm_usage(devices: Iterable[Any] | None = None, *,
              group: Any = None) -> dict[str, float] | None:
    """``{"hbm_bytes_in_use", "hbm_bytes_limit", "hbm_peak_bytes",
    "hbm_utilization"}`` of the most loaded device, or None when no device
    reports stats. ``devices`` defaults to this process's current CUDA
    device (none when CUDA was never initialised). With ``group`` (a
    process group of more than one rank), the most loaded device of the
    whole group: every rank must call it, and every rank gets the same
    answer."""
    if devices is None:
        devices = [torch.cuda.current_device()] if torch.cuda.is_initialized() else []
    per_device = [(torch.device("cuda", d) if isinstance(d, int) else torch.device(d), s)
                  for d in devices if (s := device_memory_stats(d))]
    if not per_device:
        return None
    device, worst = max(per_device, key=lambda ds: ds[1].get("bytes_in_use", 0.0))
    if group is not None:
        import torch.distributed as dist

        if dist.get_world_size(group) > 1:
            mine = torch.tensor([worst["bytes_in_use"], worst["bytes_limit"],
                                 worst["peak_bytes_in_use"]], dtype=torch.float64, device=device)
            rows = torch.empty(dist.get_world_size(group), 3, dtype=torch.float64, device=device)
            dist.all_gather_into_tensor(rows, mine, group=group)
            in_use, limit, peak = rows[int(rows[:, 0].argmax())].tolist()
            worst = {"bytes_in_use": in_use, "bytes_limit": limit, "peak_bytes_in_use": peak}
    return _summary(worst)
