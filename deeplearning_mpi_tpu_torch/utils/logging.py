"""Run logging: a timestamped log file and stdout, on process 0 only.

Port of the reference's ``utils/logging.py``: one
``<log_dir>/training_log_%Y%m%d_%H%M%S.log`` a run, the hyperparameters
and the system at start, the epoch lines after; beside it the
``.metrics.jsonl`` sidecar of canonical metrics records (fed by the
trainer's registry through ``telemetry.registry.LoggerSink``). Every other
rank logs nothing.
"""

from __future__ import annotations

import datetime
import json
import shutil
import subprocess
from pathlib import Path
from typing import Any, Mapping


def card_name_and_power() -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card), or None without ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


class RunLogger:
    """Print and append-to-file logger, active only on process 0. Without
    ``log_dir`` it only prints. The file's lines carry a timestamp; stdout
    gets the bare message (the CLIs' lines, ``Epoch N: loss ...``, are
    read as they are)."""

    def __init__(self, log_dir: str | Path | None = None, *, echo: bool = True,
                 run_name: str | None = None) -> None:
        from deeplearning_mpi_tpu_torch.runtime.bootstrap import is_coordinator

        self.echo = echo
        self.enabled = is_coordinator()
        self.path: Path | None = None
        if self.enabled and log_dir is not None:
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            name = run_name or f"training_log_{stamp}"
            log_dir = Path(log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            self.path = log_dir / f"{name}.log"
            self.path.touch()

    def log(self, message: str) -> None:
        if not self.enabled:
            return
        if self.echo:
            print(message, flush=True)
        if self.path is not None:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            with self.path.open("a") as f:
                f.write(f"[{stamp}] {message}\n")

    def log_metrics(self, record: Mapping[str, Any]) -> None:
        """Append one metrics record to ``<run>.metrics.jsonl``: one JSON
        object a line. Registry records carry their numeric ``ts``; a bare
        record is stamped here."""
        if not self.enabled or self.path is None:
            return
        line = dict(record)
        if "ts" not in line:
            line["ts"] = datetime.datetime.now().isoformat(timespec="seconds")
        with self.path.with_suffix(".metrics.jsonl").open("a") as f:
            f.write(json.dumps(line, default=float) + "\n")

    def log_hyperparameters(self, params: Mapping[str, Any]) -> None:
        self.log("hyperparameters: " + json.dumps(dict(params), default=str))

    def log_system_information(self, device: Any = "cpu") -> None:
        """The host, torch and CUDA versions, the topology, and the card's
        name and power limit (``nvidia-smi``) on a CUDA run."""
        import torch

        from deeplearning_mpi_tpu_torch.runtime.bootstrap import get_system_information

        info = get_system_information(device)
        if torch.device(device).type == "cuda":
            info["card"] = card_name_and_power()
        self.log("system: " + json.dumps(info))
