"""Control-plane crash drill: the fleet supervisor SIGKILLs itself mid-surge
and a restarted supervisor recovers the fleet from its journal.

    python -m deeplearning_mpi_tpu_torch.cli.controlplane_drill --device cpu --root /tmp/cp
    python -m deeplearning_mpi_tpu_torch.cli.controlplane_drill --root build/cp \\
        --num_layers 2 --d_model 768 --num_heads 12 --head_dim 64 --d_ff 2048   # the card

A restart loop around :class:`~deeplearning_mpi_tpu_torch.serving.fleet.FleetSupervisor`,
each incarnation a child process of this one:

1. Incarnation 1 serves a burst-then-trickle trace on a 2-replica fleet
   with an autoscaler and the plan ``load_spike@step:2,supervisor_kill@step:20``
   (the reference drill's): the spike drives a scale-up and, 20 completions
   in, the supervisor SIGKILLs itself. It must die by SIGKILL, leaving its
   workers decoding as orphans.
2. Incarnation 2 runs with ``resume=True`` on the same fleet directory: it
   replays the journal, re-adopts every live worker by the handshake
   (no respawn: warm graphs and KV pools kept, ``serve_compile_total``
   flat), re-dispatches nothing a live worker holds, re-injects the
   spike's un-admitted tail and drains the trace with zero drops.
3. Bars: every completed stream (those finished while the fleet ran
   headless included) equals offline greedy token for token; the books
   reconcile across incarnations (2 faults injected = 2 recovered, the
   scale books balanced); the result names the incarnation, the adopted
   and respawned counts and each worker's kernel launches.

Prints one JSON line (``controlplane_drill: {...}``) and exits 0 iff every
bar holds. ``--kill_orphan`` also SIGKILLs one orphan between the
incarnations, so the successor must respawn it and re-dispatch its work.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

#: the reference drill's plan: the spike early, the supervisor kill mid-surge
CHAOS = "load_spike@step:2,supervisor_kill@step:20"
#: requests a load_spike injects (``serving/fleet.py``)
SPIKE_N = 8
NUM_REPLICAS = 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="controlplane_drill", description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True, help="drill directory (emptied first)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=2)
    p.add_argument("--head_dim", type=int, default=16)
    p.add_argument("--d_model", type=int, default=64)
    p.add_argument("--d_ff", type=int, default=128)
    p.add_argument("--threads", type=int, default=1, help="torch threads per CPU worker")
    p.add_argument("--kill_orphan", action="store_true",
                   help="SIGKILL one orphaned worker between the incarnations")
    p.add_argument("--phase", choices=("drill", "serve"), default="drill",
                   help=argparse.SUPPRESS)
    p.add_argument("--resume", type=int, default=0, help=argparse.SUPPRESS)
    return p


def model_spec(args) -> dict:
    return {"vocab_size": args.vocab_size, "num_layers": args.num_layers,
            "num_heads": args.num_heads, "num_kv_heads": None, "head_dim": args.head_dim,
            "d_model": args.d_model, "d_ff": args.d_ff, "attention_window": 0}


#: the reference drill's engine: 3 slots interleave continuous batching
ENGINE_SPEC = {"max_slots": 3, "block_size": 8, "num_blocks": 32, "max_blocks_per_seq": 6,
               "prefill_chunk": 8, "max_queue": 64}


def trace(vocab: int) -> list[dict]:
    """The burst-then-trickle trace both incarnations build alike (the
    successor matches the journaled admissions against it)."""
    import numpy as np

    n_burst, n_trickle, trickle_dt, max_new = 24, 12, 0.3, 16
    rng = np.random.default_rng(7)
    entries = []
    for i in range(n_burst + n_trickle):
        n = int(rng.integers(3, 21))
        entries.append({
            "arrival": 0.0 if i < n_burst else (i - n_burst + 1) * trickle_dt,
            "prompt": [int(t) for t in rng.integers(1, vocab, size=n)],
            "max_new": max_new, "deadline": 0.0,
        })
    return entries


def serve(args) -> dict:
    """One supervisor incarnation in this process. Incarnation 1 never
    returns: ``supervisor_kill`` SIGKILLs it inside ``run()``."""
    import numpy as np
    import torch

    from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.serving import AutoscalerConfig, FleetSupervisor

    root = Path(args.root)
    autoscale = AutoscalerConfig(
        min_replicas=NUM_REPLICAS, max_replicas=NUM_REPLICAS + 1, up_load_per_replica=2.0,
        down_load_per_replica=0.25, hysteresis_s=0.2, cooldown_s=0.4,
    )
    entries = trace(args.vocab_size)
    sup = FleetSupervisor(
        model_spec(args), ENGINE_SPEC, NUM_REPLICAS, root / "fleet", seed=0, chaos=CHAOS,
        autoscale=autoscale, resume=bool(args.resume), adopt_grace_s=120.0,
        heartbeat_interval_s=0.2, heartbeat_deadline_s=5.0, spawn_grace_s=600.0,
        max_replica_restarts=4, timeout_s=600.0, device=args.device,
        threads=args.threads if args.device == "cpu" else None,
    )
    result = sup.run(entries)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(TransformerConfig(**model_spec(args)), dtype=torch.float32,
                          device=args.device).init_weights(0)
    mismatched = [rid for rid, rec in sorted(result.requests.items())
                  if rec["version"] != 0 or rec["tokens"] != offline_greedy(
                      model, np.asarray(rec["prompt"], np.int32), rec["max_new"], None)]
    shed = sum(result.shed.values())
    out = {
        "ok": result.ok, "incarnation": result.incarnation, "readopted": result.readopted,
        "respawned": result.respawned, "redispatched": result.redispatched,
        "completed": result.completed, "expected": len(entries) + SPIKE_N - shed,
        "shed": shed, "dropped": result.dropped, "compile_flat": result.compile_flat,
        "chaos_balanced": result.chaos_balanced, "parity_mismatched": mismatched,
        "parity_checked": len(result.requests), "scale": result.scale,
        "restarts": result.restarts, "workers": result.workers,
    }
    (root / "result.json").write_text(json.dumps(out))
    return out


def _journaled_pids(fleet_dir: Path) -> dict[int, int]:
    """The latest journaled worker pid of each slot."""
    from deeplearning_mpi_tpu_torch.resilience.cluster import JOURNAL_FILE, replay_journal

    pids: dict[int, int] = {}
    for rec in replay_journal(fleet_dir / JOURNAL_FILE):
        if rec["ev"] in ("spawn", "adopt"):
            pids[int(rec["idx"])] = int(rec["pid"])
        elif rec["ev"] == "retired":
            pids.pop(int(rec["idx"]), None)
    return pids


def _last_summary(fleet_dir: Path) -> dict:
    summaries = [r for r in map(json.loads, (fleet_dir / "fleet_metrics.jsonl").open())
                 if r.get("kind") == "fleet_summary"]
    if not summaries:
        raise AssertionError("no fleet_summary record")
    return summaries[-1]


def drill(args, argv: list[str]) -> dict:
    """The restart loop and its bars (``argv``: this drill's flags, handed
    to each incarnation); returns the report."""
    import shutil

    from deeplearning_mpi_tpu_torch.resilience.cluster import pid_alive

    root = Path(args.root)
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    here = [a for a in argv if a != "--kill_orphan"]
    cmd = [sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.controlplane_drill",
           *here, "--phase", "serve"]
    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH", "")) if p)
    t0 = time.monotonic()
    p1 = subprocess.run(cmd + ["--resume", "0"], env=env, timeout=900)
    t_crash = time.monotonic() - t0
    if p1.returncode != -signal.SIGKILL:
        raise AssertionError(f"incarnation 1 exited {p1.returncode}, expected -SIGKILL "
                             "from its own supervisor_kill")
    fleet_dir = root / "fleet"
    live = {idx: pid for idx, pid in sorted(_journaled_pids(fleet_dir).items())
            if pid_alive(pid)}
    if not live:
        raise AssertionError("no live orphan after the supervisor's death")
    killed = None
    if args.kill_orphan:
        killed = next(iter(live.items()))
        try:
            os.killpg(killed[1], signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            os.kill(killed[1], signal.SIGKILL)
        deadline = time.monotonic() + 10.0
        while pid_alive(killed[1]) and time.monotonic() < deadline:
            time.sleep(0.05)
    t1 = time.monotonic()
    p2 = subprocess.run(cmd + ["--resume", "1"], env=env, timeout=900)
    if p2.returncode != 0:
        raise AssertionError(f"incarnation 2 exited {p2.returncode}")
    res = json.loads((root / "result.json").read_text())
    res.update(orphans=len(live), orphan_killed=killed, incarnation1_s=t_crash,
               incarnation2_s=time.monotonic() - t1)
    v = _last_summary(fleet_dir)
    bars = {
        "result ok": res["ok"],
        "incarnation >= 2": res["incarnation"] >= 2,
        "every live orphan re-adopted": res["readopted"] == len(live) - (killed is not None),
        "respawns as planned": res["respawned"] == (1 if killed else 0),
        "zero drops": res["dropped"] == 0,
        "compile flat": res["compile_flat"] is True,
        "chaos books balanced": res["chaos_balanced"] is True,
        "every request completed": res["completed"] == res["expected"],
        "parity": not res["parity_mismatched"] and res["parity_checked"] == res["completed"],
        "summary books: 2 injected = recovered + rolled back": (
            v["fault_injected_total"] == 2.0
            and v["fault_injected_total"] == v["recovery_total"] + v.get("rollback_total", 0.0)),
        "summary scale books balanced": v.get("scale_balanced") is True,
        "summary incarnation": v["supervisor_incarnation"] >= 2.0,
        "summary readopted": v["supervisor_readopted"] == res["readopted"],
    }
    res["bars"] = {k: bool(b) for k, b in bars.items()}
    res["ok_all"] = all(bars.values())
    return res


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.phase == "serve":
        serve(args)
        return 0
    res = drill(args, argv)
    print("controlplane_drill: " + json.dumps(res, sort_keys=True), flush=True)
    failed = [k for k, ok in res["bars"].items() if not ok]
    if failed:
        print(f"controlplane_drill FAILED: {failed}", file=sys.stderr)
        return 1
    print(f"controlplane_drill OK: incarnation {res['incarnation']} re-adopted "
          f"{res['readopted']} of {res['orphans']} orphan(s), respawned {res['respawned']}, "
          f"{res['completed']} streams equal to offline greedy", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
