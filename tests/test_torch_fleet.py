"""The port's serving fleet end to end on the CPU: the reference drills'
failover, hot-swap and hedging plans (``tools/fleet_drill.py``) through
replica processes of the port at tiny widths, one torch thread a worker.

1. ``replica_kill@step:4,replica_hang@step:6`` with a rolling swap after 8
   completions (``FleetSupervisor`` directly): both faults detected (exit,
   then a frozen ``progress_seq``), the books balanced (2 = 2 + 0), the
   orphans re-dispatched with their ORIGINAL arrival and deadline (every
   ``req`` op of a rid in every inbox carries the journaled admission's
   stamps), the swap performed in place with no capture after warmup,
   exactly one winning stream a rid, and every stream equal to the port's
   offline greedy under its weight version.
2. ``serve_lm --replicas 2 --hedge_ms 60 --chaos replica_slow@step:2
   --disagg``: the slow replica's work hedged (``serve_hedge_total{outcome=
   fired}`` > 0), one stream a rid, the CLI's own parity check passing, each
   replica a disaggregated pair.

The autoscaler and control-plane drills are ``test_torch_fleet_scale.py``.
"""

from __future__ import annotations

import collections
import json
import re
from pathlib import Path

import pytest
import torch

from deeplearning_mpi_tpu_torch.cli.serve_lm import main as serve_lm_main
from deeplearning_mpi_tpu_torch.resilience.cluster import JOURNAL_FILE, replay_journal
from deeplearning_mpi_tpu_torch.serving import FleetSupervisor
from deeplearning_mpi_tpu_torch.telemetry.schema import is_canonical

torch.set_num_threads(1)

from torch_fleet_drills import (  # noqa: E402
    ENGINE_SPEC, MODEL_SPEC, SEED, SWAP_SEED, check_parity, trace)


@pytest.fixture(scope="module")
def kill_hang_swap(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    # A trickle that outlasts the faults' recovery, so requests arrive
    # after the rolling swap too: the swap waits for the killed replica's
    # respawn (the head of its queue), and on a loaded host a respawn
    # (mostly importing torch) with the hang's 3 s deadline ran past a 6 s
    # trickle, so every stream finished under version 0. 16 s leaves a
    # respawn ~6 s.
    entries = trace(12, 16, dt=1.0)
    sup = FleetSupervisor(MODEL_SPEC, ENGINE_SPEC, 2, root / "fleet", seed=SEED,
                          chaos="replica_kill@step:4,replica_hang@step:6",
                          heartbeat_interval_s=0.2, heartbeat_deadline_s=3.0,
                          spawn_grace_s=300.0, max_replica_restarts=4, timeout_s=240.0,
                          device="cpu", threads=1)
    result = sup.run(entries, swap_at=8, swap_seed=SWAP_SEED)
    return entries, result, root / "fleet"


def test_failover_books_and_swap(kill_hang_swap):
    entries, result, _ = kill_hang_swap
    assert result.ok and result.dropped == 0
    assert result.completed == len(entries) - sum(result.shed.values())
    assert result.failures == {"replica_kill": 1, "replica_hang": 1} and result.restarts == 2
    assert result.redispatched >= 1
    assert result.chaos_balanced is True and result.compile_flat
    snap = result.snapshot
    assert snap["fault_injected_total"] == 2 == snap["recovery_total"] + snap.get(
        "rollback_total", 0)
    assert snap["fleet_redispatch_total"] == result.redispatched
    swap = result.swap
    assert swap["performed"] and swap["compile_flat"] and swap["in_place"]
    assert {rec["version"] for rec in result.requests.values()} == {0, 1}
    # The replicas that stopped cleanly report their counts (a CPU run
    # launches no kernel; its warmup built the same programs).
    assert result.workers and all(w["K1"] == w["K4"] == 0 and w["captures"] > 0
                                  for w in result.workers.values())
    # Every instrument the supervisor keeps is a registered name.
    stat = re.compile(r"_(count|mean|p50|p95|max)$")
    assert not [k for k in snap if not (is_canonical(k) or is_canonical(stat.sub("", k)))]


def test_failover_keeps_the_original_arrival_and_deadline(kill_hang_swap):
    _, result, fleet_dir = kill_hang_swap
    admitted = {r["rid"]: r for r in replay_journal(fleet_dir / JOURNAL_FILE)
                if r["ev"] == "admit"}
    sent = collections.defaultdict(list)
    for inbox in fleet_dir.glob("replica*/inbox.jsonl"):
        for line in inbox.read_text().splitlines():
            m = json.loads(line)
            if m["op"] == "req":
                sent[m["rid"]].append(m)
    assert any(len(v) > 1 for v in sent.values()), "no request was sent twice"
    for rid, ops in sent.items():
        for m in ops:
            assert m["arrival"] == admitted[rid]["arrival_abs"], f"rid {rid}: fresh arrival"
            assert m["deadline"] == admitted[rid]["deadline_abs"], f"rid {rid}: fresh deadline"


def test_exactly_one_stream_a_rid_and_parity(kill_hang_swap):
    _, result, fleet_dir = kill_hang_swap
    done = collections.Counter(r["rid"] for r in replay_journal(fleet_dir / JOURNAL_FILE)
                               if r["ev"] == "done")
    assert done and set(done.values()) == {1} and len(done) == result.completed
    assert check_parity(result, swap_seed=SWAP_SEED) == result.completed


def test_serve_lm_hedged_disaggregated_fleet(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DMT_CHAOS_STALL_S", "0.25")
    rc = serve_lm_main([
        "--selftest", "--device", "cpu", "--num_layers", "2", "--num_heads", "2",
        "--head_dim", "16", "--d_model", "64", "--d_ff", "128", "--max_slots", "3",
        "--block_size", "8", "--num_blocks", "32", "--max_blocks_per_seq", "6",
        "--prefill_chunk", "8", "--prompt_len_max", "20", "--num_requests", "16",
        "--rate", "3", "--max_new_tokens", "8", "--replicas", "2", "--hedge_ms", "60",
        "--chaos", "replica_slow@step:2", "--disagg", "--fleet_dir", str(tmp_path / "f")])
    out = capsys.readouterr()
    err = out.out + out.err
    assert rc == 0, err
    fired = re.search(r"hedges: .*?(\d+) fired", err)
    assert fired and int(fired.group(1)) >= 1, err
    assert "fleet OK: 16 requests bit-identical to offline greedy" in err
    assert "chaos: 1 fault(s) injected, 1 recovered" in err
    done = collections.Counter(r["rid"] for r in replay_journal(tmp_path / "f" / JOURNAL_FILE)
                               if r["ev"] == "done")
    assert len(done) == 16 and set(done.values()) == {1}
    spec = json.loads(next(Path(tmp_path / "f").glob("replica0-a0/spec.json")).read_text())
    assert spec["disagg"] is True and spec["device"] == "cpu"


def test_worker_reports_the_launches_of_serving_not_warmup(tmp_path, monkeypatch):
    """A worker's stop message counts the kernel launches since its ready
    ack: whatever its warmup launched is not reported as serving's."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd
    from deeplearning_mpi_tpu_torch.serving.engine import ServingEngine
    from deeplearning_mpi_tpu_torch.serving.fleet import worker_main

    warmup = ServingEngine.warmup

    def launching_warmup(self, *args, **kw):
        out = warmup(self, *args, **kw)
        fa.flash_attention_cuda.launches += 5
        fd.flash_decode_cuda.launches += 7
        return out

    monkeypatch.setattr(ServingEngine, "warmup", launching_warmup)
    monkeypatch.setattr(fa.flash_attention_cuda, "launches", 0)
    monkeypatch.setattr(fd.flash_decode_cuda, "launches", 0)
    rdir = tmp_path / "replica0-a0"
    rdir.mkdir()
    (rdir / "spec.json").write_text(json.dumps({
        "model": MODEL_SPEC, "engine": ENGINE_SPEC, "seed": SEED, "version": 0,
        "warmup": True, "device": "cpu", "threads": 1}))
    (rdir / "inbox.jsonl").write_text(json.dumps({"op": "stop"}) + "\n")
    assert worker_main(["--replica", "0", "--dir", str(rdir),
                        "--spec", str(rdir / "spec.json")]) == 0
    ops = [json.loads(line) for line in (rdir / "outbox.jsonl").read_text().splitlines()]
    assert ops[0]["op"] == "ready" and ops[-1]["op"] == "stopped"
    # The ready ack splits the start-up after the imports by stage.
    assert set(ops[0]["startup_s"]) == {"device", "model", "engine", "warmup"}
    assert all(t >= 0 for t in ops[0]["startup_s"].values())
    assert ops[-1]["launches"]["K1"] == ops[-1]["launches"]["K4"] == 0
    assert ops[-1]["launches"]["served"] == 0 and ops[-1]["launches"]["captures"] > 0
