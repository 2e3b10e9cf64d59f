"""The port's tensor-parallel serving fleet end to end on the CPU.

1. ``FleetSupervisor(..., tp=2, device="cpu")`` with ``replica_kill@step:4``
   and a rolling swap after 6 completions, one torch thread a worker: each
   replica is two ``LockstepTP`` ranks in its process; the kill detected and
   its orphans re-dispatched, the books balanced, the swap in place (every
   rank's shards refilled in their storages), exactly one stream a rid, and
   every stream equal to the UNSHARDED model's offline greedy under its
   weight version (``torch_fleet_drills.check_parity``, the reference's
   oracle). Each worker's ready ack and each clean worker's stop message
   report its K1 / K4 launches summed and by rank (0 on the CPU), and the
   ready ack names its ranks' devices.
2. ``serve_lm --selftest --device cpu --replicas 2 --tp 2`` exits 0 with
   the CLI's own bit-exact parity check.
3. An autoscaled fleet at tp 2: the load spike's scale-up spawns a replica
   of tp ranks, as the first one is.
"""

from __future__ import annotations

import collections
import json

import pytest
import torch

from deeplearning_mpi_tpu_torch.cli.serve_lm import main as serve_lm_main
from deeplearning_mpi_tpu_torch.resilience.cluster import JOURNAL_FILE, replay_journal
from deeplearning_mpi_tpu_torch.serving import AutoscalerConfig, FleetSupervisor
from deeplearning_mpi_tpu_torch.serving.fleet import replica_devices

torch.set_num_threads(1)

from torch_fleet_drills import (  # noqa: E402
    ENGINE_SPEC, MODEL_SPEC, SEED, SWAP_SEED, check_parity, trace)

TP = 2


@pytest.fixture(scope="module")
def tp_fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_tp") / "fleet"
    # The trickle outlasts the killed replica's respawn on a loaded host
    # (test_torch_fleet.py's drill), so streams finish under both versions.
    entries = trace(8, 12, dt=1.0)
    sup = FleetSupervisor(MODEL_SPEC, ENGINE_SPEC, 2, root, seed=SEED, tp=TP,
                          chaos="replica_kill@step:4", heartbeat_interval_s=0.2,
                          heartbeat_deadline_s=3.0, spawn_grace_s=300.0,
                          max_replica_restarts=4, timeout_s=240.0, device="cpu", threads=1)
    return entries, sup.run(entries, swap_at=6, swap_seed=SWAP_SEED), root


def test_tp_fleet_books_swap_and_parity(tp_fleet):
    entries, result, root = tp_fleet
    assert result.ok and result.dropped == 0
    assert result.completed == len(entries) - sum(result.shed.values())
    assert result.failures == {"replica_kill": 1} and result.restarts == 1
    assert result.redispatched >= 1 and result.chaos_balanced is True
    swap = result.swap
    assert swap["performed"] and swap["compile_flat"] and swap["in_place"]
    assert {rec["version"] for rec in result.requests.values()} == {0, 1}
    done = collections.Counter(r["rid"] for r in replay_journal(root / JOURNAL_FILE)
                               if r["ev"] == "done")
    assert done and set(done.values()) == {1} and len(done) == result.completed
    assert check_parity(result, swap_seed=SWAP_SEED) == result.completed


def test_tp_fleet_workers_report_their_ranks(tp_fleet):
    _, result, root = tp_fleet
    assert result.workers
    for w in result.workers.values():
        assert w["K1"] == w["K4"] == 0 and w["captures"] > 0
        assert w["K1_by_rank"] == w["K4_by_rank"] == [0] * TP
    for spec in root.glob("replica*/spec.json"):
        assert json.loads(spec.read_text())["tp"] == TP
    ready = [r for r in replay_journal(root / JOURNAL_FILE) if r["ev"] == "ready"]
    assert ready and all(r["devices"] == ["cpu"] * TP for r in ready)
    assert all(r["launches"] == {"K1": 0, "K4": 0, "K1_by_rank": [0] * TP,
                                 "K4_by_rank": [0] * TP} for r in ready)
    # On the card: replica r's rank j on cuda:((r * tp + j) mod device_count).
    assert replica_devices(1, 2, 4) == ["cuda:2", "cuda:3"]
    assert replica_devices(1, 2, 1) == ["cuda:0", "cuda:0"]
    assert replica_devices(3, 2, 4) == ["cuda:2", "cuda:3"]


def test_serve_lm_tp_fleet_selftest(tmp_path, capsys):
    rc = serve_lm_main([
        "--selftest", "--device", "cpu", "--replicas", "2", "--tp", "2", "--num_layers", "2",
        "--num_heads", "2", "--head_dim", "16", "--d_model", "64", "--d_ff", "128",
        "--num_requests", "8", "--rate", "8", "--max_new_tokens", "6",
        "--fleet_dir", str(tmp_path / "f")])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "fleet OK: 8 requests bit-identical to offline greedy" in err


def test_tp_autoscaled_fleet_spawns_tp_replicas(tmp_path):
    autoscale = AutoscalerConfig(min_replicas=1, max_replicas=2, up_load_per_replica=3.0,
                                 down_load_per_replica=0.25, hysteresis_s=0.2, cooldown_s=0.8)
    entries = trace(16, 8, dt=0.25)
    root = tmp_path / "fleet"
    sup = FleetSupervisor(MODEL_SPEC, ENGINE_SPEC, 1, root, seed=SEED, tp=TP,
                          chaos="load_spike@step:2", autoscale=autoscale,
                          heartbeat_interval_s=0.2, heartbeat_deadline_s=3.0,
                          spawn_grace_s=300.0, max_replica_restarts=4, timeout_s=240.0,
                          device="cpu", threads=1)
    result = sup.run(entries)
    assert result.ok and result.dropped == 0 and result.scale["spawned"] >= 1, result.scale
    assert result.completed == len(entries) + 8 - sum(result.shed.values())  # the spike's 8
    assert check_parity(result) == result.completed
    specs = {p.parent.name: json.loads(p.read_text()) for p in root.glob("replica*/spec.json")}
    assert len({name.split("-")[0] for name in specs}) >= 2, sorted(specs)
    assert all(spec["tp"] == TP for spec in specs.values())
    ready = [r for r in replay_journal(root / JOURNAL_FILE) if r["ev"] == "ready"]
    assert ready and all(r["devices"] == ["cpu"] * TP for r in ready)
