"""The port's autoscaled fleet and its control plane end to end on the
CPU, at tiny widths, one torch thread a worker.

1. The reference's surge drill (``tools/autoscale_drill.py``): one replica,
   ``load_spike@step:2,scale_during_failure@step:1``, ``min_replicas`` 1,
   ``max_replicas`` 3: a scale-up (a replica warmed and ready-acked before
   the router includes it), a SIGKILL of a live replica during it, zero
   drops, the chaos and scale books balanced, every stream equal to the
   port's offline greedy.
2. The control-plane drill (``cli.controlplane_drill``): the supervisor
   SIGKILLs itself mid-surge (``load_spike@step:2,supervisor_kill@step:20``)
   and a restarted incarnation re-adopts every live worker with no respawn,
   replays the journal into books that balance across incarnations, and
   drains with parity.
3. ``serve_lm --autoscale`` refuses a supervisor kind, the fleet refuses
   ``--kv_dtype`` and ``--spec_k``, ``--tp`` alone is refused as in the
   reference, and ``--tp`` with replicas reaches the fleet with its degree.
"""

from __future__ import annotations

import json

import pytest
import torch

from deeplearning_mpi_tpu_torch.cli import controlplane_drill
from deeplearning_mpi_tpu_torch.cli import serve_lm
from deeplearning_mpi_tpu_torch.cli.serve_lm import main as serve_lm_main
from deeplearning_mpi_tpu_torch.serving import AutoscalerConfig, FleetSupervisor
from torch_fleet_drills import ENGINE_SPEC, MODEL_SPEC, SEED, check_parity, trace  # noqa: E402

torch.set_num_threads(1)


def test_autoscale_surge_with_a_kill_mid_scale_up(tmp_path):
    autoscale = AutoscalerConfig(min_replicas=1, max_replicas=3, up_load_per_replica=3.0,
                                 down_load_per_replica=0.25, hysteresis_s=0.2, cooldown_s=0.8)
    entries = trace(32, 20, dt=0.25, max_new=12)
    sup = FleetSupervisor(MODEL_SPEC, ENGINE_SPEC, 1, tmp_path / "fleet", seed=SEED,
                          chaos="load_spike@step:2,scale_during_failure@step:1",
                          autoscale=autoscale, heartbeat_interval_s=0.2,
                          heartbeat_deadline_s=3.0, spawn_grace_s=300.0,
                          max_replica_restarts=4, timeout_s=240.0, device="cpu", threads=1)
    result = sup.run(entries)
    s = result.scale
    assert s["spawned"] >= 1, s
    assert s["events"] == s["spawned"] + s["retired"] + s["vetoed"]
    assert result.dropped == 0 and result.ok
    assert result.restarts >= 1 and "scale_during_failure" in result.failures
    assert result.chaos_balanced is True
    shed = sum(result.shed.values())
    assert result.completed == len(entries) + 8 - shed  # the spike's 8 included
    assert check_parity(result) == result.completed
    summary = [json.loads(line) for line in (tmp_path / "fleet" / "fleet_metrics.jsonl")
               .read_text().splitlines()]
    v = [r for r in summary if r.get("kind") == "fleet_summary"][-1]
    assert v["scale_balanced"] is True and v["chaos_balanced"] is True


def test_control_plane_readopts_and_replays(tmp_path, capsys):
    rc = controlplane_drill.main(["--device", "cpu", "--root", str(tmp_path / "cp")])
    out = capsys.readouterr()
    assert rc == 0, out.err
    res = json.loads(out.out.split("controlplane_drill: ", 1)[1].splitlines()[0])
    assert res["ok_all"] and all(res["bars"].values()), res["bars"]
    assert res["incarnation"] == 2 and res["readopted"] == res["orphans"] >= 2
    assert res["respawned"] == 0 and res["dropped"] == 0
    assert res["completed"] == res["parity_checked"] == res["expected"]


@pytest.mark.parametrize("flags,message", [
    (["--autoscale", "--chaos", "supervisor_kill@step:3"], "supervisor_kill"),
    (["--replicas", "2", "--tp", "2"], None),
    (["--replicas", "2", "--kv_dtype", "int8"], "bit-exact"),
    (["--replicas", "2", "--spec_k", "2", "--draft_layers", "1"], "--spec_k"),
    (["--tp", "2"], "requires --replicas > 1"),
    (["--tenants", "prod=lots"], "bad --tenants entry"),
], ids=["supervisor_kind", "tp", "kv_dtype", "spec_k", "tp_alone", "tenants"])
def test_serve_lm_refusals(flags, message, capsys, monkeypatch):
    if message is None:
        # Lifted: the call passes every refusal and reaches the fleet with
        # its degree (test_torch_fleet_tp.py runs such a fleet).
        ran = []
        monkeypatch.setattr(serve_lm, "_run_fleet", lambda args, eos_id: ran.append(args.tp) or 0)
        assert serve_lm_main(["--selftest", "--device", "cpu", *flags]) == 0 and ran == [2]
        return
    assert serve_lm_main(["--selftest", "--device", "cpu", *flags]) == 1
    assert message in capsys.readouterr().err
