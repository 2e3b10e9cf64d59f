"""The port's control-plane pieces against the reference's: the fleet
journal's replay fold, the orphan probe and ``pid_alive``.

The same journal records go through the reference's
``FleetSupervisor._replay_fleet_state`` and the port's and give the same
state: the reference's cases (``tests/test_controlplane.py``) on both, then
seeded random journals, two incarnations' records interleaved. The orphan
probe (``_try_adopt``: a scripted worker that acks the handshake, a dead
pid that is not adopted) and ``_AdoptedProc`` on both; ``pid_alive`` on a
zombie; the supervisor kinds refused by every ``serve_lm`` workload and
accepted by a ``FleetSupervisor``.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning_mpi_tpu.resilience import cluster as ref_cluster
from deeplearning_mpi_tpu.serving import fleet as ref_fleet
from deeplearning_mpi_tpu_torch.resilience import cluster as port_cluster
from deeplearning_mpi_tpu_torch.resilience import faults as port_faults
from deeplearning_mpi_tpu_torch.serving import fleet as port_fleet

PKGS = {
    "jax": types.SimpleNamespace(fleet=ref_fleet, cluster=ref_cluster),
    "torch": types.SimpleNamespace(fleet=port_fleet, cluster=port_cluster),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _rec(ev, inc=1, **kw):
    return {"inc": inc, "t": float(kw.pop("t", 0.0)), "ev": ev, **kw}


def _admit(rid, **kw):
    base = dict(rid=rid, prompt=[1, 2], max_new=4, arrival_rel=0.0, arrival_abs=100.0 + rid,
                deadline_abs=None, tenant="default", spike=False)
    base.update(kw)
    return _rec("admit", **base)


def _spawn(idx, pid, attempt=0, seed=0):
    return _rec("spawn", idx=idx, attempt=attempt, pid=pid, seed=seed, version=0,
                dir=f"replica{idx}-a{attempt}", chaos="")


def _replay(pkg, prior):
    return pkg.fleet.FleetSupervisor._replay_fleet_state(prior)


class TestFleetJournalReplay:
    def test_resolved_and_orphaned_requests_split(self, pkg):
        prior = [
            _rec("clock_start", t0=100.0), _spawn(0, 111),
            _rec("ready", idx=0, attempt=0, compile_total=5.0),
            _admit(0), _rec("dispatch", rid=0, target=0),
            _rec("done", rid=0, tokens=[9, 8], version=0, ttft=0.1, phase="before"),
            _admit(1), _rec("dispatch", rid=1, target=0),
        ]
        state = _replay(pkg, prior)
        assert state["t0"] == 100.0
        assert state["slots"][0]["pid"] == 111 and state["slots"][0]["compile_ready"] == 5.0
        assert state["ledger"][0]["tokens"] == [9, 8]
        assert state["ledger"][1].get("tokens") is None
        assert state["next_rid"] == 2

    def test_cross_incarnation_books_reconcile(self, pkg):
        prior = [
            _spawn(0, 11), _rec("chaos_fire", kind="replica_kill", replica=0),
            _rec("redispatch", rid=3), _rec("failure", idx=0, kind="replica_kill", chaos=""),
            _rec("chaos_recovery", kind="replica_kill"),
            _rec("scale", direction="up", outcome="ok"), _spawn(2, 33),
            _rec("scale", direction="down", outcome="vetoed"),
            _rec("brownout", stage=1), _rec("brownout", stage=0),
            _rec("chaos_fire", inc=2, kind="supervisor_kill", replica=-1),
            _rec("scale", inc=2, direction="up", outcome="ok"),
        ]
        state = _replay(pkg, prior)
        assert state["restarts"] == 1 and state["failures"] == {"replica_kill": 1}
        assert state["redispatched"] == 1
        assert [f["kind"] for f in state["fires"]] == ["replica_kill", "supervisor_kill"]
        assert state["recovery_kinds"] == ["replica_kill"]
        assert state["scale_records"] == [("up", "ok"), ("down", "vetoed"), ("up", "ok")]
        assert (state["brownout_stage"], state["brownout_stage_max"]) == (0, 1)
        assert sorted(state["slots"]) == [0, 2]

    def test_spike_burst_rides_the_journal(self, pkg):
        burst = [{"arrival": 1.0, "prompt": [5, 6], "max_new": 4, "spike": True}]
        prior = [_rec("clock_start", t0=100.0),
                 _rec("chaos_fire", kind="load_spike", replica=-1, burst=burst),
                 _admit(0, spike=True)]
        state = _replay(pkg, prior)
        assert state["fires"][0]["burst"] == burst and state["ledger"][0]["spike"] is True

    def test_retire_in_flight_resumes(self, pkg):
        prior = [_spawn(0, 11), _spawn(1, 22, seed=1), _rec("retire_begin", idx=1)]
        assert _replay(pkg, prior)["retiring"] == 1
        state = _replay(pkg, prior + [_rec("retired", idx=1)])
        assert state["retiring"] is None and sorted(state["slots"]) == [0]


def _journal(draw_ops):
    """A journal from drawn ops: spawns, readies, adopts, admissions,
    dispatches, completions, sheds, failures, chaos, scale, brownout,
    swaps and retirements, the second half stamped incarnation 2."""
    prior, rid, idx = [_rec("clock_start", t0=50.0)], 0, 0
    for n, op in enumerate(draw_ops):
        inc = 1 if n < len(draw_ops) // 2 else 2
        kind, a, b = op
        if kind == "spawn":
            prior.append(dict(_spawn(a % 4, 100 + n, attempt=b % 3), inc=inc))
            idx = max(idx, a % 4)
        elif kind == "ready":
            prior.append(_rec("ready", inc, idx=a % 4, attempt=b % 3, compile_total=float(b)))
        elif kind == "adopt":
            prior.append(_rec("adopt", inc, idx=a % 4, attempt=0, pid=200 + n,
                              compile_total=float(a), rids=[]))
        elif kind == "admit":
            prior.append(dict(_admit(rid, prompt=[a, b], spike=bool(b % 2),
                                     arrival_rel=float(a)), inc=inc))
            rid += 1
        elif kind == "done" and rid:
            prior.append(_rec("done", inc, rid=a % rid, tokens=[a, b], version=b % 2,
                              ttft=0.5, phase="during"))
        elif kind == "shed" and rid:
            prior.append(_rec("shed", inc, rid=a % rid, reason="deadline"))
        elif kind == "redispatch" and rid:
            prior.append(_rec("redispatch", inc, rid=a % rid))
        elif kind == "failure":
            prior.append(_rec("failure", inc, idx=a % 4,
                              kind=("replica_kill", "replica_hang")[b % 2], chaos=True))
        elif kind == "fire":
            prior.append(_rec("chaos_fire", inc, kind=("replica_kill", "load_spike")[b % 2],
                              replica=a % 4))
        elif kind == "recover":
            prior.append(_rec("chaos_recovery", inc, kind=("replica_kill", "load_spike")[b % 2]))
        elif kind == "scale":
            prior.append(_rec("scale", inc, direction=("up", "down")[a % 2],
                              outcome=("ok", "vetoed")[b % 2]))
        elif kind == "brownout":
            prior.append(_rec("brownout", inc, stage=a % 4))
        elif kind == "swapped":
            prior.append(_rec("swapped", inc, idx=a % 4, version=b % 3))
        elif kind == "swap_done":
            prior.append(_rec("swap_done", inc, version=1 + b % 2))
        elif kind == "retire_begin":
            prior.append(_rec("retire_begin", inc, idx=a % 4))
        elif kind == "retired":
            prior.append(_rec("retired", inc, idx=a % 4))
    return prior


OPS = st.lists(st.tuples(
    st.sampled_from(["spawn", "ready", "adopt", "admit", "done", "shed", "redispatch",
                     "failure", "fire", "recover", "scale", "brownout", "swapped",
                     "swap_done", "retire_begin", "retired"]),
    st.integers(0, 9), st.integers(0, 9)), min_size=1, max_size=60)


@settings(max_examples=200, deadline=None)
@given(OPS)
def test_replay_state_equals_the_reference(ops):
    prior = _journal(ops)
    assert _replay(PKGS["torch"], prior) == _replay(PKGS["jax"], prior)


# -- the orphan probe ------------------------------------------------------------
_FAKE_WORKER = r"""
import json, os, sys, time
d = sys.argv[1]
seq = 0
inbox = open(os.path.join(d, "inbox.jsonl"))
out = open(os.path.join(d, "outbox.jsonl"), "a")
out.write(json.dumps({"op": "done", "rid": 4, "tokens": [7], "version": 0}) + "\n")
out.flush()
while True:
    seq += 1
    tmp = os.path.join(d, "hb.tmp")
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "progress_seq": seq}, f)
    os.replace(tmp, os.path.join(d, "heartbeat.json"))
    line = inbox.readline()
    if line:
        m = json.loads(line)
        if m.get("op") == "adopt":
            out.write(json.dumps({"op": "adopted", "replica": 0, "pid": os.getpid(),
                                  "incarnation": m["incarnation"], "version": 0,
                                  "compile_total": 5.0, "mono_offset": 0.0,
                                  "rids": [9]}) + "\n")
            out.flush()
    time.sleep(0.03)
"""


def _mini_supervisor(pkg, tmp_path):
    sup = pkg.fleet.FleetSupervisor({"vocab_size": 16}, {"max_slots": 1}, 1, tmp_path / "fleet",
                                    seed=0, adopt_grace_s=8.0)
    sup.poll_interval_s = 0.05
    sup.incarnation = 7
    return sup


class TestOrphanProbe:
    def test_live_pid_acks_the_handshake(self, pkg, tmp_path):
        d = tmp_path / "replica0"
        d.mkdir(parents=True)
        (d / "inbox.jsonl").touch()
        proc = subprocess.Popen([sys.executable, "-c", _FAKE_WORKER, str(d)])
        try:
            sup = _mini_supervisor(pkg, tmp_path)
            rep = pkg.fleet._Replica(idx=0, seed=0)
            rep.dir = d
            ack, history = sup._try_adopt(rep, proc.pid)
            assert ack is not None and ack["incarnation"] == 7 and ack["rids"] == [9]
            assert any(m.get("op") == "done" and m.get("rid") == 4 for m in history)
            rep.inbox.close()
        finally:
            proc.kill()
            proc.wait()

    def test_dead_pid_is_not_adopted(self, pkg, tmp_path):
        d = tmp_path / "replica0"
        d.mkdir(parents=True)
        proc = subprocess.Popen([sys.executable, "-c", "pass"])
        proc.wait()
        sup = _mini_supervisor(pkg, tmp_path)
        rep = pkg.fleet._Replica(idx=0, seed=0)
        rep.dir = d
        assert sup._try_adopt(rep, proc.pid) == (None, [])

    def test_adopted_proc_handle_tracks_liveness(self, pkg):
        proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"],
                                start_new_session=True)
        handle = pkg.fleet._AdoptedProc(proc.pid)
        try:
            assert handle.poll() is None
        finally:
            handle.kill()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            proc.poll()
            if handle.poll() is not None:
                break
            time.sleep(0.02)
        assert handle.poll() == -signal.SIGKILL


def test_pid_alive_own_bogus_and_zombie(pkg):
    import os

    assert pkg.cluster.pid_alive(os.getpid())
    assert not pkg.cluster.pid_alive(2 ** 22 + 12345)
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{proc.pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
        except OSError:
            break
        time.sleep(0.02)
    try:
        assert not pkg.cluster.pid_alive(proc.pid)
    finally:
        proc.wait()


def test_supervisor_kinds_refused_by_serve_lm_accepted_by_the_fleet(tmp_path):
    from deeplearning_mpi_tpu_torch.cli.serve_lm import build_parser, chaos_workload

    for flags in ([], ["--disagg"], ["--replicas", "2"], ["--autoscale"]):
        supported, workload = chaos_workload(build_parser().parse_args(flags))
        assert not port_faults.CONTROLPLANE_KINDS & supported
        with pytest.raises(ValueError, match="supervisor_kill"):
            port_faults.validate_plan_kinds("supervisor_kill@step:1", supported,
                                            workload=workload)
    sup = port_fleet.FleetSupervisor({"vocab_size": 16}, {"max_slots": 1}, 1, tmp_path / "f",
                                     seed=0, chaos="supervisor_kill@step:5")
    assert sup.chaos_spec == "supervisor_kill@step:5"
    # Tensor-parallel replicas construct, and their spec carries the degree.
    sup = port_fleet.FleetSupervisor({"vocab_size": 16}, {"max_slots": 1}, 2, tmp_path / "g",
                                     tp=2)
    assert sup.tp == 2
    with pytest.raises(ValueError, match="tp must be >= 1"):
        port_fleet.FleetSupervisor({"vocab_size": 16}, {"max_slots": 1}, 2, tmp_path / "h",
                                   tp=0)
