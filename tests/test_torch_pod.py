"""The port's pod supervisor against ``deeplearning_mpi_tpu.resilience.pod``.

- Same answers from pure host logic, through both modules: the
  ``LivenessTracker`` on one fake clock (the startup grace, a baseline read,
  progress resetting the deadline, the hang's culprit by lowest step, the
  tie, stragglers), the journal's records replayed by both readers.
- The rank-fault hooks (target rank only, nothing counted elsewhere,
  ``fire_observed`` then the recovery), and the port's collateral rule (a
  gloo survivor's collective raises when its peer's socket closes).
- The reference's fake-worker drills through the port's
  ``PodSupervisor`` (no torch in the workers): clean, crash (no survivors),
  the kill re-formed onto a smaller world (its result equal to the
  reference supervisor's on the same worker), the hang's culprit, the tie
  broken toward the planned target, the unplanned tie restarted at the same
  size, the restart budget; and a ``bitflip`` over 3 ranks convicted by the
  digest vote, its host quarantined, the checkpoint after the divergence
  pruned, re-formed onto 2.
- One real ``cli.launch_pod`` of ``cli.train_lm`` over 2 gloo ranks with
  ``rank_kill@step:6``: world sizes ``[2, 1]``, the books balanced, and the
  resumed world's step and epoch losses bitwise a clean ``--resume`` of the
  epoch-0 checkpoint at world size 1 (the reference's ``tools/pod_drill.py``).
"""

import json
import os
import shutil
import sys
import textwrap
from pathlib import Path

import pytest

import deeplearning_mpi_tpu.resilience.cluster as RC
import deeplearning_mpi_tpu_torch.resilience.cluster as TC
import deeplearning_mpi_tpu_torch.resilience.faults as TF
from deeplearning_mpi_tpu.resilience.pod import PodSupervisor as RefPodSupervisor
from deeplearning_mpi_tpu_torch.resilience import ChaosInjector, FaultPlan
from deeplearning_mpi_tpu_torch.resilience.guardrails import QuarantineLedger
from deeplearning_mpi_tpu_torch.resilience.pod import (
    POD_QUARANTINES,
    POD_RANK_FAILURES,
    POD_RESTARTS,
    POD_WORLD_SIZE,
    PodFailure,
    PodSupervisor,
    collateral_deaths,
)

ROOT = Path(__file__).resolve().parent.parent


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


#: scripted liveness cases: ("obs", rank, payload) | ("adv", dt) | ("check", what, arg)
LIVENESS = {
    "grace": [("adv", 9.0), ("check", "stalled", 0), ("adv", 2.0), ("check", "stalled", 0),
              ("check", "any", None)],
    "baseline": [("obs", 0, {"progress_seq": 0}), ("check", "any", None), ("adv", 11.0),
                 ("obs", 0, {"progress_seq": 0}), ("check", "stalled", 0)],
    "first_read": [("obs", 0, {"progress_seq": 7, "step": 3}), ("check", "any", None),
                   ("check", "stalled", 0)],
    "deadline": [("obs", 0, {"progress_seq": 0}), ("adv", 1.0), ("obs", 0, {"progress_seq": 1}),
                 ("adv", 4.0), ("check", "stalled", 0), ("obs", 0, {"progress_seq": 2}),
                 ("adv", 4.0), ("check", "stalled", 0), ("adv", 2.0),
                 ("obs", 0, {"progress_seq": 2}), ("check", "stalled", 0),
                 ("check", "age", 0)],
    "culprit": [("obs", 0, {"progress_seq": 9, "step": 7}), ("obs", 1, {"progress_seq": 9,
                                                                        "step": 5}),
                ("check", "culprits", [0, 1]), ("check", "culprits", [])],
    "never_step": [("obs", 0, {"progress_seq": 3, "step": 2}), ("obs", 1, {"progress_seq": 1}),
                   ("check", "culprits", [0, 1])],
    "tie": [("obs", 0, {"progress_seq": 4, "step": 5}), ("obs", 1, {"progress_seq": 4,
                                                                    "step": 5}),
            ("check", "culprits", [0, 1])],
    "straggler": ([("obs", r, {"progress_seq": 0}) for r in (0, 1)]
                  + [x for s in (1, 2, 3) for x in (("adv", 1.0),
                                                     ("obs", 0, {"progress_seq": s}),
                                                     ("obs", 1, {"progress_seq": s}))]
                  + [x for s in (4, 5, 6, 7, 8) for x in (("adv", 1.0),
                                                           ("obs", 0, {"progress_seq": s}),
                                                           ("obs", 1, {"progress_seq": 3}))]
                  + [("check", "stragglers", [0, 1]), ("check", "stalled", 1)]),
    "no_baseline": [("obs", 0, {"progress_seq": 0}), ("adv", 1.0),
                    ("obs", 0, {"progress_seq": 1}), ("adv", 100.0),
                    ("check", "stragglers", [0])],
    "incarnation": [("obs", 0, {"progress_seq": 5, "incarnation": 2}), ("check", "any", None),
                    ("obs", 0, {"progress_seq": 6, "incarnation": 3}), ("check", "any", None)],
}


@pytest.mark.parametrize("case", sorted(LIVENESS))
def test_liveness_tracker_same(case):
    def run(mod):
        clk = FakeClock()
        deadline = 20.0 if case == "straggler" else 5.0
        t = mod.LivenessTracker((0, 1), deadline_s=deadline, grace_s=10.0, straggler_factor=4.0,
                                clock=clk, incarnation=3 if case == "incarnation" else None)
        out = []
        for op, *a in LIVENESS[case]:
            if op == "obs":
                t.observe(a[0], a[1])
            elif op == "adv":
                clk.t += a[0]
            else:
                what, arg = a
                out.append({"stalled": lambda: t.stalled(arg), "any": t.any_progress,
                            "age": lambda: t.progress_age_s(arg),
                            "culprits": lambda: t.hang_culprits(arg),
                            "stragglers": lambda: t.stragglers(arg)}[what]())
        return out

    assert run(TC) == run(RC)


def test_journal_replays_in_both_readers(tmp_path):
    inc = TC.next_incarnation(tmp_path)
    assert TC.next_incarnation(tmp_path) == inc + 1
    journal = TC.SupervisorJournal(tmp_path, incarnation=inc + 1)
    journal.record("spawn", attempt=0, world=2, pids=[11, 12], chaos="")
    journal.record("reform", old_world=2, new_world=1, restarts=1)
    journal.close()
    with open(tmp_path / TC.JOURNAL_FILE, "a") as f:
        f.write('{"inc": 9, "ev": "torn')  # a record cut mid-write
    records = TC.replay_journal(tmp_path / TC.JOURNAL_FILE)
    assert records == RC.replay_journal(tmp_path / RC.JOURNAL_FILE)
    assert [r["ev"] for r in records] == ["spawn", "reform"]
    env = {"COORDINATOR_ADDRESS": "x", "NUM_PROCESSES": "2", "PROCESS_ID": "1", "KEEP": "1"}
    TC.scrub_rendezvous_env(env)
    assert env == {"KEEP": "1"}


def test_rank_fault_hooks_fire_on_the_target_only(monkeypatch):
    detonated = []
    monkeypatch.setattr(TF, "_exit_rank", lambda step: detonated.append(("kill", step)))
    monkeypatch.setattr(TF, "_hang_rank", lambda step: detonated.append(("hang", step)))
    monkeypatch.setenv(TF.ENV_RANK, "0")  # this process
    inj = ChaosInjector(FaultPlan.parse("rank_kill@step:3,rank_hang@step:5"))
    for step in range(6):
        inj.check_rank_fault(step=step)
    assert detonated == [("kill", 3), ("hang", 5)]
    monkeypatch.setenv(TF.ENV_RANK, "5")  # not this process
    inj = ChaosInjector(FaultPlan.parse("rank_kill@step:3,bitflip@step:1"))
    inj.check_rank_fault(step=3)
    assert inj.maybe_bitflip(None, step=1) is None
    assert not any(s.fired for s in inj.plan.specs) and inj.counts() == {}
    hit = inj.fire_observed("rank_kill")
    assert hit is not None and inj.fire_observed("rank_kill") is None and not inj.balanced()
    assert inj.record_recovery("rank_kill", latency_s=0.5) and inj.balanced()


def test_collateral_deaths():
    assert collateral_deaths({0: 1, 1: TF.RANK_KILL_EXIT}) == [0]
    assert collateral_deaths({0: 1, 1: -9, 2: None}) == [0]
    assert collateral_deaths({0: 1, 1: 1}) == []  # no primary death: both failed
    assert collateral_deaths({0: None, 1: 0}) == []


# -- the reference's fake-worker drills ------------------------------------------------------
_WORKER = textwrap.dedent("""
    import json, os, sys, time

    MODE = sys.argv[1]
    rank = int(os.environ.get("PROCESS_ID", "0"))
    world = int(os.environ.get("NUM_PROCESSES", "1"))
    chaos = os.environ.get("DMT_CHAOS", "")
    hb = os.path.join(os.environ["DMT_HEARTBEAT_DIR"], f"heartbeat-{rank}.json")

    def beat(seq, step, **extra):
        tmp = hb + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"progress_seq": seq, "step": step, "pid": os.getpid(), **extra}, f)
        os.replace(tmp, hb)

    target = rank == world - 1
    for step in range(30):
        beat(step + 1, step)
        if MODE == "crash" and step == 2:
            sys.exit(1)
        if target and "rank_kill" in chaos and step == 5:
            os._exit(23)
        if MODE in ("tie", "tie_unplanned") and step == 5:
            wedge = ("rank_hang" in chaos if MODE == "tie"
                     else "attempt0" in os.environ["DMT_HEARTBEAT_DIR"])
            if wedge:
                while True:
                    beat(6, 5)
                    time.sleep(0.02)
        if MODE not in ("tie", "tie_unplanned") and "rank_hang" in chaos:
            freeze = 5 if target else 7
            if step == freeze:
                while True:
                    beat(freeze + 1, freeze)
                    time.sleep(0.02)
        time.sleep(0.02)
    if MODE == "bitflip":
        # The whole digest ring rides the last beat: free-running workers
        # would let the vote judge a step before the lagging rank reports
        # it (real ranks step in lockstep).
        flipped = target and "bitflip" in chaos
        ring = {s: ("flip" if flipped and s >= 3 else "clean") for s in range(30)}
        beat(31, 29, digests=ring, ckpts={"0": 2, "1": 5})
""")


@pytest.fixture()
def worker(tmp_path):
    path = tmp_path / "fake_worker.py"
    path.write_text(_WORKER)
    return path


def _supervisor(worker, mode, pod_dir, cls=PodSupervisor, world=2, **kw):
    kw.setdefault("heartbeat_deadline_s", 0.6)
    kw.setdefault("heartbeat_interval_s", 0.02)
    kw.setdefault("spawn_grace_s", 10.0)
    kw.setdefault("poll_interval_s", 0.05)
    return cls([sys.executable, str(worker), mode], world, pod_dir, **kw)


def _summaries(pod_dir):
    return [r for r in map(json.loads, (pod_dir / "pod_metrics.jsonl").open())
            if r.get("kind") == "pod_summary"]


def test_clean_run_single_attempt(worker, tmp_path):
    result = _supervisor(worker, "ok", tmp_path / "pod").run()
    assert (result.ok, result.world_sizes, result.restarts, result.rank_failures,
            result.chaos_balanced) == (True, [2], 0, 0, None)


def test_kill_drill_reforms_smaller_world_as_the_reference(worker, tmp_path):
    result = _supervisor(worker, "ok", tmp_path / "pod", chaos="rank_kill@step:5").run()
    ref = _supervisor(worker, "ok", tmp_path / "ref", cls=RefPodSupervisor,
                      chaos="rank_kill@step:5").run()
    fields = ("ok", "world_sizes", "restarts", "rank_failures", "chaos_balanced")
    assert [getattr(result, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert result.world_sizes == [2, 1] and result.chaos_balanced is True
    snap = result.snapshot
    assert (snap[POD_RANK_FAILURES], snap[POD_RESTARTS], snap[POD_WORLD_SIZE]) == (1, 1, 1)
    summary = _summaries(tmp_path / "pod")[-1]
    assert summary["ok"] is True and summary["world_sizes"] == "2->1"


@pytest.mark.parametrize("mode,chaos,sizes", [("ok", "rank_hang@step:5", [2, 1]),
                                              ("tie", "rank_hang@step:5", [2, 1]),
                                              ("tie_unplanned", None, [2, 2])])
def test_hang_drills(worker, tmp_path, mode, chaos, sizes):
    # ok: rank 1 wedges at step 5, rank 0 blocks at 7: only the culprit is
    # blamed. tie: both freeze at 5, the planned target is blamed. Unplanned
    # tie: the culprit is unknowable, the whole world restarts at its size.
    result = _supervisor(worker, mode, tmp_path / "pod", chaos=chaos).run()
    assert (result.ok, result.world_sizes, result.restarts, result.rank_failures) == (
        True, sizes, 1, 1)
    assert result.chaos_balanced is (None if chaos is None else True)


def test_no_survivors_and_restart_budget_are_pod_failures(worker, tmp_path):
    with pytest.raises(PodFailure, match="below min_world_size"):
        _supervisor(worker, "crash", tmp_path / "crash").run()
    assert _summaries(tmp_path / "crash")[-1]["ok"] is False
    with pytest.raises(PodFailure, match="restart budget"):
        _supervisor(worker, "ok", tmp_path / "budget", chaos="rank_kill@step:5",
                    max_pod_restarts=0).run()


def test_bitflip_convicted_by_the_vote_and_quarantined(worker, tmp_path):
    ckpt = tmp_path / "ckpt"
    for epoch in (0, 1):
        (ckpt / str(epoch)).mkdir(parents=True)
        (ckpt / f"manifest-{epoch}.json").write_text("{}")
    # Every rank exits 0 and the rings disagree at step 3: the run completed
    # on a poisoned trajectory (the reference's branch for it).
    result = _supervisor(worker, "bitflip", tmp_path / "pod", world=3, chaos="bitflip@step:3",
                         ckpt_dir=ckpt).run()
    assert result.ok and result.world_sizes == [3, 2] and result.rank_failures == 1
    assert result.chaos_balanced is True and result.snapshot[POD_QUARANTINES] == 1
    assert QuarantineLedger(tmp_path / "pod" / "quarantine.json").hosts() == {"2"}
    # Epoch 1 was saved at step 5, after the divergence at step 3.
    assert (ckpt / "0").is_dir() and not (ckpt / "1").exists()
    assert not (ckpt / "manifest-1.json").exists()
    # A later pod in the same directory never spawns the quarantined host.
    again = _supervisor(worker, "ok", tmp_path / "pod", world=3).run()
    assert again.world_sizes == [2]


# -- one real launch_pod of train_lm over 2 gloo ranks -----------------------------------------
WORKER_FLAGS = ["--device", "cpu", "--num_epochs", "3", "--batch_size", "8",
                "--train_sequences", "40", "--seq_len", "32", "--num_layers", "1",
                "--d_model", "32", "--d_ff", "64", "--num_heads", "2", "--head_dim", "16",
                "--eval_every", "1", "--keep_checkpoints", "10", "--resume"]


def _train_args(root, tag):
    return [*WORKER_FLAGS, "--model_dir", str(root / f"{tag}models"),
            "--log_dir", str(root / f"{tag}logs"), "--metrics_dir", str(root / f"{tag}metrics")]


def _losses(path):
    steps, epochs = {}, {}
    for rec in map(json.loads, open(path)):
        if rec.get("epoch") is None or rec["epoch"] < 1 or "loss" not in rec:
            continue
        if rec["kind"] == "step":
            steps[(rec["epoch"], rec["step"])] = rec["loss"]
        elif rec["kind"] == "epoch":
            epochs[rec["epoch"]] = rec["loss"]
    return steps, epochs


def test_launch_pod_train_lm_rank_kill_resumes_bitwise(tmp_path, monkeypatch, capsys):
    from deeplearning_mpi_tpu_torch.cli import launch_pod, train_lm

    for var in [k for k in os.environ if k.startswith("DMT_")] + list(TC.RENDEZVOUS_VARS):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(ROOT)
    rc = launch_pod.main([
        "--num_processes", "2", "--pod_dir", str(tmp_path / "pod"), "--chaos", "rank_kill@step:6",
        "--heartbeat_interval_s", "0.2", "--poll_interval_s", "0.1", "--heartbeat_deadline_s",
        "60", "--spawn_grace_s", "120", "--", sys.executable, "-m",
        "deeplearning_mpi_tpu_torch.cli.train_lm", *_train_args(tmp_path, "")])
    logs = "".join(p.read_text() for p in sorted((tmp_path / "pod").glob("attempt*.log")))
    assert rc == 0, capsys.readouterr().out + logs
    summary = _summaries(tmp_path / "pod")[-1]
    assert summary["world_sizes"] == "2->1" and summary["chaos_balanced"] is True
    assert summary["fault_injected_total"] == summary["recovery_total"] == 1
    assert (summary["pod_rank_failures_total"], summary["pod_restarts_total"],
            summary["pod_world_size"]) == (1, 1, 1)
    # The oracle: the epoch-0 checkpoint alone, resumed at world size 1.
    shutil.copytree(tmp_path / "models", tmp_path / "oraclemodels")
    lm = tmp_path / "oraclemodels" / "lm"
    for child in lm.iterdir():
        if (child.is_dir() and child.name.isdigit() and int(child.name) > 0) or (
                child.name.startswith("manifest-") and child.stem != "manifest-0"):
            shutil.rmtree(child) if child.is_dir() else child.unlink()
    capsys.readouterr()
    assert train_lm.main(_train_args(tmp_path, "oracle")) == 0
    assert "resumed from verified epoch 0" in capsys.readouterr().out
    pod_steps, pod_epochs = _losses(tmp_path / "metrics" / "metrics.jsonl")
    ora_steps, ora_epochs = _losses(tmp_path / "oraclemetrics" / "metrics.jsonl")
    assert ora_steps and sorted(ora_epochs) == [1, 2]
    assert pod_steps == ora_steps and pod_epochs == ora_epochs
