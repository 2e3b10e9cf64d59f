"""The port's resilience layer against ``deeplearning_mpi_tpu.resilience``.

- Same answers from pure host logic, through both modules on the same
  inputs: the chaos grammar (``FaultPlan.parse``, every kind set,
  ``validate_plan_kinds``, ``pod_entries`` / ``strip_entries``), the
  injector's books over one scripted sequence of fires and recoveries,
  ``restart_delay`` and its jitter, ``run_with_auto_resume``'s attempts.
- Port only, with the reference's expectations: the tensor hooks, the
  heartbeat, ``preflight``, ``ResilientLoader`` (transparent; a stall
  retried into the same batch; a poison batch quarantined) and the
  checkpointer's ``corrupt_ckpt`` hook (never pinned, booked as a rollback).
- The e2e drill, the port of ``TestTrainChaosE2E`` on the tiny LM (3
  epochs of 3 steps, ``kill@step:7,corrupt_ckpt@epoch:1,loader_stall@batch:1``):
  the faulted run bitwise the port's unfaulted run, with history ``[0, 1, 1,
  2]``; its history, books and ``run_summary`` counters equal the
  reference's faulted run, and its epoch losses the reference's within
  ``test_torch_train.py``'s 1e-5. A trainer warmed by ``Trainer.warmup``
  runs the same drill to the same digests, every step through the warmed
  program (``fallback_calls`` 0).
"""

import json
import os
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning_mpi_tpu.resilience.faults as RF
import deeplearning_mpi_tpu.resilience.supervisor as RS
import deeplearning_mpi_tpu_torch.resilience.faults as TF
import deeplearning_mpi_tpu_torch.resilience.supervisor as TS
from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.resilience import (
    ChaosInjector,
    FaultPlan,
    Heartbeat,
    InjectedKill,
    Preempted,
    ResilientLoader,
    TrainingFailure,
    preflight,
    run_with_auto_resume,
    tree_digests,
)
from deeplearning_mpi_tpu_torch.resilience.faults import FAULT_INJECTED, RECOVERY, ROLLBACK
from deeplearning_mpi_tpu_torch.telemetry import InMemorySink, MetricsRegistry, labeled
from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state
from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
from deeplearning_mpi_tpu_torch.utils import config

torch.set_num_threads(1)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)  # test_torch_train.py's


# -- the grammar and the kind sets ---------------------------------------------------
NAMES = ["FAULT_UNITS", "POD_KINDS", "GUARD_KINDS", "TRAIN_KINDS", "FLEET_KINDS",
         "SERVE_KINDS", "DISAGG_KINDS", "AUTOSCALE_KINDS", "CONTROLPLANE_KINDS",
         "RANK_KILL_EXIT", "FAULT_INJECTED", "RECOVERY", "ROLLBACK", "RECOVERY_LATENCY",
         "ENV_SPEC", "ENV_STALL", "ENV_RANK"]


@pytest.mark.parametrize("name", NAMES)
def test_kind_sets_and_names_equal(name):
    assert getattr(TF, name) == getattr(RF, name)


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as err:
        return ("error", str(err))


SPECS = ["nan_grad@step:7,loader_stall@batch:3,kill@step:12,corrupt_ckpt@epoch:1",
         " kill@step:0 , ,rank_kill@step:5", "bitflip@step:3,loss_spike@step:9,nan_grads@step:1",
         "replica_slow@step:2,supervisor_kill@step:4,handoff_stall@step:1", "kill@epoch:1",
         "explode@step:1", "kill@step", "kill@step:-1", "", " , "]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_same_answers(spec):
    def parse(mod):
        plan = mod.FaultPlan.parse(spec)
        return [(s.kind, s.unit, s.at, s.fired) for s in plan.specs], repr(plan), len(plan)

    assert _outcome(parse, TF) == _outcome(parse, RF)


@pytest.mark.parametrize("supported", ["TRAIN_KINDS", "SERVE_KINDS", "DISAGG_KINDS",
                                       "FLEET_KINDS", "CONTROLPLANE_KINDS"])
@pytest.mark.parametrize("spec", ["kill@step:1,nan_grad@step:2", "serve_crash@step:1",
                                  "handoff_stall@step:3,serve_crash@step:1",
                                  "replica_kill@step:4,kill@step:1", "supervisor_hang@step:2"])
def test_validate_plan_kinds_same(spec, supported):
    got = _outcome(TF.validate_plan_kinds, spec, getattr(TF, supported), workload="training")
    want = _outcome(RF.validate_plan_kinds, spec, getattr(RF, supported), workload="training")
    assert got == want


@pytest.mark.parametrize("spec,strip", [
    ("kill@step:1,rank_kill@step:5,bitflip@step:2,replica_hang@step:3,rank_kill@step:5",
     ["rank_kill@step:5"]),
    ("rank_hang@step:2, replica_kill@step:1 ,", ["rank_hang@step:2", "missing@step:1"]),
])
def test_entries_and_strip_same(spec, strip):
    for fn in ("pod_entries", "fleet_entries"):
        assert getattr(TF, fn)(spec) == getattr(RF, fn)(spec)
    assert TF.strip_entries(spec, strip) == RF.strip_entries(spec, strip)


def _script(mod):
    """One scripted sequence of fires, recoveries, rollbacks and observed
    fires; returns everything the books say."""
    inj = mod.ChaosInjector(mod.FaultPlan.parse(
        "kill@step:3,loader_die@batch:2,loader_stall@batch:1,corrupt_ckpt@epoch:0,"
        "nan_grad@step:1,nan_grads@step:4,rank_kill@step:5,rank_hang@step:6,kill@step:9"),
        stall_s=0.0)
    trace = []
    for step in range(5):
        try:
            inj.check_kill(step=step)
            trace.append(("kill", step, False))
        except mod.InjectedKill:
            trace.append(("kill", step, True))
    trace += [inj.should_fire("loader_die", 2), inj.should_fire("loader_die", 2),
              inj.should_fire("nan_grad", 1), inj.should_fire("nan_grad", 1),
              inj.should_fire("nan_grads", 4), inj.should_corrupt(epoch=0),
              inj.should_corrupt(epoch=0)]
    trace += [inj.record_recovery("kill"), inj.record_recovery("kill"),
              inj.record_recovery("loader_die", at=2, latency_s=0.5),
              inj.should_fire("loader_die", 2), inj.record_rollback(at=0),
              inj.record_recovery("loader_stall", at=1), inj.reconcile_nan_recoveries(1),
              inj.reconcile_nan_recoveries(5)]
    observed = inj.fire_observed("rank_kill")
    trace += [(observed.kind, observed.at), inj.fire_observed("bitflip"),
              inj.record_recovery("rank_kill", latency_s=0.25)]
    return (trace, {k: v for k, v in inj.counts().items()}, inj.balanced(),
            [(s.kind, s.at) for s in inj.unrecovered()], inj.summary())


def test_injector_books_same():
    got, want = _script(TF), _script(RF)
    assert got == want
    assert got[1][FAULT_INJECTED] == 6 and got[2] is True and "never fired" in got[4]


def test_bind_registry_backfills_and_from_spec(monkeypatch):
    inj = ChaosInjector(FaultPlan.parse("kill@step:0,corrupt_ckpt@epoch:0"))
    with pytest.raises(InjectedKill):
        inj.check_kill(step=0)
    inj.record_recovery("kill", latency_s=0.1)
    reg = MetricsRegistry()
    inj.bind_registry(reg)
    assert inj.should_corrupt(epoch=0)
    inj.record_rollback(at=0)
    snap = reg.snapshot()
    assert snap[FAULT_INJECTED] == 2 and snap[RECOVERY] == 1 and snap[ROLLBACK] == 1
    assert snap[labeled(FAULT_INJECTED, kind="kill")] == 1
    monkeypatch.delenv(TF.ENV_SPEC, raising=False)
    assert ChaosInjector.from_spec(None) is None
    monkeypatch.setenv(TF.ENV_SPEC, "kill@step:4")
    assert [s.kind for s in ChaosInjector.from_spec(None).plan.specs] == ["kill"]


def test_tensor_hooks():
    inj = ChaosInjector(FaultPlan.parse(
        "nan_grad@step:1,nan_grad@step:2,loss_spike@step:3,grad_spike@step:4,nan_grads@step:5"))
    tokens = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    clean = {"tokens": tokens}
    assert inj.maybe_poison(clean, "lm", step=0) is clean
    lm = inj.maybe_poison(clean, "lm", step=1)
    assert lm["tokens"] is tokens and lm["mask"].dtype == torch.float32
    assert lm["mask"].shape == tokens.shape and torch.isnan(lm["mask"]).all()
    image = inj.maybe_poison({"image": torch.ones(2, 3), "label": torch.zeros(2)}, "cnn", step=2)
    assert torch.isnan(image["image"]).all() and not torch.isnan(image["label"]).any()
    assert inj.maybe_guard_fault(clean, step=0) is clean
    keys = [inj.maybe_guard_fault(clean, step=s) for s in (3, 4, 5)]
    assert float(keys[0]["__loss_scale__"]) == 1e3 and float(keys[1]["__grad_scale__"]) == 1e4
    assert torch.isnan(keys[2]["__grad_scale__"]) and keys[2]["__grad_scale__"].dtype == torch.float32


@pytest.mark.parametrize("attempt", [1, 2, 3, 5, 12])
@pytest.mark.parametrize("base", [0.0, 0.01, 5.0])
def test_restart_delay_same(attempt, base):
    got = TS.restart_delay(attempt, base)
    assert got == RS.restart_delay(attempt, base)
    if base:
        cap = min(base * 2.0 ** (attempt - 1), 300.0)
        assert 0.75 * cap <= got <= 1.25 * cap
    assert TS.restart_delay(attempt, base) == got  # replayable


class _FakeCkpt:
    def __init__(self, latest=None):
        self.latest = latest

    def latest_epoch(self):
        return self.latest


@pytest.mark.parametrize("case", ["resume", "budget", "preempted"])
def test_auto_resume_same_attempts(case):
    def drive(mod, preempted):
        ckpt, calls, reg = _FakeCkpt(), [], MetricsRegistry()

        def fit(start_epoch):
            calls.append(start_epoch)
            if case == "preempted":
                raise preempted(1)
            if case == "resume" and len(calls) == 1:
                ckpt.latest = 3
                raise RuntimeError("simulated crash")
            if case == "budget":
                raise RuntimeError("always down")
            return "done"

        try:
            out = mod.run_with_auto_resume(fit, ckpt, max_restarts=2, restart_delay_s=0.0,
                                           logger=SimpleNamespace(log=lambda m: None),
                                           registry=reg if mod is TS else None)
        except Exception as err:  # noqa: BLE001 — compared by type name
            out = type(err).__name__
        return out, calls, reg.snapshot().get(TS.TRAIN_RESTARTS, 0.0)

    from deeplearning_mpi_tpu.resilience.preemption import Preempted as RefPreempted

    got, want = drive(TS, Preempted), drive(RS, RefPreempted)
    assert got[:2] == want[:2]
    assert got[2] == {"resume": 1, "budget": 2, "preempted": 0}[case]
    with pytest.raises(TrainingFailure, match="after 1 restarts"):
        run_with_auto_resume(lambda e: 1 / 0, _FakeCkpt(), max_restarts=1, restart_delay_s=0.0,
                             logger=SimpleNamespace(log=lambda m: None))


def test_heartbeat_beats_progress_and_final_beat(tmp_path, monkeypatch):
    monkeypatch.setenv("DMT_SUPERVISOR_INCARNATION", "7")
    hb = Heartbeat(tmp_path / "hb" / "heartbeat.json", interval_s=0.02).start()
    ref = RS.Heartbeat(tmp_path / "ref.json", interval_s=0.02).start()
    for i in range(3):
        hb.progress = {"step": i, "phase": "train"}
        ref.progress = {"step": i, "phase": "train"}
    time.sleep(0.1)
    hb.progress = {"step": 9, "phase": "checkpoint"}
    hb.stop()
    ref.stop()
    beat = Heartbeat.read(tmp_path / "hb" / "heartbeat.json")
    want = RS.Heartbeat.read(tmp_path / "ref.json")
    assert set(beat) == set(want)  # the reference's payload keys
    assert beat["progress_seq"] == 4 and beat["step"] == 9 and beat["incarnation"] == 7
    assert not (tmp_path / "hb" / "heartbeat.tmp").exists()
    assert Heartbeat.read(tmp_path / "missing.json") is None
    (tmp_path / "torn.json").write_text('{"progress_seq": 1')
    assert Heartbeat.read(tmp_path / "torn.json") is None
    Heartbeat(tmp_path / "never.json").stop()  # a stop without a start: a no-op


def test_preflight(tmp_path):
    preflight(model_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"), global_batch_size=8,
              grad_accum=2)
    assert (tmp_path / "m").is_dir() and (tmp_path / "l").is_dir()
    with pytest.raises(SystemExit, match="data directory 'nowhere' does not exist"):
        preflight(data_dir="nowhere")
    with pytest.raises(SystemExit, match="not divisible by grad_accum 4"):
        preflight(global_batch_size=10, grad_accum=4)


# -- the loader watchdog -------------------------------------------------------------------
def _loader(n=32, batch=8):
    return Loader(SyntheticTokens(n, 16), batch, shuffle=True, seed=0, device="cpu")


def _tokens(batches):
    return [b["tokens"] for b in batches]


def test_resilient_loader_transparent_without_faults():
    wrapped = ResilientLoader(_loader(), logger=SimpleNamespace(log=lambda m: None))
    assert wrapped.steps_per_epoch() == 4  # delegation
    for epoch in (0, 1):
        got, want = _tokens(wrapped.epoch(epoch)), _tokens(_loader().epoch(epoch))
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_resilient_loader_stall_retried_into_the_same_batch():
    chaos = ChaosInjector(FaultPlan.parse("loader_stall@batch:1"), stall_s=1.0)
    wrapped = ResilientLoader(_loader(), chaos=chaos, batch_timeout_s=0.1, max_retries=2,
                              backoff_s=0.01, logger=SimpleNamespace(log=lambda m: None))
    got, want = _tokens(wrapped.epoch(0)), _tokens(_loader().epoch(0))
    assert wrapped.stalls >= 1 and wrapped.retries >= 1 and not wrapped.quarantined
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert chaos.balanced()
    assert chaos.counts()[labeled(RECOVERY, kind="loader_stall")] == 1


def test_resilient_loader_quarantines_a_poison_batch():
    chaos = ChaosInjector(FaultPlan.parse("loader_die@batch:2"))
    wrapped = ResilientLoader(_loader(), chaos=chaos, batch_timeout_s=5.0, max_retries=1,
                              backoff_s=0.0, logger=SimpleNamespace(log=lambda m: None))
    got, want = _tokens(wrapped.epoch(0)), _tokens(_loader().epoch(0))
    assert wrapped.quarantined == [2] and len(got) == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want[:2] + want[3:]))
    assert chaos.balanced() and chaos.counts()[labeled(RECOVERY, kind="loader_die")] == 1


# -- the tiny LM, the checkpointer's hook, and the e2e drill ------------------------------------
EPOCHS, BATCH, SEQS, SEQ = 3, 8, 24, 32  # 3 steps an epoch, 9 in all
PLAN = "kill@step:7,corrupt_ckpt@epoch:1,loader_stall@batch:1"


@pytest.fixture(scope="module")
def reference():
    """The reference's tiny LM factory (SGD 1e-2, the reference test's) and
    its initial weights in the port's names."""
    from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
    from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
    from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
    from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer

    model = JaxLM(config=JaxConfig.tiny(), dtype=jnp.float32)
    tx = jax_optimizer("sgd", 1e-2, momentum=0.0)

    def factory(mesh=None):
        return jax_create_state(model, jax.random.key(0), jnp.zeros((1, 16), jnp.int32), tx,
                                mesh=mesh)

    return factory, lm_params_from_jax(jax.device_get(factory().params))


def _port_factory(init):
    def factory():
        model = TransformerLM(TransformerConfig(vocab_size=256, num_layers=2, num_heads=4,
                                                head_dim=8, d_model=32, d_ff=64),
                              dtype=torch.float32, device="cpu")
        model.load_state_dict(init)
        return create_train_state(model, build_optimizer("sgd", 1e-2, momentum=0.0))

    return factory


def _port_run(init, tmp, spec=None, *, warm=False, guardrails=None, seqs=SEQS):
    factory = _port_factory(init)
    chaos = ChaosInjector(FaultPlan.parse(spec), stall_s=0.05) if spec else None
    sink = InMemorySink()
    ck = Checkpointer(tmp / "ck", max_to_keep=5, chaos=chaos)
    trainer = Trainer(factory(), "lm", eval_every=1, log=lambda m: None, checkpointer=ck,
                      chaos=chaos, guardrails=guardrails, metrics=MetricsRegistry([sink]))
    loader = Loader(SyntheticTokens(seqs, SEQ), BATCH, shuffle=True, seed=0, device="cpu")
    if warm:
        trainer.warmup(next(iter(loader.epoch(0))))
    if chaos is not None:
        chaos.bind_registry(trainer.metrics)
        loader = ResilientLoader(loader, chaos=chaos, batch_timeout_s=10.0, backoff_s=0.01,
                                 logger=trainer)
    args = SimpleNamespace(num_epochs=EPOCHS, max_restarts=2, eval_only=False,
                           restart_delay_s=0.01)
    config.execute(config.Run(args, trainer, loader, None, 0, factory))
    summary = [r for r in sink.records if r["kind"] == "run_summary"][-1]
    return SimpleNamespace(trainer=trainer, chaos=chaos, history=trainer.history,
                           summary=summary, ck=ck)


def _ref_run(reference, tmp, spec):
    from deeplearning_mpi_tpu.data import ShardedLoader
    from deeplearning_mpi_tpu.data import SyntheticTokens as JaxTokens
    from deeplearning_mpi_tpu.resilience import ResilientLoader as RefLoader
    from deeplearning_mpi_tpu.runtime.mesh import create_mesh
    from deeplearning_mpi_tpu.telemetry import InMemorySink as RefSink
    from deeplearning_mpi_tpu.train import Checkpointer as RefCheckpointer
    from deeplearning_mpi_tpu.train import Trainer as RefTrainer
    from deeplearning_mpi_tpu.utils import config as ref_config

    factory, _ = reference
    mesh = create_mesh()
    chaos = RF.ChaosInjector(RF.FaultPlan.parse(spec), stall_s=0.05)
    ck = RefCheckpointer(tmp / "ck", max_to_keep=5, chaos=chaos)
    trainer = RefTrainer(factory(mesh), "lm", mesh, checkpointer=ck, eval_every=1,
                         time_steps=False, chaos=chaos)
    sink = RefSink()
    trainer.metrics.add_sink(sink)
    trainer.place_state()
    chaos.bind_registry(trainer.metrics)
    loader = RefLoader(ShardedLoader(JaxTokens(SEQS, SEQ), BATCH, mesh, shuffle=True, seed=0),
                       chaos=chaos, batch_timeout_s=10.0, backoff_s=0.01)
    args = SimpleNamespace(num_epochs=EPOCHS, max_restarts=2, eval_only=False, resume=False,
                           restart_delay_s=0.01)
    try:
        history = ref_config.execute_training(trainer, ck, args, loader, None, 0,
                                              state_factory=lambda: factory(mesh))
    finally:
        ck.close()
    summary = [r for r in sink.records if r["kind"] == "run_summary"][-1]
    return SimpleNamespace(history=history, chaos=chaos, summary=summary)


@pytest.fixture(scope="module")
def drill(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_chaos")
    _, init = reference
    return SimpleNamespace(faulted=_port_run(init, tmp / "faulted", PLAN),
                           clean=_port_run(init, tmp / "clean"),
                           warmed=_port_run(init, tmp / "warmed", PLAN, warm=True),
                           ref=_ref_run(reference, tmp / "ref", PLAN))


def _digests(trainer):
    return tree_digests({"p": trainer.state.params(), "o": trainer.state.opt_state})


def test_drill_recovers_bitwise_onto_the_unfaulted_run(drill):
    f, c = drill.faulted, drill.clean
    assert f.trainer.state.step == EPOCHS * (SEQS // BATCH)
    assert [h["epoch"] for h in f.history] == [0, 1, 1, 2]
    assert _digests(f.trainer) == _digests(c.trainer)
    clean_loss = {h["epoch"]: h["loss"] for h in c.history}
    assert all(h["loss"] == clean_loss[h["epoch"]] for h in f.history)


def test_drill_books_and_summary_equal_the_reference(drill):
    f, ref = drill.faulted, drill.ref
    assert [h["epoch"] for h in f.history] == [h["epoch"] for h in ref.history]
    assert f.chaos.balanced() and not f.chaos.unrecovered()
    assert f.chaos.counts() == ref.chaos.counts()
    assert f.chaos.summary() == ref.chaos.summary()
    books = {k: v for k, v in ref.summary.items()
             if k.startswith(("fault_injected_total", "recovery_total", "rollback_total",
                              "train_restarts_total"))}
    assert books and {k: f.summary.get(k) for k in books} == books
    assert (f.summary[FAULT_INJECTED], f.summary[RECOVERY], f.summary[ROLLBACK]) == (3, 2, 1)


def test_drill_losses_match_the_reference(drill):
    got = [h["loss"] for h in drill.faulted.history]
    want = [h["loss"] for h in drill.ref.history]
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_warmed_trainer_runs_the_drill_to_the_same_digests(drill):
    w = drill.warmed
    assert _digests(w.trainer) == _digests(drill.faulted.trainer)
    assert [h["epoch"] for h in w.history] == [0, 1, 1, 2]
    assert w.chaos.balanced() and w.trainer.train_step.fallback_calls == 0
    assert w.trainer.state.model is next(iter(w.trainer.train_step.programs.values())).model


def test_corrupt_ckpt_is_never_pinned_and_is_booked_as_a_rollback(reference, tmp_path):
    _, init = reference
    state = _port_factory(init)()
    chaos = ChaosInjector(FaultPlan.parse("corrupt_ckpt@epoch:1"))
    ck = Checkpointer(tmp_path / "ck", max_to_keep=5, chaos=chaos)
    ck.save(state, epoch=0)
    ck.save(state, epoch=1)
    assert ck.last_good_epoch() == 0  # the corrupted save stayed unpinned
    assert ck.latest_epoch() == 1
    _, epoch = ck.restore_verified(_port_factory(init)())
    assert epoch == 0 and chaos.balanced()
    assert chaos.counts()[labeled(ROLLBACK, kind="corrupt_ckpt")] == 1
    _, epoch = ck.rollback_to_last_good(_port_factory(init)())
    assert epoch == 0 and ck.all_steps() == [0]


def test_cli_chaos_drill_and_refusals(tmp_path, capsys):
    from deeplearning_mpi_tpu_torch.cli import train_lm

    flags = ["--device", "cpu", "--num_layers", "1", "--num_heads", "2", "--head_dim", "8",
             "--d_model", "16", "--d_ff", "32", "--seq_len", "16", "--batch_size", "4",
             "--train_sequences", "30", "--num_epochs", "2", "--eval_every", "1"]
    assert train_lm.main([*flags, "--chaos", "serve_crash@step:1"]) == 1
    err = capsys.readouterr().err
    assert "serve_crash" in err and "training workload" in err
    assert train_lm.main([*flags, "--chaos", "kill@step:8,corrupt_ckpt@epoch:0",
                          "--max_restarts", "2", "--restart_delay_s", "0",
                          "--model_dir", str(tmp_path / "m"), "--log_dir", str(tmp_path / "l"),
                          "--metrics_dir", str(tmp_path / "x"), "--aot_warmup"]) == 0
    out = capsys.readouterr().out
    assert "chaos: 2 fault(s) injected, 1 recovered, 1 rolled back" in out
    records = [json.loads(line) for line in open(tmp_path / "x" / "metrics.jsonl")]
    summary = [r for r in records if r["kind"] == "run_summary"][-1]
    assert summary[FAULT_INJECTED] == summary[RECOVERY] + summary[ROLLBACK] == 2
    # Every checkpoint was corrupt at the kill: a fresh init re-ran both
    # epochs. The trainer's step counter, as the reference's, counts the
    # steps this process ran (8 before the kill, 12 after).
    beat = Heartbeat.read(tmp_path / "l" / "heartbeat.json")
    assert beat["step"] == 8 + 2 * 6 and beat["pid"] == os.getpid()
