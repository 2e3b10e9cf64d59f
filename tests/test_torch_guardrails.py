"""The port's numerics guardrails against ``deeplearning_mpi_tpu``'s.

- Same answers from pure host logic, through both modules on the same
  inputs: ``GuardrailPolicy``'s verdicts (warmup grace, spike, instant
  poison, patience escalation, hysteresis, non-finite, the grad-norm
  signal) and ``replay_scale`` on the same scalar sequences;
  ``DigestVote``'s tallies; ``QuarantineLedger`` files written by one and
  read by the other; ``attach_digest_ring``.
- Port only, with the reference's expectations: ``param_digest`` and the
  in-place ``maybe_bitflip``; the kind audit (every training kind has a
  live hook, a trainer refuses the serving kinds and the guard kinds
  without a policy); the checkpointer's pin (kept by retention when every
  younger save is corrupt, rolled back to, fenced by its generation).
- The drills on the tiny LM (3 epochs of 3 steps, SGD): ``nan_grads`` is a
  tolerated spike booked as a recovery (``TestGuardSpikeAccounting``); a
  ``loss_spike`` at step 8 is judged poisoned, rolled back to the pinned
  last-good and replayed bitwise onto the unfaulted run with one rollback
  in the books (``TestLossSpikeRollbackE2E``), also on a warmed trainer
  where the faulted batch alone takes the eager step; the NaN epoch stats;
  and the cost when off (``TestCostlessWhenOff``: no ``grad_norm``, no
  guardrail object, no host read).
"""

import math
from types import SimpleNamespace

import pytest
import torch

import deeplearning_mpi_tpu.resilience.guardrails as RG
import deeplearning_mpi_tpu_torch.resilience.guardrails as TG
from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.resilience import (
    ChaosInjector,
    CheckpointCorruption,
    FaultPlan,
    GuardrailPolicy,
    ResilientLoader,
    atomic_write_json,
    param_digest,
    tree_digests,
)
from deeplearning_mpi_tpu_torch.resilience.faults import (
    FAULT_INJECTED,
    FAULT_UNITS,
    GUARD_KINDS,
    RECOVERY,
    ROLLBACK,
    SERVE_KINDS,
    TRAIN_KINDS,
)
from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry
from deeplearning_mpi_tpu_torch.train import (
    Trainer,
    build_optimizer,
    create_train_state,
    make_train_step,
)
from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
from deeplearning_mpi_tpu_torch.utils import config

torch.set_num_threads(1)


# -- GuardrailPolicy: the same verdicts ---------------------------------------------------
def _denom(policy, signal="loss"):
    band = policy._bands[signal]
    return max(band.dev, 1e-8, abs(band.mean) * 1e-3)


def _sequence(case):
    """``(config kwargs, [step inputs])``; an input is a dict of observe's
    arguments or a callable of the policy returning one (reads the bands)."""
    warm = [dict(loss=1.0)] * 8
    spike = lambda p: dict(loss=1.0 + 9.0 * _denom(p))  # noqa: E731  z ~ 9
    poison = lambda p: dict(loss=1.0 + 50.0 * _denom(p))  # noqa: E731
    cfg = dict(warmup_steps=4, spike_patience=2, hysteresis_steps=3)
    return cfg, {
        "warmup": [dict(loss=x) for x in (1.0, 500.0, 1.0, 500.0)],
        "calm": warm + [dict(loss=1.0)],
        "spike": warm + [spike],
        "poison": warm + [poison, dict(loss=1.0)],
        "patience": warm + [spike, spike, spike, dict(loss=1.0)],
        "hysteresis": warm + [spike] + [dict(loss=1.0)] * 4,
        "non_finite": [dict(loss=float("nan"), finite=False)] * 4,
        "grad_norm": [dict(loss=1.0, grad_norm=2.0)] * 8
                     + [lambda p: dict(loss=1.0, grad_norm=2.0 + 50.0 * _denom(p, "grad_norm"))],
        "drift": [dict(loss=3.0 - 0.1 * i, grad_norm=1.0 + 0.05 * i) for i in range(20)],
    }[case]


@pytest.mark.parametrize("case", ["warmup", "calm", "spike", "poison", "patience", "hysteresis",
                                  "non_finite", "grad_norm", "drift"])
def test_policy_verdicts_same(case):
    cfg, steps = _sequence(case)
    out = {}
    for mod in (TG, RG):
        policy = mod.GuardrailPolicy(mod.GuardrailConfig(**cfg))
        verdicts = []
        for step, inp in enumerate(steps):
            v = policy.observe(step, **(inp(policy) if callable(inp) else inp))
            verdicts.append((v.status, v.step, v.signal, v.z, v.reason, v.region))
        bands = {k: (b.mean, b.dev, b.n) for k, b in policy._bands.items()}
        out[mod] = (verdicts, bands, policy._seen, policy._episode_start)
    assert out[TG] == out[RG]
    statuses = [v[0] for v in out[TG][0]]
    assert {"spike": "spike", "poison": "poisoned", "patience": "poisoned",
            "grad_norm": "poisoned", "non_finite": "poisoned"}.get(case, "ok") in statuses


@pytest.mark.parametrize("replay", ["none", "skip", "clip"])
def test_replay_scale_same(replay):
    t, r = (m.GuardrailPolicy(m.GuardrailConfig(replay=replay)) for m in (TG, RG))
    for step, region in ((5, (4, 6)), (7, (4, 6)), (5, None), (4, (4, 4))):
        assert t.replay_scale(step, region) == r.replay_scale(step, region)
    assert t.replay_scale(5, (4, 6)) == {"none": 1.0, "skip": 0.0, "clip": 0.1}[replay]


# -- DigestVote, the ledger, the ring ---------------------------------------------------------
VOTES = {
    "majority": [("observe", 0, {"4": "a"}), ("observe", 1, {4: "a"}), ("observe", 2, {4: "b"}),
                 ("tally",), ("drop", 2), ("tally",)],
    "tie": [("observe", 0, {3: "a"}), ("observe", 1, {3: "b"}), ("tally",)],
    "single": [("observe", 0, {1: "a", 2: "b"}), ("tally",)],
    "watermark": [("observe", 0, {1: "x", 2: "y"}), ("observe", 1, {1: "x", 2: "y"}), ("tally",),
                  ("observe", 1, {2: "z"}), ("tally",), ("observe", 1, {3: "q"}),
                  ("observe", 0, {3: "w"}), ("tally",)],
    "earliest": [("observe", 0, {5: "a", 7: "a"}), ("observe", 1, {5: "b", 7: "b"}), ("tally",)],
    "empty": [("observe", 0, None), ("observe", 1, {}), ("tally",)],
}


@pytest.mark.parametrize("case", sorted(VOTES))
def test_digest_vote_same(case):
    def run(mod):
        vote, out = mod.DigestVote(), []
        for op, *a in VOTES[case]:
            if op == "observe":
                vote.observe(*a)
            elif op == "drop":
                vote.drop_rank(*a)
            else:
                r = vote.tally()
                out.append(None if r is None else (r.step, r.minority, r.digests))
        return out, vote.last_agreed_step

    assert run(TG) == run(RG)


def test_quarantine_ledger_round_trips_between_the_packages(tmp_path):
    path = tmp_path / "quarantine.json"
    ledger = TG.QuarantineLedger(path)
    assert 1 not in ledger
    entry = ledger.quarantine(1, reason="digest vote minority", step=6, digest="abc123")
    assert entry == {"host": "1", "reason": "digest vote minority", "step": 6,
                     "digest": "abc123"}
    ledger.quarantine(1, reason="again", step=9)  # idempotent per host
    ref = RG.QuarantineLedger(path)
    assert ref.entries == ledger.entries and 1 in ref and "1" in ref and 0 not in ref
    ref.quarantine(3, reason="x")
    assert TG.QuarantineLedger(path).hosts() == {"1", "3"}
    path.write_text("{not json")  # an unreadable ledger quarantines nobody
    assert TG.QuarantineLedger(path).hosts() == RG.QuarantineLedger(path).hosts() == set()


def test_attach_digest_ring_same():
    rings = {TG: {}, RG: {}}
    for mod, ring in rings.items():
        for step in range(20):
            mod.attach_digest_ring(ring, step, f"d{step}", cap=4)
    assert rings[TG] == rings[RG] and sorted(rings[TG]) == [16, 17, 18, 19]


# -- param_digest and the bitflip --------------------------------------------------------------
def _model(seed=0):
    return TransformerLM(TransformerConfig(vocab_size=256, num_layers=2, num_heads=4, head_dim=8,
                                           d_model=32, d_ff=64),
                         dtype=torch.float32, device="cpu").init_weights(seed)


def test_param_digest_and_in_place_bitflip(monkeypatch):
    monkeypatch.delenv("DMT_CHAOS_RANK", raising=False)
    model = _model()
    clean = param_digest(model)
    assert clean == param_digest(_model()) != param_digest(_model(1))
    assert param_digest(model, sample_leaves=1) != param_digest(model, sample_leaves=2)
    chaos = ChaosInjector(FaultPlan.parse("bitflip@step:2"))
    assert chaos.maybe_bitflip(model, step=1) is None  # not yet
    name, param = TG._digest_leaves(model, 1)[0]
    storage = param.data_ptr()
    assert chaos.maybe_bitflip(model, step=2) == name
    assert param_digest(model) != clean and param.data_ptr() == storage  # in place
    assert all(torch.isfinite(p).all() for p in model.parameters())  # silent, not a NaN
    assert chaos.maybe_bitflip(model, step=2) is None  # fire-once
    assert chaos.counts()[FAULT_INJECTED] == 1


# -- the kind audit ---------------------------------------------------------------------------
HOOKS = {"nan_grad": "maybe_poison", "kill": "check_kill", "corrupt_ckpt": "should_corrupt",
         "loader_stall": "loader_fault", "loader_die": "loader_fault",
         "loss_spike": "maybe_guard_fault", "grad_spike": "maybe_guard_fault",
         "nan_grads": "maybe_guard_fault", "bitflip": "maybe_bitflip",
         "rank_kill": "check_rank_fault", "rank_hang": "check_rank_fault"}


def test_every_training_kind_has_a_live_hook():
    assert set(HOOKS) == TRAIN_KINDS and TRAIN_KINDS <= set(FAULT_UNITS)
    for kind, hook in HOOKS.items():
        assert callable(getattr(ChaosInjector, hook)), (kind, hook)


@pytest.mark.parametrize("kind", sorted(set(FAULT_UNITS) - TRAIN_KINDS))
def test_a_trainer_refuses_each_serving_kind(kind):
    args = SimpleNamespace(chaos=f"{kind}@{FAULT_UNITS[kind]}:1")
    with pytest.raises(SystemExit, match=f"{kind}.*training workload"):
        config.build_chaos(args)
    assert kind in SERVE_KINDS or kind not in TRAIN_KINDS


def test_guard_kinds_refuse_a_trainer_without_a_policy():
    for kind in sorted(GUARD_KINDS):
        chaos = ChaosInjector(FaultPlan.parse(f"{kind}@step:1"))
        with pytest.raises(ValueError, match="guardrail"):
            Trainer(_factory()(), "lm", log=lambda m: None, chaos=chaos)


# -- the checkpointer's pin ----------------------------------------------------------------------
def _corrupting_chaos(from_epoch=1):
    return SimpleNamespace(should_corrupt=lambda *, epoch: epoch >= from_epoch,
                           record_rollback=lambda *a, **k: True,
                           record_recovery=lambda *a, **k: True)


def test_pin_survives_retention_with_all_younger_saves_corrupt(tmp_path):
    state = _factory()()
    ck = Checkpointer(tmp_path / "ck", max_to_keep=2, chaos=_corrupting_chaos())
    for epoch in range(4):
        ck.save(state, epoch=epoch)
    assert ck.last_good_epoch() == 0 and set(ck.all_steps()) == {0, 2, 3}
    restored, epoch = ck.restore_verified(_factory()())
    assert epoch == 0
    assert tree_digests(restored.params()) == tree_digests(state.params())


def test_rollback_to_last_good_discards_younger_steps_and_fences(tmp_path):
    ck = Checkpointer(tmp_path / "ck", max_to_keep=5, chaos=_corrupting_chaos())
    for epoch in range(3):
        ck.save(_factory()(), epoch=epoch)
    _, epoch = ck.rollback_to_last_good(_factory()())
    assert epoch == 0 and ck.all_steps() == [0] and ck._generation == 1
    atomic_write_json(ck.directory / "last_good.json", {"epoch": 0, "generation": 0})
    with pytest.raises(CheckpointCorruption, match="anti-rollback"):
        ck.last_good_epoch()


# -- the drills on the tiny LM ------------------------------------------------------------------
EPOCHS, BATCH, SEQS, SEQ = 3, 8, 24, 32  # 3 steps an epoch, 9 in all


def _factory(ema=False):
    init = {n: p.detach().clone() for n, p in _model().named_parameters()}

    def factory():
        model = _model()
        model.load_state_dict(init)
        return create_train_state(model, build_optimizer("sgd", 1e-2, momentum=0.0), ema=ema)

    return factory


def _loader(n=SEQS):
    return Loader(SyntheticTokens(n, SEQ), BATCH, shuffle=True, seed=0, device="cpu")


def _run(tmp, spec=None, *, warm=False):
    factory = _factory()
    chaos = ChaosInjector(FaultPlan.parse(spec)) if spec else None
    ck = Checkpointer(tmp / "ck", max_to_keep=5, chaos=chaos)
    trainer = Trainer(factory(), "lm", eval_every=1, log=lambda m: None, checkpointer=ck,
                      chaos=chaos, guardrails=GuardrailPolicy(), metrics=MetricsRegistry())
    loader = _loader()
    if warm:
        trainer.warmup(next(iter(loader.epoch(0))))
    if chaos is not None:
        chaos.bind_registry(trainer.metrics)
        loader = ResilientLoader(loader, chaos=chaos, batch_timeout_s=10.0, backoff_s=0.01,
                                 logger=trainer)
    args = SimpleNamespace(num_epochs=EPOCHS, max_restarts=2, eval_only=False,
                           restart_delay_s=0.01)
    config.execute(config.Run(args, trainer, loader, None, 0, factory))
    return SimpleNamespace(trainer=trainer, chaos=chaos, history=trainer.history,
                           snap=trainer.metrics.snapshot())


def _digests(trainer):
    return tree_digests({"p": trainer.state.params(), "o": trainer.state.opt_state})


@pytest.fixture(scope="module")
def spiked(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_guard")
    # x1000 loss at step 8 (epoch 2, past the 8-step warmup): the robust-z
    # clears z_poison, RollbackRequested, the pinned epoch 1 restored.
    return SimpleNamespace(spiked=_run(tmp / "s", "loss_spike@step:8"), clean=_run(tmp / "c"),
                           warmed=_run(tmp / "w", "loss_spike@step:8", warm=True))


def test_rollback_replays_onto_the_unfaulted_trajectory(spiked):
    s, c = spiked.spiked, spiked.clean
    assert s.trainer.state.step == EPOCHS * (SEQS // BATCH)
    assert [h["epoch"] for h in s.history] == [0, 1, 2]
    assert _digests(s.trainer) == _digests(c.trainer)
    clean = {h["epoch"]: h["loss"] for h in c.history}
    assert all(h["loss"] == clean[h["epoch"]] for h in s.history)


def test_books_reconcile_as_one_rollback(spiked):
    s = spiked.spiked
    assert s.chaos.balanced() and not s.chaos.unrecovered()
    assert s.snap[FAULT_INJECTED] == 1 and s.snap[ROLLBACK] == 1 and s.snap[RECOVERY] == 0
    assert s.snap["guard_poisoned_total"] == 1 and s.snap["guard_rollback_total"] == 1
    # Steps 0-8 (8 poisoned), then epoch 2's 3 steps again from the pin.
    assert s.snap["guard_checks_total"] == 9 + 3


def test_clean_run_draws_no_verdicts(spiked):
    snap = spiked.clean.snap
    assert snap["guard_checks_total"] == EPOCHS * (SEQS // BATCH)
    assert snap.get("guard_spike_total", 0) == 0 and snap.get("guard_poisoned_total", 0) == 0


def test_warmed_rollback_takes_the_eager_step_for_the_faulted_batch_only(spiked):
    w = spiked.warmed
    assert _digests(w.trainer) == _digests(spiked.clean.trainer)
    assert w.chaos.balanced() and w.snap["guard_rollback_total"] == 1
    assert w.trainer.train_step.fallback_calls == 1  # the batch with __loss_scale__


def test_nan_grads_is_tolerated_and_booked_as_recovery(tmp_path):
    s = _run(tmp_path, "nan_grads@step:4")
    assert [h["epoch"] for h in s.history] == [0, 1, 2]
    assert all(math.isfinite(h["loss"]) for h in s.history)
    assert s.snap[FAULT_INJECTED] == 1 and s.snap[RECOVERY] == 1 and s.snap[ROLLBACK] == 0
    assert s.snap["guard_spike_total"] == 1 and s.snap.get("guard_poisoned_total", 0) == 0
    assert s.chaos.balanced(), s.chaos.summary()


def test_nonfinite_epoch_stats():
    factory = _factory(ema=True)
    state = factory()
    with torch.no_grad():
        for p in state.model.parameters():
            p.fill_(float("nan"))
    trainer = Trainer(state, "lm", log=lambda m: None, ema_decay=0.5)
    ema = tree_digests(trainer.state.ema_params)
    stats = trainer.run_epoch(_loader(16), 0)
    assert math.isnan(stats["loss"]) and tree_digests(trainer.state.ema_params) == ema
    chaos = ChaosInjector(FaultPlan.parse("nan_grad@step:0"))
    trainer = Trainer(_factory()(), "lm", log=lambda m: None, chaos=chaos)
    chaos.bind_registry(trainer.metrics)
    stats = trainer.run_epoch(_loader(16), 0)
    assert math.isfinite(stats["loss"]) and chaos.balanced() and not chaos.unrecovered()


def test_costless_when_off(monkeypatch):
    batch = next(iter(_loader(16).epoch(0)))
    _, metrics = make_train_step("lm")(_factory()(), batch)
    assert "grad_norm" not in metrics
    _, metrics = make_train_step("lm", guard_metrics=True)(_factory()(), batch)
    assert "grad_norm" in metrics

    def boom(*args, **kwargs):
        raise AssertionError("guardrail machinery touched in off mode")

    monkeypatch.setattr(TG.GuardrailPolicy, "__init__", boom)
    monkeypatch.setattr(TG.DigestVote, "__init__", boom)
    monkeypatch.setattr(TG, "param_digest", boom)
    monkeypatch.setattr(Trainer, "_guard_observe", boom)
    reads = []
    monkeypatch.setattr(torch.Tensor, "__float__", lambda t: reads.append(1) or t.item())
    trainer = Trainer(_factory()(), "lm", log=lambda m: None, metrics_every=0)
    stats = trainer.run_epoch(_loader(16), 0)
    assert math.isfinite(stats["loss"])
    assert not any(k.startswith("guard_") for k in trainer.metrics.snapshot())
    assert not trainer._digest_ring and not trainer._step_kwargs["guard_metrics"]
    assert len(reads) == 2  # the epoch's finite count and loss sum, after the loop


def test_digest_ring_rides_the_heartbeat_and_shows_the_bitflip(tmp_path, monkeypatch):
    """The worker half of the pod's vote: with ``digest_every 1`` every
    step's parameter digest joins the ring on the heartbeat; a
    ``bitflip@step:1`` on this rank (the last of a world of one) changes
    the digests from step 1 on, and only this rank's."""
    from deeplearning_mpi_tpu_torch.resilience import GuardrailConfig, Heartbeat

    monkeypatch.delenv("DMT_CHAOS_RANK", raising=False)
    rings = {}
    for arm, spec in (("clean", None), ("flipped", "bitflip@step:1")):
        hb = Heartbeat(tmp_path / f"{arm}.json", interval_s=60.0).start()
        chaos = ChaosInjector(FaultPlan.parse(spec)) if spec else None
        trainer = Trainer(_factory()(), "lm", log=lambda m: None, heartbeat=hb, chaos=chaos,
                          guardrails=GuardrailPolicy(GuardrailConfig(digest_every=1)))
        trainer.run_epoch(_loader(), 0)
        hb.stop()  # writes the last beat
        beat = Heartbeat.read(tmp_path / f"{arm}.json")
        assert beat["step"] == 3 and beat["phase"] == "train"
        rings[arm] = beat["digests"]
    assert sorted(rings["clean"]) == ["0", "1", "2"]
    assert rings["clean"]["0"] == rings["flipped"]["0"]
    assert all(rings["clean"][s] != rings["flipped"][s] for s in ("1", "2"))
    vote = TG.DigestVote()
    vote.observe(0, rings["clean"])
    vote.observe(1, rings["clean"])
    vote.observe(2, rings["flipped"])
    assert vote.tally() == TG.VoteResult(1, (2,), {0: rings["clean"]["1"], 1: rings["clean"]["1"],
                                                   2: rings["flipped"]["1"]})
