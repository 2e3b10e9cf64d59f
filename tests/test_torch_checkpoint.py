"""The port's checkpoint, verified restore and resume, against the JAX package.

Mirrors ``tests/test_resilience.py``'s integrity primitives,
``TestCheckpointIntegrity`` and the ``GracefulShutdown`` / preempted-``fit``
cases on the port's ``train.checkpoint.Checkpointer`` (``torch.save`` step
directories, sha256 manifests), plus:

- ``tree_digests`` gives the JAX package's hex digests for the same f32,
  bf16 and int32 arrays;
- rollback to the pin, the anti-rollback generation fence, and retention
  keeping the pin;
- a template that differs in a name, shape or dtype is refused (a full
  restore raises, the verified walk passes it as corrupt); an EMA mismatch
  is refused both ways by the params-only restore, which never opens the
  optimizer state's file;
- the training CLI: 2 epochs equal 1 epoch + ``--resume`` to 2 bit for bit
  at f32, for adam and for adafactor (factored moments); a corrupted newest
  step rolls back; ``--eval_only`` reports the last eval; the ``arch.json``
  sidecar refuses a tree-invisible mismatch;
- a warmup + cosine schedule preempted after epoch 0 and resumed equals the
  uninterrupted run (the schedule's count rides the checkpoint);
- a checkpoint written by the JAX ``train_lm`` CLI and read by the JAX
  ``Checkpointer`` converts (``lm_params_from_jax``, ``opt_state_from_jax``)
  and continues 2 steps in the port within ``test_torch_train.py``'s atol
  5e-5 of 2 more JAX steps; the other optimizers' states convert too.
"""

import dataclasses
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.resilience.integrity import tree_digests as jax_tree_digests
from deeplearning_mpi_tpu.train import Checkpointer as JaxCheckpointer
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_lr_schedule as jax_lr_schedule
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.cli import train_lm
from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax, opt_state_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.resilience import (
    CheckpointCorruption,
    GracefulShutdown,
    Preempted,
    atomic_write_json,
    corrupt_checkpoint,
    manifest_path,
    read_manifest,
    tree_digests,
)
from deeplearning_mpi_tpu_torch.train import (
    Trainer,
    build_lr_schedule,
    build_optimizer,
    create_train_state,
    make_train_step,
)
from deeplearning_mpi_tpu_torch.train import checkpoint as checkpoint_module
from deeplearning_mpi_tpu_torch.train.checkpoint import CheckpointMismatch, Checkpointer

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

PARAM_TOL = dict(atol=5e-5, rtol=1e-4)


def _state(optimizer="sgd", *, ema=False, seed=0, lr=1e-2):
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32,
                          device="cpu").init_weights(seed)
    return create_train_state(model, build_optimizer(optimizer, lr), ema=ema)


def _digests(state):
    return tree_digests(state.arrays())


# -- integrity primitives -----------------------------------------------------

class TestIntegrityPrimitives:
    def test_atomic_write_json_round_trips_and_leaves_no_temp(self, tmp_path):
        path = tmp_path / "m.json"
        atomic_write_json(path, {"a": 1})
        atomic_write_json(path, {"a": 2})
        assert json.loads(path.read_text()) == {"a": 2}
        assert list(tmp_path.iterdir()) == [path]

    def test_tree_digests_deterministic_and_value_sensitive(self):
        tree = {"w": torch.arange(8, dtype=torch.float32), "b": {"c": torch.ones(3)}}
        d1 = tree_digests(tree)
        assert d1 == tree_digests({"w": tree["w"].clone(), "b": {"c": tree["b"]["c"].clone()}})
        assert set(d1) == {"['w']", "['b']['c']"}
        w = tree["w"].clone()
        w[0] = 7.0
        d3 = tree_digests({"w": w, "b": tree["b"]})
        assert d3["['w']"] != d1["['w']"] and d3["['b']['c']"] == d1["['b']['c']"]

    def test_tree_digests_cover_dtype_and_shape(self):
        assert (tree_digests({"x": torch.ones(4)})["['x']"]
                != tree_digests({"x": torch.ones(2, 2)})["['x']"])
        assert (tree_digests({"x": torch.zeros(4, dtype=torch.int32)})["['x']"]
                != tree_digests({"x": torch.zeros(4)})["['x']"])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
    def test_tree_digests_equal_the_jax_packages(self, dtype):
        """One array, one hex digest, in both packages (bf16 hashed by its
        16-bit pattern under the numpy name ``bfloat16``)."""
        rng = np.random.default_rng(3)
        arrays = {"a": rng.standard_normal((5, 7)).astype(np.float32) * 100,
                  "n": {"s": np.float32(1.5), "v": rng.standard_normal(3).astype(np.float32)}}
        if dtype == "int32":
            arrays = {"a": rng.integers(-9, 9, (5, 7)).astype(np.int32), "step": np.int32(12)}
        jtree = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), arrays)
        ttree = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype)),
                             arrays)
        assert tree_digests(ttree) == jax_tree_digests(jtree)

    def test_corrupt_checkpoint_flips_bytes_in_largest_file(self, tmp_path):
        small = tmp_path / "meta.json"
        small.write_bytes(b"{}")
        big = tmp_path / "arrays.bin"
        big.write_bytes(bytes(4096))
        assert corrupt_checkpoint(tmp_path, span=64) == big
        assert small.read_bytes() == b"{}"
        data = big.read_bytes()
        assert any(x != 0 for x in data) and len(data) == 4096


# -- the checkpointer ---------------------------------------------------------

class TestCheckpointIntegrity:
    def test_layout_is_one_file_per_key_beside_a_manifest(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck")
        ck.save(_state(ema=True), epoch=0)
        assert sorted(p.name for p in ck.step_dir(0).iterdir()) == [
            "ema_params.pt", "opt_state.pt", "params.pt", "step.pt"]
        assert set(read_manifest(ck.directory, 0)) == {
            "ema_params.pt", "opt_state.pt", "params.pt", "step.pt"}
        assert ck.last_good_epoch() == 0
        assert not [p for p in ck.directory.iterdir() if p.name.startswith("tmp-")]
        ck.save(_state(), epoch=1)  # EMA off: no ema_params file
        assert "ema_params.pt" not in {p.name for p in ck.step_dir(1).iterdir()}

    def test_restore_round_trips_every_tensor(self, tmp_path):
        state = _state("adam", ema=True)
        state = make_train_step("lm", ema_decay=0.5)(
            state, {"tokens": torch.randint(0, 256, (2, 16))})[0]
        ck = Checkpointer(tmp_path / "ck")
        ck.save(state, epoch=3)
        restored = ck.restore(_state("adam", ema=True, seed=1))
        assert restored.step == 1
        assert _digests(restored) == _digests(state)

    def test_restore_verified_rolls_back_past_corruption(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", max_to_keep=4)
        s0 = _state()
        ck.save(s0, epoch=0)
        ck.save(dataclasses.replace(s0, step=s0.step + 1), epoch=1)
        corrupt_checkpoint(ck.step_dir(1))
        state, epoch = ck.restore_verified(_state(seed=1))
        assert epoch == 0 and state.step == 0
        assert tree_digests(state.arrays()["params"]) == tree_digests(s0.arrays()["params"])

    def test_all_corrupt_history_raises(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", max_to_keep=4)
        ck.save(_state(), epoch=0)
        corrupt_checkpoint(ck.step_dir(0))
        with pytest.raises(CheckpointCorruption, match="tried epochs"):
            ck.restore_verified(_state())

    def test_step_without_manifest_restores_unverified(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck")
        ck.save(_state(), epoch=0)
        assert manifest_path(ck.directory, 0).exists()
        manifest_path(ck.directory, 0).unlink()
        assert read_manifest(ck.directory, 0) is None
        assert ck.restore_verified(_state())[1] == 0

    def test_manifest_retention_follows_max_to_keep(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", max_to_keep=2)
        state = _state()
        for epoch in range(4):
            ck.save(state, epoch=epoch)
        kept = sorted(int(p.stem.split("-", 1)[1]) for p in ck.directory.glob("manifest-*.json"))
        assert kept == ck.all_steps() == [2, 3]

    def test_retention_keeps_the_pin(self, tmp_path, monkeypatch):
        """Saves that no longer hash clean when re-read are never pinned,
        and retention keeps the pinned step however old it gets."""
        ck = Checkpointer(tmp_path / "ck", max_to_keep=2)
        state = _state()
        ck.save(state, epoch=0)
        real, calls = checkpoint_module.dir_digests, []

        def torn_on_reread(path):  # the manifest's hash, then a re-read that differs
            calls.append(path)
            out = real(path)
            return out if len(calls) % 2 else {k: "0" * 64 for k in out}

        monkeypatch.setattr(checkpoint_module, "dir_digests", torn_on_reread)
        for epoch in (1, 2, 3):
            ck.save(state, epoch=epoch)
        assert ck.last_good_epoch() == 0
        assert ck.all_steps() == [0, 2, 3]
        assert manifest_path(ck.directory, 0).exists()

    def test_rollback_to_last_good_discards_younger_steps_and_fences(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", max_to_keep=5)
        s0 = _state()
        ck.save(s0, epoch=0)
        pin = json.loads((ck.directory / "last_good.json").read_text())
        ck.save(dataclasses.replace(s0, step=7), epoch=1)
        ck.save(dataclasses.replace(s0, step=9), epoch=2)
        (ck.directory / "last_good.json").write_text(json.dumps(pin))  # pin epoch 0
        state, epoch = ck.rollback_to_last_good(_state(seed=2))
        assert epoch == 0 and state.step == 0 and ck.all_steps() == [0]
        assert json.loads((ck.directory / "last_good.json").read_text()) == {
            "epoch": 0, "generation": 1}
        # A stale pin (an older generation) is refused by this process.
        (ck.directory / "last_good.json").write_text(json.dumps(pin))
        with pytest.raises(CheckpointCorruption, match="anti-rollback"):
            ck.last_good_epoch()

    def test_rollback_past_a_corrupt_pin_takes_the_verified_walk(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", max_to_keep=5)
        ck.save(_state(), epoch=0)
        ck.save(_state(), epoch=1)
        corrupt_checkpoint(ck.step_dir(1))  # the pin (epoch 1) no longer hashes clean
        assert ck.rollback_to_last_good(_state())[1] == 0
        assert ck.last_good_epoch() == 0

    @pytest.mark.parametrize("other", [
        dict(optimizer="adam"), dict(ema=True),
        dict(model=TransformerConfig(vocab_size=256, num_layers=2, num_heads=4, head_dim=8,
                                     d_model=32, d_ff=48)),
    ], ids=["optimizer", "ema", "shape"])
    def test_mismatched_template_is_refused(self, tmp_path, other):
        ck = Checkpointer(tmp_path / "ck")
        ck.save(_state(), epoch=0)
        if "model" in other:
            model = TransformerLM(other["model"], dtype=torch.float32, device="cpu")
            template = create_train_state(model, build_optimizer("sgd", 1e-2))
        else:
            template = _state(**other)
        with pytest.raises(CheckpointMismatch):
            ck.restore(template)
        with pytest.raises(CheckpointCorruption):
            ck.restore_verified(template)

    def test_params_only_restore_refuses_ema_mismatch_both_ways(self, tmp_path):
        plain, with_ema = Checkpointer(tmp_path / "a"), Checkpointer(tmp_path / "b")
        plain.save(_state(), epoch=0)
        with_ema.save(_state(ema=True), epoch=0)
        model = lambda: TransformerLM(TransformerConfig.tiny(), dtype=torch.float32,  # noqa: E731
                                      device="cpu")
        with pytest.raises(ValueError, match="drop --ema"):
            plain.restore_params_only(create_train_state(model(), None, ema=True))
        with pytest.raises(ValueError, match="pass --ema"):
            with_ema.restore_params_only(create_train_state(model(), None))
        # The optimizer state's file is never opened: damage it, remove it.
        (with_ema.step_dir(0) / "opt_state.pt").write_bytes(b"not a checkpoint")
        got = with_ema.restore_params_only(create_train_state(model(), None, ema=True))
        want = _state(ema=True)
        assert tree_digests(got.arrays()["params"]) == tree_digests(want.arrays()["params"])
        assert tree_digests(got.ema_params) == tree_digests(want.ema_params)
        (with_ema.step_dir(0) / "opt_state.pt").unlink()
        assert with_ema.restore_params_only(create_train_state(model(), None, ema=True)).step == 0


# -- preemption ---------------------------------------------------------------

class TestGracefulShutdown:
    def test_manual_request_latches(self):
        gs = GracefulShutdown()
        assert not gs.requested()
        gs.request()
        assert gs.requested()

    def test_sigterm_sets_the_flag_and_uninstall_restores(self):
        gs = GracefulShutdown().install()
        if not gs.installed:
            pytest.skip("not on the main thread; install degraded")
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + 2.0
            while not gs.requested() and time.monotonic() < deadline:
                time.sleep(0.005)
            assert gs.requested()
        finally:
            gs.uninstall()
        assert signal.getsignal(signal.SIGTERM) is not gs._handler

    def test_preempted_fit_checkpoints_and_raises(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck")
        loader = Loader(SyntheticTokens(16, 16), 8, shuffle=False, device="cpu")
        shutdown = GracefulShutdown()
        trainer = Trainer(_state(), "lm", checkpointer=ck, eval_every=1, shutdown=shutdown,
                          log=lambda msg: None)
        shutdown.request()
        with pytest.raises(Preempted) as exc:
            trainer.fit(loader, num_epochs=3)
        assert exc.value.epoch == 0 and ck.latest_epoch() == 0


def test_preempted_schedule_run_resumes_onto_the_uninterrupted_trajectory(tmp_path):
    """Warmup + cosine over 3 epochs: preempted after epoch 0, then resumed
    from its checkpoint, the run ends bit-identical to an uninterrupted one
    (a restore that dropped the optimizer's count would restart the warmup)."""
    loader = Loader(SyntheticTokens(24, 16, seed=4), 8, seed=4, device="cpu")

    def fresh():
        lr = build_lr_schedule(1e-2, "cosine", warmup_steps=2, decay_steps=9)
        model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32,
                              device="cpu").init_weights(0)
        return create_train_state(model, build_optimizer("adam", lr, clip_norm=1.0), ema=True)

    quiet = dict(log=lambda msg: None, ema_decay=0.9, eval_every=10)
    whole = Trainer(fresh(), checkpointer=Checkpointer(tmp_path / "a"), **quiet)
    whole.fit(loader, 3)
    ck = Checkpointer(tmp_path / "b")
    shutdown = GracefulShutdown()
    shutdown.request()
    with pytest.raises(Preempted):
        Trainer(fresh(), checkpointer=ck, shutdown=shutdown, **quiet).fit(loader, 3)
    state, epoch = ck.restore_verified(fresh())
    assert epoch == 0 and int(state.opt_state["count"]) == 3
    resumed = Trainer(state, checkpointer=ck, **quiet)
    resumed.fit(loader, 3, start_epoch=epoch + 1)
    assert _digests(resumed.state) == _digests(whole.state)
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in whole.history[1:]]


# -- the training CLI -----------------------------------------------------------

CLI = ["--device", "cpu", "--num_layers", "2", "--num_heads", "2", "--head_dim", "8",
       "--seq_len", "32", "--batch_size", "4", "--train_sequences", "40",
       "--learning_rate", "1e-2", "--attention", "flash"]
FACTORED = ["--d_model", "128", "--d_ff", "128"]  # adafactor factors the 128-wide weights
SMALL = ["--d_model", "16", "--d_ff", "32"]


@pytest.mark.parametrize("opt", ["adam", "adafactor"])
def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, opt, capsys):
    args = CLI + FACTORED + ["--optimizer", opt]
    a = train_lm.train(args + ["--num_epochs", "2", "--model_dir", str(tmp_path / "a")])
    b = train_lm.train(args + ["--num_epochs", "1", "--model_dir", str(tmp_path / "b")])
    b2 = train_lm.train(args + ["--num_epochs", "2", "--model_dir", str(tmp_path / "b"),
                                "--resume"])
    assert "resumed from verified epoch 0" in capsys.readouterr().out
    assert b2.state.step == a.state.step == 18
    assert _digests(b2.state) == _digests(a.state)
    assert b.history[0]["loss"] == a.history[0]["loss"]
    assert b2.history[-1]["loss"] == a.history[1]["loss"]
    assert b2.history[-1]["eval_loss"] == a.history[1]["eval_loss"]
    if opt == "adafactor":
        assert b2.state.opt_state["v_row"]["embed.weight"].shape == (128,)
    # The restored state is the saved one.
    restored = Checkpointer(tmp_path / "a" / "lm").restore(a.state)
    assert _digests(restored) == _digests(a.state)


def test_cli_rolls_back_evaluates_and_guards_the_architecture(tmp_path, capsys):
    model_dir = str(tmp_path / "m")
    base = CLI + SMALL + ["--num_epochs", "2", "--model_dir", model_dir]
    a = train_lm.train(base)
    final_eval = a.history[-1]["eval_loss"]
    # --eval_only restores the newest step and reports its eval loss.
    ev = train_lm.train(base + ["--eval_only"])
    assert len(ev.history) == 1 and ev.history[0]["loss"] == final_eval
    # A corrupted newest step: --resume rolls back and retrains epoch 1.
    corrupt_checkpoint(tmp_path / "m" / "lm" / "1")
    capsys.readouterr()
    again = train_lm.train(base + ["--resume"])
    out = capsys.readouterr().out
    assert "checkpoint epoch 1 CORRUPT — rolling back" in out
    assert "resumed from verified epoch 0" in out
    assert _digests(again.state) == _digests(a.state)
    # An all-corrupt history: --resume starts fresh, --eval_only finds nothing.
    for epoch in (0, 1):
        corrupt_checkpoint(tmp_path / "m" / "lm" / str(epoch))
    train_lm.train(base + ["--num_epochs", "1", "--resume"])
    assert "starting fresh" in capsys.readouterr().out
    assert train_lm.main(CLI + SMALL + ["--model_dir", str(tmp_path / "none"), "--eval_only"]) == 1
    assert "no checkpoint" in capsys.readouterr().err
    # arch.json: a tree-invisible mismatch is refused on resume and on a
    # fresh run into the directory; without the sidecar the flags decide.
    assert train_lm.main(base + ["--attention_window", "8", "--resume"]) == 1
    assert train_lm.main(base + ["--attention_window", "8"]) == 1
    assert "attention_window: checkpoint=0, flags=8" in capsys.readouterr().err
    (tmp_path / "m" / "lm" / "arch.json").unlink()
    assert train_lm.main(base + ["--attention_window", "8", "--num_epochs", "1"]) == 0


# -- JAX checkpoints continue in the port ---------------------------------------

JAX_SHAPE = ["--seq_len", "32", "--num_layers", "2", "--num_heads", "2", "--head_dim", "8",
             "--d_model", "128", "--d_ff", "128"]


def _port_state(cfg, jparams, jopt, optimizer, lr, step, **opt_kw):
    model = TransformerLM(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jparams))
    state = create_train_state(model, build_optimizer(optimizer, lr, clip_norm=1.0, **opt_kw))
    return dataclasses.replace(state, step=step, opt_state=opt_state_from_jax(jopt, optimizer))


def _continue_both(jstate, tstate, n, seed):
    ds = SyntheticTokens(4 * n, 32, seed=seed)
    jstep, tstep = jax_make_step("lm", donate=False), make_train_step("lm")
    for i in range(n):
        tokens = np.stack([ds[4 * i + j]["tokens"] for j in range(4)])
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, _ = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
    return jstate, tstate


def _assert_params_match(jparams, model):
    want = lm_params_from_jax(jax.device_get(jparams))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_jax_cli_checkpoint_continues_in_the_port(tmp_path, optimizer):
    from deeplearning_mpi_tpu.cli import train_lm as jax_train_lm

    rc = jax_train_lm.main(JAX_SHAPE + [
        "--num_epochs", "1", "--batch_size", "8", "--train_sequences", "24",
        "--eval_every", "1", "--optimizer", optimizer, "--learning_rate", "1e-3",
        "--model_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
    ])
    assert rc == 0
    jc = dataclasses.replace(JaxConfig.tiny(), num_heads=2, d_model=128, d_ff=128)
    jm = JaxLM(config=jc, dtype=jnp.float32)
    template = jax_create_state(jm, jax.random.key(0), jnp.zeros((1, 32), jnp.int32),
                                jax_optimizer(optimizer, 1e-3, clip_norm=1.0))
    ck = JaxCheckpointer(tmp_path / "ckpt" / "lm")
    jstate, epoch = ck.restore_verified(template)
    ck.close()
    assert epoch == 0 and int(jstate.step) == 2
    tc = TransformerConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(TransformerConfig)})
    host = jax.device_get(jstate)
    tstate = _port_state(tc, host.params, host.opt_state, optimizer, 1e-3, int(jstate.step))
    assert int(tstate.opt_state["count"]) == 2
    jstate, tstate = _continue_both(jstate, tstate, 2, seed=5)
    assert int(tstate.opt_state["count"]) == int(jstate.step) == 4
    _assert_params_match(jstate.params, tstate.model)


@pytest.mark.parametrize("optimizer, schedule, kw", [
    ("sgd", ("cosine", 2, 10), {"weight_decay": 0.01}),
    ("sgd", ("constant", 0, 0), {}),
    ("adamw", ("linear", 1, 10), {"weight_decay": 0.1}),
    ("lion", ("constant", 2, 0), {"weight_decay": 0.1}),
    ("adafactor", ("cosine", 1, 10), {"weight_decay": 0.01}),
], ids=["sgd_cosine", "sgd_constant", "adamw_linear", "lion_warmup", "adafactor_decay"])
def test_every_optimizer_state_converts_and_continues(optimizer, schedule, kw):
    """A JAX state after 2 steps (each optimizer with a schedule, whose
    count rides the state) converts with ``opt_state_from_jax`` and
    continues 2 steps in the port within atol 5e-5 of JAX."""
    name, warmup, decay = schedule
    jc = dataclasses.replace(JaxConfig.tiny(), d_model=128, d_ff=128)
    jm = JaxLM(config=jc, dtype=jnp.float32)
    jlr = jax_lr_schedule(1e-3, name, warmup_steps=warmup, decay_steps=decay)
    jstate = jax_create_state(jm, jax.random.key(1), jnp.zeros((1, 32), jnp.int32),
                              jax_optimizer(optimizer, jlr, clip_norm=1.0, **kw))
    jstep = jax_make_step("lm", donate=False)
    ds = SyntheticTokens(8, 32, seed=6)
    for i in range(2):
        tokens = np.stack([ds[4 * i + j]["tokens"] for j in range(4)])
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(tokens)})
    tc = TransformerConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(TransformerConfig)})
    host = jax.device_get(jstate)
    lr = build_lr_schedule(1e-3, name, warmup_steps=warmup, decay_steps=decay)
    tstate = _port_state(tc, host.params, host.opt_state, optimizer, lr, 2, **kw)
    assert int(tstate.opt_state["count"]) == (0 if optimizer == "sgd" and name == "constant"
                                              else 2)
    jstate, tstate = _continue_both(jstate, tstate, 2, seed=7)
    _assert_params_match(jstate.params, tstate.model)
