"""``Trainer.warmup``, ``train_lm --aot_warmup`` / ``--tuned_step`` and Adam
without host tensors, on the CPU.

On the CPU there is no CUDA graph: warmup builds the same static-buffer
program (static batch buffers, the static optimizer state and EMA the
trainer's state then holds, static metric outputs handed out as clones)
and runs it eagerly, so these cases hold what a capture must keep:

- the state after warmup is bitwise the state before (warmup runs the
  step, then puts everything back);
- a warmed trainer's 3 steps (losses, parameters, Adam moments, EMA,
  ``count``) are bitwise the unwarmed trainer's, dense with EMA and the
  MoE LM;
- the registry's 3 step records hold 3 different losses, each the
  unwarmed run's: a record that kept the program's static output would
  read the last step's loss three times;
- a batch of another shape runs the eager step (one ``fallback_calls``)
  and the next warmed step still equals the unwarmed run's;
- a layout that is not captured is refused (ROADMAP item 9.1b).

Adam's bias correction with Python-scalar bases is held to ``optax.adam``
over 40 updates. ``train_lm --tuned_step`` applies a DB entry (remat,
``grad_accum``) and a corrupt DB keeps the defaults; ``--aot_warmup`` trains
the unwarmed run's losses.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from deeplearning_mpi_tpu_torch.cli import train_lm
from deeplearning_mpi_tpu_torch.compiler import autotune
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd
from deeplearning_mpi_tpu_torch.resilience.integrity import tree_digests
from deeplearning_mpi_tpu_torch.telemetry import InMemorySink, MetricsRegistry
from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

B, S = 4, 16


class _Batches:
    """A loader of fixed batches."""

    def __init__(self, batches) -> None:
        self.batches = batches

    def epoch(self, epoch):
        return iter(self.batches)


def _batches(n, vocab=256, rows=B, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.from_numpy(rng.integers(0, vocab, (rows, S)))} for _ in range(n)]


def _trainer(cfg, *, warm: bool, ema: float = 0.9):
    model = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    state = create_train_state(model, build_optimizer("adam", 1e-2, clip_norm=1.0),
                               attention_fn=flash_attention_bhsd, ema=ema > 0)
    sink = InMemorySink()
    trainer = Trainer(state, "lm", ema_decay=ema, log=lambda msg: None,
                      metrics=MetricsRegistry([sink]),
                      aux_weight=0.01 if cfg.moe_experts else 0.0)
    if warm:
        trainer.warmup(_batches(1, cfg.vocab_size, seed=9)[0])
    return trainer, sink


def _state_tree(trainer):
    st = trainer.state
    return {"params": {n: p.detach() for n, p in st.model.named_parameters()},
            "opt": st.opt_state, "ema": st.ema_params or {}}


def test_warmup_leaves_the_state_bitwise():
    trainer, _ = _trainer(TransformerConfig.tiny(), warm=False)
    before = tree_digests(_state_tree(trainer))
    trainer.warmup(_batches(1, seed=9)[0])
    assert tree_digests(_state_tree(trainer)) == before
    assert trainer.state.step == 0
    assert trainer.metrics.gauge("train_compile_seconds").value > 0


@pytest.mark.parametrize("cfg", [TransformerConfig.tiny(), TransformerConfig.tiny_moe()],
                         ids=["dense_ema", "moe"])
def test_warmed_steps_are_bitwise_the_unwarmed(cfg):
    batches = _batches(3, cfg.vocab_size)
    runs = {}
    for warm in (False, True):
        trainer, sink = _trainer(cfg, warm=warm)
        trainer.run_epoch(_Batches(batches), 0)
        runs[warm] = (tree_digests(_state_tree(trainer)),
                      [r["loss"] for r in sink.records if r["kind"] == "step"],
                      int(trainer.state.opt_state["count"]))
    assert runs[True][0] == runs[False][0]  # parameters, moments, EMA, count
    assert runs[True][1] == runs[False][1] and len(set(runs[True][1])) == 3
    assert runs[True][2] == runs[False][2] == 3


def test_shape_drift_runs_the_eager_step():
    batches = _batches(3)
    other = _batches(1, rows=2 * B, seed=5)[0]
    runs = {}
    for warm in (False, True):
        trainer, _ = _trainer(TransformerConfig.tiny(), warm=warm)
        losses = []
        for batch in (batches[0], other, batches[1]):
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            losses.append(float(metrics["loss"]))
        runs[warm] = (losses, tree_digests(_state_tree(trainer)))
        if warm:
            assert trainer.train_step.fallback_calls == 1
    assert runs[True] == runs[False]


def test_warmup_refuses_a_layout_it_does_not_capture():
    trainer, _ = _trainer(TransformerConfig.tiny(), warm=False)
    trainer.zero = True
    with pytest.raises(ValueError, match="item 9.1b"):
        trainer.warmup(_batches(1)[0])


def test_adam_bias_correction_matches_optax():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    tx = build_optimizer("adam", 1e-3)
    ours = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    state = tx.init(ours, {n: None for n in ours})
    ref_tx = optax.adam(1e-3)
    theirs = {n: jnp.asarray(v) for n, v in params.items()}
    ref_state = ref_tx.init(theirs)
    for _ in range(40):
        grads = {n: rng.normal(size=v.shape).astype(np.float32) * 1e-2
                 for n, v in params.items()}
        updates, state = tx.update({n: torch.from_numpy(g) for n, g in grads.items()}, state,
                                   ours, leaves=None)
        ref_updates, ref_state = ref_tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                                               ref_state, theirs)
        for n in params:
            np.testing.assert_allclose(updates[n].numpy(), np.asarray(ref_updates[n]),
                                       rtol=1e-5, atol=1e-9)
            ours[n] += updates[n]
            theirs[n] = theirs[n] + ref_updates[n]


TINY = ["--device", "cpu", "--num_layers", "2", "--num_heads", "2", "--head_dim", "8",
        "--d_model", "16", "--d_ff", "32", "--seq_len", "32", "--batch_size", "4",
        "--train_sequences", "40", "--num_epochs", "1", "--learning_rate", "1e-2"]


def _losses(trainer):
    return [h["loss"] for h in trainer.history]


def test_train_lm_tuned_step_and_aot_warmup(tmp_path, capsys):
    db = autotune.TuningDB(tmp_path / "tuned.json")
    db.record_key(autotune.step_tuning_key("lm", (4, 32), None, torch.float32, "cpu"),
                  {"remat": "dots", "grad_accum": 2, "overlap": False}, best_seconds=0.01)
    db.save()
    tuned = train_lm.train([*TINY, "--tuned_step", str(tmp_path / "tuned.json")])
    out = capsys.readouterr().out
    assert "tuned step schedule" in out and "'grad_accum': 2" in out
    assert tuned.state.model.remat == "dots" and tuned._step_kwargs["grad_accum"] == 2
    (tmp_path / "bad.json").write_text("{not json")
    plain = train_lm.train([*TINY, "--tuned_step", str(tmp_path / "bad.json")])
    assert "using flag defaults" in capsys.readouterr().out
    assert plain.state.model.remat == "none" and plain._step_kwargs["grad_accum"] == 1
    np.testing.assert_allclose(_losses(tuned), _losses(plain), rtol=1e-5)
    warmed = train_lm.train([*TINY, "--aot_warmup"])
    assert "warmup: no CUDA graph on cpu" in capsys.readouterr().out
    assert _losses(warmed) == _losses(plain)


def test_tuning_db_entry_is_what_cli_autotune_writes(tmp_path):
    from deeplearning_mpi_tpu_torch.cli import autotune as cli

    assert cli.main(["--device", "cpu", "--db", str(tmp_path / "t.json"), "--step", "4x16",
                     "--grad_accums", "1", "--verify_steps", "2", "--repeats", "1"]) == 0
    entries = json.loads((tmp_path / "t.json").read_text())["entries"]
    (key,) = entries
    assert key == "step|lm|4x16|1|float32|cpu"
    assert {c["remat"] for c in entries[key]["candidates"]} == {"none", "dots", "full"}
    assert cli.main(["--device", "cpu", "--attn_shape", "1x64x2x16"]) == 1
