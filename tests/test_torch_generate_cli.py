"""The port's train -> generate / serve workflow, on the CPU.

Mirrors ``tests/test_generate_cli.py`` (without ``--tp``): the port's
``cli.generate`` restores what the port's ``cli.train_lm`` saved
(params-only: any optimizer's checkpoint serves with no optimizer flag),
the ``arch.json`` sidecar refuses a tree-invisible mismatch, ``--ema``
decodes the averaged weights and a mismatch either way is refused,
``--quantize int8`` decodes, and the argv checks refuse before any restore.
Beyond it: the CLI's greedy, beam and ragged (``--prompts_file``) outputs
equal the library's on the restored model, each ragged row its solo greedy
run; ``--time`` reports; ``cli.serve_lm --model_dir --selftest`` serves the
restored weights token-identical to offline greedy.
"""

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu_torch.cli import generate, serve_lm, train_lm
from deeplearning_mpi_tpu_torch.models.generate import beam_search
from deeplearning_mpi_tpu_torch.models.generate import generate as lib_generate

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

SHAPE = ["--num_layers", "2", "--num_heads", "2", "--head_dim", "8", "--d_model", "16",
         "--d_ff", "32"]
TRAIN = SHAPE + ["--device", "cpu", "--seq_len", "32", "--num_epochs", "1", "--batch_size", "8",
                 "--train_sequences", "24", "--eval_every", "1", "--learning_rate", "1e-2"]


def _gen(model_dir, *extra):
    return ["--device", "cpu", "--model_dir", str(model_dir), *SHAPE, *extra]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("ckpt")
    assert train_lm.main(TRAIN + ["--model_dir", str(model_dir)]) == 0
    return model_dir


def test_train_then_generate(ckpt, capsys):
    assert generate.main(_gen(ckpt, "--prompt", "hello", "--max_new_tokens", "8",
                              "--greedy")) == 0
    assert capsys.readouterr().out.startswith("hello")


@pytest.mark.parametrize("opt_flags", [["--optimizer", "lion"],
                                       ["--optimizer", "adafactor", "--weight_decay", "0.01"]],
                         ids=["lion", "adafactor_wd"])
def test_generate_from_any_optimizer_checkpoint(tmp_path, capsys, opt_flags):
    assert train_lm.main(TRAIN + ["--model_dir", str(tmp_path)] + opt_flags) == 0
    capsys.readouterr()
    assert generate.main(_gen(tmp_path, "--prompt", "hi", "--max_new_tokens", "4",
                              "--greedy")) == 0
    assert capsys.readouterr().out.startswith("hi")


def test_arch_sidecar_guards_tree_invisible_flags(tmp_path, capsys):
    base = TRAIN + ["--model_dir", str(tmp_path)]
    assert train_lm.main(base + ["--attention_window", "8"]) == 0
    gen = _gen(tmp_path, "--prompt", "hi", "--max_new_tokens", "4", "--greedy")
    assert generate.main(gen) == 1
    assert "attention_window: checkpoint=8, flags=0" in capsys.readouterr().err
    assert generate.main(gen + ["--attention_window", "8"]) == 0
    assert train_lm.main(base + ["--attention_window", "16", "--resume"]) == 1
    assert train_lm.main(base + ["--attention_window", "16"]) == 1
    (tmp_path / "lm" / "arch.json").unlink()
    assert generate.main(gen) == 0


def test_gqa_window_train_then_generate(tmp_path, capsys):
    """Grouped K/V heads and a sliding window through one train -> generate
    cycle (the reference's composition sweep, without MoE)."""
    shape = ["--num_heads", "4", "--num_kv_heads", "2", "--attention_window", "8"]
    assert train_lm.main(TRAIN + shape + ["--model_dir", str(tmp_path)]) == 0
    capsys.readouterr()
    assert generate.main(_gen(tmp_path, *shape, "--prompt", "hello", "--max_new_tokens",
                              "8", "--greedy")) == 0
    assert capsys.readouterr().out.startswith("hello")


def test_ema_checkpoint_generates_and_refuses_mismatch_both_ways(tmp_path, ckpt, capsys):
    assert train_lm.main(TRAIN + ["--model_dir", str(tmp_path), "--ema", "0.9"]) == 0
    capsys.readouterr()
    gen = _gen(tmp_path, "--prompt", "hi", "--max_new_tokens", "4", "--greedy")
    assert generate.main(gen + ["--ema", "0.9"]) == 0
    assert capsys.readouterr().out.startswith("hi")
    assert generate.main(gen) == 1
    assert "failed to restore" in capsys.readouterr().err
    assert generate.main(_gen(ckpt, "--prompt", "hi", "--greedy", "--ema", "0.9")) == 1
    err = capsys.readouterr().err
    assert "failed to restore" in err and "drop --ema" in err


def test_ema_flag_range_validated():
    for bad in ("1.0", "-0.1"):
        with pytest.raises(SystemExit):
            generate.build_parser().parse_args(["--model_dir", "x", "--ema", bad])


def test_generate_quantized_from_checkpoint(ckpt, capsys):
    assert generate.main(_gen(ckpt, "--prompt", "hello", "--max_new_tokens", "8", "--greedy",
                              "--quantize", "int8")) == 0
    assert capsys.readouterr().out.startswith("hello")


def test_generate_missing_checkpoint_fails_cleanly(tmp_path, capsys):
    assert generate.main(_gen(tmp_path / "nope", "--max_new_tokens", "4")) == 1
    assert "no checkpoint" in capsys.readouterr().err


@pytest.mark.parametrize("argv, message", [
    (["--eos_id", "300"], "outside the byte vocab"),
    (["--length_penalty", "0.6"], "requires --eos_id"),
    (["--length_penalty", "0.6", "--eos_id", "10"], "only applies to --num_beams > 1"),
    (["--prompt", "a", "--prompts_file", "p.txt"], "mutually exclusive"),
    (["--prompts_file", "p.txt", "--num_beams", "2"], "single-prompt"),
], ids=["eos_range", "penalty_no_eos", "penalty_one_beam", "prompt_and_file", "file_and_beams"])
def test_argv_checks_refuse_before_any_restore(tmp_path, capsys, argv, message):
    assert generate.main(_gen(tmp_path / "nope", *argv)) == 1
    assert message in capsys.readouterr().err


def _restored(ckpt):
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig
    from deeplearning_mpi_tpu_torch.utils.config import restore_lm

    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=2, head_dim=8, d_model=16,
                            d_ff=32)
    return restore_lm(cfg, dtype=torch.float32, device=torch.device("cpu"), model_dir=ckpt)


def test_cli_outputs_equal_the_library_on_the_restored_model(ckpt, tmp_path, capsys):
    model = _restored(ckpt)
    prompt = torch.tensor([list(b"tokens")])
    got = generate.run(_gen(ckpt, "--prompt", "tokens", "--max_new_tokens", "6", "--greedy",
                            "--time"))
    want = lib_generate(model, prompt, max_new_tokens=6, temperature=0.0)
    np.testing.assert_array_equal(got.tokens, want.numpy())
    assert got.timing["decode_steps"] == 5
    got = generate.run(_gen(ckpt, "--prompt", "tokens", "--max_new_tokens", "6",
                            "--num_beams", "3", "--eos_id", "10", "--length_penalty", "0.6",
                            "--time"))
    want = beam_search(model, prompt, max_new_tokens=6, num_beams=3, eos_id=10,
                       length_penalty=0.6)
    np.testing.assert_array_equal(got.tokens, want.numpy())
    assert got.timing["positions"] == 6
    prompts = ["hello there", "ab", "xyz", "a longer one"]
    path = tmp_path / "prompts.txt"
    path.write_text("\n".join(prompts) + "\n")
    capsys.readouterr()
    assert generate.main(_gen(ckpt, "--prompts_file", str(path), "--max_new_tokens", "5",
                              "--greedy")) == 0
    assert capsys.readouterr().out.startswith("hello there")
    got = generate.run(_gen(ckpt, "--prompts_file", str(path), "--max_new_tokens", "5",
                            "--greedy", "--time"))
    assert got.timing["positions"] == 4 * (12 + 5 - 2)
    for text, window in zip(prompts, got.windows()):
        solo = lib_generate(model, torch.tensor([list(text.encode())]), max_new_tokens=5,
                            temperature=0.0)
        np.testing.assert_array_equal(window, solo[0].numpy())
    path.write_text("a\n\nb\n")
    assert generate.main(_gen(ckpt, "--prompts_file", str(path), "--greedy")) == 1
    assert "blank prompt line" in capsys.readouterr().err


def test_serve_lm_serves_the_restored_weights(ckpt, capsys):
    argv = ["--device", "cpu", "--model_dir", str(ckpt), *SHAPE, "--num_requests", "6",
            "--max_new_tokens", "6"]
    assert serve_lm.main(argv + ["--selftest"]) == 0
    assert "selftest OK: 6 requests" in capsys.readouterr().err
    assert serve_lm.main(argv + ["--attention_window", "4", "--selftest"]) == 1
    assert "attention_window" in capsys.readouterr().err
    assert serve_lm.main(argv) == 0
    assert capsys.readouterr().out.count("\n[") == 5
