"""Generation from the port's MoE LM against ``deeplearning_mpi_tpu``'s, and the refusals.

Weights go across with ``lm_params_from_jax``; prompts are numpy-seeded.
float32 on the CPU at ``TransformerConfig.tiny_moe()`` with the capacity
factor of ``tests/test_generate.py``'s ``_moe_droppy_cfg`` (0.5): there the
batched forward over a whole prompt drops tokens that the position-by-
position walk keeps, so the reference prefills an MoE model stepwise and so
must the port.

- Greedy ``generate`` is token-identical to JAX's, on uniform prompts and
  on ragged ``prompt_lens`` (with and without a shared prefix); the
  prefill's logits equal JAX's within 1e-5, and differ from the batched
  forward's on this config.
- The MoE prefill equals the port's own stepwise decode walk (the ragged
  path with every row full); ``beam_search`` with one beam equals greedy.
- The CLIs: ``train_lm --moe_experts`` checkpoints and logs the dropped
  fraction, ``generate --moe_experts --greedy`` on that checkpoint equals
  the library on the restored model, and ``arch.json`` refuses another
  ``--moe_routing``.
- Refusals, as in the reference: the serving engine, ``serve_lm
  --moe_experts``, ``draft_config`` / ``self_draft``, int8 weights
  (``TransformerLM(quantized=True)`` and ``generate --quantize int8``), and
  ``train_lm --moe_routing expert_choice`` without
  ``--allow_acausal_routing`` (a parser error, exit 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.generate import generate_jit as jax_generate
from deeplearning_mpi_tpu.models.generate import prefill as jax_prefill
from deeplearning_mpi_tpu_torch.cli import generate as generate_cli
from deeplearning_mpi_tpu_torch.cli import serve_lm, train_lm
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import beam_search, generate, prefill
from deeplearning_mpi_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    draft_config,
    self_draft,
)
from deeplearning_mpi_tpu_torch.serving import ServingEngine
from deeplearning_mpi_tpu_torch.utils.config import restore_lm

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

P, NEW = 8, 6


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(JaxConfig.tiny_moe(), moe_capacity_factor=0.5)
    jm = JaxLM(config=jc, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tc = TransformerConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(TransformerConfig)})
    tm = TransformerLM(tc, dtype=torch.float32, device="cpu")
    tm.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    prompt = np.random.default_rng(3).integers(1, 256, (3, P)).astype(np.int32)
    return jm, params, tm, prompt


def test_prefill_is_stepwise_and_matches_jax(pair):
    jm, params, tm, prompt = pair
    _, jlogits = jax.jit(lambda p, x: jax_prefill(jm, p, x, total_len=P + NEW,
                                                  last_logits_only=False))(
        params, jnp.asarray(prompt))
    cache, logits = prefill(tm, torch.from_numpy(prompt).long(), total_len=P + NEW,
                            last_logits_only=False)
    assert cache.index == P
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        batched = tm(torch.from_numpy(prompt).long())
    # The batched forward routes the whole prompt at once and drops here.
    assert float((batched - logits).abs().max()) > 1e-3


@pytest.mark.parametrize("case", ["uniform", "ragged", "ragged_shared"])
def test_greedy_generate_is_token_identical_to_jax(pair, case):
    jm, params, tm, prompt = pair
    lens = None if case == "uniform" else np.array([P, 3, 5], np.int32)
    shared = 3 if case == "ragged_shared" else 0
    fn = jax_generate(jm, max_new_tokens=NEW, temperature=0.0, shared_prefix=shared)
    want = np.asarray(fn(params, jnp.asarray(prompt), jax.random.key(0),
                         None if lens is None else jnp.asarray(lens)))
    got = generate(tm, torch.from_numpy(prompt).long(), max_new_tokens=NEW, temperature=0.0,
                   prompt_lens=None if lens is None else torch.from_numpy(lens),
                   shared_prefix=shared)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_equals_the_stepwise_walk_and_one_beam_equals_greedy(pair):
    _, _, tm, prompt = pair
    x = torch.from_numpy(prompt).long()
    greedy = generate(tm, x, max_new_tokens=NEW, temperature=0.0)
    walk = generate(tm, x, max_new_tokens=NEW, temperature=0.0,
                    prompt_lens=torch.full((x.shape[0],), P))
    torch.testing.assert_close(greedy, walk, atol=0, rtol=0)
    torch.testing.assert_close(beam_search(tm, x, max_new_tokens=NEW, num_beams=1), greedy,
                               atol=0, rtol=0)


MODEL = ["--num_layers", "2", "--num_heads", "2", "--head_dim", "8", "--d_model", "16",
         "--d_ff", "32", "--moe_experts", "4"]


def test_cli_train_then_generate_equals_the_library(tmp_path, capsys):
    rc = train_lm.main(["--device", "cpu", *MODEL, "--seq_len", "16", "--batch_size", "4",
                        "--train_sequences", "20", "--num_epochs", "1",
                        "--model_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "Epoch 0: moe_dropped_frac" in out, out
    got = generate_cli.run(["--device", "cpu", *MODEL, "--model_dir", str(tmp_path),
                            "--prompt", "moe", "--max_new_tokens", "5", "--greedy"])
    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=2, head_dim=8, d_model=16,
                            d_ff=32, moe_experts=4)
    model = restore_lm(cfg, dtype=torch.float32, device=torch.device("cpu"),
                       model_dir=tmp_path)
    prompt = torch.tensor([list(b"moe")])
    want = generate(model, prompt, max_new_tokens=5, temperature=0.0)
    np.testing.assert_array_equal(got.tokens, want.numpy())
    with pytest.raises(SystemExit, match="moe_routing"):
        generate_cli.run(["--device", "cpu", *MODEL, "--model_dir", str(tmp_path),
                          "--moe_routing", "expert_choice", "--greedy"])


def test_moe_is_refused_where_the_reference_refuses_it(capsys):
    cfg = TransformerConfig.tiny_moe()
    model = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    with pytest.raises(NotImplementedError, match="dense-MLP only"):
        ServingEngine(model)
    assert serve_lm.main(["--device", "cpu", "--selftest", "--moe_experts", "4"]) == 1
    assert "dense-MLP only" in capsys.readouterr().err
    with pytest.raises(ValueError, match="dense"):
        draft_config(cfg, 1)
    with pytest.raises(ValueError, match="dense"):
        self_draft(model, 1)
    with pytest.raises(ValueError, match="moe_experts"):
        TransformerLM(cfg, dtype=torch.float32, device="cpu", quantized=True)
    with pytest.raises(SystemExit, match="moe_experts"):
        generate_cli.run(["--device", "cpu", *MODEL, "--model_dir", "/nonexistent",
                          "--quantize", "int8"])
    with pytest.raises(SystemExit) as exit_info:
        train_lm.main(["--device", "cpu", *MODEL, "--moe_routing", "expert_choice"])
    assert exit_info.value.code == 2 and "--allow_acausal_routing" in capsys.readouterr().err
