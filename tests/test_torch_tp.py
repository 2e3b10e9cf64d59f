"""Tensor parallelism in the port against ``deeplearning_mpi_tpu``.

- The placement: for every leaf of the 110M config (shapes only) and of
  ``TP_SHAPE`` (tied and untied), the port's decision
  (``parallel.tensor_parallel.param_spec``, on the port's ``[out, in]``
  layout) is the reference's ``param_spec`` at tp 2 and 4, and a sharded
  model's plan holds exactly those leaves; a rule that splits a Megatron
  pair is refused.
- The one-process form (``LockstepTP``) at tp 2 and 4, float32, on the
  reference's weights: logits and gradients within 1e-5 relative L2 of
  JAX's on the global batch, and one Adam step with clip 1.0 within the
  port's JAX parity tolerances (loss 1e-5; parameters atol 5e-5, rtol
  1e-4: ``tests/test_torch_train.py``) of the reference's single-device
  ``make_train_step("lm")``; greedy, ragged and beam generation
  token-identical to the unsharded model, the cache at the local heads.
- ONE spawn of 4 gloo ranks (``tests/torch_tp_ranks.py``): the
  process-group form under ``tp 4`` and ``dp 2 x tp 2`` against the same
  JAX step at the same tolerances, the replicas bitwise equal; the float64
  twins within 1e-7 relative of one process; each wrong copy (no backward
  all-reduce in the column-parallel copy, one rank's partial dropped from
  the row-parallel sum, the embedding's gradient summed over the model
  group) rejected by the float32 bar; checkpoints moved between ``dp 2 x
  tp 2 --zero`` and one process with equal ``tree_digests``, a resumed run
  bitwise the uninterrupted one, and each rank's moment sizes the
  reference's shard.
- ``cli.generate --device cpu --tp 2``: token-identical to ``--tp 1`` on a
  port checkpoint, greedy and 3 beams; the ``--tp`` refusals (``serve_lm``
  with the reference's reason: tensor-parallel replicas need the fleet).
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.ops.loss import lm_cross_entropy as jax_lm_loss
from deeplearning_mpi_tpu.parallel.tensor_parallel import param_spec as ref_param_spec
from deeplearning_mpi_tpu.parallel.zero import zero1_spec as ref_zero1_spec
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax, transposed_from_jax
from deeplearning_mpi_tpu_torch.models.generate import beam_search, generate
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.parallel import tensor_parallel as tpm
from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_tp_ranks as ranks  # noqa: E402

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

B, S = 8, 32
#: float32 bars against the JAX step (the port's parity tolerances).
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
#: relative L2 of each gradient (and of the logits) against JAX's, float32.
GRAD_L2 = 1e-5
#: relative error of the float64 twins against one process.
F64_TOL = 1e-7


def port_name(keys: list[str]) -> str:
    """The port's name of a reference param leaf (its path's keys)."""
    if keys[0] == "embed":
        return "embed.weight"
    if keys[0] in ("final_norm", "lm_head"):
        return f"{keys[0]}.{'scale' if keys[1] == 'scale' else 'weight'}"
    layer = int(keys[0].split("_")[1])
    if keys[1] in ("attn_norm", "mlp_norm"):
        return f"layers.{layer}.{keys[1]}.scale"
    return f"layers.{layer}.{keys[1]}.{keys[2]}.weight"


def reference_leaves(cfg: JaxConfig) -> list[tuple[str, str, tuple, object]]:
    """``(reference path, port name, port shape, abstract leaf)`` of every
    param leaf, in the reference's flatten order (shapes only)."""
    shapes = jax.eval_shape(lambda: JaxLM(config=cfg, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = port_name([k.key for k in path])
        shape = tuple(leaf.shape)
        if len(shape) == 2 and transposed_from_jax(name):
            shape = shape[::-1]
        out.append((jax.tree_util.keystr(path), name, shape, leaf))
    return out


def to_reference_dim(name: str, shape: tuple, dim: int | None) -> int | None:
    """A port dim as the reference's dim of the same leaf."""
    if dim is None or not (len(shape) == 2 and transposed_from_jax(name)):
        return dim
    return 1 - dim


def spec_dim(spec, axis: str) -> int | None:
    return next((i for i, a in enumerate(spec) if a == axis), None)


def port_config(jc: JaxConfig) -> TransformerConfig:
    return TransformerConfig(**{f.name: getattr(jc, f.name)
                                for f in dataclasses.fields(TransformerConfig)})


TP_SHAPE = JaxConfig(vocab_size=256, num_layers=2, num_heads=4, head_dim=16, d_model=32, d_ff=64)
CONFIGS = {"110m": JaxConfig(), "tp_shape": TP_SHAPE,
           "tp_shape_untied": dataclasses.replace(TP_SHAPE, tied_embeddings=False)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tp_placement_equals_reference(config, tp):
    """Every leaf: the port's sharded dim is the reference's ``param_spec``
    (through the transpose), and a model sharded over ``tp`` shards exactly
    those leaves."""
    cfg = CONFIGS[config]
    want, got, shapes = {}, {}, {}
    for path, name, shape, leaf in reference_leaves(cfg):
        want[name] = spec_dim(ref_param_spec(leaf, tp=tp, path=path), "model")
        got[name] = to_reference_dim(name, shape, tpm.param_spec(name, shape, tp))
        shapes[name] = shape
    assert got == want
    model = TransformerLM(port_config(cfg), dtype=torch.float32, device="meta",
                          tp=tpm.LockstepTP(tp, "meta"))
    sharded = {n for n, d in want.items() if d is not None}
    assert {n: to_reference_dim(n, shapes[n], d) for n, d in model.tp_plan.dims.items()} == {
        n: want[n] for n in sharded}
    assert {tpm.split_name(n)[0] for n, _ in model.named_parameters()
            if tpm.split_name(n)[1] is not None} == sharded


def test_tp_refuses_a_split_pair_and_uneven_heads():
    """A grouped ``k_proj`` under ``min_size`` beside a sharded ``q_proj``:
    the rule splits the pair, the port refuses; so does a ``tp`` that
    divides H*D but not the heads."""
    gqa = TransformerConfig(vocab_size=256, num_layers=1, num_heads=4, num_kv_heads=1,
                            head_dim=16, d_model=32, d_ff=64)
    with pytest.raises(ValueError, match="Megatron pair only whole"):
        tpm.plan(gqa, 2)
    uneven = TransformerConfig(vocab_size=256, num_layers=1, num_heads=2, head_dim=32,
                               d_model=64, d_ff=128)
    with pytest.raises(ValueError, match="whole heads"):
        tpm.plan(uneven, 4)


@pytest.fixture(scope="module")
def reference():
    """The reference's TP_SHAPE model, its weights, a seeded global batch,
    the JAX logits and gradients on it, and the parameters after one Adam
    step with clip 1.0 from ``make_train_step("lm")`` on one device."""
    jm = JaxLM(config=TP_SHAPE, dtype=jnp.float32)
    state = jax_create_state(jm, jax.random.key(0), jnp.zeros((1, S), jnp.int32),
                             jax_optimizer("adam", 1e-3, clip_norm=1.0))
    params = jax.device_get(state.params)
    tokens = np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)

    def loss(p):
        return jax_lm_loss(jm.apply({"params": p}, jnp.asarray(tokens)), jnp.asarray(tokens))

    logits = np.array(jm.apply({"params": state.params}, jnp.asarray(tokens)))
    grads = lm_params_from_jax(jax.device_get(jax.grad(loss)(state.params)))
    new, metrics = jax_make_step("lm", donate=False)(state, {"tokens": jnp.asarray(tokens)})
    return {"jax_params": params, "params": lm_params_from_jax(params),
            "tokens": torch.from_numpy(tokens).long(),
            "logits": torch.from_numpy(logits), "grads": grads,
            "loss": float(metrics["loss"]),
            "stepped": lm_params_from_jax(jax.device_get(new.params))}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def tp_model(reference, tp: int) -> TransformerLM:
    """The sharded model on the reference's numpy tree (each rank its slice)."""
    model = TransformerLM(port_config(TP_SHAPE), dtype=torch.float32, device="cpu",
                          tp=tpm.LockstepTP(tp, "cpu"))
    model.load_state_dict(lm_params_from_jax(reference["jax_params"], model))
    return model


@pytest.mark.parametrize("tp", [2, 4])
def test_lockstep_tp_matches_jax(reference, tp):
    """``LockstepTP``: logits and gradients within 1e-5 relative L2 of the
    reference's, one Adam + clip step within the parity tolerances of its
    single-device train step."""
    model = tp_model(reference, tp)
    tokens = reference["tokens"]
    logits = model(tokens)
    assert rel(logits.detach(), reference["logits"]) <= GRAD_L2
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy

    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(lm_cross_entropy(logits, tokens), params)
    grads = model.tp_layout.gather(dict(zip(names, grads)))
    worst = max((rel(grads[n], g), n) for n, g in reference["grads"].items())
    assert worst[0] <= GRAD_L2, worst
    state, metrics = make_train_step("lm")(
        create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0)),
        {"tokens": tokens})
    np.testing.assert_allclose(float(metrics["loss"]), reference["loss"], **LOSS_TOL)
    got = model.full_state_dict()
    for n, want in reference["stepped"].items():
        np.testing.assert_allclose(got[n].numpy(), want.numpy(), err_msg=n, **PARAM_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_lockstep_tp_generation_equals_unsharded(reference, tp):
    """Greedy, ragged and 3-beam generation of the sharded model equal the
    unsharded model's token for token; each rank's cache holds Hkv/tp
    heads."""
    one = TransformerLM(port_config(TP_SHAPE), dtype=torch.float32, device="cpu")
    one.load_state_dict(reference["params"])
    model = tp_model(reference, tp)
    cache = model.new_cache(2, 16)
    assert [tuple(k.shape) for k in cache.k[0]] == [(2, 16, TP_SHAPE.num_heads // tp, 16)] * tp
    prompt = reference["tokens"][:2, :5]
    lens = torch.tensor([3, 5])
    for kw in ({}, {"prompt_lens": lens, "shared_prefix": 3}):
        assert torch.equal(generate(model, prompt, max_new_tokens=6, temperature=0.0, **kw),
                           generate(one, prompt, max_new_tokens=6, temperature=0.0, **kw))
    assert torch.equal(beam_search(model, prompt, max_new_tokens=5, num_beams=3),
                       beam_search(one, prompt, max_new_tokens=5, num_beams=3))


# -- four gloo ranks ------------------------------------------------------------
@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """ONE spawn of 4 gloo ranks of ``torch_tp_ranks.worker_tp``; beside
    it, one process's float64 step and a one-process ZeRO_CFG checkpoint
    (2 steps) with its digests."""
    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    out = tmp_path_factory.mktemp("tp_ranks")
    zero_model = TransformerLM(ranks.lm_config(ranks.ZERO_CFG), dtype=torch.float32,
                               device="cpu").init_weights(0)
    ds = SyntheticTokens(3 * B, S, seed=1)
    batches = [torch.stack([torch.from_numpy(ds[i * B + j]["tokens"]) for j in range(B)])
               for i in range(3)]
    inputs = {"cfg": ranks.TP_CFG, "params": reference["params"], "tokens": reference["tokens"],
              "zero_params": zero_model.state_dict(), "zero_batches": batches}
    one = ranks.zero_trainer(inputs, None)
    for tokens in batches[:2]:
        one.state, _ = one.train_step(one.state, {"tokens": tokens})
    Checkpointer(out / "one").save(one.state, epoch=0)
    torch.save(inputs, out / "inputs.pt")
    return {"ranks": ranks.spawn(out, ranks.worker_tp), "out": out,
            "one_digests": tree_digests(one.state.arrays()),
            "f64": ranks.tp_step_case(inputs, dtype=torch.float64)}


def jax_bar_failures(results: list[dict], reference) -> list:
    """What fails the float32 bar against the JAX step: each loss within
    LOSS_TOL, each gradient within GRAD_L2, each parameter within
    PARAM_TOL."""
    bad = []
    for r, got in enumerate(results):
        for key in ("probe_loss", "adam_loss"):
            if not np.isclose(got[key], reference["loss"], **LOSS_TOL):
                bad.append((r, key, got[key]))
        bad += [(r, "grads", n, e) for n, g in reference["grads"].items()
                if (e := rel(got["grads"][n], g)) > GRAD_L2]
        bad += [(r, "params", n) for n, p in reference["stepped"].items()
                if not np.allclose(got["params"][n].numpy(), p.numpy(), **PARAM_TOL)]
    return bad


@pytest.mark.parametrize("layout", list(ranks.TP_LAYOUTS))
def test_tp_ranks_match_jax(spawned, reference, layout):
    """``tp 4`` and ``dp 2 x tp 2`` over 4 gloo ranks against the
    reference's single-device step: the float32 bar; every rank's whole
    parameters bitwise equal."""
    results = [res[layout] for res in spawned["ranks"]]
    assert not jax_bar_failures(results, reference)
    for got in results[1:]:
        assert all(torch.equal(got["params"][n], t) for n, t in results[0]["params"].items())


@pytest.mark.parametrize("layout", list(ranks.TP_LAYOUTS))
def test_tp_ranks_f64_match_one_process(spawned, layout):
    """The float64 twins: losses, gradients and the stepped parameters
    within 1e-7 relative of one process's float64 step."""
    one = spawned["f64"]
    for got in (res[f"{layout}_f64"] for res in spawned["ranks"]):
        assert abs(got["adam_loss"] - one["adam_loss"]) <= F64_TOL * abs(one["adam_loss"])
        for key in ("grads", "params"):
            worst = max((rel(got[key][n], t), n) for n, t in one[key].items())
            assert worst[0] <= F64_TOL, (key, worst)


@pytest.mark.parametrize("kind", ranks.WRONG_TP)
def test_tp_bar_rejects_wrong_copy(spawned, reference, kind):
    """Each wrong copy of the tensor-parallel collectives fails the float32
    bar that ``tp 4`` meets."""
    assert jax_bar_failures([res[kind] for res in spawned["ranks"]], reference)


def test_sharded_checkpoint_restores_in_one_process(spawned):
    """Saved under ``dp 2 x tp 2 --zero`` (gathered whole), restored by one
    process: the same ``tree_digests`` as the ranks' own state, and each
    rank's restore of it equal too."""
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    saved = spawned["ranks"][0]["checkpoint"]["saved"]
    assert all(res["checkpoint"]["saved"] == saved for res in spawned["ranks"])
    assert all(res["checkpoint"]["restored"] == saved for res in spawned["ranks"])
    inputs = torch.load(spawned["out"] / "inputs.pt", weights_only=False)
    template = ranks.zero_trainer(inputs, None).state
    state, epoch = Checkpointer(spawned["out"] / "sharded").restore_verified(template)
    assert epoch == 0 and tree_digests(state.arrays()) == saved


def test_one_process_checkpoint_restores_sharded(spawned):
    """Saved by one process, restored under ``dp 2 x tp 2 --zero``: every
    rank's gathered tree has the one process's ``tree_digests``."""
    assert all(res["checkpoint"]["from_one"] == spawned["one_digests"]
               for res in spawned["ranks"])


def test_resume_equals_uninterrupted_under_dp2_tp2_zero(spawned):
    """A run restored from its own save and stepped on equals the run that
    never stopped, bit for bit."""
    for res in spawned["ranks"]:
        assert res["checkpoint"]["resumed"] == res["checkpoint"]["uninterrupted"]


def test_tp_zero_moments_are_the_reference_shard(spawned):
    """Under ``dp 2 x tp 2 --zero`` each rank's moment of each leaf holds
    the numel of the reference's placement (``param_spec`` then
    ``zero1_spec``): gate_proj's ``P("data", "model")`` a quarter."""
    cfg = JaxConfig(**ranks.ZERO_CFG)
    expect = {}
    for path, name, _, leaf in reference_leaves(cfg):
        spec = ref_zero1_spec(leaf, ref_param_spec(leaf, tp=2, path=path), 2)
        expect[name] = leaf.size // (2 if "model" in spec else 1) // (2 if "data" in spec else 1)
        if "gate_proj" in name:
            assert tuple(spec) == ("data", "model")
    for res in spawned["ranks"]:
        got = {tpm.split_name(n)[0]: k for n, k in res["checkpoint"]["local_numel"].items()}
        assert got == expect


# -- the CLIs -------------------------------------------------------------------
TP_FLAGS = ["--num_layers", "2", "--num_heads", "4", "--head_dim", "16", "--d_model", "32",
            "--d_ff", "64"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from deeplearning_mpi_tpu_torch.cli import train_lm

    root = tmp_path_factory.mktemp("tp_ckpt")
    assert train_lm.main(["--device", "cpu", *TP_FLAGS, "--seq_len", "32", "--batch_size", "4",
                          "--train_sequences", "24", "--num_epochs", "1",
                          "--model_dir", str(root)]) == 0
    return root


@pytest.mark.parametrize("extra", [["--max_new_tokens", "8", "--greedy"],
                                   ["--max_new_tokens", "6", "--num_beams", "3"]],
                         ids=["greedy", "beams3"])
def test_generate_cli_tp2_equals_tp1(checkpoint, capsys, extra):
    """``cli.generate --device cpu --tp 2`` prints what ``--tp 1`` prints."""
    from deeplearning_mpi_tpu_torch.cli import generate as cli

    argv = ["--device", "cpu", *TP_FLAGS, "--model_dir", str(checkpoint), "--prompt", "ab", *extra]
    capsys.readouterr()
    assert cli.main(argv) == 0
    single = capsys.readouterr().out
    assert cli.main(argv + ["--tp", "2"]) == 0
    assert capsys.readouterr().out == single and single.strip()


@pytest.mark.parametrize("cli,extra,message", [
    ("train_lm", ["--tp", "2", "--moe_experts", "4", "--ep", "2", "--nproc", "4"], None),
    ("train_lm", ["--tp", "2", "--sp", "2", "--attention", "ring", "--nproc", "4"], None),
    ("train_lm", ["--tp", "2", "--optimizer", "adafactor", "--nproc", "2"], None),
    ("train_lm", ["--tp", "3"], "must divide"),
    ("train_resnet", ["--tp", "2", "--synthetic"], "convolutions"),
    ("generate", ["--tp", "2", "--quantize", "int8", "--model_dir", "x"], "single-device dense"),
    ("serve_lm", ["--tp", "2", "--selftest"], "requires --replicas > 1"),
    ("train_lm", ["--zero", "--moe_experts", "4", "--ep", "2", "--nproc", "4"], None),
    ("train_lm", ["--zero_overlap", "--sp", "2", "--attention", "ring", "--nproc", "4"], None),
], ids=["moe", "sp", "adafactor", "uneven", "conv", "int8", "serve", "zero_ep", "zero_sp"])
def test_tp_refusals(cli, extra, message, capsys):
    """What the port leaves out is refused with its reason (``--tp`` on
    the convolutions or at widths it does not divide, int8, serving); the
    reference runs each. ``--tp 2`` beside ``--moe_experts 4 --ep 2``,
    beside ``--sp 2 --attention ring`` and with adafactor, and ZeRO-1
    beside ``--ep 2`` and ``--sp 2`` (``--zero_overlap`` falling back),
    run on gloo ranks and log one process's epoch losses."""
    import importlib

    module = importlib.import_module(f"deeplearning_mpi_tpu_torch.cli.{cli}")
    flags = [] if cli == "train_resnet" else TP_FLAGS
    if message is None:
        run = ["--device", "cpu", *flags, "--seq_len", "32", "--batch_size", "4",
               "--train_sequences", "20", "--num_epochs", "1"]
        one = [v for i, f in enumerate(extra) if f in ("--moe_experts", "--optimizer")
               for v in (f, extra[i + 1])]
        assert module.main(run + one) == 0
        want = re.findall(r"^Epoch \d+: loss ([0-9.]+)", capsys.readouterr().out, re.M)
        out = subprocess.run([sys.executable, "-m", f"deeplearning_mpi_tpu_torch.cli.{cli}",
                              *run, *extra], cwd=pathlib.Path(__file__).resolve().parents[1],
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr[-2000:]
        assert want and re.findall(r"^Epoch \d+: loss ([0-9.]+)", out.stdout, re.M) == want
        return
    assert module.main(["--device", "cpu", *flags, *extra]) == 1
    assert message in capsys.readouterr().err
