"""The LM's dense parallel axes composed, in the port against
``deeplearning_mpi_tpu``: pipeline x tensor parallelism and tensor x
sequence parallelism.

- ONE spawn of 4 gloo ranks (``tests/torch_compose_ranks.py``): ``pp 2 x
  tp 2`` (the pipelined LM, 2 microbatches, Megatron blocks in each stage,
  the tied table sharded over the model group) and ``tp 2 x sp 2`` with
  the ring and with Ulysses (each model rank at its local heads), each held
  to the reference's train step on the whole batch
  (``tests/torch_compose_reference.py``: the losses within 1e-5, each
  gradient and its clip within 1e-5 relative L2, the parameters after one
  Adam step within 1e-4 of JAX's and 1e-5 of the port's one-process step,
  the MoE metrics within 1e-6) with every rank's whole parameters bitwise
  equal; each float64 twin within 1e-7 of one process; each wrong copy
  rejected by the float32 bar (the pipe's sends and sums crossing to the
  other model coordinate, the clip counting a stage's replicated norms tp
  times, the ring rotating over the model group, the gradients not summed
  over the seq group); a ``pp 2 x tp 2`` checkpoint resumed bitwise and
  restored in one process, over ``LockstepPipe(2)`` and flat.
- The one-process grid (two lockstep axes side by side, the form the card
  runs): ``LockstepPipe(2) x LockstepTP(2)`` and ``LockstepTP(2)`` x
  the ring / Ulysses over ``LockstepRing(2)``, one step within 1e-5 of the
  flat step.
- Ulysses at each ratio of heads, tp and sp: run where the reference runs
  (the whole model's heads divisible by sp, a model rank's maybe not),
  else its error.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.parallel.ulysses import make_ulysses_attention_fn as jax_ulysses_fn
from deeplearning_mpi_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from deeplearning_mpi_tpu.runtime.mesh import create_mesh as jax_create_mesh
from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
from deeplearning_mpi_tpu_torch.ops.attention import dense_attention
from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn, make_ulysses_attention_fn
from deeplearning_mpi_tpu_torch.parallel.pipeline import LockstepPipe
from deeplearning_mpi_tpu_torch.parallel.seq_common import LockstepRing
from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP
from deeplearning_mpi_tpu_torch.parallel.ulysses import ulysses_attention
from deeplearning_mpi_tpu_torch.resilience import tree_digests
from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_compose_ranks as ranks  # noqa: E402
import torch_tp_ranks  # noqa: E402
from torch_compose_ranks import bar_failures, f64_failures, rel, replicas_differ  # noqa: E402
from torch_compose_reference import jax_step, tokens  # noqa: E402

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

LAYOUTS = ranks.DENSE
WRONG = [k for k, v in ranks.WRONG.items() if v in LAYOUTS]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's step on :data:`ranks.CFG`, the port's one-process
    float32 and float64 steps of each layout, then ONE spawn of 4 gloo
    ranks of ``torch_compose_ranks.worker``."""
    ref = jax_step(ranks.CFG, tokens(0))
    toks = torch.from_numpy(tokens(0)).long()
    gen = np.random.default_rng(7)
    inputs = {"cfg": ranks.CFG, "params": ref["params0"], "tokens": toks,
              "clip": {name: ref["clip"] for name in LAYOUTS},
              "batches": [torch.from_numpy(gen.integers(0, 256, toks.shape)) for _ in range(3)],
              "layouts": list(LAYOUTS), "checkpoints": ["pp2_tp2"]}
    out = tmp_path_factory.mktemp("compose_dense")
    torch.save(inputs, out / "inputs.pt")
    one = {name: ranks.step_case(inputs, name) for name in LAYOUTS}
    f64 = {name: ranks.step_case(inputs, name, dtype=torch.float64) for name in LAYOUTS}
    return {"ranks": torch_tp_ranks.spawn(out, ranks.worker), "ref": ref, "one": one,
            "f64": f64, "inputs": inputs, "out": out}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compose_matches_jax(spawned, layout):
    results = [res[layout] for res in spawned["ranks"]]
    assert not bar_failures(results, spawned["ref"], spawned["one"][layout])
    assert not replicas_differ(results)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compose_f64_matches_one_process(spawned, layout):
    results = [res[f"{layout}_f64"] for res in spawned["ranks"]]
    assert not f64_failures(results, spawned["f64"][layout])


@pytest.mark.parametrize("kind", WRONG)
def test_compose_bar_rejects_wrong_copy(spawned, kind):
    layout = ranks.WRONG[kind]
    results = [res[kind] for res in spawned["ranks"]]
    assert bar_failures(results, spawned["ref"], spawned["one"][layout])


def test_pp2_tp2_checkpoint_resumes_bitwise_and_restores_in_one_process(spawned):
    """A ``pp 2 x tp 2`` save: the same digests on every rank and after its
    restore, the resumed step bitwise the uninterrupted one, stage leaves
    stacked and model shards gathered whole; restored in one process over
    ``LockstepPipe(2)``, the same digests; its flat view loads a
    one-process ``TransformerLM``."""
    ckpts = [res["pp2_tp2_checkpoint"] for res in spawned["ranks"]]
    saved = ckpts[0]["saved"]
    assert any("stages.block_0" in k for k in saved)
    assert not any(".shards." in k for k in saved)
    for c in ckpts:
        assert c["saved"] == saved and c["restored"] == saved
        assert c["resumed"] == c["uninterrupted"]
    config = ranks.lm_config(ranks.CFG)
    model = PipelinedLM(config, num_stages=2, num_microbatches=2, dtype=torch.float32,
                        device="cpu", pipe=LockstepPipe(2))
    template = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0), ema=True)
    state, epoch = Checkpointer(spawned["out"] / "pp2_tp2").restore_verified(template)
    assert epoch == 0 and tree_digests(state.arrays()) == saved
    flat = TransformerLM(config, dtype=torch.float32, device="cpu")
    flat.load_state_dict(model.full_state_dict())


def _grid_step(model, attention_fn, toks):
    state = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0),
                               attention_fn=attention_fn)
    state, metrics = make_train_step("lm")(state, {"tokens": toks})
    return float(metrics["loss"]), model.full_state_dict()


@pytest.mark.parametrize("grid", ["pp2_tp2", "tp2_sp2_ring", "tp2_sp2_ulysses"])
def test_lockstep_grid_matches_one_process(spawned, grid):
    """The one-process form of each composition (what the card runs): one
    Adam step within 1e-5 of the flat step (loss, every parameter)."""
    inputs, one = spawned["inputs"], spawned["one"][grid]
    config = ranks.lm_config(ranks.CFG)
    tp = LockstepTP(2, "cpu")
    if grid == "pp2_tp2":
        model = PipelinedLM(config, num_stages=2, num_microbatches=2, dtype=torch.float32,
                            device="cpu", pipe=LockstepPipe(2), tp=tp)
        model.load_flat_state_dict(inputs["params"])
        fn = None
    else:
        model = TransformerLM(config, dtype=torch.float32, device="cpu", tp=tp)
        model.load_state_dict(model.tp_layout.local(inputs["params"]))
        fn = (make_ring_attention_fn(sp=2) if grid.endswith("ring")
              else make_ulysses_attention_fn(sp=2, head_groups=2))
    loss, params = _grid_step(model, fn, inputs["tokens"])
    assert abs(loss - one["adam_loss"]) <= 1e-5 * abs(one["adam_loss"])
    worst = max((rel(params[n], t), n) for n, t in one["params"].items())
    assert worst[0] <= 1e-5, worst


#: (whole model's heads, kv heads, tp, sp): Ulysses at each model rank's
#: local heads H/tp over sp ranks. The reference raises where sp does not
#: divide H; where it divides H but not H/tp the port trades the sequence
#: for the local (batch, head) pairs.
ULYSSES_RATIOS = [(4, 2, 2, 2), (6, 2, 2, 2), (2, 2, 2, 2), (6, 6, 2, 4), (4, 2, 1, 4)]


@pytest.mark.parametrize("heads,kv,tp,sp", ULYSSES_RATIOS)
def test_ulysses_at_local_heads_runs_or_raises_as_the_reference(heads, kv, tp, sp):
    """Each model rank's Ulysses (``LockstepRing(sp)``, ``head_groups=tp``)
    on its H/tp heads equals dense attention on them, output and
    gradients, where the reference's Ulysses over the whole model's H runs;
    where it raises, the port raises the same message."""
    gen = torch.Generator().manual_seed(heads * 100 + tp * 10 + sp)
    b, s, d = 4, 16, 8
    q = torch.randn(b, s, heads, d, generator=gen)
    k, v = (torch.randn(b, s, kv, d, generator=gen) for _ in range(2))
    mesh = jax_create_mesh(JaxMeshSpec(data=8 // sp, seq=sp))
    want_err = None
    try:
        jax_ulysses_fn(mesh)(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    except ValueError as err:
        want_err = str(err)
    ring = LockstepRing(sp)
    local, local_kv = heads // tp, kv // tp
    for r in range(tp):
        hq = slice(r * local, (r + 1) * local)
        hk = slice(r * local_kv, (r + 1) * local_kv)
        leaves = [t[:, :, h].clone().requires_grad_() for t, h in ((q, hq), (k, hk), (v, hk))]
        if want_err is not None:
            with pytest.raises(ValueError) as got:
                ulysses_attention(*leaves, ring=ring, head_groups=tp)
            assert str(got.value) == want_err
            return
        out = ulysses_attention(*leaves, ring=ring, head_groups=tp)
        grep = leaves[0].shape[2] // leaves[1].shape[2]
        want = dense_attention(leaves[0], leaves[1].repeat_interleave(grep, 2),
                               leaves[2].repeat_interleave(grep, 2), causal=True)
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
        do = torch.randn(out.shape, generator=gen)
        got_g = torch.autograd.grad(out, leaves, do)
        want_g = torch.autograd.grad(want, leaves, do)
        for a, w in zip(got_g, want_g):
            torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_train_lm_cli_dp2_pp2_tp2_logs_the_one_process_losses(capsys):
    """``cli.train_lm --nproc 8 --dp 2 --pp 2 --tp 2``: the three axes at
    once on 8 gloo ranks, each data rank its share of each microbatch; the
    epoch losses of one process."""
    import os
    import re
    import subprocess

    from deeplearning_mpi_tpu_torch.cli import train_lm

    flags = ["--device", "cpu", "--num_layers", "2", "--num_heads", "4", "--num_kv_heads", "2",
             "--head_dim", "16", "--d_model", "32", "--d_ff", "64", "--seq_len", "32",
             "--batch_size", "8", "--train_sequences", "40", "--num_epochs", "2",
             "--learning_rate", "1e-2"]
    assert train_lm.main(flags) == 0
    want = re.findall(r"^Epoch \d+: loss ([0-9.]+)", capsys.readouterr().out, re.M)
    out = subprocess.run([sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.train_lm",
                          *flags, "--nproc", "8", "--dp", "2", "--pp", "2", "--tp", "2",
                          "--microbatches", "2"], cwd=pathlib.Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = re.findall(r"^Epoch \d+: loss ([0-9.]+)", out.stdout, re.M)
    assert len(want) == 2 and got == want, (got, want)


def test_jax_pipelined_params_load_into_pp2_tp2():
    """The reference's ``PipelinedLM`` (pipe 2 x model 2 x data 2 on the
    virtual devices; :data:`ranks.CFG`, 2 microbatches) and the port's over
    ``LockstepPipe(2) x LockstepTP(2)`` on its weights
    (``models.convert.pipelined_params_from_jax``, each stage's model
    shards kept by ``load_full_state_dict``): the logits within 1e-5 and
    every gradient of the mean LM loss within 1e-5 relative L2."""
    from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
    from deeplearning_mpi_tpu.models.pipeline_lm import PipelinedLM as JaxPipelinedLM
    from deeplearning_mpi_tpu.ops.loss import lm_cross_entropy as jax_lm_loss
    from deeplearning_mpi_tpu_torch.models.convert import pipelined_params_from_jax
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy

    mesh = jax_create_mesh(JaxMeshSpec(data=2, pipe=2, model=2))
    jm = JaxPipelinedLM(JaxConfig(**ranks.CFG), mesh, num_microbatches=2, dtype=jnp.float32)
    toks = jnp.asarray(tokens(3))
    params = jm.init(jax.random.key(4), toks)["params"]

    def loss(p):
        logits = jm.apply({"params": p}, toks)
        return jax_lm_loss(logits, toks), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = PipelinedLM(ranks.lm_config(ranks.CFG), num_stages=2, num_microbatches=2,
                        dtype=torch.float32, device="cpu", pipe=LockstepPipe(2),
                        tp=LockstepTP(2, "cpu"))
    model.load_full_state_dict(pipelined_params_from_jax(jax.device_get(params)))
    t = torch.from_numpy(np.asarray(toks)).long()
    got = model(t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), atol=1e-5, rtol=1e-5)
    names, leaves = zip(*model.named_parameters())
    g = dict(zip(names, torch.autograd.grad(lm_cross_entropy(got, t), leaves)))
    whole = model.layout.gather(g)
    want = model.layout.gather(model.tp_layout.local(pipelined_params_from_jax(
        jax.device_get(grads))))
    worst = max((rel(whole[n], w), n) for n, w in want.items())
    assert worst[0] <= 1e-5, worst
