"""The pipeline and sequence axes composed further, in the port against
``deeplearning_mpi_tpu``: the MoE LM's experts split inside the pipeline's
stages, the chunked loss over sequence shards, and the refusal of a
sequence-parallel attention inside the stages.

- ONE spawn of 4 gloo ranks (``tests/torch_sharded_ranks.py``):
  ``pp 2 x ep 2`` (the MoE LM in 2 stages of 2 microbatches, each stage's
  experts over the expert group) held to the reference's ``PipelinedLM``
  step (its ``[S, ...]`` stack run in order on the microbatches its
  ``split_microbatches`` cuts), and ``dp 2 x sp 2`` ring with
  ``loss_chunk`` 8 held to the reference's chunked step on the whole batch
  (``tests/torch_sharded_reference.py``). The bars: the loss within 1e-5
  relative, each gradient and its clip within 1e-5 relative L2, the
  parameters after one Adam step within 1e-4 relative L2 of JAX's and 1e-5
  of the port's one-process step, the MoE balance loss and dropped fraction
  within 1e-6, every rank's whole parameters bitwise equal; each float64
  twin within 1e-7 of one process. Each wrong copy fails its bar: one
  expert rank's combine partial dropped from the sum, and each shard's
  chunked mean over its own slice averaged over the shards. A ``pp 2 x ep
  2`` checkpoint resumes bit for bit and restores in one process.
- ``--pp`` with ``--sp`` / ``--attention ring|ulysses``: the reference's
  ``PipelinedLM`` with its ring or Ulysses attention raises (its
  ``shard_map`` over ``seq`` nested in the pipeline's is refused by JAX),
  so the port's CLI refuses it with that reason.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models.pipeline_lm import PipelinedLM as JaxPipelinedLM
from deeplearning_mpi_tpu.parallel import make_ring_attention_fn as jax_ring_fn
from deeplearning_mpi_tpu.parallel import make_ulysses_attention_fn as jax_ulysses_fn
from deeplearning_mpi_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from deeplearning_mpi_tpu.runtime.mesh import create_mesh as jax_create_mesh
from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
from deeplearning_mpi_tpu_torch.resilience import tree_digests
from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state
from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
from deeplearning_mpi_tpu_torch.utils.config import PP_SEQ_REASON

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_sharded_ranks as ranks  # noqa: E402
import torch_tp_ranks  # noqa: E402
from torch_compose_ranks import rel, replicas_differ  # noqa: E402
from torch_sharded_reference import jax_step, tokens  # noqa: E402

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

LAYOUTS = ranks.COMPOSE
WRONG = [k for k, v in ranks.WRONG.items() if v in LAYOUTS]
#: The float32 bars (module docstring) and the float64 twins'.
LOSS_TOL, GRAD_L2, TRAJECTORY_L2, ONE_L2, AUX_TOL, F64_TOL = 1e-5, 1e-5, 1e-4, 1e-5, 1e-6, 1e-7


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's steps (the pipelined MoE LM; the dense LM with the
    chunked loss), the port's one-process float32 and float64 steps, then
    ONE spawn of 4 gloo ranks of ``torch_sharded_ranks.worker``."""
    toks = tokens(0)
    refs = {"pp2_ep2": jax_step(ranks.MOE_CFG, toks, pipelined=True,
                                aux_weight=ranks.AUX_WEIGHT),
            "dp2_sp2_chunk": jax_step(ranks.CFG, toks, loss_chunk=ranks.LOSS_CHUNK)}
    gen = np.random.default_rng(7)
    inputs = {"cfg": ranks.CFG, "moe_cfg": ranks.MOE_CFG,
              "params": refs["dp2_sp2_chunk"]["params0"],
              "moe_params": refs["pp2_ep2"]["params0"], "tokens": torch.from_numpy(toks).long(),
              "clip": {name: ref["clip"] for name, ref in refs.items()},
              "batches": [torch.from_numpy(gen.integers(0, 256, toks.shape)) for _ in range(3)],
              "layouts": list(LAYOUTS), "wrong": WRONG, "checkpoints": ["pp2_ep2"]}
    out = tmp_path_factory.mktemp("compose_pipe")
    torch.save(inputs, out / "inputs.pt")
    one = {name: ranks.step_case(inputs, name) for name in LAYOUTS}
    f64 = {name: ranks.step_case(inputs, name, dtype=torch.float64) for name in LAYOUTS}
    return {"ranks": torch_tp_ranks.spawn(out, ranks.worker), "ref": refs, "one": one,
            "f64": f64, "inputs": inputs, "out": out}


def bar_failures(results: list[dict], ref: dict, one: dict) -> list:
    """What fails the float32 bar (module docstring) on any rank."""
    bad = []
    for r, got in enumerate(results):
        for key in ("probe_loss", "clip_loss", "step_loss"):
            if abs(got[key] - ref["loss"]) > LOSS_TOL * abs(ref["loss"]):
                bad.append((r, key, got[key], ref["loss"]))
        for key in ("grads", "clipped"):
            bad += [(r, key, n, e) for n, g in ref[key].items()
                    if (e := rel(got[key][n], g)) > GRAD_L2]
        bad += [(r, "params", n, e) for n, p in ref["stepped"].items()
                if (e := rel(got["params"][n], p)) > TRAJECTORY_L2]
        bad += [(r, "params vs one process", n, e) for n, p in one["params"].items()
                if (e := rel(got["params"][n], p)) > ONE_L2]
        for key in ("moe_aux_loss", "moe_dropped_frac"):
            if key in ref and abs(got[key] - ref[key]) > AUX_TOL:
                bad.append((r, key, got[key], ref[key]))
    return bad


def f64_failures(results: list[dict], one: dict) -> list:
    bad = []
    for r, got in enumerate(results):
        if abs(got["step_loss"] - one["step_loss"]) > F64_TOL * abs(one["step_loss"]):
            bad.append((r, "loss", got["step_loss"], one["step_loss"]))
        for key in ("grads", "clipped", "params"):
            bad += [(r, key, n, e) for n, t in one[key].items()
                    if (e := rel(got[key][n], t)) > F64_TOL]
    return bad


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_process_matches_jax(spawned, layout):
    """The port's one-process step (the pipelined LM's stages run in order;
    the flat LM with the chunked loss) meets the bar the ranks are held to."""
    assert not bar_failures([spawned["one"][layout]], spawned["ref"][layout],
                            spawned["one"][layout])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compose_matches_jax(spawned, layout):
    results = [res[layout] for res in spawned["ranks"]]
    assert not bar_failures(results, spawned["ref"][layout], spawned["one"][layout])
    assert not replicas_differ(results)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compose_f64_matches_one_process(spawned, layout):
    results = [res[f"{layout}_f64"] for res in spawned["ranks"]]
    assert not f64_failures(results, spawned["f64"][layout])


@pytest.mark.parametrize("kind", WRONG)
def test_compose_bar_rejects_wrong_copy(spawned, kind):
    layout = ranks.WRONG[kind]
    results = [res[kind] for res in spawned["ranks"]]
    assert bar_failures(results, spawned["ref"][layout], spawned["one"][layout])


def test_pp2_ep2_checkpoint_resumes_bitwise_and_restores_in_one_process(spawned):
    """A ``pp 2 x ep 2`` save: the same digests on every rank and after its
    restore, the resumed step bitwise the uninterrupted one, the stage
    leaves stacked and the expert stacks whole; restored by one process
    holding both stages and every expert, the same digests."""
    ckpts = [res["pp2_ep2_checkpoint"] for res in spawned["ranks"]]
    saved = ckpts[0]["saved"]
    assert any("stages.block_0.mlp.experts_gate" in k for k in saved)
    for c in ckpts:
        assert c["saved"] == saved and c["restored"] == saved
        assert c["resumed"] == c["uninterrupted"]
    model = PipelinedLM(ranks.lm_config(ranks.MOE_CFG), num_stages=2, num_microbatches=2,
                        dtype=torch.float32, device="cpu")
    template = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0), ema=True)
    state, epoch = Checkpointer(spawned["out"] / "pp2_ep2").restore_verified(template)
    assert epoch == 0 and tree_digests(state.arrays()) == saved
    assert state.arrays()["params"]["stages.block_0.mlp.experts_gate"].shape[:2] == (2, 4)


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_pp_with_seq_attention_raises_in_the_reference_and_is_refused(schedule, capsys):
    """The reference's ``PipelinedLM`` over ``pipe 2 x seq 2`` with its ring
    or Ulysses attention raises the error :data:`PP_SEQ_REASON` quotes; the
    port's ``train_lm --pp 2 --sp 2 --attention <schedule>`` on 4 gloo
    ranks exits 1 with that reason and its ROADMAP item."""
    from deeplearning_mpi_tpu_torch.cli import train_lm

    mesh = jax_create_mesh(JaxMeshSpec(data=2, pipe=2, seq=2))
    fn = (jax_ring_fn if schedule == "ring" else jax_ulysses_fn)(mesh)
    cfg = JaxConfig(vocab_size=256, num_layers=2, num_heads=4, head_dim=8, d_model=32, d_ff=64)
    jm = JaxPipelinedLM(cfg, mesh, num_microbatches=2, dtype=jnp.float32, attention_fn=fn)
    toks = jnp.asarray(tokens(1)[:, :16])
    with pytest.raises(ValueError, match="should match the mesh passed to shard_map"):
        params = jm.init(jax.random.key(0), toks)["params"]
        jax.jit(lambda p: jm.apply({"params": p}, toks))(params)
    flags = ["--device", "cpu", "--nproc", "4", "--pp", "2", "--sp", "2", "--attention",
             schedule, "--num_layers", "2", "--num_heads", "4", "--head_dim", "8",
             "--d_model", "32", "--d_ff", "64", "--seq_len", "32", "--batch_size", "4",
             "--train_sequences", "20"]
    assert train_lm.main(flags) == 1
    err = capsys.readouterr().err
    assert PP_SEQ_REASON in err and "item 8.6" in err
