"""The optimizers over the sharded layouts, in the port against
``deeplearning_mpi_tpu``: ZeRO-1 beside the expert, sequence and pipeline
axes, and Adafactor beside the model, expert and pipeline axes.

ONE spawn of 4 gloo ranks (``tests/torch_sharded_ranks.py``), at widths
where Adafactor factors and ZeRO-1 shards (``d_model`` 128, ``d_ff`` 256):

- ZeRO-1 (Adam 1e-3, clip 1.0) over ``dp 2 x ep 2`` (the MoE LM),
  ``dp 2 x sp 2`` (ring) and ``dp 2 x pp 2`` (2 stages, 2 microbatches):
  the loss and every whole parameter bitwise equal to the same layout's
  step without ZeRO-1 (float32 and float64), and each Adam moment's local
  shape the one the reference's placement gives on its whole leaf
  (``infer_state_sharding(zero=True)`` on a mesh of the same degrees: an
  expert stack's ``E`` taken, a stage stack's ``S`` taken and the size
  threshold read on the stacked leaf). A ``dp 2 x ep 2`` ZeRO-1 checkpoint
  resumes bit for bit and restores in one process.
- Adafactor (1e-3, clip 1.0) over ``dp 2 x tp 2``, ``dp 2 x ep 2`` (the
  MoE LM) and ``dp 2 x pp 2``, held to the reference's step on its whole
  leaves (``tests/torch_sharded_reference.py``; for ``pp``, its
  ``PipelinedLM`` whose optimizer sees the stacked ``[S, ...]`` leaves):
  the loss within 1e-5 relative, each gradient and its clip within 1e-5
  relative L2 of JAX's, each parameter's step delta within 1e-3 relative L2
  of the reference optimizer's update of the same whole gradients
  (``optax_deltas``: the clip and Adafactor on the stacked leaves) and
  1e-5 of the port's one-process step; every rank's whole parameters
  bitwise equal; the float64 twins within 1e-7 of one process. Checkpoints
  at ``dp 2 x tp 2``, ``dp 2 x ep 2`` and ``dp 2 x pp 2`` resume bit for
  bit and restore in one process (the factors saved as the whole leaves').
- Each wrong copy fails its bar: the ZeRO-1 slice on an expert stack's
  expert dim (the placement), Adafactor's factored means from the local
  model shard alone, and its block RMS per stage rather than over the
  stacked leaf (the step deltas).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
from deeplearning_mpi_tpu_torch.resilience import tree_digests
from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state
from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_sharded_ranks as ranks  # noqa: E402
import torch_tp_ranks  # noqa: E402
from torch_compose_ranks import rel, replicas_differ  # noqa: E402
from torch_sharded_reference import (  # noqa: E402
    jax_step,
    optax_deltas,
    tokens,
    zero_moment_shapes,
)

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

LAYOUTS = ranks.ZERO + ranks.ADAFACTOR
WRONG = [k for k, v in ranks.WRONG.items() if v in LAYOUTS]
#: The layouts whose checkpoints are saved, resumed and restored.
CHECKPOINTS = ("dp2_ep2_zero", "dp2_tp2_ada", "dp2_ep2_ada", "dp2_pp2_ada")
#: The bars (module docstring).
LOSS_TOL, GRAD_L2, DELTA_L2, ONE_L2, F64_TOL = 1e-5, 1e-5, 1e-3, 1e-5, 1e-7


def _degrees(name: str) -> dict:
    return ranks.layout(name).mesh


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's Adafactor steps and ZeRO-1 placements, the port's
    one-process float32 and float64 Adafactor steps, then ONE spawn of 4
    gloo ranks of ``torch_sharded_ranks.worker``."""
    toks = tokens(0)
    refs = {"dp2_tp2_ada": jax_step(ranks.CFG, toks, optimizer="adafactor"),
            "dp2_ep2_ada": jax_step(ranks.MOE_CFG, toks, optimizer="adafactor",
                                    aux_weight=ranks.AUX_WEIGHT),
            "dp2_pp2_ada": jax_step(ranks.CFG, toks, optimizer="adafactor", pipelined=True)}
    shapes = {name: zero_moment_shapes(ranks.MOE_CFG if "ep2" in name else ranks.CFG,
                                       _degrees(name), pipelined="pp2" in name)
              for name in ranks.ZERO}
    gen = np.random.default_rng(11)
    clip = {name: refs["dp2_ep2_ada" if "ep2" in name else "dp2_pp2_ada" if "pp2" in name
                       else "dp2_tp2_ada"]["clip"] for name in LAYOUTS}
    inputs = {"cfg": ranks.CFG, "moe_cfg": ranks.MOE_CFG,
              "params": refs["dp2_tp2_ada"]["params0"],
              "moe_params": refs["dp2_ep2_ada"]["params0"],
              "pipe_params": refs["dp2_pp2_ada"]["params0"],
              "tokens": torch.from_numpy(toks).long(), "clip": clip,
              "batches": [torch.from_numpy(gen.integers(0, 256, toks.shape)) for _ in range(3)],
              "layouts": list(LAYOUTS), "wrong": WRONG,
              "checkpoints": list(CHECKPOINTS)}
    out = tmp_path_factory.mktemp("sharded_optim")
    torch.save(inputs, out / "inputs.pt")
    one = {name: ranks.step_case(inputs, name) for name in ranks.ADAFACTOR}
    f64 = {name: ranks.step_case(inputs, name, dtype=torch.float64) for name in ranks.ADAFACTOR}
    return {"ranks": torch_tp_ranks.spawn(out, ranks.worker), "ref": refs, "shapes": shapes,
            "one": one, "f64": f64, "inputs": inputs, "out": out}


def delta_failures(results: list[dict], ref: dict, one: dict, layout: str) -> list:
    """What fails the Adafactor bar (module docstring) on any rank. The
    step deltas are held to the reference optimizer's update of the same
    whole gradients (``optax_deltas``): at 1e-3 an unfactored leaf's first
    step is ``lr * g / sqrt(g**2 + 1e-30)``, so a gradient element that
    rounds to 0 in one framework and not in the other moves by the LR (the
    one-process port's layer-0 ``k_proj`` lands 2.2e-2 relative L2 from
    JAX's step end to end, its gradient 1.2e-6 from JAX's); the gradients
    are held to JAX's."""
    bad = []
    params0 = ref["params0"]
    for r, got in enumerate(results):
        for key in ("probe_loss", "clip_loss", "step_loss"):
            if abs(got[key] - ref["loss"]) > LOSS_TOL * abs(ref["loss"]):
                bad.append((r, key, got[key], ref["loss"]))
        for key in ("grads", "clipped"):
            bad += [(r, key, n, e) for n, g in ref[key].items()
                    if (e := rel(got[key][n], g)) > GRAD_L2]
        lay = ranks.layout(layout)
        want = optax_deltas(ranks.MOE_CFG if lay.cfg == "moe_cfg" else ranks.CFG, got["grads"],
                            pipelined=lay.pipelined)
        for n, p0 in params0.items():
            delta = got["params"][n].double() - p0.double()
            if (e := rel(delta, want[n])) > DELTA_L2:
                bad.append((r, "delta", n, e))
            if (e := rel(delta, one["params"][n].double() - p0.double())) > ONE_L2:
                bad.append((r, "delta vs one process", n, e))
    return bad


def placement_failures(results: list[dict], want: dict) -> list:
    """The moments whose local shape differs from the reference's
    placement, on any rank."""
    return [(r, n, got["moment_shapes"].get(n), shape) for r, got in enumerate(results)
            for n, shape in want.items() if n in got["moment_shapes"]
            and got["moment_shapes"][n] != shape] + [
        (r, "names", sorted(got["moment_shapes"])) for r, got in enumerate(results)
        if not set(got["moment_shapes"]) <= set(want)]


@pytest.mark.parametrize("layout", ranks.ADAFACTOR)
def test_adafactor_one_process_matches_jax(spawned, layout):
    """One process holding the whole model (the pipelined LM's two stages,
    its optimizer on the stacked leaves) meets the bar the ranks are held to."""
    one = spawned["one"][layout]
    assert not delta_failures([one], spawned["ref"][layout], one, layout)


@pytest.mark.parametrize("layout", ranks.ADAFACTOR)
def test_adafactor_matches_jax(spawned, layout):
    results = [res[layout] for res in spawned["ranks"]]
    assert not delta_failures(results[:1], spawned["ref"][layout], spawned["one"][layout],
                              layout)
    assert not replicas_differ(results)


@pytest.mark.parametrize("layout", ranks.ADAFACTOR)
def test_adafactor_f64_matches_one_process(spawned, layout):
    one = spawned["f64"][layout]
    for got in (res[f"{layout}_f64"] for res in spawned["ranks"]):
        assert abs(got["step_loss"] - one["step_loss"]) <= F64_TOL * abs(one["step_loss"])
        for key in ("grads", "clipped", "params"):
            worst = max((rel(got[key][n], t), n) for n, t in one[key].items())
            assert worst[0] <= F64_TOL, (key, worst)


@pytest.mark.parametrize("layout", ranks.ZERO)
def test_zero_bitwise_the_same_layout_without_it(spawned, layout):
    for res in spawned["ranks"]:
        for suffix in ("", "_f64"):
            got, want = res[f"{layout}{suffix}"], res[f"{layout}_unzeroed{suffix}"]
            assert got["step_loss"] == want["step_loss"]
            assert all(torch.equal(got["params"][n], t) for n, t in want["params"].items())
    assert not replicas_differ([res[layout] for res in spawned["ranks"]])


@pytest.mark.parametrize("layout", ranks.ZERO)
def test_zero_places_moments_as_the_reference(spawned, layout):
    """Each rank's Adam moments have the local shapes of the reference's
    ZeRO-1 placement, and some leaf is cut over data (the widths shard)."""
    results = [res[layout] for res in spawned["ranks"]]
    assert not placement_failures(results, spawned["shapes"][layout])
    got = results[0]
    assert any(s != got["param_shapes"][n] for n, s in got["moment_shapes"].items())


@pytest.mark.parametrize("kind", WRONG)
def test_bar_rejects_wrong_copy(spawned, kind):
    layout = ranks.WRONG[kind]
    results = [res[kind] for res in spawned["ranks"]]
    if layout in ranks.ZERO:
        assert placement_failures(results, spawned["shapes"][layout])
    else:
        assert delta_failures(results[:1], spawned["ref"][layout], spawned["one"][layout],
                              layout)


@pytest.mark.parametrize("layout", CHECKPOINTS)
def test_checkpoint_resumes_bitwise_and_restores_in_one_process(spawned, layout):
    """A save under ``dp 2 x ep 2 --zero`` (the moments gathered whole over
    data and experts) and under Adafactor at ``dp 2 x tp 2``, ``dp 2 x ep
    2`` and ``dp 2 x pp 2`` (its factors gathered as the reference's whole
    leaves', the stages' stacked ``[S, ...]``, an unfactored leaf's unused
    ``zeros(1)`` slots as ``[S, 1]``): the same digests on every rank and
    after its restore, the resumed step bitwise the uninterrupted one;
    restored by one process without ZeRO-1 or a split (the pipelined LM
    holding both stages), the same digests."""
    ckpts = [res[f"{layout}_checkpoint"] for res in spawned["ranks"]]
    saved = ckpts[0]["saved"]
    for c in ckpts:
        assert c["saved"] == saved and c["restored"] == saved
        assert c["resumed"] == c["uninterrupted"]
    lay = ranks.layout(layout)
    model = (ranks.build_model(layout, spawned["inputs"]) if lay.pipelined else
             TransformerLM(ranks.lm_config(spawned["inputs"][lay.cfg]), dtype=torch.float32,
                           device="cpu"))
    template = create_train_state(model, build_optimizer(lay.optimizer, 1e-3, clip_norm=1.0),
                                  ema=True)
    state, epoch = Checkpointer(spawned["out"] / layout).restore_verified(template)
    assert epoch == 0 and tree_digests(state.arrays()) == saved
