"""The MoE LM's parallel axes composed, in the port against
``deeplearning_mpi_tpu``: expert x sequence and expert x tensor
parallelism.

- ONE spawn of 4 gloo ranks (``tests/torch_compose_ranks.py``): ``ep 2 x
  sp 2`` with token and with expert choice (each block routing its
  sequence shard as the whole sequence: positions after the earlier
  shards' claims, capacity from the whole length, the balance loss over
  the whole rows, each expert's top-C over the whole row) and ``ep 2 x tp
  2`` (the reference's ``ep_spec``: each expert's ``gate`` / ``up`` split
  on d_ff, ``down`` on its input, the router replicated, the ``down``
  partials summed over the model group), each held to the reference's train
  step on the whole batch (``tests/torch_compose_reference.py``: losses
  within 1e-5, gradients and their clip within 1e-5 relative L2, the
  parameters after one Adam step within 1e-4 of JAX's and 1e-5 of the
  port's one process, the load-balance loss and the dropped fraction within
  1e-6), every rank's whole parameters bitwise equal; each float64 twin
  within 1e-7 of one process; each wrong copy rejected by that bar
  (capacity from the shard's length, positions without the earlier shards'
  prefix, each shard's balance loss averaged afterwards, a ``down`` partial
  not summed over the model group, the clip counting the router tp times);
  an ``ep 2 x tp 2`` checkpoint resumed bitwise and restored in one process.
- The one-process grid (what the card runs): the routing shard by shard
  over ``LockstepRing(2)`` and the experts split over ``LockstepTP(2)``,
  one step within 1e-5 of the flat step, the metrics within 1e-6.
- ``cli.train_lm --nproc 4 --moe_experts 4 --ep 2 --tp 2`` logs the
  one-process run's losses, records its layout in ``arch.json``, and
  ``cli.generate`` loads its checkpoint.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
from deeplearning_mpi_tpu_torch.parallel.seq_common import LockstepRing
from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP
from deeplearning_mpi_tpu_torch.resilience import tree_digests
from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_compose_ranks as ranks  # noqa: E402
import torch_tp_ranks  # noqa: E402
from torch_compose_ranks import (  # noqa: E402
    AUX_TOL,
    bar_failures,
    f64_failures,
    rel,
    replicas_differ,
)
from torch_compose_reference import jax_step, tokens  # noqa: E402

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUTS = ranks.MOE
WRONG = [k for k, v in ranks.WRONG.items() if v in LAYOUTS]


def _routing(layout: str) -> str:
    return ranks.LAYOUTS[layout][3]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's step on :data:`ranks.MOE_CFG` under each routing,
    the port's one-process float32 and float64 steps of each layout, then
    ONE spawn of 4 gloo ranks of ``torch_compose_ranks.worker``."""
    refs = {r: jax_step({**ranks.MOE_CFG, "moe_routing": r}, tokens(1),
                        aux_weight=ranks.AUX_WEIGHT, seed=1)
            for r in ("token_choice", "expert_choice")}
    toks = torch.from_numpy(tokens(1)).long()
    gen = np.random.default_rng(8)
    inputs = {"moe_cfg": ranks.MOE_CFG, "moe_params": refs["token_choice"]["params0"],
              "tokens": toks, "clip": {name: refs[_routing(name)]["clip"] for name in LAYOUTS},
              "batches": [torch.from_numpy(gen.integers(0, 256, toks.shape)) for _ in range(3)],
              "layouts": list(LAYOUTS), "checkpoints": ["ep2_tp2"]}
    out = tmp_path_factory.mktemp("compose_moe")
    torch.save(inputs, out / "inputs.pt")
    one = {name: ranks.step_case(inputs, name) for name in LAYOUTS}
    f64 = {name: ranks.step_case(inputs, name, dtype=torch.float64) for name in LAYOUTS}
    return {"ranks": torch_tp_ranks.spawn(out, ranks.worker), "refs": refs, "one": one,
            "f64": f64, "inputs": inputs, "out": out}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compose_moe_matches_jax(spawned, layout):
    results = [res[layout] for res in spawned["ranks"]]
    ref = spawned["refs"][_routing(layout)]
    assert not bar_failures(results, ref, spawned["one"][layout])
    assert not replicas_differ(results)
    if _routing(layout) == "token_choice":
        assert ref["moe_dropped_frac"] > 0  # the capacity binds: positions matter


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compose_moe_f64_matches_one_process(spawned, layout):
    results = [res[f"{layout}_f64"] for res in spawned["ranks"]]
    assert not f64_failures(results, spawned["f64"][layout])


@pytest.mark.parametrize("kind", WRONG)
def test_compose_moe_bar_rejects_wrong_copy(spawned, kind):
    layout = ranks.WRONG[kind]
    results = [res[kind] for res in spawned["ranks"]]
    assert bar_failures(results, spawned["refs"][_routing(layout)], spawned["one"][layout])


def test_ep2_tp2_checkpoint_resumes_bitwise_and_restores_in_one_process(spawned):
    """An ``ep 2 x tp 2`` save: the same digests on every rank and after its
    restore (expert stacks whole, d_ff whole), the resumed step bitwise the
    uninterrupted one; restored into one process's flat MoE LM, the same
    digests."""
    ckpts = [res["ep2_tp2_checkpoint"] for res in spawned["ranks"]]
    saved = ckpts[0]["saved"]
    assert not any(".shards." in k for k in saved)
    for c in ckpts:
        assert c["saved"] == saved and c["restored"] == saved
        assert c["resumed"] == c["uninterrupted"]
    model = TransformerLM(ranks.lm_config(ranks.MOE_CFG), dtype=torch.float32, device="cpu")
    template = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0), ema=True)
    state, epoch = Checkpointer(spawned["out"] / "ep2_tp2").restore_verified(template)
    assert epoch == 0 and tree_digests(state.arrays()) == saved


@pytest.mark.parametrize("grid", ["seq_token_choice", "seq_expert_choice", "tp"])
def test_lockstep_grid_moe_matches_one_process(spawned, grid):
    """The one-process form (what the card runs): the routing of each of
    ``LockstepRing(2)``'s shards with the other's claims, or the experts
    split over ``LockstepTP(2)``; one Adam step within 1e-5 of the flat
    step, the balance loss and the dropped fraction within 1e-6."""
    routing = grid.split("_", 1)[1] if grid.startswith("seq") else "token_choice"
    layout = {"token_choice": "ep2_sp2", "expert_choice": "ep2_sp2_ec"}[routing]
    if grid == "tp":
        layout = "ep2_tp2"
    inputs, one = spawned["inputs"], spawned["one"][layout]
    config = ranks.lm_config(ranks.MOE_CFG, routing)
    kw = {"tp": LockstepTP(2, "cpu")} if grid == "tp" else {"seq": LockstepRing(2)}
    model = TransformerLM(config, dtype=torch.float32, device="cpu", **kw)
    model.load_state_dict(model.tp_layout.local(inputs["moe_params"]) if grid == "tp"
                          else inputs["moe_params"])
    state = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0))
    state, metrics = make_train_step("lm", aux_weight=ranks.AUX_WEIGHT)(
        state, {"tokens": inputs["tokens"]})
    assert abs(float(metrics["loss"]) - one["adam_loss"]) <= 1e-5 * abs(one["adam_loss"])
    assert ("moe_aux_loss" in metrics) == ("moe_aux_loss" in one)
    for key in ("moe_aux_loss", "moe_dropped_frac"):
        if key in one:
            assert abs(float(metrics[key]) - one[key]) <= AUX_TOL, key
    params = model.full_state_dict()
    worst = max((rel(params[n], t), n) for n, t in one["params"].items())
    assert worst[0] <= 1e-5, worst


FLAGS = ["--device", "cpu", "--num_layers", "2", "--num_heads", "4", "--num_kv_heads", "2",
         "--head_dim", "16", "--d_model", "32", "--d_ff", "64", "--seq_len", "32",
         "--batch_size", "4", "--train_sequences", "40", "--num_epochs", "2",
         "--learning_rate", "1e-2", "--moe_experts", "4"]


def _cli(*argv: str, timeout: int = 180) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_train_lm_cli_ep2_tp2_logs_the_one_process_losses_and_generate_loads_it(tmp_path):
    """``--nproc 4 --ep 2 --tp 2``: the epoch losses and dropped fractions
    of one process; ``arch.json`` records the layout; ``cli.generate``
    (one process) loads the checkpoint and decodes."""
    one = _cli("deeplearning_mpi_tpu_torch.cli.train_lm", *FLAGS)
    assert one.returncode == 0, one.stderr[-2000:]
    got = _cli("deeplearning_mpi_tpu_torch.cli.train_lm", *FLAGS, "--nproc", "4", "--ep", "2",
               "--tp", "2", "--model_dir", str(tmp_path))
    assert got.returncode == 0, got.stderr[-2000:]
    pattern = r"^Epoch \d+: (?:loss|moe_dropped_frac) ([0-9.]+)"
    want = re.findall(pattern, one.stdout, re.M)
    assert len(want) == 4 and re.findall(pattern, got.stdout, re.M) == want
    arch = json.loads((tmp_path / "lm" / "arch.json").read_text())
    assert arch["layout"]["expert"] == 2 and arch["layout"]["model"] == 2
    gen = _cli("deeplearning_mpi_tpu_torch.cli.generate", *FLAGS[:14], "--moe_experts", "4",
               "--model_dir", str(tmp_path), "--prompt", "ab", "--max_new_tokens", "4",
               "--greedy")
    assert gen.returncode == 0, gen.stderr[-2000:]
