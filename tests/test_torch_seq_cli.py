"""The training CLI under sequence parallelism against the JAX train step.

``python -m deeplearning_mpi_tpu_torch.cli.train_lm --device cpu --nproc 4``
with ``--sp 4 --attention ring``, ``--dp 2 --sp 2 --attention ring`` and
``--sp 4 --attention ulysses`` trains ``TransformerConfig.tiny()``'s widths
(vocab 256) for one step of batch 4 at seq 32 (5 sequences: 4 train, 1
eval) and saves it. Its parameters after the step (atol 5e-5, rtol 1e-4,
``tests/test_torch_train.py``'s) and its logged epoch loss (printed to 4
decimals: within 6e-5) equal the JAX train step with the same schedule on a
``data x seq`` virtual mesh, from the port's seeded init on the loader's
first batch. The CLI refuses ``--sp`` without a sequence-parallel
attention; beside ``--moe_experts`` and ``--loss_chunk`` it logs one
process's losses.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.parallel import make_ring_attention_fn as jax_ring
from deeplearning_mpi_tpu.parallel import make_ulysses_attention_fn as jax_ulysses
from deeplearning_mpi_tpu.parallel import shard_state as jax_shard_state
from deeplearning_mpi_tpu.runtime.mesh import MeshSpec as JaxSpec
from deeplearning_mpi_tpu.runtime.mesh import batch_sharding as jax_batch_sharding
from deeplearning_mpi_tpu.runtime.mesh import create_mesh as jax_create_mesh
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train import make_train_step as jax_make_step
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--device", "cpu", "--num_layers", "2", "--num_heads", "4", "--head_dim", "8",
         "--d_model", "32", "--d_ff", "64", "--seq_len", "32", "--batch_size", "4",
         "--train_sequences", "5", "--num_epochs", "1", "--learning_rate", "1e-3"]
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)


def _cli(*extra):
    return subprocess.run([sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.train_lm",
                           *FLAGS, *extra], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "OMP_NUM_THREADS": "1"})


def _jax_params_from_port(sd, template):
    """The inverse of ``lm_params_from_jax``: each JAX leaf numbered element
    by element, converted, tells where each port element goes."""
    leaves, treedef = jax.tree.flatten(template)
    sizes = [leaf.size for leaf in leaves]
    offsets = np.cumsum([0] + sizes)
    ids = [np.arange(a, b, dtype=np.float64).reshape(leaf.shape)
           for a, b, leaf in zip(offsets[:-1], offsets[1:], leaves)]
    where = lm_params_from_jax(jax.tree.unflatten(treedef, ids))
    flat = np.zeros(offsets[-1], np.float32)
    for name, pos in where.items():
        flat[pos.numpy().astype(np.int64).ravel()] = sd[name].numpy().ravel()
    return jax.tree.unflatten(treedef, [flat[a:b].reshape(leaf.shape) for a, b, leaf
                                        in zip(offsets[:-1], offsets[1:], leaves)])


def _jax_step(data, sp, attention):
    """The JAX train step from the CLI's init and first batch: (loss, params)."""
    jc = JaxConfig.tiny()
    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=4, head_dim=8, d_model=32,
                            d_ff=64)
    init = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    mesh = jax_create_mesh(JaxSpec(data=data, seq=sp), devices=jax.devices()[:data * sp])
    fn = (jax_ring if attention == "ring" else jax_ulysses)(mesh)
    tx = jax_optimizer("adam", 1e-3, clip_norm=1.0)
    state = jax_create_state(JaxLM(config=jc, dtype=jnp.float32, attention_fn=fn),
                             jax.random.key(0), jnp.zeros((1, 32), jnp.int32), tx)
    params = _jax_params_from_port(init.state_dict(), jax.device_get(state.params))
    state = jax_shard_state(state.replace(params=params, opt_state=tx.init(params)), mesh)
    ds = SyntheticTokens(5, 32, seed=0)
    batch = next(iter(Loader([ds[i] for i in range(4)], 4, shuffle=True, seed=0,
                             device="cpu").epoch(0)))
    tokens = jax.device_put(batch["tokens"].numpy(), jax_batch_sharding(mesh, ndim=2))
    state, metrics = jax_make_step("lm", donate=False)(state, {"tokens": tokens})
    return float(metrics["loss"]), lm_params_from_jax(jax.device_get(state.params))


@pytest.mark.parametrize("data, sp, attention", [(1, 4, "ring"), (2, 2, "ring"),
                                                 (1, 4, "ulysses")],
                         ids=["sp4_ring", "dp2_sp2_ring", "sp4_ulysses"])
def test_sp_cli_step_matches_the_jax_step(tmp_path, data, sp, attention):
    out = _cli("--nproc", "4", "--dp", str(data), "--sp", str(sp), "--attention", attention,
               "--model_dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"attention {attention} (--sp {sp})" in out.stdout and "(gloo)" in out.stdout
    losses = [float(x) for x in re.findall(r"^Epoch 0: loss ([0-9.]+)", out.stdout, re.M)]
    want_loss, want = _jax_step(data, sp, attention)
    assert len(losses) == 1 and abs(losses[0] - want_loss) <= 6e-5, (losses, want_loss)
    got = torch.load(tmp_path / "lm" / "0" / "params.pt", weights_only=False)
    assert set(got) == set(want)
    for name, p in want.items():
        np.testing.assert_allclose(got[name].numpy(), p.numpy(), err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("extra, message", [
    (("--sp", "2"), "--attention ring or ulysses"),
    (("--nproc", "4", "--ep", "2", "--sp", "2", "--attention", "ring", "--moe_experts", "4"),
     None),
    (("--nproc", "4", "--sp", "4", "--attention", "ulysses", "--loss_chunk", "8"), None),
], ids=["no_schedule", "moe", "loss_chunk"])
def test_sp_cli_refusals(extra, message):
    """What ``--sp`` leaves out exits 1 with its reason; the MoE LM under
    ``--ep 2 --sp 2`` and the chunked loss under ``--sp 4`` (each refused
    before its slice) run and log one process's losses (and dropped
    fractions)."""
    out = _cli(*extra)
    if message is not None:
        assert out.returncode == 1 and message in out.stderr, out.stderr[-2000:]
        return
    model = [v for i, f in enumerate(extra) if f in ("--moe_experts", "--loss_chunk")
             for v in (f, extra[i + 1])]
    one = _cli(*model)
    assert out.returncode == 0 and one.returncode == 0, (out.stderr[-2000:], one.stderr[-2000:])
    pattern = r"^Epoch \d+: (?:loss|moe_dropped_frac) ([0-9.]+)"
    want = re.findall(pattern, one.stdout, re.M)
    assert want and re.findall(pattern, out.stdout, re.M) == want
