"""The PyTorch port stands alone: no JAX, flax, optax, orbax or JAX package.

An AST scan of every module of ``deeplearning_mpi_tpu_torch`` and of
``chip_smoke.py`` finds no such import; a subprocess with ``jax`` blocked in
``sys.modules`` imports the port's serving engine and generation and runs
one tiny engine step, one train step with flash attention, a checkpoint
save and verified restore, a beam search and an int8 conversion on the
CPU, then a warmed engine with a draft, int8 KV pools and the prefix
cache, and imports the CLIs; and one that runs the original workloads'
path: hello_world over gloo, a CNN train and eval step on the CIFAR loader,
and the CNN CLIs' imports; one that runs the MoE LM's path (an
expert-sharded step over gloo, its checkpoint, stepwise MoE generation);
one that runs the sequence-parallel path (the one-process ring and
Ulysses, an LM step under a seq mesh over gloo); three for tensor
parallelism and ZeRO-1: ``train_lm --tp 2`` and ``--zero_overlap`` over 2
gloo processes, ``generate --tp 2`` in one; one for pipeline parallelism
(``train_lm --pp 2`` over 2 gloo processes, a ``LockstepPipe`` step and
its checkpoint in one), one for each composed layout and each combination
lifted beside them (``--pp x --ep``, ``--loss_chunk x --sp``, ZeRO-1 beside
``--ep`` / ``--sp`` / ``--pp``, Adafactor beside ``--tp`` / ``--ep`` /
``--pp``: ``train_lm`` over 4 gloo processes) one for the ViT (a step,
``train_resnet --arch vit_tiny``) and one for the telemetry (``train_lm``
with ``--metrics_dir --log_dir --profile_dir``, a traced ``Trainer`` epoch,
``serve_lm --metrics_file``), two for the compiler layer
(``train_lm --aot_warmup --tuned_step``, ``cli.autotune --selftest``), and
two for the resilience layer (``train_lm --chaos ... --max_restarts 1``,
``cli.launch_pod`` over a tiny worker) and two for its serving half (a
warmed disaggregated pair under chaos, a fleet worker serving from its
inbox), each process with jax blocked. The
AST scan covers every module of the package, the compiler layer's
(``compiler/aot.py``, ``autotune.py``, ``cache.py``, ``cli/autotune.py``)
and the resilience layer's (``resilience/faults.py``, ``supervisor.py``,
``watchdog.py``, ``guardrails.py``, ``cluster.py``, ``pod.py``,
``train/resilience.py``, ``cli/launch_pod.py``) and the serving half's
(``serving/disagg.py``, ``router.py``, ``autoscaler.py``, ``fleet.py``,
``cli/controlplane_drill.py``) included, and five for the last modules
(the sanitize drill, the linter, the simulator and its sweep, a ``.pth``
import evaluated through ``train_resnet``, a threaded native-loader
epoch), with the scan covering ``analysis/``, ``sim/``,
``utils/torch_import.py``, ``data/native.py`` and their CLIs.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deeplearning_mpi_tpu")
#: The subprocesses run tiny shapes: one intra-op thread each.
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
PORT_FILES = sorted((ROOT / "deeplearning_mpi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from deeplearning_mpi_tpu_torch.models.generate import generate\n"
        "from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM\n"
        "from deeplearning_mpi_tpu_torch.serving.engine import EngineConfig, ServingEngine\n"
        "m = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device='cpu').init_weights(0)\n"
        "e = ServingEngine(m, EngineConfig())\n"
        "r = e.submit(np.arange(1, 6, dtype=np.int32), 3)\n"
        "e.run_until_idle()\n"
        "want = generate(m, torch.arange(1, 6)[None], max_new_tokens=3, temperature=0.0)\n"
        "assert r.generated == want[0, 5:].tolist()\n"
        "from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens\n"
        "from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd\n"
        "from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step\n"
        "s = create_train_state(m, build_optimizer('adam', 1e-3, clip_norm=1.0), attention_fn=flash_attention_bhsd)\n"
        "batch = next(Loader(SyntheticTokens(4, 32), 4, device='cpu').epoch(0))\n"
        "s, metrics = make_train_step('lm')(s, batch)\n"
        "assert s.step == 1 and float(metrics['finite']) == 1.0\n"
        "import tempfile\n"
        "from deeplearning_mpi_tpu_torch.models.generate import beam_search\n"
        "from deeplearning_mpi_tpu_torch.ops.quant import quantize_lm_params\n"
        "from deeplearning_mpi_tpu_torch.resilience import tree_digests\n"
        "from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer\n"
        "ck = Checkpointer(tempfile.mkdtemp())\n"
        "ck.save(s, epoch=0)\n"
        "r, epoch = ck.restore_verified(create_train_state(m, build_optimizer('adam', 1e-3, clip_norm=1.0)))\n"
        "assert epoch == 0 and tree_digests(r.arrays()) == tree_digests(s.arrays())\n"
        "assert beam_search(m, torch.arange(1, 6)[None], max_new_tokens=3, num_beams=2).shape == (1, 8)\n"
        "assert any(k.endswith('.kernel') for k in quantize_lm_params(m.state_dict()))\n"
        "from deeplearning_mpi_tpu_torch.models.transformer import self_draft\n"
        "e = ServingEngine(m, EngineConfig(spec_k=2, kv_dtype='int8', prefix_cache=True), draft=self_draft(m, 1))\n"
        "e.warmup()\n"
        "r = e.submit(np.arange(1, 6, dtype=np.int32), 3)\n"
        "e.run_until_idle()\n"
        "assert r.generated and e.counters['spec_proposed_total'] > 0\n"
        "import deeplearning_mpi_tpu_torch.cli.generate, deeplearning_mpi_tpu_torch.cli.train_lm\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=ENV)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_original_workloads_run_with_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from deeplearning_mpi_tpu_torch.runtime import bootstrap\n"
        "from deeplearning_mpi_tpu_torch.runtime.hello_world import run_hello_world\n"
        "from deeplearning_mpi_tpu_torch.runtime.mesh import create_mesh, data_group\n"
        f"bootstrap.init('file://{tmp_path}/store', 1, 0, 'cpu', timeout_s=60)\n"
        "assert run_hello_world().ok\n"
        "group = data_group(create_mesh(device='cpu'))\n"
        "from deeplearning_mpi_tpu_torch.data import Loader, SyntheticCIFAR10\n"
        "from deeplearning_mpi_tpu_torch.data.cifar10 import train_transform\n"
        "from deeplearning_mpi_tpu_torch.models import get_model\n"
        "from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_eval_step, make_train_step\n"
        "m = get_model('resnet18', num_filters=8, device='cpu').init_weights(0)\n"
        "s = create_train_state(m, build_optimizer('sgd', 0.1, weight_decay=1e-5))\n"
        "batch = next(Loader(SyntheticCIFAR10(8), 8, transform=train_transform, device='cpu').epoch(0))\n"
        "s, metrics = make_train_step('classification', group=group)(s, batch)\n"
        "assert s.step == 1 and float(metrics['finite']) == 1.0 and 'batch_stats' in s.arrays()\n"
        "assert 'accuracy' in make_eval_step('classification')(s, batch)\n"
        "bootstrap.shutdown()\n"
        "import deeplearning_mpi_tpu_torch.cli.train_resnet, deeplearning_mpi_tpu_torch.cli.train_unet\n"
        "import deeplearning_mpi_tpu_torch.cli.hello_world, deeplearning_mpi_tpu_torch.cli.download\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=ENV)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_moe_path_runs_with_jax_blocked(tmp_path):
    """The MoE LM's path with jax blocked: an expert-sharded train step over
    gloo at world size 1, the checkpoint's gathered stacks restored, the
    stepwise MoE generation, and the MoE modules' imports."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import tempfile, torch\n"
        "from deeplearning_mpi_tpu_torch.runtime import bootstrap\n"
        "from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh, data_group\n"
        f"bootstrap.init('file://{tmp_path}/store', 1, 0, 'cpu', timeout_s=60)\n"
        "mesh = create_mesh(MeshSpec(data=1, expert=1), device='cpu')\n"
        "from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens\n"
        "from deeplearning_mpi_tpu_torch.models.generate import generate\n"
        "from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM\n"
        "from deeplearning_mpi_tpu_torch.parallel.expert_parallel import ExpertShards\n"
        "from deeplearning_mpi_tpu_torch.resilience import tree_digests\n"
        "from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step\n"
        "from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer\n"
        "shards = ExpertShards(mesh.get_group('expert'), 1, 0)\n"
        "m = TransformerLM(TransformerConfig.tiny_moe(), dtype=torch.float32, device='cpu',\n"
        "                  expert_shards=shards).init_weights(0)\n"
        "s = create_train_state(m, build_optimizer('adam', 1e-3, clip_norm=1.0))\n"
        "batch = next(Loader(SyntheticTokens(4, 16), 4, grad_accum=2, device='cpu').epoch(0))\n"
        "step = make_train_step('lm', aux_weight=0.01, grad_accum=2, group=data_group(mesh))\n"
        "s, metrics = step(s, batch)\n"
        "assert s.step == 1 and 'moe_dropped_frac' in metrics and 'moe_aux_loss' in metrics\n"
        "ck = Checkpointer(tempfile.mkdtemp())\n"
        "ck.save(s, epoch=0)\n"
        "r, _ = ck.restore_verified(create_train_state(m, build_optimizer('adam', 1e-3)))\n"
        "assert tree_digests(r.arrays()) == tree_digests(s.arrays())\n"
        "assert generate(m, torch.arange(1, 6)[None], max_new_tokens=3, temperature=0.0).shape == (1, 8)\n"
        "bootstrap.shutdown()\n"
        "import deeplearning_mpi_tpu_torch.models.moe, deeplearning_mpi_tpu_torch.cli.serve_lm\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=ENV)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sequence_parallel_path_runs_with_jax_blocked(tmp_path):
    """The sequence-parallel path with jax blocked: the one-process ring
    (both inners) and Ulysses, and an LM train step under a seq mesh over
    gloo at world size 1, with the ``parallel`` modules' imports."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn, make_ulysses_attention_fn\n"
        "from deeplearning_mpi_tpu_torch.parallel import seq_common, ring_flash\n"
        "q, k, v = (torch.randn(2, 16, 4, 8) for _ in range(3))\n"
        "outs = [make_ring_attention_fn(sp=4, flash=f)(q, k, v) for f in (True, False)]\n"
        "outs.append(make_ulysses_attention_fn(sp=4)(q, k, v))\n"
        "assert all(torch.allclose(o, outs[0], atol=1e-5) for o in outs)\n"
        "from deeplearning_mpi_tpu_torch.runtime import bootstrap\n"
        "from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh, data_group, seq_shards\n"
        f"bootstrap.init('file://{tmp_path}/store', 1, 0, 'cpu', timeout_s=60)\n"
        "mesh = create_mesh(MeshSpec(data=1, seq=1), device='cpu')\n"
        "from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens\n"
        "from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM\n"
        "from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step\n"
        "m = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device='cpu').init_weights(0)\n"
        "s = create_train_state(m, build_optimizer('adam', 1e-3, clip_norm=1.0),\n"
        "                       attention_fn=make_ring_attention_fn(mesh))\n"
        "batch = next(Loader(SyntheticTokens(4, 16), 4, device='cpu').epoch(0))\n"
        "step = make_train_step('lm', group=data_group(mesh), seq=seq_shards(mesh))\n"
        "s, metrics = step(s, batch)\n"
        "assert s.step == 1 and float(metrics['finite']) == 1.0\n"
        "bootstrap.shutdown()\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=ENV)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


_BLOCKED_RANK = (
    "import sys\n"
    "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
    "    sys.modules[name] = None\n"
    "from deeplearning_mpi_tpu_torch.cli import train_lm\n"
    "rank, store, extra = int(sys.argv[1]), sys.argv[2], sys.argv[3:]\n"
    "rc = train_lm.main(['--device', 'cpu', '--num_layers', '1', '--num_heads', '4',\n"
    "                    '--head_dim', '32', '--d_model', '128', '--d_ff', '512',\n"
    "                    '--seq_len', '16', '--batch_size', '4', '--train_sequences', '12',\n"
    "                    '--num_epochs', '1', '--coordinator', 'file://' + store,\n"
    "                    '--num_processes', '2', '--process_id', str(rank), *extra])\n"
    "assert rc == 0, rc\n"
    "print('ok')\n"
)


@pytest.mark.parametrize("path", ["train_lm_tp", "zero_overlap", "generate_tp"])
def test_tensor_parallel_and_zero_paths_run_with_jax_blocked(path, tmp_path):
    """``train_lm --tp 2`` (the process-group form over gloo) and ``--dp 2
    --zero_overlap`` (the bucketed schedule) as 2 processes, and
    ``generate --tp 2`` (the one-process form) on a port checkpoint, each
    process with jax blocked."""
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    if path == "generate_tp":
        code = (
            "import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from deeplearning_mpi_tpu_torch.cli import generate, train_lm\n"
            "T = ['--device', 'cpu', '--num_layers', '1', '--num_heads', '4', '--head_dim', '16',\n"
            "     '--d_model', '32', '--d_ff', '64']\n"
            f"d = '{tmp_path}'\n"
            "assert train_lm.main(T + ['--seq_len', '16', '--batch_size', '4',\n"
            "    '--train_sequences', '12', '--num_epochs', '1', '--model_dir', d]) == 0\n"
            "g = generate.run(T + ['--model_dir', d, '--prompt', 'ab', '--max_new_tokens', '4',\n"
            "                      '--greedy', '--tp', '2'])\n"
            "assert g.tokens.shape == (1, 6)\n"
            "print('ok')\n"
        )
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
        return
    extra = ["--tp", "2"] if path == "train_lm_tp" else ["--dp", "2", "--zero_overlap"]
    procs = [subprocess.Popen([sys.executable, "-c", _BLOCKED_RANK, str(r),
                               str(tmp_path / "store"), *extra], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and stdout.strip().endswith("ok"), stderr
    if path == "zero_overlap":
        assert "explicit bucketed ZeRO-1 schedule active" in outs[0][0]


def test_pipeline_runs_with_jax_blocked(tmp_path):
    """``train_lm --pp 2 --microbatches 2`` (the process-group form over
    gloo) as 2 processes, and one process's ``LockstepPipe(2)`` step with a
    checkpoint round trip, each with jax blocked."""
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    extra = ["--num_layers", "2", "--pp", "2", "--microbatches", "2"]
    procs = [subprocess.Popen([sys.executable, "-c", _BLOCKED_RANK, str(r),
                               str(tmp_path / "store"), *extra], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    code = (
        "import sys, tempfile\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM\n"
        "from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig\n"
        "from deeplearning_mpi_tpu_torch.parallel.pipeline import LockstepPipe\n"
        "from deeplearning_mpi_tpu_torch.resilience import tree_digests\n"
        "from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step\n"
        "from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer\n"
        "def state():\n"
        "    m = PipelinedLM(TransformerConfig.tiny(), num_stages=2, num_microbatches=2,\n"
        "                    dtype=torch.float32, device='cpu', pipe=LockstepPipe(2)).init_weights(0)\n"
        "    return create_train_state(m, build_optimizer('adam', 1e-3, clip_norm=1.0))\n"
        "s, metrics = make_train_step('lm')(state(), {'tokens': torch.randint(0, 256, (4, 16))})\n"
        "assert s.step == 1 and float(metrics['finite']) == 1.0\n"
        "ck = Checkpointer(tempfile.mkdtemp())\n"
        "ck.save(s, epoch=0)\n"
        "r, _ = ck.restore_verified(state())\n"
        "assert tree_digests(r.arrays()) == tree_digests(s.arrays())\n"
        "print('ok')\n"
    )
    one = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert one.returncode == 0 and one.stdout.strip() == "ok", one.stderr
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and stdout.strip().endswith("ok"), stderr
    assert "--pp 2 x 2 microbatches" in outs[0][0]


_BLOCKED_RANK4 = _BLOCKED_RANK.replace("'--num_layers', '1'", "'--num_layers', '2'").replace(
    "'--num_processes', '2'", "'--num_processes', '4'")


@pytest.mark.parametrize("layout", [
    ["--pp", "2", "--tp", "2", "--microbatches", "2"],
    ["--tp", "2", "--sp", "2", "--attention", "ulysses"],
    ["--moe_experts", "4", "--ep", "2", "--sp", "2", "--attention", "ring"],
    ["--moe_experts", "4", "--ep", "2", "--tp", "2"],
], ids=["pp_tp", "tp_sp", "ep_sp", "ep_tp"])
def test_composed_layouts_run_with_jax_blocked(layout, tmp_path):
    """``train_lm`` under each composition (4 gloo processes), every
    process with jax blocked."""
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _BLOCKED_RANK4, str(r),
                               str(tmp_path / "store"), *layout], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and stdout.strip().endswith("ok"), stderr[-2000:]


@pytest.mark.parametrize("layout", [
    ["--moe_experts", "4", "--pp", "2", "--ep", "2", "--microbatches", "2"],
    ["--dp", "2", "--sp", "2", "--attention", "ring", "--loss_chunk", "8"],
    ["--moe_experts", "4", "--dp", "2", "--ep", "2", "--zero"],
    ["--dp", "2", "--sp", "2", "--attention", "ring", "--zero"],
    ["--dp", "2", "--pp", "2", "--zero", "--microbatches", "2"],
    ["--dp", "2", "--tp", "2", "--optimizer", "adafactor"],
    ["--moe_experts", "4", "--dp", "2", "--ep", "2", "--optimizer", "adafactor"],
    ["--dp", "2", "--pp", "2", "--optimizer", "adafactor", "--microbatches", "2"],
], ids=["pp_ep", "loss_chunk_sp", "zero_ep", "zero_sp", "zero_pp", "adafactor_tp",
        "adafactor_ep", "adafactor_pp"])
def test_completed_layouts_run_with_jax_blocked(layout, tmp_path):
    """``train_lm`` under each combination lifted beside the composed
    layouts (4 gloo processes), every process with jax blocked."""
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _BLOCKED_RANK4, str(r),
                               str(tmp_path / "store"), *layout], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and stdout.strip().endswith("ok"), stderr[-2000:]


def test_vit_runs_with_jax_blocked():
    """A ViT step and ``train_resnet --arch vit_tiny --synthetic`` with jax
    blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from deeplearning_mpi_tpu_torch.models.vit import ViT\n"
        "from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step\n"
        "m = ViT(10, patch_size=8, num_layers=1, num_heads=2, head_dim=8, d_model=16, d_ff=32,\n"
        "        dtype=torch.float32, device='cpu').init_weights(0)\n"
        "s = create_train_state(m, build_optimizer('adam', 1e-3))\n"
        "batch = {'image': torch.randn(2, 32, 32, 3), 'label': torch.tensor([1, 2])}\n"
        "s, metrics = make_train_step('classification')(s, batch)\n"
        "assert float(metrics['finite']) == 1.0\n"
        "from deeplearning_mpi_tpu_torch.cli import train_resnet\n"
        "assert train_resnet.main(['--device', 'cpu', '--arch', 'vit_tiny', '--synthetic',\n"
        "    '--num_epochs', '1', '--batch_size', '8', '--train_samples', '8']) == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=ENV)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


def test_telemetry_path_runs_with_jax_blocked(tmp_path):
    """The telemetry path with jax blocked: ``train_lm`` with
    ``--metrics_dir --log_dir --profile_dir``, a traced ``Trainer`` epoch,
    and ``serve_lm --selftest --metrics_file`` with the engine's registry."""
    code = (
        "import json, pathlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"tmp = pathlib.Path({str(tmp_path)!r})\n"
        "from deeplearning_mpi_tpu_torch.cli import serve_lm, train_lm\n"
        "tiny = ['--num_layers', '2', '--num_heads', '2', '--head_dim', '8', '--d_model', '16',\n"
        "        '--d_ff', '32']\n"
        "assert train_lm.main(['--device', 'cpu', *tiny, '--seq_len', '16', '--batch_size', '4',\n"
        "    '--train_sequences', '20', '--num_epochs', '1', '--metrics_dir', str(tmp / 'm'),\n"
        "    '--log_dir', str(tmp / 'l'), '--profile_dir', str(tmp / 'p')]) == 0\n"
        "kinds = [json.loads(l)['kind'] for l in (tmp / 'm' / 'metrics.jsonl').open()]\n"
        "assert kinds[-2:] == ['epoch', 'run_summary'] and 'step' in kinds, kinds\n"
        "assert list((tmp / 'p').iterdir()) and len(list((tmp / 'l').iterdir())) == 3\n"
        "assert (tmp / 'l' / 'heartbeat.json').is_file()  # the run log, its sidecar, the beat\n"
        "import torch\n"
        "from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens\n"
        "from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM\n"
        "from deeplearning_mpi_tpu_torch.telemetry import SpanRecorder\n"
        "from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state\n"
        "m = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device='cpu').init_weights(0)\n"
        "tracer = SpanRecorder(tmp / 'trace_t.jsonl', proc='trainer')\n"
        "t = Trainer(create_train_state(m, build_optimizer('adam', 1e-3)), 'lm', tracer=tracer)\n"
        "stats = t.run_epoch(Loader(SyntheticTokens(8, 16), 4, device='cpu'), 0)\n"
        "assert abs(sum(v for k, v in stats.items() if k.startswith('phase_'))\n"
        "           - stats['duration_s']) <= 1e-9\n"
        "assert serve_lm.main(['--selftest', '--device', 'cpu', *tiny, '--num_requests', '4',\n"
        "    '--metrics_file', str(tmp / 'serve.jsonl')]) == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=ENV)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


@pytest.mark.parametrize("path", ["train_lm_aot_tuned", "autotune_selftest"])
def test_compiler_paths_run_with_jax_blocked(path, tmp_path):
    """The compiler layer with jax blocked: ``train_lm --aot_warmup
    --tuned_step`` on a DB written by ``compiler.autotune``, and
    ``cli.autotune --selftest``."""
    block = ("import sys\n"
             "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
             "    sys.modules[name] = None\n")
    if path == "autotune_selftest":
        code = block + ("from deeplearning_mpi_tpu_torch.cli import autotune\n"
                        "assert autotune.main(['--selftest', '--device', 'cpu']) == 0\n")
    else:
        db = tmp_path / "tuned.json"
        code = block + (
            "import torch\n"
            "from deeplearning_mpi_tpu_torch.cli import train_lm\n"
            "from deeplearning_mpi_tpu_torch.compiler import autotune\n"
            f"db = autotune.TuningDB({str(db)!r})\n"
            "db.record_key(autotune.step_tuning_key('lm', (4, 16), None, torch.float32, 'cpu'),\n"
            "              {'remat': 'full', 'grad_accum': 2, 'overlap': False})\n"
            "db.save()\n"
            "assert train_lm.main(['--device', 'cpu', '--num_layers', '2', '--num_heads', '2',\n"
            "    '--head_dim', '8', '--d_model', '16', '--d_ff', '32', '--seq_len', '16',\n"
            "    '--batch_size', '4', '--train_sequences', '20', '--num_epochs', '1',\n"
            f"    '--aot_warmup', '--tuned_step', {str(db)!r}]) == 0\n")
    out = subprocess.run([sys.executable, "-c", code + "print('ok')\n"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=ENV)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
    if path == "train_lm_aot_tuned":
        assert "tuned step schedule" in out.stdout and "warmup: no CUDA graph" in out.stdout


RESILIENCE_MODULES = ["resilience/faults.py", "resilience/supervisor.py", "resilience/watchdog.py",
                      "resilience/guardrails.py", "resilience/cluster.py", "resilience/pod.py",
                      "train/resilience.py", "cli/launch_pod.py"]


def test_scan_covers_the_resilience_layer():
    scanned = {p.relative_to(ROOT / "deeplearning_mpi_tpu_torch").as_posix() for p in PORT_FILES
               if p.name != "chip_smoke.py"}
    assert set(RESILIENCE_MODULES) <= scanned


@pytest.mark.parametrize("path", ["train_lm_chaos", "launch_pod"])
def test_resilience_paths_run_with_jax_blocked(path, tmp_path):
    """The resilience layer with jax blocked: ``train_lm --chaos
    kill@step:4,corrupt_ckpt@epoch:0 --max_restarts 1`` (the kill restarted
    from a fresh init, the corrupt save walked past), and ``cli.launch_pod``
    over 2 tiny workers with ``rank_kill`` re-formed onto 1."""
    block = ("import sys\n"
             "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
             "    sys.modules[name] = None\n")
    if path == "train_lm_chaos":
        code = block + (
            "from deeplearning_mpi_tpu_torch.cli import train_lm\n"
            "assert train_lm.main(['--device', 'cpu', '--num_layers', '1', '--num_heads', '2',\n"
            "    '--head_dim', '8', '--d_model', '16', '--d_ff', '32', '--seq_len', '16',\n"
            "    '--batch_size', '4', '--train_sequences', '20', '--num_epochs', '2',\n"
            f"    '--model_dir', {str(tmp_path / 'm')!r}, '--restart_delay_s', '0',\n"
            "    '--chaos', 'kill@step:4,corrupt_ckpt@epoch:0', '--max_restarts', '1']) == 0\n")
    else:
        worker = tmp_path / "worker.py"
        worker.write_text(
            "import json, os, time\n"
            "rank, world = int(os.environ.get('PROCESS_ID', 0)), int(os.environ.get('NUM_PROCESSES', 1))\n"
            "for step in range(10):\n"
            "    path = os.path.join(os.environ['DMT_HEARTBEAT_DIR'], f'heartbeat-{rank}.json')\n"
            "    open(path + '.tmp', 'w').write(json.dumps({'progress_seq': step + 1, 'step': step}))\n"
            "    os.replace(path + '.tmp', path)\n"
            "    if rank == world - 1 and 'rank_kill' in os.environ.get('DMT_CHAOS', '') and step == 3:\n"
            "        os._exit(23)\n"
            "    time.sleep(0.05)\n")
        code = block + (
            "from deeplearning_mpi_tpu_torch.cli import launch_pod\n"
            f"assert launch_pod.main(['--num_processes', '2', '--pod_dir', {str(tmp_path / 'pod')!r},\n"
            "    '--chaos', 'rank_kill@step:3', '--heartbeat_interval_s', '0.05',\n"
            "    '--poll_interval_s', '0.05', '--heartbeat_deadline_s', '5',\n"
            f"    '--', sys.executable, {str(worker)!r}]) == 0\n")
    out = subprocess.run([sys.executable, "-c", code + "print('ok')\n"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=ENV)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
    if path == "train_lm_chaos":
        assert "chaos: 2 fault(s) injected, 1 recovered, 1 rolled back" in out.stdout
    else:
        assert "re-forming: world 2 -> 1" in out.stdout


SERVING_RESILIENCE_MODULES = ["serving/disagg.py", "serving/router.py", "serving/autoscaler.py",
                              "serving/fleet.py", "cli/controlplane_drill.py"]


def test_scan_covers_the_serving_half_of_the_resilience_layer():
    scanned = {p.relative_to(ROOT / "deeplearning_mpi_tpu_torch").as_posix() for p in PORT_FILES
               if p.name != "chip_smoke.py"}
    assert set(SERVING_RESILIENCE_MODULES) <= scanned


@pytest.mark.parametrize("path", ["disagg", "fleet_worker"])
def test_serving_resilience_paths_run_with_jax_blocked(path, tmp_path):
    """The serving half with jax blocked: a warmed disaggregated pair under
    ``handoff_stall`` and ``serve_crash`` drains with its books balanced;
    a fleet worker (``serving.fleet.worker_main``, as the supervisor spawns
    it) serves two requests from its inbox, swaps its weights in place and
    stops, reporting its launch counts."""
    block = ("import sys\n"
             "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
             "    sys.modules[name] = None\n")
    model = {"vocab_size": 256, "num_layers": 1, "num_heads": 2, "num_kv_heads": None,
             "head_dim": 8, "d_model": 16, "d_ff": 32, "attention_window": 0}
    engine = {"max_slots": 2, "block_size": 4, "num_blocks": 16, "max_blocks_per_seq": 4,
              "prefill_chunk": 4}
    if path == "disagg":
        code = block + (
            "import numpy as np\n"
            "from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM\n"
            "from deeplearning_mpi_tpu_torch.resilience.faults import ChaosInjector\n"
            "from deeplearning_mpi_tpu_torch.serving import DisaggregatedEngine, EngineConfig\n"
            f"model = TransformerLM(TransformerConfig(**{model!r}), device='cpu').init_weights(0)\n"
            "chaos = ChaosInjector.from_spec('handoff_stall@step:2,serve_crash@step:4')\n"
            f"engine = DisaggregatedEngine(model, EngineConfig(**{engine!r}), chaos=chaos)\n"
            "assert engine.warmup()\n"
            "reqs = [engine.submit(np.arange(1, n + 1), 4) for n in (3, 6, 2)]\n"
            "engine.run_until_idle()\n"
            "assert all(r.state.value == 'finished' for r in reqs) and chaos.balanced()\n"
            "assert engine.counters['serve_handoffs_total'] >= 3 and engine.pool.in_use == 0\n")
    else:
        import json

        rdir = tmp_path / "replica0-a0"
        rdir.mkdir()
        (rdir / "spec.json").write_text(json.dumps({
            "model": model, "engine": engine, "seed": 0, "version": 0, "warmup": True,
            "device": "cpu", "threads": 1}))
        (rdir / "inbox.jsonl").write_text("".join(json.dumps(m) + "\n" for m in (
            {"op": "req", "rid": 0, "prompt": [1, 2, 3], "max_new": 3},
            {"op": "req", "rid": 1, "prompt": [4, 5], "max_new": 2})))
        code = block + (
            "from deeplearning_mpi_tpu_torch.serving.fleet import worker_main\n"
            f"assert worker_main(['--replica', '0', '--dir', {str(rdir)!r},\n"
            f"                    '--spec', {str(rdir / 'spec.json')!r}]) == 0\n")
    proc = subprocess.Popen([sys.executable, "-c", code + "print('ok')\n"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
    if path == "fleet_worker":
        import time

        outbox, deadline = rdir / "outbox.jsonl", time.monotonic() + 90
        while time.monotonic() < deadline and proc.poll() is None:
            text = outbox.read_text() if outbox.exists() else ""
            if text.count('"op": "done"') == 2:
                break
            time.sleep(0.05)
        with open(rdir / "inbox.jsonl", "a") as f:
            f.write(json.dumps({"op": "swap", "seed": 1, "version": 1}) + "\n"
                    + json.dumps({"op": "stop"}) + "\n")
    try:
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0 and stdout.strip().endswith("ok"), stdout + stderr
    if path == "fleet_worker":
        ops = [json.loads(line) for line in (rdir / "outbox.jsonl").read_text().splitlines()]
        assert [m["op"] for m in ops][0] == "ready" and ops[-1]["op"] == "stopped"
        assert sorted(m["rid"] for m in ops if m["op"] == "done") == [0, 1]
        swapped = [m for m in ops if m["op"] == "swapped"]
        assert swapped and swapped[0]["in_place"] is True
        assert ops[-1]["launches"] == {"K1": 0, "K4": 0, "captures": ops[0]["compile_total"],
                                       "served": 2}


#: The modules the tensor-parallel serving slice changed.
TP_SERVING_MODULES = ["serving/kv_pool.py", "serving/engine.py", "serving/disagg.py",
                      "serving/fleet.py", "compiler/aot.py", "cli/serve_lm.py",
                      "resilience/guardrails.py", "resilience/pod.py"]


def test_scan_covers_the_tensor_parallel_serving_modules():
    scanned = {p.relative_to(ROOT / "deeplearning_mpi_tpu_torch").as_posix() for p in PORT_FILES
               if p.name != "chip_smoke.py"}
    assert set(TP_SERVING_MODULES) <= scanned


def test_serve_lm_fleet_tp_runs_with_jax_blocked(tmp_path):
    """``serve_lm --replicas 2 --tp 2`` on the CPU with jax blocked in the
    supervisor's process: two tensor-parallel replicas serve the trace and
    every stream passes the CLI's bit-exact parity check."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from deeplearning_mpi_tpu_torch.cli.serve_lm import main\n"
        "rc = main(['--selftest', '--device', 'cpu', '--replicas', '2', '--tp', '2',\n"
        "           '--num_layers', '1', '--num_heads', '2', '--head_dim', '16',\n"
        "           '--d_model', '64', '--d_ff', '128', '--num_requests', '4',\n"
        f"           '--max_new_tokens', '4', '--fleet_dir', {str(tmp_path / 'f')!r}])\n"
        "assert rc == 0, rc\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=180, env=ENV)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
    assert "fleet OK: 4 requests bit-identical to offline greedy" in out.stderr


#: The last modules of the port: the analysis package, the simulator, the
#: .pth import and the native loader.
LAST_MODULES = (
    "analysis/__init__.py", "analysis/core.py", "analysis/passes.py", "analysis/lint.py",
    "analysis/sanitizer.py", "sim/__init__.py", "sim/traces.py", "sim/simulator.py",
    "sim/search.py", "cli/sim_drill.py", "cli/sanitize_drill.py", "cli/import_torch.py",
    "utils/torch_import.py", "data/native.py", "data/loader.py",
)


def test_scan_covers_the_last_modules():
    scanned = {p.relative_to(ROOT / "deeplearning_mpi_tpu_torch").as_posix() for p in PORT_FILES
               if p.name != "chip_smoke.py"}
    assert set(LAST_MODULES) <= scanned


@pytest.mark.parametrize("path", ["sanitizer", "linter", "simulator", "import_cli",
                                  "native_loader"])
def test_last_modules_run_with_jax_blocked(path, tmp_path):
    """Each of the last modules with jax blocked: the sanitize drill on the
    CPU (every injection classified); the linter over the port's tree (0
    findings) and over the fixture corpus (8); a trace simulated and swept;
    a ``.pth`` imported and evaluated through ``train_resnet --eval_only``;
    a threaded epoch of native-transformed CIFAR batches."""
    block = ("import sys\n"
             "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deeplearning_mpi_tpu'):\n"
             "    sys.modules[name] = None\n")
    code = {
        "sanitizer": (
            "from deeplearning_mpi_tpu_torch.cli import sanitize_drill\n"
            "assert sanitize_drill.main(['--device', 'cpu']) == 0\n"),
        "linter": (
            "from deeplearning_mpi_tpu_torch.analysis import lint\n"
            "assert lint.main([]) == 0\n"
            "from deeplearning_mpi_tpu_torch.analysis.core import run_lint\n"
            f"found = run_lint([__import__('pathlib').Path({str(ROOT / 'tests/fixtures/torch_lint')!r})],"
            " suppressions={})\n"
            "assert len(found) == 8, found\n"),
        "simulator": (
            "from deeplearning_mpi_tpu_torch.serving.autoscaler import AutoscalerConfig\n"
            "from deeplearning_mpi_tpu_torch.sim import *\n"
            "e = to_fleet_entries(generate_entries(TraceConfig(duration_s=30.0, base_rps=4.0), 0))\n"
            "cfg = SimConfig(autoscale=AutoscalerConfig(min_replicas=1, max_replicas=3))\n"
            "r = FleetSimulator(cfg).run(e)\n"
            "assert r.completed + r.shed_total == r.requests == len(e)\n"
            "s = run_sweep(e, cfg, [{}, {'hedge_ms': 400.0}], trace_key=trace_digest(e))\n"
            "assert s.key.startswith('simpolicy|')\n"),
        "import_cli": (
            "import numpy as np, torch\n"
            "from deeplearning_mpi_tpu_torch.models.resnet import resnet18\n"
            "from deeplearning_mpi_tpu_torch.cli import import_torch, train_resnet\n"
            "names = {'Conv_0': 'conv1', 'BatchNorm_0': 'bn1', 'Dense_0': 'fc'}\n"
            "m = resnet18(num_classes=10, torch_padding=True, device='cpu').init_weights(1)\n"
            "sd = {}\n"
            "for k, v in m.state_dict().items():\n"
            "    mod, leaf = k.rsplit('.', 1)\n"
            "    parts = mod.split('.')\n"
            "    if parts[0] in names: sd[names[parts[0]] + '.' + leaf] = v\n"
            "    else:\n"
            "        b = int(parts[0].split('_')[1]); i = int(parts[1].split('_')[1])\n"
            "        src = f'layer{b // 2 + 1}.{b % 2}.'\n"
            "        src += ('downsample.' + ('0' if 'Conv' in parts[1] else '1') if i == 2\n"
            "                else ('conv' if 'Conv' in parts[1] else 'bn') + str(i + 1))\n"
            "        sd[src + '.' + leaf] = v\n"
            f"torch.save({{'module.' + k: v for k, v in sd.items()}}, {str(tmp_path / 'r.pth')!r})\n"
            f"assert import_torch.main(['--input', {str(tmp_path / 'r.pth')!r}, '--arch', 'resnet18',"
            f" '--model_dir', {str(tmp_path / 'ck')!r}, '--device', 'cpu']) == 0\n"
            "t = train_resnet.train(['--device', 'cpu', '--synthetic', '--batch_size', '8',"
            " '--train_samples', '16', '--torch_padding', '--eval_only', '--model_dir',"
            f" {str(tmp_path / 'ck')!r}])\n"
            "assert 'accuracy' in t.history[-1]\n"),
        "native_loader": (
            "from deeplearning_mpi_tpu_torch.data import Loader, SyntheticCIFAR10\n"
            "from deeplearning_mpi_tpu_torch.data.native import native_available, train_transform\n"
            "ds = SyntheticCIFAR10(32, seed=0)\n"
            "a = [b['image'] for b in Loader(ds, 8, transform=train_transform, device='cpu',"
            " num_workers=2).epoch(0)]\n"
            "c = [b['image'] for b in Loader(ds, 8, transform=train_transform, device='cpu',"
            " num_workers=0).epoch(0)]\n"
            "assert len(a) == 4 and all((x == y).all() for x, y in zip(a, c))\n"
            "print('native', native_available())\n"),
    }[path]
    out = subprocess.run([sys.executable, "-c", block + code + "print('ok')\n"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240, env=ENV)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_refuses_without_card_or_port(alone, tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where there is
    no CUDA device (here), and in a directory that holds nothing else of
    the repo."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True,
        timeout=120, env=ENV)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
