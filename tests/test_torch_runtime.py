"""The port's runtime and data parallelism, over gloo in real processes.

Every multi-process case starts its ranks as ``python -c`` processes that
meet in a ``file://`` store under ``tmp_path`` (no port: the suite runs
under several workers), each group joined with a timeout of 60 s so a hang
fails instead of eating the suite's limit; the ranks write their results
with ``torch.save`` and the test reads them.

- collectives on 2 and 4 ranks (sum / mean over a dict, gather, reduce-
  scatter, a ring shift forward and back, a broadcast from rank 1), the
  hello_world checks, and an identity "ring shift" that the single-shift
  check must catch; the mesh over the group, and a pipe axis of 2 (its
  coordinates and the non-wrapping stage shift);
- data-parallel training on 2 ranks (ResNet-18 and UNet at small widths,
  BatchNorm over the global batch, the gradient mean over one flat bucket)
  equal to one process on the same global batch to atol 2e-5 after 3 SGD
  steps (``tests/test_train.py``'s bound), the replicas bitwise equal; a
  NaN on one rank's shard makes both ranks skip; a world-2 checkpoint
  restores at world 1;
- the CLIs with ``--device cpu --nproc 2`` (and hello_world with 4) exit 0;
  a flag of an unported layer refuses and names its ROADMAP item;
- bootstrap's arguments and environment (the reference's and torchrun's),
  init -> shutdown -> init, and ``MeshSpec.resolve`` against the JAX one.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 60


def spawn(tmp_path, world: int, fn: str, *args) -> list:
    """Run ``fn(rank, world, store, out_dir, *args)`` of this module in
    ``world`` processes (``LOCAL_RANK`` = rank); returns each rank's saved
    result."""
    store = tmp_path / f"store-{fn}-{world}"
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
            f"import test_torch_runtime as t\n"
            f"t.{fn}(int(sys.argv[1]), {world}, {str(store)!r}, {str(tmp_path)!r}, *{args!r})\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT,
                              env={**os.environ, "OMP_NUM_THREADS": "2", "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=3 * TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{outs[r][-3000:]}"
    return [torch.load(tmp_path / f"{fn}-rank{r}.pt", weights_only=False) for r in range(world)]


def _join(rank, world, store, device="cpu"):
    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    return bootstrap.init(f"file://{store}", world, rank, device, timeout_s=TIMEOUT_S)


def _save(out_dir, fn, rank, result):
    torch.save(result, pathlib.Path(out_dir) / f"{fn}-rank{rank}.pt")


# -- workers (run in the spawned ranks) ---------------------------------------
def w_collectives(rank, world, store, out_dir):
    from deeplearning_mpi_tpu_torch.runtime import bootstrap, collectives
    from deeplearning_mpi_tpu_torch.runtime import mesh as M
    from deeplearning_mpi_tpu_torch.runtime.hello_world import run_hello_world

    topo = _join(rank, world, store)
    mesh = M.create_mesh(device="cpu")
    g = M.data_group(mesh)
    x = torch.arange(2.0 * world) + 10 * rank
    res = {
        "topology": (topo.process_id, topo.num_processes, topo.backend, topo.platform),
        "mesh": (M.data_size(mesh), M.data_rank(mesh), M.batch_rows(8 * world, mesh)),
        "sum": collectives.all_reduce_sum({"a": x, "b": {"c": x * 2}}, g),
        "mean": collectives.all_reduce_mean(x, g),
        "gather": collectives.all_gather(x[None], g, axis=0),
        "scatter": collectives.reduce_scatter(x, g),
        "fwd": collectives.ring_shift(x, g, offset=1),
        "back": collectives.ring_shift(x, g, offset=-1),
        "bcast": collectives.broadcast_from(x, src=1, group=g),
        "hello": run_hello_world(g),
    }
    pmesh = M.create_mesh(M.MeshSpec(data=world // 2, pipe=2), device="cpu")
    stage = M.pipe_rank(pmesh)
    res["pipe"] = (M.pipe_size(pmesh), stage, M.data_size(pmesh))
    res["stage_shift"] = collectives.stage_shift([x] if stage == 0 else [],
                                                 [x] if stage == 1 else [], M.pipe_group(pmesh))
    collectives.ring_shift = lambda v, group=None, offset=1: v.clone()  # identity "ring"
    res["identity"] = run_hello_world(g)
    _save(out_dir, "w_collectives", rank, res)
    bootstrap.shutdown()
    bootstrap.shutdown()


def _model(kind, seed=0, dtype=torch.float32, device="cpu"):
    from deeplearning_mpi_tpu_torch.models import UNet, resnet18

    if kind == "resnet":
        model = resnet18(num_filters=8, stem="cifar", dtype=dtype, device="cpu")
    else:
        model = UNet(features=(4, 8), dtype=dtype, device="cpu")
    return model.init_weights(seed).to(dtype=dtype, device=device)


def _global_batches(kind, n_steps=4, batch=8, dtype=np.float32):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n_steps):
        if kind == "resnet":
            out.append({"image": torch.from_numpy(rng.normal(size=(batch, 32, 32, 3)).astype(dtype)),
                        "label": torch.from_numpy(rng.integers(0, 10, batch).astype(np.int64))})
        else:
            out.append({"image": torch.from_numpy(rng.normal(size=(batch, 16, 16, 3)).astype(dtype)),
                        "mask": torch.from_numpy((rng.random((batch, 16, 16)) > 0.5).astype(np.float32))})
    return out


def train_steps(kind, group=None, rows=slice(None), nan_rows=None, *, global_batch=8,
                dtype=torch.float32, device="cpu"):
    """3 SGD steps on the global batches' ``rows``, then a 4th with a NaN in
    ``nan_rows`` of it; returns the state, the losses and finite flags, and
    the state dict after step 3 (on the CPU)."""
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    task = "classification" if kind == "resnet" else "segmentation"
    state = create_train_state(_model(kind, dtype=dtype, device=device),
                               build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=1e-5))
    step = make_train_step(task, group=group)
    losses, finite = [], []
    after3 = None
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    for i, batch in enumerate(_global_batches(kind, batch=global_batch, dtype=np_dtype)):
        batch = {k: v[rows].clone().to(device) for k, v in batch.items()}
        if i == 3:
            after3 = {n: t.cpu().clone() for n, t in state.model.state_dict().items()}
            if nan_rows is not None:
                batch["image"][nan_rows] = float("nan")
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        finite.append(float(m["finite"]))
    return state, losses, finite, after3


def w_train(rank, world, store, out_dir, kind, ckpt_dir):
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.runtime import bootstrap, collectives
    from deeplearning_mpi_tpu_torch.runtime import mesh as M
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    _join(rank, world, store)
    mesh = M.create_mesh(device="cpu")
    a, b = M.batch_rows(8, mesh)
    # The NaN lands in rank 1's rows only.
    state, losses, finite, after3 = train_steps(kind, M.data_group(mesh), slice(a, b),
                                                nan_rows=slice(0, 1) if rank == 1 else None)
    res = {"losses": losses, "finite": finite, "after3": after3,
           "final": {n: t.clone() for n, t in state.model.state_dict().items()},
           "grad_means": collectives.counts["all_reduce_mean"]}
    if ckpt_dir:
        Checkpointer(ckpt_dir).save(state, epoch=0)
        res["digests"] = tree_digests(state.arrays())
    _save(out_dir, "w_train", rank, res)
    bootstrap.shutdown()


def w_train_f64(rank, world, store, out_dir, device):
    """``world`` ranks over gloo (``cpu``) or NCCL (``cuda``, one card a
    rank): the transport checks, then 3 float64 ResNet steps on this rank's
    rows of a global batch of 2 rows a rank."""
    from deeplearning_mpi_tpu_torch.runtime import bootstrap, collectives
    from deeplearning_mpi_tpu_torch.runtime import mesh as M
    from deeplearning_mpi_tpu_torch.runtime.hello_world import run_hello_world

    topo = _join(rank, world, store, device)
    mesh = M.create_mesh(device=device)
    g = M.data_group(mesh)
    x = torch.arange(2.0 * world, device=topo.device) + 10 * rank
    res = {"topology": (topo.process_id, topo.num_processes, topo.backend),
           "hello": run_hello_world(g),
           "gather": collectives.all_gather(x[None], g).cpu(),
           "scatter": collectives.reduce_scatter(x, g).cpu(),
           "back": collectives.ring_shift(x, g, offset=-1).cpu()}
    a, b = M.batch_rows(2 * world, mesh)
    _, res["losses"], _, res["after3"] = train_steps(
        "resnet", g, slice(a, b), global_batch=2 * world, dtype=torch.float64,
        device=topo.device)
    _save(out_dir, "w_train_f64", rank, res)
    bootstrap.shutdown()


def check_ranks_train_like_one_process(res, world, device):
    """``w_train_f64``'s ranks against one process on the global batch:
    the transport checks, the float64 parameters and statistics after 3
    steps within 1e-7 of one process's (the loss is float32 on both, as the
    reference's: its rounding, ~5e-9 here at lr 0.1, is the floor), the
    replicas bitwise equal."""
    xs = [torch.arange(2.0 * world) + 10 * r for r in range(world)]
    _, losses, _, after3 = train_steps("resnet", global_batch=2 * world, dtype=torch.float64,
                                       device=device)
    for rank, r in enumerate(res):
        assert r["topology"][:2] == (rank, world)
        assert r["hello"].ok and r["hello"].n_devices == world
        torch.testing.assert_close(r["gather"], torch.stack(xs))
        torch.testing.assert_close(r["scatter"], sum(xs).chunk(world)[rank])
        torch.testing.assert_close(r["back"], xs[(rank + 1) % world])
        np.testing.assert_allclose(r["losses"][:3], losses[:3], rtol=1e-6)
        for n, t in after3.items():
            torch.testing.assert_close(r["after3"][n], t, atol=1e-7, rtol=0, msg=n)
            assert torch.equal(r["after3"][n], res[0]["after3"][n]), n


# -- tests ----------------------------------------------------------------------
def test_four_ranks_train_like_one_process_in_float64(tmp_path):
    """4 gloo ranks of 2 rows each against one process on the 8 rows, in
    float64 (where no pre-activation lands on the other side of a ReLU):
    within 1e-7, and the replicas bitwise equal. ``tests/test_torch_gpu.py``
    runs the same over NCCL, one card a rank."""
    check_ranks_train_like_one_process(spawn(tmp_path, 4, "w_train_f64", "cpu"), 4, "cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_hello_world(tmp_path, world):
    res = spawn(tmp_path, world, "w_collectives")
    xs = [torch.arange(2.0 * world) + 10 * r for r in range(world)]
    total = sum(xs)
    for rank, r in enumerate(res):
        assert r["topology"] == (rank, world, "gloo", "cpu")
        assert r["mesh"] == (world, rank, (8 * rank, 8 * (rank + 1)))
        torch.testing.assert_close(r["sum"]["a"], total)
        torch.testing.assert_close(r["sum"]["b"]["c"], 2 * total)
        torch.testing.assert_close(r["mean"], total / world)
        torch.testing.assert_close(r["gather"], torch.stack(xs))
        torch.testing.assert_close(r["scatter"], total.chunk(world)[rank])
        torch.testing.assert_close(r["fwd"], xs[(rank - 1) % world])
        torch.testing.assert_close(r["back"], xs[(rank + 1) % world])
        torch.testing.assert_close(r["bcast"], xs[1])
        assert r["hello"].ok and r["hello"].n_devices == world
        assert r["identity"].broadcast_ok and r["identity"].psum_ok
        assert not r["identity"].ring_ok  # the single-shift check catches it
        # The pipe axis: (data, pipe) row-major; stage 1 receives stage 0's value.
        assert r["pipe"] == (2, rank % 2, world // 2)
        want = [xs[rank - 1]] if rank % 2 else []
        assert len(r["stage_shift"]) == len(want)
        for got, w in zip(r["stage_shift"], want):
            torch.testing.assert_close(got, w)


@pytest.mark.parametrize("kind", ["resnet", "unet"])
def test_two_ranks_train_like_one_process(tmp_path, kind):
    """2 gloo ranks, each on its half of the global batch, reach the
    parameters and statistics of one process on the whole batch (atol
    2e-5) with bitwise-equal replicas; a NaN in rank 1's shard alone makes
    both ranks skip the step; the world-2 checkpoint restores at world 1."""
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    ckpt = str(tmp_path / "ckpt") if kind == "resnet" else ""
    r0, r1 = spawn(tmp_path, 2, "w_train", kind, ckpt)
    _, losses, _, after3 = train_steps(kind)
    for n, t in after3.items():
        torch.testing.assert_close(r0["after3"][n], t, atol=2e-5, rtol=0, msg=n)
        assert torch.equal(r0["after3"][n], r1["after3"][n]), n
        assert torch.equal(r0["final"][n], r1["final"][n]), n
    np.testing.assert_allclose(r0["losses"][:3], losses[:3], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])  # NaN at step 4 on both
    assert r0["finite"] == r1["finite"] == [1.0, 1.0, 1.0, 0.0]
    for n, t in r0["final"].items():  # the NaN step changed nothing
        assert torch.equal(t, r0["after3"][n]), n
    assert r0["grad_means"] == r1["grad_means"] == 4  # one flat all-reduce a step
    if ckpt:
        ck = Checkpointer(ckpt)
        assert sorted(p.name for p in pathlib.Path(ckpt).iterdir() if p.is_dir()) == ["0"]
        template = create_train_state(_model(kind, seed=9), build_optimizer(
            "sgd", 0.1, momentum=0.9, weight_decay=1e-5))
        restored, epoch = ck.restore_elastic(template)
        assert epoch == 0 and restored.step == 4
        assert tree_digests(restored.arrays()) == r0["digests"] == r1["digests"]


def _cli(module, *args, timeout=240):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", f"deeplearning_mpi_tpu_torch.cli.{module}",
                           *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("nproc", [2, 4])
def test_hello_world_cli(nproc):
    out = _cli("hello_world", "--device", "cpu", "--nproc", str(nproc), "--timeout_s",
               str(TIMEOUT_S))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count(f"hello_world OK: n_devices={nproc}") == nproc


def test_train_resnet_cli_two_ranks(tmp_path):
    out = _cli("train_resnet", "--device", "cpu", "--nproc", "2", "--synthetic",
               "--train_samples", "8", "--batch_size", "4", "--num_epochs", "1",
               "--model_dir", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "over 2 process(es) (gloo)" in out.stdout
    assert "Final eval: " in out.stdout or "Epoch 0 eval: accuracy" in out.stdout
    assert (tmp_path / "resnet_distributed" / "0" / "batch_stats.pt").is_file()


def test_train_unet_cli_two_ranks():
    out = _cli("train_unet", "--device", "cpu", "--nproc", "2", "--synthetic",
               "--image_size", "32", "--train_samples", "10", "--batch_size", "4",
               "--num_epochs", "1", "--loss", "bce_dice")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "eval: dice" in out.stdout


@pytest.mark.parametrize("flag,item", [(["--pp", "2"], "item 8"), (["--tp", "2"], "item 8"),
                                       (["--chaos", "kill@step:1"], "item 10"),
                                       (["--tuned_step", "db.json"], "item 9"),
                                       (["--num_workers", "2"], "item 7")])
def test_unported_flags_refuse(flag, item, capsys):
    from deeplearning_mpi_tpu_torch.cli import train_resnet, train_unet

    for cli in (train_resnet, train_unet):
        assert cli.main(["--device", "cpu", "--synthetic", *flag]) == 1
        err = capsys.readouterr().err
        assert f"ROADMAP Queue 1 {item}" in err and flag[0] in err


def test_bootstrap_contract(tmp_path, monkeypatch):
    """The reference's variables and torchrun's; one process with no
    coordinator joins no group; init -> shutdown -> init; CUDA asked for
    without CUDA raises."""
    import torch.distributed as dist

    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    topo = bootstrap.init(device="cpu")
    assert not dist.is_initialized() and topo.num_processes == 1 and topo.backend is None
    assert bootstrap.is_coordinator()

    monkeypatch.setenv("COORDINATOR_ADDRESS", f"file://{tmp_path / 'a'}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    topo = bootstrap.init(device="cpu", timeout_s=TIMEOUT_S)
    assert dist.is_initialized() and topo.backend == "gloo" and topo.num_processes == 1
    bootstrap.shutdown()
    bootstrap.shutdown()
    assert not dist.is_initialized()
    monkeypatch.delenv("NUM_PROCESSES")
    monkeypatch.delenv("PROCESS_ID")
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"file://{tmp_path / 'b'}")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    topo = bootstrap.init(device="cpu", timeout_s=TIMEOUT_S)
    assert topo.process_id == 0 and topo.coordinator_address.endswith("/b")
    info = bootstrap.get_system_information("cpu")
    assert info["backend"] == "gloo" and info["num_processes"] == 1
    bootstrap.shutdown()

    seen = {}
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: seen.update(
        backend=backend, **kw))
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    bootstrap.init(device="cpu")
    assert seen == {"backend": "gloo", "init_method": "tcp://10.0.0.7:29555", "world_size": 4,
                    "rank": 3}
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(ValueError, match="coordinator"):
        bootstrap.init(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bootstrap.init(device="cuda")


@pytest.mark.parametrize("spec,n", [((-1, 1, 1, 1, 1), 8), ((2, 2, 1, 1, 2), 8),
                                    ((-1, 1, 1, 1, 3), 8), ((3, 1, 1, 1, 1), 8),
                                    ((-1, 2, 2, 1, 1), 4)])
def test_mesh_spec_resolves_like_the_reference(spec, n):
    from deeplearning_mpi_tpu.runtime.mesh import MeshSpec as JaxSpec
    from deeplearning_mpi_tpu_torch.runtime.mesh import MESH_AXES, MeshSpec, local_batch_size

    assert MESH_AXES == ("data", "pipe", "expert", "seq", "model")
    try:
        want = JaxSpec(*spec).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshSpec(*spec).resolve(n)
        assert str(got.value) == str(e)
    else:
        assert MeshSpec(*spec).resolve(n) == want
    assert local_batch_size(16, None) == 16
