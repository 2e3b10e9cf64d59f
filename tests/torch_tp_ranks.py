"""Rank-side cases of the gloo spawns of ``tests/test_torch_tp.py`` and
``tests/test_torch_zero.py``, and of their four-card NCCL counterparts in
``tests/test_torch_gpu.py``.

Imports torch and the port only (the ranks never load JAX): the parent test
computes the one-process and JAX references and asserts. Every rank runs
every case in order, so the collectives line up.

- :func:`worker_tp`: one LM step (the gradients through a probe optimizer,
  the parameters after one Adam step) at ``TP_SHAPE`` under ``tp 4`` and
  ``dp 2 x tp 2``, float32 and float64; the same step with each wrong copy
  of :func:`wrong_tp` (a column-parallel layer with no backward all-reduce,
  a row-parallel sum without one rank's partial, the embedding's gradient
  summed over the model group); and the checkpoint round trips under
  ``dp 2 x tp 2 --zero`` (:func:`checkpoint_case`).
- :func:`worker_zero`: 3 steps with clip and EMA of pure data parallelism,
  ``--zero`` and the overlapped schedule over ``dp 4`` (float32, float64,
  ``grad_accum`` 2), each wrong copy of :func:`wrong_zero` (the clip on
  the local shard's norm, the mean divided by dp twice, a bucket launched
  before the last chunk), each rank's moment sizes, the logged fallback
  of each case the overlapped schedule refuses, and ``--zero`` on a
  ResNet-18 (BatchNorm over the data group) against its data-parallel
  step.
"""

from __future__ import annotations

import contextlib
import os
import pathlib

import torch
import torch.distributed as dist
from torch_seq_ranks import GradProbe

#: ``tests/test_generate_cli.py``'s ``TP_SHAPE`` (every Megatron kernel
#: clears the rule's ``min_size``) at vocab 256.
TP_CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16, d_model=32, d_ff=64)
#: ``tests/test_zero.py``'s widths, where ZeRO-1's ``MIN_SIZE`` shards the
#: embedding and every projection.
ZERO_CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=32, d_model=128, d_ff=512)
#: name -> (data, model).
TP_LAYOUTS = {"tp4": (1, 4), "dp2_tp2": (2, 2)}
#: The wrong copies the tensor-parallel bars must reject.
WRONG_TP = ("no_backward_allreduce", "dropped_partial", "embed_grad_summed")
#: The wrong copies the overlapped schedule's bars must reject.
WRONG_ZERO = ("local_clip", "dp_twice", "early_bucket")
#: The bucket size of the overlapped runs: several buckets at these widths.
BUCKET_BYTES = 1 << 16


def lm_config(cfg: dict):
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**cfg)


def lm_model(cfg: dict, sd: dict, dtype=torch.float32, device="cpu", tp=None):
    """The LM of ``cfg`` (sharded over ``tp``) holding the whole model's
    state dict ``sd``."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import shard_state_dict

    model = TransformerLM(lm_config(cfg), dtype=dtype, device=device, tp=tp)
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(shard_state_dict(sd, model))
    return model


def _whole(model, tree: dict) -> dict:
    """A tree of the model's own names as the whole model's, on the host."""
    layout = model.tp_layout
    tree = tree if layout is None else layout.gather(tree)
    return {n: t.detach().cpu() for n, t in tree.items()}


def tp_step_case(inputs: dict, mesh=None, *, tp=None, device: str = "cpu",
                 dtype: torch.dtype = torch.float32, attention=None,
                 tokens: str = "tokens", cfg: dict | None = None) -> dict:
    """One LM step on ``inputs[tokens]`` (this rank's rows under ``mesh``),
    the model sharded over ``tp`` (default: the mesh's model group): the
    loss, the whole gradients and the whole parameters after one Adam step
    (lr 1e-3, clip 1.0), on the host."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows, data_group, tp_shards
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    tp = tp if tp is not None else tp_shards(mesh, device)
    a, b = batch_rows(inputs[tokens].shape[0], mesh)
    batch = {"tokens": inputs[tokens][a:b].to(device)}
    step = make_train_step("lm", group=data_group(mesh))
    out = {}
    for name, tx in (("probe", GradProbe()), ("adam", build_optimizer("adam", 1e-3, clip_norm=1.0))):
        model = lm_model(cfg or inputs["cfg"], inputs["params"], dtype, device, tp)
        state, metrics = step(create_train_state(model, tx, attention_fn=attention), batch)
        out[f"{name}_loss"] = float(metrics["loss"])
        if name == "probe":
            out["grads"] = _whole(model, state.opt_state["g"])
        else:
            out["params"] = _whole(model, dict(model.named_parameters()))
    return out


class _SummedGather(torch.autograd.Function):
    """The wrong embedding gather: its backward sums the gradient over the
    group before keeping this rank's block."""

    @staticmethod
    def forward(ctx, x, group, axis):
        n = dist.get_world_size(group)
        ctx.args = group, n, dist.get_rank(group), axis
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, grad):
        group, n, rank, axis = ctx.args
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        return grad.chunk(n, dim=axis)[rank].contiguous(), None, None


@contextlib.contextmanager
def wrong_tp(kind: str):
    """A wrong copy of one of the tensor-parallel collectives."""
    from deeplearning_mpi_tpu_torch.runtime import collectives as c

    saved = {n: getattr(c, n) for n in ("copy_to_group", "reduce_from_group", "gather_from_group")}
    if kind == "no_backward_allreduce":
        c.copy_to_group = lambda x, group: x
    elif kind == "dropped_partial":
        # x * 0 keeps rank 1's graph (and so its backward collectives).
        c.reduce_from_group = lambda x, group: saved["reduce_from_group"](
            x * 0.0 if dist.get_rank(group) == 1 else x, group)
    elif kind == "embed_grad_summed":
        c.gather_from_group = lambda x, group, axis: _SummedGather.apply(x, group, axis)
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(c, n, f)


@contextlib.contextmanager
def wrong_zero(kind: str):
    """A wrong copy of one piece of the overlapped ZeRO-1 schedule."""
    from deeplearning_mpi_tpu_torch.parallel import zero as z

    saved = {n: getattr(z, n) for n in ("bucket_ready", "data_mean", "shard_squares")}
    if kind == "local_clip":
        z.shard_squares = lambda squares, group: squares
    elif kind == "dp_twice":
        z.data_mean = lambda summed, dp: summed / dp / dp
    elif kind == "early_bucket":
        z.bucket_ready = lambda chunk, grad_accum: True
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(z, n, f)


def zero_trainer(inputs: dict, group, *, tp=None, dtype=torch.float32, device="cpu",
                 kind: str = "dp", clip: float = 1.0, accum: int = 1, log=None,
                 cfg: dict | None = None):
    """A ``Trainer`` of the ZeRO-1 cases on ``inputs["zero_params"]`` (Adam
    lr 1e-3, ``clip``, EMA 0.9): ``kind`` ``dp`` (pure data parallelism),
    ``zero`` or ``overlap`` (the bucketed schedule, :data:`BUCKET_BYTES`)."""
    from deeplearning_mpi_tpu_torch.parallel.zero import make_overlapped_train_step
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    model = lm_model(cfg or ZERO_CFG, inputs["zero_params"], dtype, device, tp)
    state = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=clip), ema=True)
    trainer = Trainer(state, "lm", group=group, grad_accum=accum, ema_decay=0.9,
                      zero=kind != "dp", log=log or (lambda msg: None))
    if kind == "overlap":
        trainer.train_step = make_overlapped_train_step(
            "lm", trainer.state, group, grad_accum=accum, ema_decay=0.9,
            bucket_bytes=BUCKET_BYTES)
    return trainer


def zero_run(inputs: dict, mesh, *, steps: int | None = None, **kw) -> dict:
    """``zero_trainer``'s steps on ``inputs["zero_batches"]`` (this rank's
    rows of each): the losses and the whole parameters, moments and EMA
    after them, and this rank's moment sizes."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows, data_group

    device = kw.get("device", "cpu")
    trainer = zero_trainer(inputs, data_group(mesh), **kw)
    state, losses = trainer.state, []
    for tokens in inputs["zero_batches"][:steps]:
        a, b = batch_rows(tokens.shape[0], mesh)
        state, metrics = trainer.train_step(state, {"tokens": tokens[a:b].to(device)})
        losses.append(float(metrics["loss"]))
    arrays = state.arrays()
    host = lambda tree: {n: t.detach().cpu() for n, t in tree.items()}  # noqa: E731
    return {"losses": losses, "params": host(arrays["params"]),
            "mu": host(arrays["opt_state"]["mu"]), "nu": host(arrays["opt_state"]["nu"]),
            "ema": host(arrays["ema_params"]),
            "local_numel": {n: t.numel() for n, t in state.opt_state["mu"].items()},
            "local_bytes": sum(t.numel() * t.element_size() for k in ("mu", "nu")
                               for t in state.opt_state[k].values())}


def checkpoint_case(inputs: dict, mesh, out_dir: pathlib.Path) -> dict:
    """Under ``dp 2 x tp 2 --zero`` on :data:`ZERO_CFG`: 2 steps, a save
    into ``out_dir/sharded``, a third step (the uninterrupted run); a fresh
    template restored from that save and stepped once (the resumed run);
    and the parent's one-process save ``out_dir/one`` restored. The digests
    of each state's whole tree, and this rank's moment sizes."""
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows, data_group, tp_shards
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    def trainer():
        return zero_trainer(inputs, data_group(mesh), tp=tp_shards(mesh, "cpu"), kind="zero")

    batches = []
    for tokens in inputs["zero_batches"]:
        a, b = batch_rows(tokens.shape[0], mesh)
        batches.append({"tokens": tokens[a:b]})
    t = trainer()
    for batch in batches[:2]:
        t.state, _ = t.train_step(t.state, batch)
    sharded = Checkpointer(out_dir / "sharded")
    sharded.save(t.state, epoch=0)
    out = {"saved": tree_digests(t.state.arrays()),
           "local_numel": {n: x.numel() for n, x in t.state.opt_state["mu"].items()}}
    t.state, _ = t.train_step(t.state, batches[2])
    out["uninterrupted"] = tree_digests(t.state.arrays())
    r = trainer()
    r.state, _ = sharded.restore_verified(r.state)
    out["restored"] = tree_digests(r.state.arrays())
    r.state, _ = r.train_step(r.state, batches[2])
    out["resumed"] = tree_digests(r.state.arrays())
    o = trainer()
    o.state, _ = Checkpointer(out_dir / "one").restore_verified(o.state)
    out["from_one"] = tree_digests(o.state.arrays())
    return out


def _join(rank: int, world: int, store: str, device: str):
    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    os.environ["LOCAL_RANK"] = str(rank)
    # A rank that skips a collective hangs the others: fail within minutes.
    bootstrap.init(f"file://{store}", world, rank, device,
                   timeout_s=120 if device == "cpu" else 300)


def worker_tp(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank of ``tests/test_torch_tp.py``'s spawn."""
    torch.set_num_threads(1)
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    _join(rank, world, store, "cpu")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    meshes = {name: create_mesh(MeshSpec(data=dp, model=tp), device="cpu")
              for name, (dp, tp) in TP_LAYOUTS.items()}
    results = {}
    for name, mesh in meshes.items():
        results[name] = tp_step_case(inputs, mesh)
        results[f"{name}_f64"] = tp_step_case(inputs, mesh, dtype=torch.float64)
    for kind in WRONG_TP:
        with wrong_tp(kind):
            results[kind] = tp_step_case(inputs, meshes["tp4"])
    results["checkpoint"] = checkpoint_case(inputs, meshes["dp2_tp2"], out_dir)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


def fallback_logs(inputs: dict, meshes: dict) -> dict:
    """The line ``Trainer.place_state`` logs for each case the overlapped
    schedule refuses (over a data group of 4, or 2 beside ``tp 2``)."""
    from deeplearning_mpi_tpu_torch.models import resnet18
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_group, tp_shards
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    def logged(model, tx, **kw):
        lines = []
        Trainer(create_train_state(model, tx), kw.pop("task", "lm"), zero_overlap=True,
                log=lines.append, **kw)
        return lines

    adam = build_optimizer("adam", 1e-3, clip_norm=1.0)
    group = data_group(meshes["dp4"])
    tiny = TransformerConfig.tiny()
    return {
        "tp": logged(lm_model(ZERO_CFG, inputs["zero_params"], tp=tp_shards(meshes["dp2_tp2"],
                                                                             "cpu")),
                     adam, group=data_group(meshes["dp2_tp2"])),
        "aux_weight": logged(TransformerLM(TransformerConfig.tiny_moe(), dtype=torch.float32,
                                           device="cpu").init_weights(0),
                             adam, group=group, aux_weight=0.01),
        "loss_chunk": logged(TransformerLM(tiny, dtype=torch.float32, device="cpu",
                                           return_prehead=True).init_weights(0),
                             adam, group=group, loss_chunk=8),
        "batch_stats": logged(resnet18(num_filters=8, device="cpu").init_weights(0),
                              build_optimizer("sgd", 0.1), group=group, task="classification"),
        "not_mirrored": logged(lm_model(ZERO_CFG, inputs["zero_params"]),
                               build_optimizer("adafactor", 1e-3), group=group),
    }


def cnn_run(group, zero: bool) -> dict:
    """2 SGD steps of a ResNet-18 at 8 filters (BatchNorm over the data
    group) on this rank's rows of 8 seeded images: the whole parameters,
    statistics and momentum after them."""
    from deeplearning_mpi_tpu_torch.models import resnet18
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    gen = torch.Generator().manual_seed(7)
    images = torch.randn(2, 8, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (2, 8), generator=gen)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rows = slice(r * 8 // n, (r + 1) * 8 // n)
    model = resnet18(num_filters=8, stem="cifar", device="cpu").init_weights(0)
    trainer = Trainer(create_train_state(model, build_optimizer("sgd", 0.1, weight_decay=1e-5)),
                      "classification", group=group, zero=zero, log=lambda msg: None)
    state = trainer.state
    for x, y in zip(images, labels):
        state, _ = trainer.train_step(state, {"image": x[rows], "label": y[rows]})
    arrays = state.arrays()
    return {"params": arrays["params"], "batch_stats": arrays["batch_stats"],
            "trace": arrays["opt_state"]["trace"], "sharded": len(state.zero.dims) if zero else 0}


def worker_zero(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank of ``tests/test_torch_zero.py``'s spawn."""
    torch.set_num_threads(1)
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh, data_group

    _join(rank, world, store, "cpu")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    meshes = {"dp4": create_mesh(MeshSpec(data=4), device="cpu"),
              "dp2_tp2": create_mesh(MeshSpec(data=2, model=2), device="cpu")}
    mesh, clip = meshes["dp4"], inputs["clip"]
    results = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        for kind in ("dp", "zero", "overlap"):
            results[f"{kind}_{tag}"] = zero_run(inputs, mesh, kind=kind, dtype=dtype, clip=clip)
    for kind in ("dp", "overlap"):
        results[f"{kind}_accum"] = zero_run(inputs, mesh, kind=kind, dtype=torch.float64,
                                            clip=clip, accum=2)
    for kind in WRONG_ZERO:
        with wrong_zero(kind):
            results[kind] = zero_run(inputs, mesh, kind="overlap", dtype=torch.float64, clip=clip,
                                     accum=2 if kind == "early_bucket" else 1)
    results["fallbacks"] = fallback_logs(inputs, meshes)
    results["cnn_dp"] = cnn_run(data_group(mesh), zero=False)
    results["cnn_zero"] = cnn_run(data_group(mesh), zero=True)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


#: The four-card tensor-parallel layouts, ``(data, model, dtype, tokens)``:
#: the cases under test in float32 and float64, and pure data parallelism.
CUDA_TP_LAYOUTS = {"tp4": (1, 4, torch.float32, "tokens"),
                   "dp2_tp2": (2, 2, torch.float32, "tokens"),
                   "dp4": (4, 1, torch.float32, "tokens"),
                   "tp4_f64": (1, 4, torch.float64, "tokens_f64"),
                   "dp2_tp2_f64": (2, 2, torch.float64, "tokens_f64")}


def worker_cuda_tp(rank: int, world: int, store: str, out_dir: str) -> None:
    """One NCCL rank (card ``rank``) of the four-card tensor-parallel case:
    the LM step in each of :data:`CUDA_TP_LAYOUTS`, TF32 off; flash
    attention (K1-K3 at the local heads) in float32, the dense core in
    float64."""
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _join(rank, world, store, "cuda")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    for name, (dp, tp, dtype, tokens) in CUDA_TP_LAYOUTS.items():
        mesh = create_mesh(MeshSpec(data=dp, model=tp), device="cuda")
        results[name] = tp_step_case(
            inputs, mesh, device="cuda", dtype=dtype, tokens=tokens,
            attention=flash_attention_bhsd if dtype == torch.float32 else None)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


def worker_cuda_zero(rank: int, world: int, store: str, out_dir: str) -> None:
    """One NCCL rank (card ``rank``) of the four-card ZeRO-1 case over
    ``dp 4``: 3 steps of pure data parallelism and ``--zero`` in float32,
    and of both and the overlapped schedule in float64, TF32 off."""
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _join(rank, world, store, "cuda")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    mesh = create_mesh(MeshSpec(data=4), device="cuda")
    results = {}
    for kind, dtype, tag in (("dp", torch.float32, "f32"), ("zero", torch.float32, "f32"),
                             ("dp", torch.float64, "f64"), ("overlap", torch.float64, "f64")):
        results[f"{kind}_{tag}"] = zero_run(inputs, mesh, kind=kind, dtype=dtype, device="cuda",
                                            clip=inputs["clip"], cfg=inputs["cfg"])
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


def spawn(out_dir: pathlib.Path, fn, world: int = 4) -> list[dict]:
    """Run ``fn`` on ``world`` ranks in one ``start_processes`` call; each
    rank's results."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(world, str(out_dir / "store"), str(out_dir)),
                       nprocs=world, start_method="spawn")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def tree_errors(got: dict, want: dict) -> list:
    """Relative L2 errors of each tensor of ``got`` against ``want``, worst
    first."""
    errs = {n: float((got[n].double() - t.double()).norm() / t.double().norm().clamp(min=1e-30))
            for n, t in want.items()}
    return sorted(errs.items(), key=lambda kv: kv[1], reverse=True)
