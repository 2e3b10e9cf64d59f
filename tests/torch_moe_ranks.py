"""Rank-side cases of ``tests/test_torch_train_moe.py``'s one gloo spawn.

Imports torch and the port only (the ranks never load JAX): the parent
test computes the one-process and JAX references and asserts. Every rank
runs every case in order, so the collectives line up:

- the MoE LM as ``dp 2 x ep 2``, as ``ep 4`` and as ``dp 4`` (no expert
  group): the logits of the rank's rows, the global load-balance loss, the
  step's gradients (the data mean, expert stacks gathered), one Adam step's
  loss, dropped fraction and parameters; the ``dp 2 x ep 2`` state is
  checkpointed and the ``ep 4`` ranks restore it; ``dp 2 x ep 2`` again in
  float64, and once more with a wrong copy of the layer that does not sum
  the router probabilities' gradient over the expert group (the negative
  control of :func:`split_batch_rule`);
- a small ResNet with BatchNorm under ``grad_accum`` 2 on ranks 0-1 (a
  2-rank subgroup), rows from the loader.

:func:`worker_cuda` is the four-card NCCL counterpart of the MoE case
(``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

LAYOUTS = {"dp2_ep2": (2, 2), "ep4": (1, 4), "dp4": (4, 1)}
AUX_WEIGHT = 0.01
#: :func:`split_batch_rule`'s factor over the pure data-parallel noise.
SPLIT_BATCH_FACTOR = 2.0


class GradProbe:
    """An optimizer whose state keeps the gradients it was given and whose
    update is zero: the step's gradients, read from its state."""

    name = "probe"

    def init(self, params, views):
        return {"g": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads, state, params, *, leaves, shards=None):
        return {n: torch.zeros_like(g) for n, g in grads.items()}, {"g": dict(grads)}


def moe_model(cfg, full_sd, shards, device="cpu", dtype=torch.float32):
    """The MoE LM with ``full_sd``'s weights, this rank's experts; made
    double (parameters and compute) for ``dtype`` float64."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.parallel.expert_parallel import shard_state_dict

    model = TransformerLM(cfg, dtype=dtype, device=device, expert_shards=shards)
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(shard_state_dict(full_sd, shards))
    return model


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def moe_case(cfg, full_sd, tokens, mesh=None, ckpt_dir=None, restore_dir=None,
             device="cpu", dtype=torch.float32) -> dict:
    """Everything the MoE comparison reads, on this process's rows (all of
    them without a mesh), on the host."""
    from deeplearning_mpi_tpu_torch.models import moe
    from deeplearning_mpi_tpu_torch.models.norm import set_group
    from deeplearning_mpi_tpu_torch.resilience.integrity import tree_digests
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows, data_group, expert_shards
    from deeplearning_mpi_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    shards, group = expert_shards(mesh), data_group(mesh)
    a, b = batch_rows(tokens.shape[0], mesh)
    batch = {"tokens": tokens[a:b].to(device)}
    out: dict = {"rows": (a, b)}
    model = moe_model(cfg, full_sd, shards, device, dtype)
    set_group(model, group)
    with torch.no_grad(), moe.collecting(model) as sown:
        out["logits"] = model(batch["tokens"].long())
    out["aux"] = float(moe.collect_aux_loss(sown))
    state = create_train_state(model, GradProbe())
    state, metrics = make_train_step("lm", aux_weight=AUX_WEIGHT, group=group)(state, batch)
    out["grads"] = state.arrays()["opt_state"]["g"]
    state = create_train_state(moe_model(cfg, full_sd, shards, device, dtype),
                               build_optimizer("adam", 1e-3, clip_norm=1.0))
    state, metrics = make_train_step("lm", aux_weight=AUX_WEIGHT, group=group)(state, batch)
    out["loss"], out["drop"] = float(metrics["loss"]), float(metrics["moe_dropped_frac"])
    out["step_aux"] = float(metrics["moe_aux_loss"])
    out["local_params"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    arrays = state.arrays()
    out["params"], out["digests"] = arrays["params"], tree_digests(arrays)
    if ckpt_dir is not None:
        Checkpointer(ckpt_dir).save(state, epoch=0)
    if restore_dir is not None:
        template = create_train_state(moe_model(cfg, full_sd, shards, device),
                                      build_optimizer("adam", 1e-3, clip_norm=1.0))
        restored, _ = Checkpointer(restore_dir).restore_elastic(template)
        out["restored_digests"] = tree_digests(restored.arrays())
    return _host(out)


class ArrayRows:
    """A dataset over numpy arrays of equal length."""

    def __init__(self, **arrays):
        self.arrays = arrays

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.arrays.items()}


def bn_case(bn_sd, images, labels, group=None, num_replicas=1, rank=0) -> dict:
    """One classification step of the small ResNet under ``grad_accum`` 2,
    this rank's rows from the loader: loss, gradients, BatchNorm
    statistics (float64)."""
    from deeplearning_mpi_tpu_torch.data import Loader
    from deeplearning_mpi_tpu_torch.models.resnet import BasicBlock, ResNet
    from deeplearning_mpi_tpu_torch.train import create_train_state, make_train_step

    model = ResNet((1, 1), BasicBlock, num_filters=4, stem="cifar", dtype=torch.float64,
                   device="cpu")
    model.load_state_dict(bn_sd)
    model.double()
    loader = Loader(ArrayRows(image=images, label=labels), len(images), shuffle=False,
                    num_replicas=num_replicas, rank=rank, grad_accum=2, device="cpu")
    batch = next(iter(loader.epoch(0)))
    state = create_train_state(model, GradProbe())
    state, metrics = make_train_step("classification", grad_accum=2, group=group)(state, batch)
    return {"loss": float(metrics["loss"]), "grads": state.opt_state["g"],
            "batch_stats": state.batch_stats(), "rows": loader.rows.tolist()}


def worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the spawn: every case, results to ``out_dir``."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    bootstrap.init(f"file://{store}", world, rank, "cpu", timeout_s=60)
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    for name, (dp, ep) in LAYOUTS.items():
        mesh = create_mesh(MeshSpec(data=dp, expert=ep), device="cpu")
        results[name] = moe_case(
            inputs["cfg"], inputs["moe_sd"], inputs["tokens"], mesh,
            ckpt_dir=out_dir / "ckpt" if name == "dp2_ep2" else None,
            restore_dir=out_dir / "ckpt" if name == "ep4" else None)
    results["dp2_ep2_f64"] = moe_case(inputs["cfg"], inputs["moe_sd"], inputs["tokens"],
                                      create_mesh(MeshSpec(data=2, expert=2), device="cpu"),
                                      dtype=torch.float64)
    with router_probs_not_summed(inputs["cfg"].moe_experts):
        results["dp2_ep2_unsummed"] = moe_case(
            inputs["cfg"], inputs["moe_sd"], inputs["tokens"],
            create_mesh(MeshSpec(data=2, expert=2), device="cpu"))
    sub = dist.new_group([0, 1])
    if rank < 2:
        results["bn"] = bn_case(inputs["bn_sd"], inputs["images"], inputs["labels"], sub,
                                num_replicas=2, rank=rank)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


#: The four-card layouts, ``(data, expert, dtype)``: the case under test
#: in float32 and in float64, then pure data and pure expert parallelism
#: beside it.
CUDA_LAYOUTS = {"dp2_ep2": (2, 2, torch.float32), "dp2_ep2_f64": (2, 2, torch.float64),
                "dp4": (4, 1, torch.float32), "ep4": (1, 4, torch.float32)}


def worker_cuda(rank: int, world: int, store: str, out_dir: str) -> None:
    """One NCCL rank (card ``rank``) of the four-card case: the MoE LM in
    each of :data:`CUDA_LAYOUTS`, TF32 off."""
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    bootstrap.init(f"file://{store}", world, rank, "cuda", timeout_s=300)
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    for name, (dp, ep, dtype) in CUDA_LAYOUTS.items():
        mesh = create_mesh(MeshSpec(data=dp, expert=ep), device="cuda")
        results[name] = moe_case(inputs["cfg"], inputs["moe_sd"], inputs["tokens"], mesh,
                                 device="cuda", dtype=dtype)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


class router_probs_not_summed:
    """The wrong copy of the MoE layer: the router probabilities enter the
    rank's experts without ``copy_to_experts``, so their gradient misses
    the other ranks' experts (the activations ``x`` still get theirs)."""

    def __init__(self, num_experts: int) -> None:
        self.num_experts = num_experts

    def __enter__(self):
        from deeplearning_mpi_tpu_torch.models import moe

        self.right = moe.copy_to_experts
        moe.copy_to_experts = lambda x, group: (x if x.shape[-1] == self.num_experts
                                                else self.right(x, group))

    def __exit__(self, *exc):
        from deeplearning_mpi_tpu_torch.models import moe

        moe.copy_to_experts = self.right


#: A fixed ceiling on the baseline's own worst relative L2 error (``dp 4``
#: against one process on the global batch) in each class, so that a fault
#: in the shared data-parallel path cannot raise its own bar: 2x the worst
#: recorded on four H100s (gradients 3.35e-6 in the sequence-parallel
#: check's ``dp 4``, parameters after one Adam step 1.95e-6 in the expert-
#: parallel check's; PERF.md §6). A class without a ceiling here is held by
#: the factor alone.
DP_CEILING = {"grads": 2 * 3.35e-6, "params": 2 * 1.95e-6}


def split_batch_rule(results: list[dict], baseline: list[dict], one: dict,
                     factor: float = SPLIT_BATCH_FACTOR, keys: tuple = ("grads", "params"),
                     ceiling: dict = DP_CEILING) -> tuple[list, dict]:
    """The float32 bar for a step whose batch is split over ranks: each
    gradient and each parameter after the step of ``results`` (each class
    of ``keys``) within ``factor`` times the worst relative L2 error,
    against ``one`` (one process on the global batch), of the same class in
    ``baseline``, the same step as pure data parallelism over as many
    ranks in the same spawn. Splitting the batch associates float32 sums
    differently, by an amount the step itself sets; a layout that adds no
    error of its own stays near that figure. The baseline's own worst must
    stay under ``ceiling`` (:data:`DP_CEILING`). Returns the tensors over
    their bar (and a baseline over its ceiling, as ``("baseline", key)``),
    worst first, and the bars."""
    worst = {key: max(relative_error(got[key][n], t) for got in baseline
                      for n, t in one[key].items()) for key in keys}
    bars = {key: factor * e for key, e in worst.items()}
    over = [(("baseline", key), e) for key, e in worst.items()
            if key in ceiling and e > ceiling[key]]
    over += [((r, key, n), e) for r, got in enumerate(results) for key, bar in bars.items()
             for n, t in one[key].items() if (e := relative_error(got[key][n], t)) > bar]
    return sorted(over, key=lambda kv: kv[1], reverse=True), bars


def relative_error(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def relative_errors(results: list[dict], one: dict) -> list:
    """Every relative error of the ranks' ``results`` against one process's
    ``one`` (the load-balance loss, the step's loss, each gradient and each
    updated parameter), worst first, so a failure reports all of them."""
    errors = {}
    for r, got in enumerate(results):
        errors[(r, "aux")] = abs(got["aux"] - one["aux"]) / abs(one["aux"])
        errors[(r, "loss")] = abs(got["loss"] - one["loss"]) / abs(one["loss"])
        for key in ("grads", "params"):
            for n, t in one[key].items():
                errors[(r, key, n)] = relative_error(got[key][n], t)
    return sorted(errors.items(), key=lambda kv: kv[1], reverse=True)


def differing_replicas(results: list[dict]) -> list:
    """The (rank, name) of every non-expert parameter that is not bitwise
    equal to rank 0's after the step."""
    return [(r, n) for n, t in results[0]["local_params"].items() if "experts_" not in n
            for r, got in enumerate(results[1:], 1)
            if not torch.equal(got["local_params"][n], t)]


def spawn(out_dir: pathlib.Path, world: int = 4, fn=worker) -> list[dict]:
    """Run ``fn`` (:func:`worker`) on ``world`` ranks in one
    ``start_processes`` call; each rank's results."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(world, str(out_dir / "store"), str(out_dir)),
                       nprocs=world, start_method="spawn")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def bn_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 16, 16, 3)), rng.integers(0, 10, size=4).astype(np.int32))
