"""Rank-side cases of the gloo spawns of ``tests/test_torch_compose_dense.py``
and ``tests/test_torch_compose_moe.py``, and of their four-card NCCL
counterparts in ``tests/test_torch_gpu.py``.

Imports torch and the port only (the ranks never load JAX): the parent test
computes the one-process and JAX references and asserts. Every rank runs
every case in order, so the collectives line up.

The four compositions (:data:`LAYOUTS`), each on four ranks:

- ``pp2_tp2``: the pipelined LM (2 microbatches), Megatron blocks inside
  each stage, the tied table sharded over the model group;
- ``tp2_sp2_ring`` / ``tp2_sp2_ulysses``: the LM at each model rank's local
  heads, its sequence over the seq group;
- ``ep2_sp2`` / ``ep2_sp2_ec``: the MoE LM, its experts over the expert
  group and its sequence over the seq group, token and expert choice;
- ``ep2_tp2``: the MoE LM, its experts over the expert group and each
  expert's d_ff over the model group.

:func:`step_case` takes one step of each: the loss (and the MoE metrics),
the whole gradients, their clip at ``inputs["clip"]`` and the whole
parameters after one Adam step (lr 1e-3, clip 1.0). :func:`wrong` holds the
wrong copies each composition's bar must reject; :func:`checkpoint_case`
saves, resumes and restores.
"""

from __future__ import annotations

import contextlib
import pathlib

import numpy as np
import torch
import torch.distributed as dist
from torch_pipe_ranks import ClipProbe
from torch_seq_ranks import GradProbe
from torch_tp_ranks import _join

#: The dense compositions' LM: 2 layers, 4 heads over 2 KV heads, every
#: Megatron kernel at least the rule's ``min_size``.
CFG = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, d_model=32,
           d_ff=64)
#: The MoE compositions' LM: the same with 4 experts, top 2.
MOE_CFG = dict(CFG, moe_experts=4)
AUX_WEIGHT = 0.01
#: name -> (mesh degrees, the model's config key, attention, routing).
LAYOUTS = {
    "pp2_tp2": (dict(pipe=2, model=2), "cfg", None, None),
    "tp2_sp2_ring": (dict(seq=2, model=2), "cfg", "ring", None),
    "tp2_sp2_ulysses": (dict(seq=2, model=2), "cfg", "ulysses", None),
    "ep2_sp2": (dict(expert=2, seq=2), "moe_cfg", "ring", "token_choice"),
    "ep2_sp2_ec": (dict(expert=2, seq=2), "moe_cfg", "ring", "expert_choice"),
    "ep2_tp2": (dict(expert=2, model=2), "moe_cfg", None, "token_choice"),
}
DENSE = ("pp2_tp2", "tp2_sp2_ring", "tp2_sp2_ulysses")
MOE = ("ep2_sp2", "ep2_sp2_ec", "ep2_tp2")
#: GPipe microbatches of ``pp2_tp2``.
MICROBATCHES = 2
#: The wrong copies each bar must reject: name -> the layout it runs on.
WRONG = {
    # pp x tp: the pipe's sends and sums over the other model coordinate
    # (the embedding shards' gradients summed across shards); the clip's
    # norm counting the stage's replicated norms tp times.
    "pipe_wrong_model_coordinate": "pp2_tp2",
    "clip_replicated_counted_tp_times": "pp2_tp2",
    # tp x sp: the ring rotating over the model group; the gradients not
    # summed over the seq group.
    "ring_over_model_group": "tp2_sp2_ring",
    "grads_not_summed_over_seq": "tp2_sp2_ring",
    # MoE x sp: capacity from the shard's length; positions without the
    # earlier shards' claims; each shard's balance loss, averaged after.
    "capacity_from_shard": "ep2_sp2",
    "positions_without_prefix": "ep2_sp2",
    "balance_loss_per_shard": "ep2_sp2",
    # MoE x tp: one model rank's down partial dropped from the sum; the
    # clip's norm counting the router tp times.
    "down_partial_not_summed": "ep2_tp2",
    "clip_router_counted_tp_times": "ep2_tp2",
}


def lm_config(cfg: dict, routing: str | None = None):
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**cfg, **({"moe_routing": routing} if routing else {}))


def build_model(layout: str, cfg: dict, sd: dict, mesh=None, *, dtype=torch.float32,
                device="cpu"):
    """The model of ``layout`` over ``mesh`` (one process: the flat LM)
    holding the whole model's state dict ``sd``; made double for
    ``dtype`` float64."""
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import shard_state_dict
    from deeplearning_mpi_tpu_torch.runtime.mesh import (
        expert_shards,
        pipe_shards,
        pipe_size,
        seq_ring,
        tp_shards,
    )

    routing = LAYOUTS[layout][3]
    config = lm_config(cfg, routing)
    if pipe_size(mesh) > 1:
        model = PipelinedLM(config, num_stages=2, num_microbatches=MICROBATCHES, dtype=dtype,
                            device=device, pipe=pipe_shards(mesh, device),
                            tp=tp_shards(mesh, device))
        if dtype == torch.float64:
            model.double()
        return model.load_flat_state_dict(sd)
    model = TransformerLM(config, dtype=dtype, device=device, expert_shards=expert_shards(mesh),
                          tp=tp_shards(mesh, device), seq=seq_ring(mesh))
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(shard_state_dict(sd, model))
    return model


def attention(layout: str, mesh=None, plain: bool = False):
    """The layout's attention fn over the mesh's seq group (dense without a
    mesh, or without a seq axis); ``plain``: the ring's and Ulysses' plain
    inners on any device (float64 on the card)."""
    from deeplearning_mpi_tpu_torch.ops.attention import dense_attention
    from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn, make_ulysses_attention_fn

    kind = LAYOUTS[layout][2]
    if kind is None or mesh is None:
        return None
    if kind == "ring":
        return make_ring_attention_fn(mesh, flash=False if plain else None)
    return make_ulysses_attention_fn(mesh, **({"inner": dense_attention} if plain else {}))


def rows(tokens: torch.Tensor, layout: str, mesh) -> torch.Tensor:
    """This rank's rows of a global batch (every rank holds all: the data
    axis is 1; a pipelined step cuts them into microbatches itself)."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows

    a, b = batch_rows(tokens.shape[0], mesh)
    return tokens[a:b]


def whole(state) -> dict:
    """The state's whole tree (a collective over every sharded axis) with
    the flat LM's names, on the host."""
    from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked

    arrays = state.arrays()
    pipelined = hasattr(state.model, "pipe_layout")
    host = lambda tree: {n: t.detach().cpu() for n, t in  # noqa: E731
                         (flat_from_stacked(tree) if pipelined else tree).items()}
    out = {"params": host(arrays["params"])}
    if "g" in arrays["opt_state"]:
        out["g"] = host(arrays["opt_state"]["g"])
    return out


def step_case(inputs: dict, layout: str, mesh=None, *, dtype=torch.float32, device="cpu",
              tokens: str = "tokens", attention_fn=None) -> dict:
    """One step of ``layout`` on ``inputs[tokens]`` (the flat LM in one
    process without a mesh): the losses, the MoE metrics, the whole
    gradients, their clip and the parameters after one Adam step."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_group, seq_shards
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    cfg = inputs[LAYOUTS[layout][1]]
    sd = inputs["moe_params" if cfg.get("moe_experts") else "params"]
    moe = bool(cfg.get("moe_experts"))
    batch = {"tokens": rows(inputs[tokens], layout, mesh).to(device)}
    step = make_train_step("lm", group=data_group(mesh), seq=seq_shards(mesh),
                           aux_weight=AUX_WEIGHT if moe else 0.0)
    fn = attention_fn if attention_fn is not None else attention(layout, mesh)
    out = {}
    for name, tx in (("probe", GradProbe()), ("clip", ClipProbe(inputs["clip"][layout])),
                     ("adam", build_optimizer("adam", 1e-3, clip_norm=1.0))):
        model = build_model(layout, cfg, sd, mesh, dtype=dtype, device=device)
        state, metrics = step(create_train_state(model, tx, attention_fn=fn), batch)
        out[f"{name}_loss"] = float(metrics["loss"])
        tree = whole(state)
        if name == "adam":
            out["params"] = tree["params"]
            out.update({k: float(metrics[k]) for k in ("moe_aux_loss", "moe_dropped_frac")
                        if k in metrics})
        else:
            out["grads" if name == "probe" else "clipped"] = tree["g"]
    return out


def _diagonal_pipe_group(mesh):
    """Pipe groups that pair stage 0 of model coordinate ``m`` with stage 1
    of coordinate ``1 - m`` (``pipe 2 x model 2``): a stage's sends and the
    pipe's sums cross to the other model coordinate."""
    grid = mesh.mesh.reshape(2, 2).tolist()  # [pipe][model]
    mine = None
    for m in range(2):
        ranks = [grid[0][m], grid[1][1 - m]]
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = group
    return mine


@contextlib.contextmanager
def wrong(kind: str, mesh):
    """A wrong copy of one piece of a composition. Each keeps every rank's
    graph and collectives (a dropped value is multiplied by 0), so no rank
    waits on another."""
    from deeplearning_mpi_tpu_torch.models import moe as moe_mod
    from deeplearning_mpi_tpu_torch.parallel import seq_common
    from deeplearning_mpi_tpu_torch.parallel import tensor_parallel as tpm
    from deeplearning_mpi_tpu_torch.runtime import mesh as mesh_mod
    from deeplearning_mpi_tpu_torch.train import trainer

    saved = [(mesh_mod, "pipe_group", mesh_mod.pipe_group),
             (mesh_mod, "seq_group", mesh_mod.seq_group),
             (tpm, "is_tp_shard", tpm.is_tp_shard),
             (trainer, "_mean_over_group", trainer._mean_over_group),
             (moe_mod.MoEMLP, "_global_len", moe_mod.MoEMLP._global_len),
             (moe_mod.MoEMLP, "_balance_loss", moe_mod.MoEMLP._balance_loss),
             (moe_mod.MoEMLP, "_experts", moe_mod.MoEMLP._experts),
             (seq_common.GroupRing, "all_gather", seq_common.GroupRing.all_gather)]
    if kind == "pipe_wrong_model_coordinate":
        diagonal = _diagonal_pipe_group(mesh)
        mesh_mod.pipe_group = lambda m: diagonal
    elif kind in ("clip_replicated_counted_tp_times", "clip_router_counted_tp_times"):
        tpm.is_tp_shard = lambda name, leaf=None: (
            tpm.split_name(name)[1] is not None or "norm" in name or "router" in name)
    elif kind == "ring_over_model_group":
        model_group = mesh.get_group("model")
        mesh_mod.seq_group = lambda m: model_group
    elif kind == "grads_not_summed_over_seq":
        mean = trainer._mean_over_group
        trainer._mean_over_group = lambda grads, scalars, group, seq=None: mean(
            grads, scalars, group, None)
    elif kind == "capacity_from_shard":
        moe_mod.MoEMLP._global_len = lambda self, local: local
    elif kind == "positions_without_prefix":
        gather = seq_common.GroupRing.all_gather

        def without_prefix(self, xs):
            (every,) = gather(self, xs)
            rank = self.ranks[0]
            keep = torch.zeros(every.shape[0], *[1] * (every.dim() - 1), dtype=every.dtype)
            keep[rank:] = 1
            return [every * keep.to(every.device)]

        seq_common.GroupRing.all_gather = without_prefix
    elif kind == "balance_loss_per_shard":
        def per_shard(self, primary, probs, seq, tokens):
            n = 1 if seq is None else seq.n
            local = sum(p.shape[0] * p.shape[1] for p in probs)
            frac, mean = primary / local, sum(p.sum(dim=(0, 1)) for p in probs) / local
            return self.num_experts * (frac * mean).sum() / n

        moe_mod.MoEMLP._balance_loss = per_shard
    elif kind == "down_partial_not_summed":
        experts = moe_mod.MoEMLP._experts

        def dropped(self, expert_in):
            tp = self.tp
            reduce = tp.reduce
            tp.reduce = lambda parts: reduce([p * (0.0 if dist.get_rank(tp.group) == 1 else 1.0)
                                              for p in parts])
            try:
                return experts(self, expert_in)
            finally:
                tp.reduce = reduce

        moe_mod.MoEMLP._experts = dropped
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def checkpoint_case(inputs: dict, layout: str, mesh, out_dir: pathlib.Path,
                    device="cpu") -> dict:
    """Under ``layout``: 2 steps (Adam, clip 1.0, EMA 0.9), a save into
    ``out_dir``, a third step (the uninterrupted run); a fresh template
    restored from that save and stepped once (the resumed run). The
    ``tree_digests`` of each."""
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_group, seq_shards
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    cfg = inputs[LAYOUTS[layout][1]]
    sd = inputs["moe_params" if cfg.get("moe_experts") else "params"]

    def fresh():
        model = build_model(layout, cfg, sd, mesh, device=device)
        return create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0), ema=True,
                                  attention_fn=attention(layout, mesh))

    step = make_train_step("lm", group=data_group(mesh), seq=seq_shards(mesh), ema_decay=0.9,
                           aux_weight=AUX_WEIGHT if cfg.get("moe_experts") else 0.0)
    batches = [{"tokens": rows(t, layout, mesh).to(device)} for t in inputs["batches"]]
    state = fresh()
    for batch in batches[:2]:
        state, _ = step(state, batch)
    Checkpointer(out_dir).save(state, epoch=0)
    out = {"saved": tree_digests(state.arrays())}
    state, _ = step(state, batches[2])
    out["uninterrupted"] = tree_digests(state.arrays())
    restored, _ = Checkpointer(out_dir).restore_verified(fresh())
    out["restored"] = tree_digests(restored.arrays())
    restored, _ = step(restored, batches[2])
    out["resumed"] = tree_digests(restored.arrays())
    return out


def meshes(names, device: str):
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    return {name: create_mesh(MeshSpec(**LAYOUTS[name][0]), device=device) for name in names}


def worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank of a compose test's spawn: every layout of
    ``inputs["layouts"]`` in float32 and float64, each wrong copy on its
    layout, and the checkpoint of each layout in ``inputs["checkpoints"]``."""
    torch.set_num_threads(1)
    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    _join(rank, world, store, "cpu")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    by_name = meshes(inputs["layouts"], "cpu")
    results = {}
    for name, mesh in by_name.items():
        results[name] = step_case(inputs, name, mesh)
        results[f"{name}_f64"] = step_case(inputs, name, mesh, dtype=torch.float64)
    for kind, name in WRONG.items():
        if name in by_name:
            with wrong(kind, by_name[name]):
                results[kind] = step_case(inputs, name, by_name[name])
    for name in inputs["checkpoints"]:
        results[f"{name}_checkpoint"] = checkpoint_case(inputs, name, by_name[name],
                                                        out_dir / name)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


def worker_cuda(rank: int, world: int, store: str, out_dir: str) -> None:
    """One NCCL rank (card ``rank``) of the four-card compositions: each
    layout of ``inputs["layouts"]`` in float32 (flash attention: K1-K3 at
    the local heads and shards, the kernel ring on CUDA) and float64 (the
    dense core); the split-batch baselines in float32, TF32 off: the model
    of each layout of ``inputs["dp4"]`` over ``dp 4`` (flat, or the MoE
    LM) and of each of ``inputs["dp2_sp2"]`` over ``dp 2 x sp 2`` (its
    attention and routing over the seq group); each wrong copy of
    ``inputs["wrong"]`` on its layout in float32."""
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _join(rank, world, store, "cuda")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    flash = lambda name: flash_attention_bhsd if LAYOUTS[name][2] is None else None  # noqa: E731
    by_name = meshes(inputs["layouts"], "cuda")
    for name, mesh in by_name.items():
        results[name] = step_case(inputs, name, mesh, device="cuda", attention_fn=flash(name))
        results[f"{name}_f64"] = step_case(inputs, name, mesh, dtype=torch.float64,
                                           device="cuda", attention_fn=attention(name, mesh, True))
    baselines = {"dp4": (MeshSpec(data=4), flash_attention_bhsd),
                 "dp2_sp2": (MeshSpec(data=2, seq=2), None)}
    for prefix, (spec, fn) in baselines.items():
        mesh = create_mesh(spec, device="cuda")
        for base in inputs[prefix]:
            results[f"{prefix}_{base}"] = step_case(inputs, base, mesh, device="cuda",
                                                    attention_fn=fn)
    for kind in inputs["wrong"]:
        name = WRONG[kind]
        with wrong(kind, by_name[name]):
            results[kind] = step_case(inputs, name, by_name[name], device="cuda",
                                      attention_fn=flash(name))
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


# -- the bars (the parent tests', and the four-card test's) -----------------
def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


#: The float32 bars against the reference's step, and against the port's
#: one-process step: the losses within 1e-5; each gradient and its clip
#: within 1e-5 relative L2 of JAX's; each parameter after the Adam step
#: within 1e-4 relative L2 of JAX's (Adam's first step is near the sign of
#: each gradient, where the two frameworks' float32 rounding of a near-zero
#: gradient moves a parameter by up to the learning rate:
#: ``tests/test_torch_pipeline.py``) and 1e-5 of the port's one process;
#: the MoE load-balance loss and dropped fraction within 1e-6.
LOSS_TOL = 1e-5
GRAD_L2 = 1e-5
TRAJECTORY_L2 = 1e-4
ONE_L2 = 1e-5
AUX_TOL = 1e-6
#: The float64 twins against one process.
F64_TOL = 1e-7


def bar_failures(results: list[dict], ref: dict, one: dict) -> list:
    """What fails the float32 bar (above) on any rank."""
    bad = []
    for r, got in enumerate(results):
        for key in ("probe_loss", "clip_loss", "adam_loss"):
            if not np.isclose(got[key], ref["loss"], atol=LOSS_TOL, rtol=LOSS_TOL):
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
    """What fails the float64 twin's bar against one process's float64
    step: the loss, each gradient and each stepped parameter within 1e-7
    relative."""
    bad = []
    for r, got in enumerate(results):
        if abs(got["adam_loss"] - one["adam_loss"]) > F64_TOL * abs(one["adam_loss"]):
            bad.append((r, "loss", got["adam_loss"], one["adam_loss"]))
        for key in ("grads", "clipped", "params"):
            bad += [(r, key, n, e) for n, t in one[key].items()
                    if (e := rel(got[key][n], t)) > F64_TOL]
    return bad


def replicas_differ(results: list[dict]) -> list:
    """The whole parameters in which any rank differs from rank 0."""
    return [n for got in results[1:] for n, t in results[0]["params"].items()
            if not torch.equal(got["params"][n], t)]
