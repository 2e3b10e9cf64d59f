"""Rank-side cases of the gloo spawns of ``tests/test_torch_compose_pipe.py``
and ``tests/test_torch_sharded_optim.py``, and of their four-card NCCL
counterparts in ``tests/test_torch_gpu.py``.

Imports torch and the port only (the ranks never load JAX): the parent test
computes the one-process and JAX references and asserts. Every rank runs
every case in order, so the collectives line up.

The layouts (:data:`LAYOUTS`), each on four ranks:

- ``pp2_ep2``: the MoE LM pipelined in 2 stages (2 microbatches), each
  stage's experts over the expert group;
- ``dp2_sp2_chunk``: the LM over ``dp 2 x sp 2`` (ring) with the chunked
  loss (``loss_chunk`` 8), each shard chunking its own slice;
- ``dp2_ep2_zero`` / ``dp2_sp2_zero`` / ``dp2_pp2_zero``: ZeRO-1 over the
  data group beside the expert, seq and pipe axes (Adam);
- ``dp2_tp2_ada`` / ``dp2_ep2_ada`` / ``dp2_pp2_ada``: Adafactor beside the
  model, expert and pipe axes.

:func:`step_case` takes one step of each: the loss (and the MoE metrics),
the whole gradients, their clip at ``inputs["clip"]`` and the whole
parameters after one step of the layout's optimizer (with ZeRO-1, the
moments' local shapes too). :func:`wrong` holds the wrong copies each bar
must reject; :func:`checkpoint_case` saves, resumes and restores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib

import torch
import torch.distributed as dist
from torch_pipe_ranks import ClipProbe, pipe_rows
from torch_seq_ranks import GradProbe
from torch_tp_ranks import _join

#: The LM of every layout: widths at which Adafactor factors (two dims of
#: at least 128) and ZeRO-1 shards (leaves of at least 16384 elements; a
#: stage's ``k_proj``, 8192, only as the stacked ``[2, 128, 64]`` leaf).
CFG = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
           d_model=128, d_ff=256)
#: The MoE layouts' LM: the same with 4 experts, top 2.
MOE_CFG = dict(CFG, moe_experts=4)
AUX_WEIGHT = 0.01
MICROBATCHES = 2
LOSS_CHUNK = 8
#: name -> mesh degrees, the config key, attention, pipelined, optimizer,
#: ZeRO-1, loss chunk.
LAYOUTS = {
    "pp2_ep2": (dict(pipe=2, expert=2), "moe_cfg", None, True, "adam", False, 0),
    "dp2_sp2_chunk": (dict(data=2, seq=2), "cfg", "ring", False, "adam", False, LOSS_CHUNK),
    "dp2_ep2_zero": (dict(data=2, expert=2), "moe_cfg", None, False, "adam", True, 0),
    "dp2_sp2_zero": (dict(data=2, seq=2), "cfg", "ring", False, "adam", True, 0),
    "dp2_pp2_zero": (dict(data=2, pipe=2), "cfg", None, True, "adam", True, 0),
    "dp2_tp2_ada": (dict(data=2, model=2), "cfg", None, False, "adafactor", False, 0),
    "dp2_ep2_ada": (dict(data=2, expert=2), "moe_cfg", None, False, "adafactor", False, 0),
    "dp2_pp2_ada": (dict(data=2, pipe=2), "cfg", None, True, "adafactor", False, 0),
}
COMPOSE = ("pp2_ep2", "dp2_sp2_chunk")
ZERO = ("dp2_ep2_zero", "dp2_sp2_zero", "dp2_pp2_zero")
ADAFACTOR = ("dp2_tp2_ada", "dp2_ep2_ada", "dp2_pp2_ada")
#: The wrong copies each bar must reject: name -> the layout it runs on.
WRONG = {
    # pp x ep: one expert rank's combine partial dropped from the sum.
    "combine_partial_dropped": "pp2_ep2",
    # loss_chunk x sp: each shard's chunked mean over its own slice, the
    # shards' means averaged (no cross-edge target, the wrong count).
    "chunk_mean_of_means": "dp2_sp2_chunk",
    # ZeRO x ep: the moments' data slice on the expert dim.
    "zero_slice_on_expert_dim": "dp2_ep2_zero",
    # Adafactor x tp: the factored means from the local shard alone.
    "adafactor_local_factors": "dp2_tp2_ada",
    # Adafactor x pp: the block RMS of each stage, not of the stacked leaf.
    "adafactor_rms_per_stage": "dp2_pp2_ada",
}


@dataclasses.dataclass(frozen=True)
class Layout:
    mesh: dict
    cfg: str
    attention: str | None
    pipelined: bool
    optimizer: str
    zero: bool
    loss_chunk: int


def layout(name: str) -> Layout:
    return Layout(*LAYOUTS[name])


def lm_config(cfg: dict):
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**cfg)


def build_model(name: str, inputs: dict, mesh=None, *, dtype=torch.float32, device="cpu"):
    """The model of ``name`` over ``mesh`` (one process: the flat LM, or the
    pipelined LM running its 2 stages in order) holding the whole model's
    state dict; made double for ``dtype`` float64."""
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import shard_state_dict
    from deeplearning_mpi_tpu_torch.runtime.mesh import (
        expert_shards,
        pipe_shards,
        seq_ring,
        tp_shards,
    )

    lay = layout(name)
    cfg = inputs[lay.cfg]
    sd = inputs["moe_params" if cfg.get("moe_experts")
                else "pipe_params" if lay.pipelined and "pipe_params" in inputs else "params"]
    config = lm_config(cfg)
    if lay.pipelined:
        model = PipelinedLM(config, num_stages=2, num_microbatches=MICROBATCHES, dtype=dtype,
                            device=device, pipe=pipe_shards(mesh, device) if mesh else None,
                            tp=tp_shards(mesh, device) if mesh else None,
                            expert_shards=expert_shards(mesh), return_prehead=lay.loss_chunk > 0)
        if dtype == torch.float64:
            model.double()
        return model.load_flat_state_dict(sd)
    model = TransformerLM(config, dtype=dtype, device=device, expert_shards=expert_shards(mesh),
                          tp=tp_shards(mesh, device) if mesh else None, seq=seq_ring(mesh),
                          return_prehead=lay.loss_chunk > 0)
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(shard_state_dict(sd, model))
    return model


def attention(name: str, mesh=None):
    """The layout's attention fn over the mesh's seq group (dense without a
    mesh or a seq axis)."""
    from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn

    if layout(name).attention is None or mesh is None:
        return None
    return make_ring_attention_fn(mesh, flash=False)


def rows(tokens: torch.Tensor, name: str, mesh) -> torch.Tensor:
    """This rank's rows of a global batch: a pipelined layout's data
    coordinate takes its share of each of the reference's microbatches
    (``torch_pipe_ranks.pipe_rows``, the CLI's loader order)."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows

    if layout(name).pipelined:
        return pipe_rows(tokens, mesh, MICROBATCHES)
    a, b = batch_rows(tokens.shape[0], mesh)
    return tokens[a:b]


def whole_params(state) -> dict:
    """The state's whole parameters (a collective over every split axis)
    with the flat LM's names, on the host."""
    from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked

    tree = dataclasses.replace(state, opt_state={}, zero=None).arrays()["params"]
    if hasattr(state.model, "pipe_layout"):
        tree = flat_from_stacked(tree)
    return {n: t.detach().cpu() for n, t in tree.items()}


def whole_probe(state) -> dict:
    """A probe's gradients (its state), whole, flat names, on the host."""
    from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked

    tree = state.arrays()["opt_state"]["g"]
    if hasattr(state.model, "pipe_layout"):
        tree = flat_from_stacked(tree)
    return {n: t.detach().cpu() for n, t in tree.items()}


def optimizer(name: str):
    from deeplearning_mpi_tpu_torch.train import build_optimizer

    return build_optimizer(layout(name).optimizer, 1e-3, clip_norm=1.0)


def trainer_state(name: str, inputs: dict, mesh, tx, *, dtype=torch.float32, device="cpu",
                  zero: bool = False, ema: bool = False, attention_fn=None):
    """A ``Trainer``'s placed state of ``name`` (ZeRO-1 with ``zero``) and
    its train step."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_group, seq_shards
    from deeplearning_mpi_tpu_torch.train import Trainer, create_train_state

    lay = layout(name)
    model = build_model(name, inputs, mesh, dtype=dtype, device=device)
    fn = attention_fn if attention_fn is not None else attention(name, mesh)
    state = create_train_state(model, tx, attention_fn=fn, ema=ema)
    moe = bool(inputs[lay.cfg].get("moe_experts"))
    trainer = Trainer(state, "lm", aux_weight=AUX_WEIGHT if moe else 0.0,
                      loss_chunk=lay.loss_chunk, ema_decay=0.9 if ema else 0.0,
                      group=data_group(mesh), seq=seq_shards(mesh), zero=zero, log=lambda m: None)
    return trainer


def step_case(inputs: dict, name: str, mesh=None, *, dtype=torch.float32, device="cpu",
              zero: bool | None = None, attention_fn=None) -> dict:
    """One step of ``name`` on ``inputs["tokens"]`` (one process without a
    mesh): the losses, the MoE metrics, the whole gradients, their clip,
    the whole parameters after one step of its optimizer; with ZeRO-1 the
    moments' local shapes."""
    lay = layout(name)
    zero = lay.zero if zero is None else zero
    batch = {"tokens": rows(inputs["tokens"], name, mesh).to(device)}
    out = {}
    for kind, tx in (("probe", GradProbe()), ("clip", ClipProbe(inputs["clip"][name])),
                     ("step", optimizer(name))):
        trainer = trainer_state(name, inputs, mesh, tx, dtype=dtype, device=device,
                                zero=zero and kind == "step", attention_fn=attention_fn)
        state, metrics = trainer.train_step(trainer.state, batch)
        out[f"{kind}_loss"] = float(metrics["loss"])
        if kind == "step":
            out["params"] = whole_params(state)
            out.update({k: float(metrics[k]) for k in ("moe_aux_loss", "moe_dropped_frac")
                        if k in metrics})
            if state.zero is not None:
                out["moment_shapes"] = {n: tuple(t.shape) for n, t in
                                        state.opt_state["mu"].items()}
                out["param_shapes"] = {n: tuple(p.shape)
                                       for n, p in state.model.named_parameters()}
        else:
            out["grads" if kind == "probe" else "clipped"] = whole_probe(state)
    return out


@contextlib.contextmanager
def wrong(kind: str):
    """A wrong copy of one piece of a layout. Each keeps every rank's graph
    and collectives (a dropped value is multiplied by 0), so no rank waits
    on another."""
    from deeplearning_mpi_tpu_torch.models import moe as moe_mod
    from deeplearning_mpi_tpu_torch.ops.loss import chunked_lm_loss
    from deeplearning_mpi_tpu_torch.parallel import leaves, zero
    from deeplearning_mpi_tpu_torch.parallel.seq_common import SeqShards

    saved = [(moe_mod, "reduce_from_experts", moe_mod.reduce_from_experts),
             (SeqShards, "chunked_lm_loss", SeqShards.chunked_lm_loss),
             (zero, "leaf_zero_dim", zero.leaf_zero_dim),
             (leaves.Reducer, "axes_of", leaves.Reducer.axes_of)]
    axes_of = leaves.Reducer.axes_of
    if kind == "combine_partial_dropped":
        reduce = moe_mod.reduce_from_experts
        moe_mod.reduce_from_experts = lambda out, group: reduce(
            out * (0.0 if dist.get_rank(group) == 1 else 1.0), group)
    elif kind == "chunk_mean_of_means":
        def mean_of_means(self, x, head_kernel, tokens, mask, chunk_size):
            local = self.local_len(tokens.shape[1])
            mine = tokens[:, self.rank * local:(self.rank + 1) * local]
            return chunked_lm_loss(x, head_kernel, mine, chunk_size=chunk_size) / self.size

        SeqShards.chunked_lm_loss = mean_of_means
    elif kind == "zero_slice_on_expert_dim":
        leaf_zero_dim = zero.leaf_zero_dim

        def on_expert_dim(name, p, dp, views, **kw):
            if views is not None and views[name].split.get(0) == "expert":
                return 0
            return leaf_zero_dim(name, p, dp, views, **kw)

        zero.leaf_zero_dim = on_expert_dim
    elif kind == "adafactor_local_factors":
        leaves.Reducer.axes_of = lambda self, n, dims=None: (
            () if dims is not None else axes_of(self, n, dims))
    elif kind == "adafactor_rms_per_stage":
        leaves.Reducer.axes_of = lambda self, n, dims=None: tuple(
            a for a in axes_of(self, n, dims) if dims is not None or a != "pipe")
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def checkpoint_case(inputs: dict, name: str, mesh, out_dir: pathlib.Path,
                    device="cpu") -> dict:
    """Under ``name``: 2 steps (its optimizer, clip 1.0, EMA 0.9), a save
    into ``out_dir``, a third step (the uninterrupted run); a fresh
    template restored from that save and stepped once (the resumed run).
    The ``tree_digests`` of each."""
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    lay = layout(name)

    def fresh():
        return trainer_state(name, inputs, mesh, optimizer(name), device=device, zero=lay.zero,
                             ema=True)

    batches = [{"tokens": rows(t, name, mesh).to(device)} for t in inputs["batches"]]
    trainer = fresh()
    state = trainer.state
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    Checkpointer(out_dir).save(state, epoch=0)
    out = {"saved": tree_digests(state.arrays())}
    state, _ = trainer.train_step(state, batches[2])
    out["uninterrupted"] = tree_digests(state.arrays())
    template = fresh()
    restored, _ = Checkpointer(out_dir).restore_verified(template.state)
    out["restored"] = tree_digests(restored.arrays())
    restored, _ = template.train_step(restored, batches[2])
    out["resumed"] = tree_digests(restored.arrays())
    return out


def meshes(names, device: str):
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    return {name: create_mesh(MeshSpec(**layout(name).mesh), device=device) for name in names}


def worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank of a test's spawn: every layout of
    ``inputs["layouts"]`` in float32 and float64 (a ZeRO layout also
    without ZeRO-1), each wrong copy of ``inputs["wrong"]`` on its layout,
    and the checkpoint of each layout in ``inputs["checkpoints"]``."""
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
        if layout(name).zero:
            results[f"{name}_unzeroed"] = step_case(inputs, name, mesh, zero=False)
            results[f"{name}_unzeroed_f64"] = step_case(inputs, name, mesh, dtype=torch.float64,
                                                        zero=False)
    for kind in inputs["wrong"]:
        name = WRONG[kind]
        with wrong(kind):
            results[kind] = step_case(inputs, name, by_name[name])
    for name in inputs["checkpoints"]:
        results[f"{name}_checkpoint"] = checkpoint_case(inputs, name, by_name[name],
                                                        out_dir / name)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


def worker_cuda(rank: int, world: int, store: str, out_dir: str) -> None:
    """One NCCL rank (card ``rank``) of ``tests/test_torch_gpu.py``'s
    composed cases: each layout of ``inputs["layouts"]`` in float32 (flash
    attention: K1-K3, the kernel ring on CUDA) and float64 (the plain
    cores), a ZeRO-1 layout also without ZeRO-1; and the split-batch
    baseline of ``pp2_ep2`` (the pipelined MoE LM, its stages run in order
    and every expert on each rank, over ``dp 4``; each data rank its share
    of each microbatch) in float32, TF32 off."""
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd
    from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _join(rank, world, store, "cuda")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    for name, mesh in meshes(inputs["layouts"], "cuda").items():
        zeros = (True, False) if layout(name).zero else (None,)
        for zero in zeros:
            tag = "_unzeroed" if zero is False else ""
            flash = (flash_attention_bhsd if layout(name).attention is None
                     else make_ring_attention_fn(mesh, flash=True))
            results[f"{name}{tag}"] = step_case(inputs, name, mesh, device="cuda", zero=zero,
                                                attention_fn=flash)
            results[f"{name}{tag}_f64"] = step_case(inputs, name, mesh, dtype=torch.float64,
                                                    device="cuda", zero=zero)
    if "pp2_ep2" in inputs["layouts"]:
        LAYOUTS["dp4_pp2_ep2"] = (dict(data=4), "moe_cfg", None, True, "adam", False, 0)
        results["dp4_pp2_ep2"] = step_case(inputs, "dp4_pp2_ep2",
                                           create_mesh(MeshSpec(data=4), device="cuda"),
                                           device="cuda", attention_fn=flash_attention_bhsd)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()
