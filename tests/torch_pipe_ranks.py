"""Rank-side cases of ``tests/test_torch_pipeline.py``'s gloo spawn, and of
its four-card NCCL counterpart in ``tests/test_torch_gpu.py``.

Imports torch and the port only (the ranks never load JAX): the parent test
computes the one-process and JAX references and asserts. Every rank runs
every case in order, so the collectives line up.

- :func:`worker_pipe`: one LM step (the gradients and their clip through
  probe optimizers, the parameters after one Adam step) of the pipelined
  LM at :data:`CFG` under ``pp 4`` (M 4) and ``dp 2 x pp 2`` (M 2),
  float32, and ``pp 4`` in float64; the same step with each wrong copy of
  :func:`wrong_pipe`; the MoE LM (:data:`MOE_CFG`) under ``dp 2 x pp 2``
  with its load-balance loss and dropped fraction, and each wrong copy of
  the two; a ``dp 2 x pp 2`` checkpoint and its resume
  (:func:`checkpoint_case`).
- :func:`worker_cuda_pipe`: the NCCL ranks (one card each) of the four-card
  case.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch
from torch_seq_ranks import GradProbe
from torch_tp_ranks import _join

#: ``TransformerConfig.tiny()`` at 4 layers (4 stages of 1 block, 2 of 2).
CFG = dict(vocab_size=256, num_layers=4, num_heads=4, head_dim=8, d_model=32, d_ff=64)
#: ``TransformerConfig.tiny_moe()``: 2 layers, 4 experts, top 2.
MOE_CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=8, d_model=32, d_ff=64,
               moe_experts=4)
#: name -> (data, pipe, microbatches).
PIPE_LAYOUTS = {"pp4": (1, 4, 4), "dp2_pp2": (2, 2, 2)}
#: The wrong copies the dense bars must reject (on ``pp 4``).
WRONG_PIPE = ("no_encode_grad", "embed_grad_summed", "output_index_shifted",
              "last_microbatch_dropped", "local_clip")
#: The wrong copies the MoE bars must reject (on ``dp 2 x pp 2``).
WRONG_MOE = ("aux_averaged", "drop_not_divided")
AUX_WEIGHT = 0.01


def lm_config(cfg: dict):
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**cfg)


class ClipProbe:
    """An optimizer whose state keeps the gradients after the clip of
    ``clip_norm`` (the model's global norm, over the pipe) and whose update
    is zero."""

    name = "clip_probe"

    def __init__(self, clip_norm: float) -> None:
        from deeplearning_mpi_tpu_torch.train import build_optimizer

        self.tx = build_optimizer("sgd", 1.0, clip_norm=clip_norm)

    def init(self, params, views):
        return {"g": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads, state, params, *, leaves, shards=None):
        return ({n: torch.zeros_like(g) for n, g in grads.items()},
                {"g": self.tx.clip(grads, shards)})


def pipe_rows(x: torch.Tensor, mesh, chunks: int) -> torch.Tensor:
    """This rank's rows of a global batch when the step cuts it into
    ``chunks`` microbatches: its data coordinate's share of each contiguous
    global chunk, in chunk order (the loader's ``grad_accum`` order, which
    ``cli.train_lm`` uses under ``--pp``), so that its local microbatch ``m``
    is its share of the reference's microbatch ``m``."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_rank, data_size

    n, r = data_size(mesh), data_rank(mesh)
    return torch.cat([c.chunk(n)[r] for c in x.chunk(chunks)])


def pipe_model(cfg: dict, flat_sd: dict, mesh, microbatches: int, *, stages: int | None = None,
               dtype=torch.float32, device="cpu"):
    """The pipelined LM of ``cfg`` over the mesh's pipe (or, without a
    mesh, ``stages`` stages in this process) holding the flat state dict
    ``flat_sd``; made double for ``dtype`` float64."""
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.runtime.mesh import pipe_shards, pipe_size

    model = PipelinedLM(lm_config(cfg), num_stages=stages or pipe_size(mesh),
                        num_microbatches=microbatches, dtype=dtype, device=device,
                        pipe=pipe_shards(mesh, device))
    if dtype == torch.float64:
        model.double()
    return model.load_flat_state_dict(flat_sd)


def whole(model, tree: dict) -> dict:
    """A tree of the pipelined model's own names as the flat model's, on the
    host (a collective over the pipe group)."""
    from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked

    flat = flat_from_stacked(model.pipe_layout.gather(tree))
    return {n: t.detach().cpu() for n, t in flat.items()}


def step_case(inputs: dict, mesh, microbatches: int, *, stages: int | None = None,
              dtype=torch.float32, device="cpu", tokens: str = "tokens",
              attention=None) -> dict:
    """One step of the pipelined LM on this rank's rows of
    ``inputs[tokens]``: the loss, the whole gradients, their clip at
    ``inputs["clip"]`` and the whole parameters after one Adam step (lr
    1e-3, clip 1.0), on the host."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_group
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    batch = {"tokens": pipe_rows(inputs[tokens], mesh, microbatches).to(device)}
    step = make_train_step("lm", group=data_group(mesh))
    out = {}
    for name, tx in (("probe", GradProbe()), ("clip", ClipProbe(inputs["clip"])),
                     ("adam", build_optimizer("adam", 1e-3, clip_norm=1.0))):
        model = pipe_model(inputs["cfg"], inputs["params"], mesh, microbatches, stages=stages,
                           dtype=dtype, device=device)
        state, metrics = step(create_train_state(model, tx, attention_fn=attention), batch)
        out[f"{name}_loss"] = float(metrics["loss"])
        if name == "adam":
            out["params"] = whole(model, dict(model.named_parameters()))
        else:
            out["grads" if name == "probe" else "clipped"] = whole(model, state.opt_state["g"])
    return out


def moe_case(inputs: dict, mesh, microbatches: int, device="cpu") -> dict:
    """One Adam step of the MoE pipelined LM with the balance loss weighted
    ``AUX_WEIGHT``: the loss, the load-balance loss and the dropped
    fraction the step reports."""
    from deeplearning_mpi_tpu_torch.models.norm import set_group
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_group
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    model = pipe_model(MOE_CFG, inputs["moe_params"], mesh, microbatches, device=device)
    set_group(model, data_group(mesh))
    batch = {"tokens": pipe_rows(inputs["moe_tokens"], mesh, microbatches).to(device)}
    step = make_train_step("lm", aux_weight=AUX_WEIGHT, group=data_group(mesh))
    _, metrics = step(create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0)),
                      batch)
    return {k: float(metrics[k]) for k in ("loss", "moe_aux_loss", "moe_dropped_frac")}


def checkpoint_case(inputs: dict, mesh, microbatches: int, out_dir: pathlib.Path,
                    device="cpu") -> dict:
    """Under the mesh's pipe: 2 steps (Adam, clip 1.0, EMA 0.9), a save into
    ``out_dir``, a third step (the uninterrupted run); a fresh template
    restored from that save and stepped once (the resumed run). The
    ``tree_digests`` of each."""
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.runtime.mesh import data_group
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    def fresh():
        model = pipe_model(inputs["cfg"], inputs["params"], mesh, microbatches, device=device)
        return create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0), ema=True)

    step = make_train_step("lm", group=data_group(mesh), ema_decay=0.9)
    batches = [{"tokens": pipe_rows(t, mesh, microbatches).to(device)}
               for t in inputs["batches"]]
    state = fresh()
    for batch in batches[:2]:
        state, _ = step(state, batch)
    Checkpointer(out_dir).save(state, epoch=0)
    out = {"saved": tree_digests(state.arrays())}
    state, _ = step(state, batches[2])
    out["uninterrupted"] = tree_digests(state.arrays())
    restored, epoch = Checkpointer(out_dir).restore_verified(fresh())
    out["restored"] = tree_digests(restored.arrays())
    restored, _ = step(restored, batches[2])
    out["resumed"] = tree_digests(restored.arrays())
    return out


@contextlib.contextmanager
def wrong_pipe(kind: str):
    """A wrong copy of one piece of the pipelined step. Each keeps every
    rank's graph (a wrong copy multiplies by 0, never detaches), so every
    rank still makes its backward sends."""
    from deeplearning_mpi_tpu_torch.models import pipeline_lm as lm
    from deeplearning_mpi_tpu_torch.parallel import pipeline as pl

    saved = [(pl, "place_output", pl.place_output),
             (pl.PipeLayout, "sum_over", pl.PipeLayout.sum_over),
             (pl.GroupPipe, "runs_head", pl.GroupPipe.runs_head),
             (lm.EmbedHead, "encode", lm.EmbedHead.encode),
             (lm, "reduce_moe_scalars", lm.reduce_moe_scalars)]
    place, encode = pl.place_output, lm.EmbedHead.encode
    if kind == "no_encode_grad":
        lm.EmbedHead.encode = lambda self, tokens: (
            lambda x: x.detach() + 0.0 * x)(encode(self, tokens))
    elif kind == "embed_grad_summed":
        pl.GroupPipe.runs_head = True
    elif kind == "output_index_shifted":
        pl.place_output = lambda t, s, m: t - s if 0 <= t - s < m else None
    elif kind == "last_microbatch_dropped":
        pl.place_output = lambda t, s, m: None if place(t, s, m) == m - 1 else place(t, s, m)
    elif kind == "local_clip":
        pl.PipeLayout.sum_over = lambda self, x: x
    elif kind == "aux_averaged":
        lm.reduce_moe_scalars = lambda aux, drop, s: (aux.mean() / s, drop.mean() / s)
    elif kind == "drop_not_divided":
        lm.reduce_moe_scalars = lambda aux, drop, s: (aux.mean(), drop.mean())
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def worker_pipe(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank of ``tests/test_torch_pipeline.py``'s spawn."""
    torch.set_num_threads(1)
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    _join(rank, world, store, "cpu")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    meshes = {name: (create_mesh(MeshSpec(data=dp, pipe=pp), device="cpu"), m)
              for name, (dp, pp, m) in PIPE_LAYOUTS.items()}
    results = {name: step_case(inputs, mesh, m) for name, (mesh, m) in meshes.items()}
    results["pp4_f64"] = step_case(inputs, *meshes["pp4"], dtype=torch.float64)
    for kind in WRONG_PIPE:
        with wrong_pipe(kind):
            results[kind] = step_case(inputs, *meshes["pp4"])
    results["moe"] = moe_case(inputs, *meshes["dp2_pp2"])
    for kind in WRONG_MOE:
        with wrong_pipe(kind):
            results[kind] = moe_case(inputs, *meshes["dp2_pp2"])
    results["checkpoint"] = checkpoint_case(inputs, *meshes["dp2_pp2"], out_dir / "pp2")
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


#: The four-card layouts, ``(data, pipe, microbatches, dtype)``: the cases
#: under test in float32 and float64, and pure data parallelism.
CUDA_PIPE_LAYOUTS = {"pp4": (1, 4, 4, torch.float32), "dp2_pp2": (2, 2, 2, torch.float32),
                     "dp4": (4, 1, 2, torch.float32), "pp4_f64": (1, 4, 4, torch.float64),
                     "dp2_pp2_f64": (2, 2, 2, torch.float64)}


def worker_cuda_pipe(rank: int, world: int, store: str, out_dir: str) -> None:
    """One NCCL rank (card ``rank``) of the four-card pipeline case: the step
    in each of :data:`CUDA_PIPE_LAYOUTS` (``dp4``: the flat LM over 4 data
    ranks), TF32 off, flash attention (K1-K3 at the microbatch shape) in
    float32 and the dense core in float64; then a ``--pp 4`` checkpoint and
    its resume."""
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh
    from torch_tp_ranks import tp_step_case

    torch.backends.cuda.matmul.allow_tf32 = False
    _join(rank, world, store, "cuda")
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    for name, (dp, pp, m, dtype) in CUDA_PIPE_LAYOUTS.items():
        mesh = create_mesh(MeshSpec(data=dp, pipe=pp), device="cuda")
        tokens = "tokens_f64" if dtype == torch.float64 else "tokens"
        attention = flash_attention_bhsd if dtype == torch.float32 else None
        if pp == 1:
            results[name] = tp_step_case(inputs, mesh, device="cuda", dtype=dtype, tokens=tokens,
                                         attention=attention, cfg=inputs["cfg"])
        else:
            results[name] = step_case(inputs, mesh, m, device="cuda", dtype=dtype,
                                      tokens=tokens, attention=attention)
    mesh = create_mesh(MeshSpec(pipe=4), device="cuda")
    results["checkpoint"] = checkpoint_case(inputs, mesh, 4, out_dir / "pp4", device="cuda")
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()
