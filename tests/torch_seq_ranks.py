"""Rank-side cases of ``tests/test_torch_seq_parallel.py``'s one gloo spawn.

Imports torch and the port only (the ranks never load JAX): the parent test
computes the one-process and JAX references and asserts. Every rank runs
every case in order, so the collectives line up:

- attention in the process-group form on global ``[B, S, H, D]`` inputs,
  each rank its rows (data coordinate) and its sequence slice (seq
  coordinate): the output and ``(dq, dk, dv)`` of its shard;
- one ``make_train_step("lm")`` step of a tiny LM under ``dp 2 x sp 2``
  with the plain ring: the loss, the reduced gradients and the parameters
  after one Adam step; and the same step with a wrong loss whose last
  shard keeps an edge target (the negative control).

:func:`worker_cuda` is the four-card NCCL counterpart of the training case
(``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import os
import pathlib

import torch

#: name -> (data, seq, schedule, kwargs); ``schedule`` is ``ring_flash``
#: (the kernel ring, K1-K3's plain versions on the CPU), ``ring_xla`` (the
#: plain ring) or ``ulysses``.
ATTENTION_CASES = {
    "sp4_ring_flash": (1, 4, "ring_flash", {"causal": True}),
    "sp4_ring_xla": (1, 4, "ring_xla", {"causal": True}),
    "sp4_ring_flash_gqa_w20": (1, 4, "ring_flash", {"causal": True, "window": 20, "gqa": True}),
    "sp4_ulysses": (1, 4, "ulysses", {"causal": True}),
    "dp2_sp2_ring_w20": (2, 2, "ring_flash", {"causal": True, "window": 20}),
}


class GradProbe:
    """An optimizer whose state keeps the gradients it was given and whose
    update is zero: the step's gradients, read from its state."""

    name = "probe"

    def init(self, params, views):
        return {"g": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads, state, params, *, leaves, shards=None):
        return {n: torch.zeros_like(g) for n, g in grads.items()}, {"g": dict(grads)}


def attention_fn(schedule: str, mesh=None, sp: int | None = None):
    """The schedule's factory over ``mesh`` (process-group form) or ``sp``."""
    from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn, make_ulysses_attention_fn

    kw = {"mesh": mesh} if mesh is not None else {"sp": sp}
    if schedule == "ulysses":
        return make_ulysses_attention_fn(**kw)
    return make_ring_attention_fn(**kw, flash=schedule == "ring_flash")


def shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows and sequence slice of a global ``[B, S, ...]`` tensor."""
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows, seq_rank, seq_size

    a, b = batch_rows(x.shape[0], mesh)
    local = x.shape[1] // seq_size(mesh)
    r = seq_rank(mesh)
    return x[a:b, r * local:(r + 1) * local]


def attention_case(inputs: dict, schedule: str, kw: dict, mesh=None, sp=None) -> list:
    """Output and ``(dq, dk, dv)``: of this rank's shard with ``mesh``, of
    the global tensors with ``sp`` (the one-process form)."""
    kw = dict(kw)
    gqa = kw.pop("gqa", False)
    q, k, v, do = (inputs["gqa" if gqa and n in "kv" else "qkv"][n] for n in ("q", "k", "v", "do"))
    if mesh is not None:
        q, k, v, do = (shard(t, mesh) for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_fn(schedule, mesh, sp)(*leaves, **kw)
    return [out.detach(), *torch.autograd.grad(out, leaves, do)]


def edge_target_loss(self, logits, tokens, mask):
    """The wrong copy: every slice predicts the token after it in a row that
    wraps round, so the last slice's last position keeps a target."""
    from deeplearning_mpi_tpu_torch.ops.loss import _token_nll

    local = self.local_len(tokens.shape[1])
    start = self.rank * local
    targets = torch.roll(tokens, -1, dims=1)[:, start:start + local]
    return _token_nll(logits, targets).sum() / (tokens.shape[0] * (tokens.shape[1] - 1))


def lm_step_case(inputs: dict, mesh=None, device: str = "cpu",
                 dtype: torch.dtype = torch.float32, attention: str = "ring_xla",
                 tokens: str = "tokens", sp: int | None = None) -> dict:
    """One LM step on the global batch ``inputs[tokens]`` (this rank's rows
    and slice under ``mesh``): the loss, the reduced gradients and the
    parameters after one Adam step (lr 1e-3, clip 1.0), on the host.
    ``attention``: a schedule of :func:`attention_fn` over the mesh's seq
    group (or, without a mesh, over ``sp`` ranks in one process), ``flash``
    (K1-K3 over whole rows) or ``dense``."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_bhsd
    from deeplearning_mpi_tpu_torch.runtime.mesh import batch_rows, data_group, seq_shards
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    a, b = batch_rows(inputs[tokens].shape[0], mesh)
    batch = {"tokens": inputs[tokens][a:b].to(device)}
    fn = {"dense": None, "flash": flash_attention_bhsd}.get(attention)
    if attention not in ("dense", "flash"):
        fn = attention_fn(attention, mesh, sp)
    step = make_train_step("lm", group=data_group(mesh), seq=seq_shards(mesh))
    out = {}
    for name, tx in (("probe", GradProbe()), ("adam", build_optimizer("adam", 1e-3, clip_norm=1.0))):
        model = TransformerLM(inputs["cfg"], dtype=dtype, device=device)
        if dtype == torch.float64:
            model.double()
        model.load_state_dict(inputs["params"])
        state, metrics = step(create_train_state(model, tx, attention_fn=fn), batch)
        out[f"{name}_loss"] = float(metrics["loss"])
        if name == "probe":
            out["grads"] = {n: g.detach().cpu() for n, g in state.opt_state["g"].items()}
        else:
            out["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return out


def worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the spawn: every case, results to ``out_dir``."""
    torch.set_num_threads(1)
    from deeplearning_mpi_tpu_torch.parallel.seq_common import SeqShards
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    bootstrap.init(f"file://{store}", world, rank, "cpu", timeout_s=120)
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    meshes = {}
    for name, (dp, sp, schedule, kw) in ATTENTION_CASES.items():
        if (dp, sp) not in meshes:
            meshes[dp, sp] = create_mesh(MeshSpec(data=dp, seq=sp), device="cpu")
        results[name] = attention_case(inputs, schedule, kw, meshes[dp, sp])
    mesh = meshes[(2, 2)]
    results["lm"] = lm_step_case(inputs, mesh)
    right = SeqShards.lm_loss
    SeqShards.lm_loss = edge_target_loss
    try:
        results["lm_edge_target"] = lm_step_case(inputs, mesh)
    finally:
        SeqShards.lm_loss = right
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


#: The four-card layouts, ``(data, seq, attention, dtype, tokens)``: the
#: cases under test, pure data parallelism (flash over whole rows) beside
#: them, and the plain ring in float64 on the smaller batch, over ``sp 4``
#: and over the ``dp 2 x sp 2`` plane.
CUDA_LAYOUTS = {"sp4_ring": (1, 4, "ring_flash", torch.float32, "tokens"),
                "sp4_ulysses": (1, 4, "ulysses", torch.float32, "tokens"),
                "dp2_sp2_ring": (2, 2, "ring_flash", torch.float32, "tokens"),
                "dp4": (4, 1, "flash", torch.float32, "tokens"),
                "sp4_ring_f64": (1, 4, "ring_xla", torch.float64, "tokens_f64"),
                "dp2_sp2_ring_f64": (2, 2, "ring_xla", torch.float64, "tokens_f64")}


def worker_cuda(rank: int, world: int, store: str, out_dir: str) -> None:
    """One NCCL rank (card ``rank``) of the four-card case: the LM step in
    each of :data:`CUDA_LAYOUTS`, TF32 off."""
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.runtime.mesh import MeshSpec, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    bootstrap.init(f"file://{store}", world, rank, "cuda", timeout_s=300)
    out_dir = pathlib.Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    results = {}
    for name, (dp, sp, attention, dtype, tokens) in CUDA_LAYOUTS.items():
        mesh = create_mesh(MeshSpec(data=dp, seq=sp), device="cuda")
        results[name] = lm_step_case(inputs, mesh, device="cuda", dtype=dtype,
                                     attention=attention, tokens=tokens)
    torch.save(results, out_dir / f"rank{rank}.pt")
    bootstrap.shutdown()


def relative_error(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def relative_errors(results: list[dict], one: dict) -> list:
    """Every relative error of the ranks' LM steps against one card's: the
    two losses, each gradient and each updated parameter, worst first."""
    errors = {}
    for r, got in enumerate(results):
        for key in ("probe_loss", "adam_loss"):
            errors[(r, key)] = abs(got[key] - one[key]) / abs(one[key])
        for key in ("grads", "params"):
            for n, t in one[key].items():
                errors[(r, key, n)] = relative_error(got[key][n], t)
    return sorted(errors.items(), key=lambda kv: kv[1], reverse=True)


def differing_replicas(results: list[dict]) -> list:
    """The (rank, name) of every parameter not bitwise equal to rank 0's."""
    return [(r, n) for n, t in results[0]["params"].items()
            for r, got in enumerate(results[1:], 1) if not torch.equal(got["params"][n], t)]


def spawn(out_dir: pathlib.Path, world: int = 4, fn=worker) -> list[dict]:
    """Run ``fn`` on ``world`` ranks in one ``start_processes`` call; each
    rank's results."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(world, str(out_dir / "store"), str(out_dir)),
                       nprocs=world, start_method="spawn")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]
