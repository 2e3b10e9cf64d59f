"""The tuning DB and the tuners whose choices the port has.

Port of ``deeplearning_mpi_tpu/compiler/autotune.py``. A DB entry is keyed
by ``(kernel, shape, dtype, backend)`` (or a pre-built ``step|...`` /
``spec_k|...`` key): a tuning measured on one backend never serves
another. The port's backend field is its own, ``cuda`` or ``cpu``. Call
sites consult :func:`default_db` lazily and fall back to the defaults on
any miss, parse error or absent DB: tuning is an overlay, never a
requirement, and a lookup never raises.

Tuned here, as in the reference, oracle-first (a candidate that changes
the numbers is ``rejected: "numerics"``, never preferred):

- :func:`tune_step_schedule`: the whole train step's schedule (remat x
  ``grad_accum`` x the overlapped ZeRO-1 schedule), every candidate held
  to the untuned step's loss trajectory before it is timed;
  ``train_lm --tuned_step`` applies the winner;
- :func:`tune_spec_k`: the speculative proposal depth, raced end to end on
  the port's engine (K4 on the card); ``serve_lm --tuning_db`` applies it.

**No counterpart** (the lookups return None, the tuners raise with the
reason): :func:`tune_flash_attention` / :func:`tuned_attention_blocks`,
:func:`tune_flash_decode` / :func:`tuned_decode_schedule` and
:func:`tune_decode_buckets` / :func:`tuned_decode_bucket`. K1-K3
(``csrc/flash_attention_*.cu``) compile one tile each and K4
(``csrc/flash_decode.cu``) one split (``ops/kernels/flash_decode.py``
``SPLIT_ROWS``), so there is no block to choose; and on the card K4 is
the only decode schedule: the engine never takes the dense einsum, so
there is no kernel-vs-einsum crossover to tune. The reference's
``donate`` step field has no counterpart either (PyTorch donates
nothing): the port's step candidates leave it out.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from deeplearning_mpi_tpu_torch.resilience.integrity import atomic_write_json

__all__ = [
    "SPEC_K_CANDIDATES",
    "STEP_REMAT_CANDIDATES",
    "TuningDB",
    "default_db",
    "expected_tokens_per_step",
    "pow2_bucket",
    "set_default_db",
    "spec_k_key",
    "step_candidates",
    "step_tuning_key",
    "tune_decode_buckets",
    "tune_flash_attention",
    "tune_flash_decode",
    "tune_spec_k",
    "tune_step_schedule",
    "tuned_attention_blocks",
    "tuned_decode_bucket",
    "tuned_decode_schedule",
    "tuned_spec_k",
    "tuned_step_schedule",
    "tuning_key",
]

DB_VERSION = 1
#: Env var naming the tuning DB consulted at call sites.
ENV_DB = "DMT_TUNING_DB"
#: Default search space for the speculative proposal depth (0 = plain
#: decode; always a candidate so a hostile draft can lose to no-draft).
SPEC_K_CANDIDATES = (0, 1, 2, 4)
#: Remat policies the step tuner tries, cheapest-memory last
#: (``models.transformer.TransformerLM``'s ``remat``).
STEP_REMAT_CANDIDATES = ("none", "dots", "full")
#: Why the kernel-shape tuners have no counterpart (module docstring).
KERNEL_TUNING_NA = (
    "n/a in the port: K1-K3 compile one tile and K4 one split (SPLIT_ROWS), so there is no "
    "block size to tune, and on the card K4 is the only decode schedule (no kernel-vs-einsum "
    "choice)")


def default_backend() -> str:
    """The port's backend name for keys: ``cuda`` where a card is visible,
    else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def dtype_name(dtype: Any) -> str:
    """``float32`` / ``bfloat16`` / ... for a torch dtype, a numpy dtype or
    a name (the reference's ``jnp.dtype(dtype).name``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def tuning_key(kernel: str, shape: tuple[int, ...], dtype: Any, backend: str) -> str:
    dims = "x".join(str(int(s)) for s in shape)
    return f"{kernel}|{dims}|{dtype_name(dtype)}|{backend}"


def _mesh_desc(mesh: Any) -> str:
    """Terse mesh descriptor for tuning keys: ``data2`` / ``data2,model2``.
    Accepts a ``DeviceMesh`` (``runtime.mesh``), an ``{axis: size}`` dict,
    a pre-formatted string, or None (one process: ``1``). Size-1 axes are
    left out, so they never fork keys."""
    if isinstance(mesh, str):
        return mesh
    if mesh is None:
        items = []
    elif isinstance(mesh, dict):
        items = list(mesh.items())
    else:
        items = list(zip(mesh.mesh_dim_names, mesh.shape))
    active = [(a, int(n)) for a, n in items if int(n) > 1]
    if not active:
        return "1"
    return ",".join(f"{a}{n}" for a, n in active)


def step_tuning_key(model: str, shape: tuple[int, ...], mesh: Any, dtype: Any,
                    backend: str | None = None) -> str:
    """Key for a whole-step schedule entry:
    ``step|<model>|<batch>x<seq>|<mesh>|<dtype>|<backend>``."""
    backend = backend or default_backend()
    dims = "x".join(str(int(s)) for s in shape)
    return f"step|{model}|{dims}|{_mesh_desc(mesh)}|{dtype_name(dtype)}|{backend}"


class TuningDB:
    """JSON-backed map from tuning key to winning parameters::

        {"version": 1,
         "entries": {"step|lm|8x2048|1|bfloat16|cuda": {
             "params": {"remat": "none", "grad_accum": 1, "overlap": false},
             "best_seconds": ..., "candidates": [...], ...}}}

    Writes go through ``resilience.integrity.atomic_write_json``, so a
    crashed tuning run leaves the previous DB, never a torn one; :meth:`load`
    treats a corrupt, missing or other-version file as empty: a tuning DB
    must never take a run down."""

    def __init__(self, path: str | Path | None = None) -> None:
        self.path = Path(path) if path else None
        self.entries: dict[str, dict[str, Any]] = {}
        #: provenance of every successful lookup (one record per distinct key)
        self.consulted: list[dict[str, Any]] = []
        self._consulted_keys: set[str] = set()

    @classmethod
    def load(cls, path: str | Path) -> "TuningDB":
        db = cls(path)
        try:
            payload = json.loads(Path(path).read_text())
            if payload.get("version") == DB_VERSION:
                db.entries = dict(payload["entries"])
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            pass  # absent or corrupt: start empty, keep the path
        return db

    def save(self, path: str | Path | None = None) -> Path:
        path = Path(path) if path else self.path
        if path is None:
            raise ValueError("TuningDB has no path to save to")
        self.path = path
        atomic_write_json(path, {"version": DB_VERSION, "entries": self.entries})
        return path

    def record(self, kernel: str, shape: tuple[int, ...], dtype: Any, params: dict[str, Any], *,
               backend: str | None = None, best_seconds: float | None = None,
               candidates: list[dict[str, Any]] | None = None) -> str:
        backend = backend or default_backend()
        key = tuning_key(kernel, shape, dtype, backend)
        self.entries[key] = {
            "kernel": kernel, "shape": [int(s) for s in shape], "dtype": dtype_name(dtype),
            "backend": backend, "params": dict(params), "best_seconds": best_seconds,
            "candidates": candidates or [],
        }
        return key

    def record_key(self, key: str, params: dict[str, Any], *, best_seconds: float | None = None,
                   candidates: list[dict[str, Any]] | None = None, **meta: Any) -> str:
        """Store a winning entry under a pre-built key (``step|...``,
        ``spec_k|...``); extra ``meta`` fields land in the entry verbatim."""
        self.entries[key] = {"params": dict(params), "best_seconds": best_seconds,
                             "candidates": candidates or [], **meta}
        return key

    def lookup_key(self, key: str) -> dict[str, Any] | None:
        """Params for an exact key, or None; a hit is noted in
        :attr:`consulted` (once per distinct key)."""
        entry = self.entries.get(key)
        if not entry:
            return None
        if key not in self._consulted_keys:
            self._consulted_keys.add(key)
            self.consulted.append({"key": key, "params": dict(entry["params"]),
                                   "best_seconds": entry.get("best_seconds")})
        return dict(entry["params"])

    def lookup(self, kernel: str, shape: tuple[int, ...], dtype: Any, *,
               backend: str | None = None) -> dict[str, Any] | None:
        """The winning params for this exact (kernel, shape, dtype,
        backend), or None: no nearest-shape guessing."""
        return self.lookup_key(tuning_key(kernel, shape, dtype,
                                          backend or default_backend()))

    def __len__(self) -> int:
        return len(self.entries)


# -- process-default DB (what call sites consult) ------------------------------
_UNSET = object()
_default_db: Any = _UNSET


def default_db() -> TuningDB | None:
    """The process-wide tuning DB: whatever :func:`set_default_db`
    installed, else ``$DMT_TUNING_DB`` loaded once, else None."""
    global _default_db
    if _default_db is _UNSET:
        path = os.environ.get(ENV_DB)
        _default_db = TuningDB.load(path) if path else None
    return _default_db


def set_default_db(db: TuningDB | str | Path | None) -> TuningDB | None:
    """Install (or with None reset to 'unset': ``$DMT_TUNING_DB`` is read
    again on the next :func:`default_db`) the process-default DB; paths
    are loaded. Returns the installed DB."""
    global _default_db
    if db is None:
        _default_db = _UNSET
        return None
    if not isinstance(db, TuningDB):
        db = TuningDB.load(db)
    _default_db = db
    return db


# -- the tuners with no counterpart --------------------------------------------
def tuned_attention_blocks(shape: tuple[int, ...], dtype: Any) -> None:
    """None: K1-K3 have one tile (:data:`KERNEL_TUNING_NA`)."""
    return None


def tuned_decode_schedule(shape: tuple[int, ...], dtype: Any, *,
                          role: str | None = None) -> None:
    """None: K4 has one split and is the only decode schedule on the card."""
    return None


def tuned_decode_bucket(batch: int, context: int, shape: tuple[int, ...], dtype: Any, *,
                        role: str | None = None) -> None:
    """None: there is no per-bucket decode schedule to choose."""
    return None


def tune_flash_attention(*args: Any, **kwargs: Any) -> dict[str, Any]:
    raise NotImplementedError(f"tune_flash_attention: {KERNEL_TUNING_NA}")


def tune_flash_decode(*args: Any, **kwargs: Any) -> dict[str, Any]:
    raise NotImplementedError(f"tune_flash_decode: {KERNEL_TUNING_NA}")


def tune_decode_buckets(*args: Any, **kwargs: Any) -> dict[str, dict[str, Any]]:
    raise NotImplementedError(f"tune_decode_buckets: {KERNEL_TUNING_NA}")


# -- buckets and speculative depth ---------------------------------------------
def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Round ``n`` up to the next power of two, clamped to ``cap``."""
    n = max(int(n), 1)
    b = 1
    while b < n:
        b *= 2
    if cap is not None:
        b = min(b, int(cap))
    return b


def spec_k_key(config: Any, draft_layers: int, dtype: Any, backend: str | None = None) -> str:
    """Key for a tuned speculative depth:
    ``spec_k|<layers>x<heads>x<head_dim>x<d_model>|draft<N>|<dtype>|<backend>``."""
    backend = backend or default_backend()
    dims = f"{config.num_layers}x{config.num_heads}x{config.head_dim}x{config.d_model}"
    return f"spec_k|{dims}|draft{int(draft_layers)}|{dtype_name(dtype)}|{backend}"


def tuned_spec_k(config: Any, draft_layers: int, dtype: Any) -> dict[str, Any] | None:
    """The tuned ``{"spec_k": int, "accept_rate": float}`` for this
    target/draft pair from the default DB, or None; never raises."""
    try:
        db = default_db()
        if db is None:
            return None
        params = db.lookup_key(spec_k_key(config, draft_layers, dtype))
        if not params or not isinstance(params.get("spec_k"), int):
            return None
        return params
    except Exception:
        return None


def expected_tokens_per_step(accept_rate: float, k: int) -> float:
    """Expected emitted tokens per verify step under per-proposal
    acceptance ``a``: ``(1 - a^(k+1)) / (1 - a)``."""
    a = min(max(float(accept_rate), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tune_spec_k(config: Any = None, *, draft_layers: int = 1, dtype: Any = torch.float32,
                db: TuningDB | None = None, candidates: tuple[int, ...] | None = None,
                num_requests: int = 6, prompt_len: int = 8, max_new_tokens: int = 16,
                seed: int = 0, device: str | torch.device | None = None) -> dict[str, Any]:
    """Search the speculative proposal depth for one target/draft pair, as
    the reference: for each candidate ``k`` (0 always in the field) a
    serving engine with the self-draft (the target's first
    ``draft_layers`` layers) replays the same seeded requests, scored in
    emitted tokens per wall-second; the measured acceptance rides along,
    and the winner is recorded under :func:`spec_k_key`. Greedy parity
    makes every candidate emit the same streams: a pure throughput race.
    On the card the decode steps run K4."""
    from deeplearning_mpi_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        self_draft,
    )
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

    device = torch.device(device or default_backend())
    cfg = config or TransformerConfig.tiny()
    model = TransformerLM(cfg, dtype=dtype, device=device).init_weights(seed)
    draft = self_draft(model, draft_layers)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(num_requests)]
    max_k = max(candidates or SPEC_K_CANDIDATES)
    base = EngineConfig(
        max_slots=max(num_requests // 2, 1), block_size=8,
        num_blocks=4 * num_requests * ((prompt_len + max_new_tokens) // 8 + 2),
        max_blocks_per_seq=(prompt_len + max_new_tokens + max_k) // 8 + 2, prefill_chunk=8)
    results: list[dict[str, Any]] = []
    best: dict[str, Any] | None = None
    for k in sorted(set(candidates or SPEC_K_CANDIDATES)):
        engine = ServingEngine(model, dataclasses.replace(base, spec_k=k),
                               draft=draft if k else None)
        reqs = [engine.submit(p, max_new_tokens) for p in prompts]
        engine.step()  # the first prefill, outside the timed window
        _sync(device)
        t0 = time.perf_counter()
        engine.run_until_idle()
        _sync(device)
        wall = time.perf_counter() - t0
        counters = engine.counters
        proposed = counters.get("spec_proposed_total", 0)
        accepted = counters.get("spec_accepted_total", 0)
        entry = {"spec_k": int(k),
                 "tokens_per_s": sum(len(r.generated) for r in reqs) / wall if wall > 0 else 0.0,
                 "seconds": wall, "accept_rate": accepted / proposed if proposed else None}
        results.append(entry)
        if best is None or entry["tokens_per_s"] > best["tokens_per_s"]:
            best = entry
    params = {"spec_k": best["spec_k"], "accept_rate": best["accept_rate"]}
    if db is not None:
        db.record_key(spec_k_key(cfg, draft_layers, dtype, device.type), params,
                      best_seconds=best["seconds"], candidates=results, kernel="spec_k",
                      draft_layers=int(draft_layers), dtype=dtype_name(dtype),
                      backend=device.type)
    return params


# -- whole-step schedule -------------------------------------------------------
def step_candidates(dp: int, *, grad_accums: tuple[int, ...] = (1, 2)) -> list[dict[str, Any]]:
    """The whole-step search space: remat policy x ``grad_accum`` x
    {flat all-reduce, overlapped ZeRO-1}; overlap candidates only exist
    with data parallelism. The reference's ``donate`` field is left out."""
    overlaps = (False, True) if dp > 1 else (False,)
    return [{"remat": remat, "grad_accum": ga, "overlap": ov}
            for remat in STEP_REMAT_CANDIDATES for ga in grad_accums for ov in overlaps]


def tune_step_schedule(
    model: str = "lm", *, batch_size: int = 8, seq_len: int = 16, config: Any = None,
    mesh: Any = None, dtype: Any = torch.float32, db: TuningDB | None = None,
    candidates: list[dict[str, Any]] | None = None, steps: int = 5, repeats: int = 2,
    rtol: float = 1e-5, device: str | torch.device | None = None,
    step_factory: Callable | None = None,
) -> dict[str, Any]:
    """Search the whole-train-step schedule for one (model, shape, mesh,
    dtype) and record the winner under its ``step|...`` key.

    Oracle-first, as the reference: the untuned step (no remat,
    ``grad_accum`` 1, the flat all-reduce) runs first on ``steps`` seeded
    batches (random tokens and a random token mask) from one seeded init,
    Adam 1e-2; every candidate must reproduce its per-step loss trajectory
    within ``rtol`` (``grad_accum`` only re-associates float sums) before
    it is timed, else it is ``rejected: "numerics"``. A candidate the
    configuration cannot run (overlap without data parallelism, a batch
    its ``grad_accum`` does not divide) is ``rejected: "unsupported"``.
    Timing: the median over ``repeats`` fresh states of the verified loop's
    seconds a step. The default config is the reference's (1 layer, d 64,
    2 heads of 32, d_ff 256, vocab 256). One process: a ``mesh`` with data
    parallelism is refused. ``step_factory(candidate, state)`` builds a
    candidate's step (default: ``train.make_train_step``)."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.parallel.zero import OverlapUnsupported
    from deeplearning_mpi_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    if model != "lm":
        raise ValueError(f"step tuning currently covers the 'lm' task only, got {model!r}")
    dp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("data", 1) if mesh is not None else 1
    if dp > 1:
        raise ValueError("step tuning runs in one process: tuning across a process group "
                         "is not ported yet (ROADMAP Queue 1 item 9.1b)")
    device = torch.device(device or default_backend())
    cfg = config or TransformerConfig(vocab_size=256, num_layers=1, num_heads=2, head_dim=32,
                                      d_model=64, d_ff=256)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch_size, seq_len)))
                .to(device),
                "mask": torch.from_numpy(rng.integers(0, 2, (batch_size, seq_len))
                                         .astype(np.float32)).to(device)}
               for _ in range(steps)]

    def build_state(remat: str):
        mdl = TransformerLM(cfg, dtype=dtype, device=device, remat=remat).init_weights(0)
        return create_train_state(mdl, build_optimizer("adam", 1e-2))

    def build_step(cand: dict[str, Any], state: Any, oracle: bool = False):
        if step_factory is not None and not oracle:
            return step_factory(cand, state)
        if cand.get("overlap"):
            raise OverlapUnsupported("no data parallelism")
        return make_train_step(model, grad_accum=cand.get("grad_accum", 1))

    def run(cand: dict[str, Any], oracle: bool = False) -> list[float]:
        state = build_state(cand.get("remat", "none"))
        step = build_step(cand, state, oracle)
        losses = []
        for b in batches:
            state, metrics = step(state, b)
            losses.append(metrics["loss"])
        return [float(x) for x in losses]

    oracle = run({"remat": "none", "grad_accum": 1, "overlap": False}, oracle=True)
    results: list[dict[str, Any]] = []
    best: dict[str, Any] | None = None
    for cand in candidates if candidates is not None else step_candidates(dp):
        entry = dict(cand)
        if batch_size % cand.get("grad_accum", 1):
            results.append({**entry, "rejected": "unsupported"})
            continue
        try:
            losses = run(cand)
        except OverlapUnsupported:
            results.append({**entry, "rejected": "unsupported"})
            continue
        if not np.allclose(losses, oracle, rtol=rtol, atol=1e-7):
            results.append({**entry, "rejected": "numerics"})
            continue
        times = []
        for _ in range(repeats):
            state = build_state(cand.get("remat", "none"))
            step = build_step(cand, state)
            state, _ = step(state, batches[0])  # first-call costs outside the window
            _sync(device)
            t0 = time.perf_counter()
            for b in batches:
                state, _ = step(state, b)
            _sync(device)
            times.append((time.perf_counter() - t0) / steps)
        entry["seconds"] = statistics.median(times)
        results.append(entry)
        if best is None or entry["seconds"] < best["seconds"]:
            best = entry
    if best is None:
        return {}
    params = {k: best[k] for k in ("remat", "grad_accum", "overlap")}
    if db is not None:
        db.record_key(step_tuning_key(model, (batch_size, seq_len), mesh, dtype, device.type),
                      params, best_seconds=best["seconds"], candidates=results, kernel="step",
                      model=model, shape=[int(batch_size), int(seq_len)],
                      mesh=_mesh_desc(mesh), dtype=dtype_name(dtype), backend=device.type)
    return params


def tuned_step_schedule(model: str, shape: tuple[int, ...], mesh: Any, dtype: Any = torch.float32,
                        *, db: TuningDB | None = None) -> dict[str, Any] | None:
    """The tuned whole-step schedule for this exact (model, shape, mesh,
    dtype) on this backend, or None; never raises: a missing, corrupt or
    poisoned DB means the defaults, not a failed run."""
    try:
        db = db if db is not None else default_db()
        if db is None:
            return None
        return db.lookup_key(step_tuning_key(model, tuple(shape), mesh, dtype))
    except Exception:
        return None
