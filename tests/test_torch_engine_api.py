"""The port engine's warmup, API leftovers and ``serve_lm`` flags, against the JAX engine.

- *Warmup.* On the CPU ``warmup()`` builds the static-buffer programs it
  captures as CUDA graphs on the card and runs each once eagerly; a warmed
  engine's streams equal the unwarmed engine's and offline greedy's, no
  program is built during traffic (``captures`` holds, the counterpart of
  the reference's zero-compiles-after-warmup check) and no step falls back
  to the eager path.
- *API.* ``cancel``, ``set_brownout`` and ``recover`` on the same trace and
  at the same step as the JAX engine: the same sheds, the same recovery
  books, the same streams.
- *CLI.* ``cli.serve_lm --selftest`` with ``--kv_dtype int8``,
  ``--prefix_cache``, ``--spec_k``/``--draft_layers``, ``--warmup`` and
  ``--decode_buckets``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.models.transformer import draft_config as jax_draft_config
from deeplearning_mpi_tpu.models.transformer import truncate_lm_params as jax_truncate
from deeplearning_mpi_tpu.serving import EngineConfig as JaxEngineConfig
from deeplearning_mpi_tpu.serving import ServingEngine as JaxEngine
from deeplearning_mpi_tpu.telemetry import MetricsRegistry
from deeplearning_mpi_tpu_torch.compiler.aot import CapturedProgram, WarmProgram
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.generate import generate
from deeplearning_mpi_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    self_draft,
)
from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

SHAPE = dict(max_slots=3, block_size=4, num_blocks=32, max_blocks_per_seq=8, prefill_chunk=4)
MAX_NEW = 5
TIERS = {"gold": {"budget_tokens": 0, "priority": 1.0},
         "free": {"budget_tokens": 0, "priority": 0.0}}


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxConfig.tiny()
    params = JaxLM(config=cfg, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.device_get(params)))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 255, size=n).astype(np.int32) for n in (5, 13, 3, 17, 9)]
    return SimpleNamespace(cfg=cfg, params=params, model=model, prompts=prompts)


def offline(model, prompt, max_new=MAX_NEW):
    out = generate(model, torch.as_tensor(prompt, dtype=torch.long)[None],
                   max_new_tokens=max_new, temperature=0.0)
    return out[0, len(prompt):].tolist()


def port_engine(tiny, spec_k=0, **kw):
    cfg = EngineConfig(**SHAPE, spec_k=spec_k, **kw.pop("config", {}))
    return ServingEngine(tiny.model, cfg, draft=self_draft(tiny.model, 1) if spec_k else None,
                         **kw)


def jax_engine(tiny, spec_k=0, **kw):
    cfg = JaxEngineConfig(**SHAPE, spec_k=spec_k, **kw.pop("config", {}))
    if spec_k:
        kw.update(draft_config=jax_draft_config(tiny.cfg, 1),
                  draft_params=jax_truncate(tiny.params, 1))
    return JaxEngine(tiny.cfg, tiny.params, cfg, dtype=jnp.float32, **kw)


# -- warmup -------------------------------------------------------------------

WARM_MODES = {
    "plain": {},
    "speculative": {"spec_k": 3},
    "int8": {"config": {"kv_dtype": "int8"}},
    "prefix_speculative": {"spec_k": 2, "config": {"prefix_cache": True}},
}


@pytest.mark.parametrize("mode", sorted(WARM_MODES))
def test_warmed_engine_equals_unwarmed(tiny, mode):
    streams = []
    for warm in (False, True):
        engine = port_engine(tiny, **{k: dict(v) if isinstance(v, dict) else v
                                      for k, v in WARM_MODES[mode].items()})
        if warm:
            built = engine.warmup()
            widths = len(engine._gather_widths())
            assert built["decode"] == widths == 4  # 1, 2, 4, 8 blocks
            assert engine.captures == sum(built.values())
        captures = engine.captures
        reqs = [engine.submit(p, MAX_NEW) for p in tiny.prompts]
        engine.run_until_idle()
        assert engine.captures == captures, "traffic built a program after warmup"
        if warm:
            fns = [engine._decode_fn]
            if engine._spec is not None:
                fns += [engine._verify_fn, engine._spec._decode_fn]
            assert all(isinstance(f, WarmProgram) and f.fallback_calls == 0 for f in fns)
        engine.pool.check()
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]
    if mode != "int8":
        assert streams[1] == [offline(tiny.model, p) for p in tiny.prompts]


def test_captured_program_and_fallback_on_cpu():
    """On the CPU a program's static buffers take each call's arrays and the
    program runs on them eagerly; a shape warmup did not build runs the
    fallback, counted."""
    calls = []

    def fn(a, b):
        calls.append((a.clone(), b.clone()))
        return a * 2 + b

    prog = CapturedProgram(fn, (torch.zeros(3, dtype=torch.int64), torch.zeros(3)))
    assert len(calls) == 1 and prog.graph is None and prog.launches == {}
    out = prog(np.arange(3, dtype=np.int64), torch.ones(3))
    torch.testing.assert_close(out, torch.tensor([1.0, 3.0, 5.0]))
    torch.testing.assert_close(prog.inputs[0], torch.arange(3))
    warm = WarmProgram({3: prog}, lambda a, b: torch.full((a.shape[0],), -1.0),
                       key=lambda a, b: a.shape[0])
    assert warm(np.ones(3, np.int64), torch.zeros(3)).tolist() == [2.0, 2.0, 2.0]
    assert warm(np.ones(5, np.int64), torch.zeros(5)).tolist() == [-1.0] * 5
    assert warm.fallback_calls == 1


# -- cancel, brownout, recover ------------------------------------------------

def _cancel_run(engine, prompts):
    """Three requests and one queued behind them (max_slots 3): cancel the
    queued one and a running one after two steps, then drain."""
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    engine.step()
    engine.step()
    out = [engine.cancel(reqs[3]), engine.cancel(reqs[1])]
    engine.run_until_idle()
    out.append(engine.cancel(reqs[0]))  # already finished: a no-op
    engine.pool.check()
    return out, [(r.state.value, r.shed_reason, r.generated) for r in reqs], engine.pool.in_use


def test_cancel_queued_and_running_as_jax(tiny):
    results = []
    for build in (port_engine, jax_engine):
        results.append(_cancel_run(build(tiny), tiny.prompts[:4]))
    assert results[0] == results[1]
    flags, states, in_use = results[0]
    assert flags == [True, True, False] and in_use == 0
    assert states[1][:2] == ("shed", "cancelled") and states[3][:2] == ("shed", "cancelled")
    assert states[0][2] == offline(tiny.model, tiny.prompts[0])


def test_brownout_stage2_suspends_drafts_and_stage1_sheds_the_low_tier(tiny):
    """Stage 2 turns speculative decode into plain decode (same tokens, no
    new proposals); stage 1 sheds the tenant below the top priority at the
    door and stage 0 reopens it, as the JAX engine does."""
    engine = port_engine(tiny, spec_k=3, tenants=TIERS)
    jengine = jax_engine(tiny, spec_k=3, tenants=TIERS, registry=MetricsRegistry())
    sheds = []
    for e in (engine, jengine):
        e.set_brownout(1)
        free = e.submit(tiny.prompts[0], MAX_NEW, tenant="free")
        gold = e.submit(tiny.prompts[1], MAX_NEW, tenant="gold")
        e.set_brownout(2)
        assert e.spec_suspended
        e.run_until_idle()
        e.set_brownout(0)
        assert not e.spec_suspended
        again = e.submit(tiny.prompts[0], MAX_NEW, tenant="free")
        e.run_until_idle()
        sheds.append((free.state.value, free.shed_reason, gold.generated, again.generated))
    assert sheds[0] == sheds[1]
    assert sheds[0][:2] == ("shed", "brownout")
    assert sheds[0][2] == offline(tiny.model, tiny.prompts[1])
    c = engine.counters
    assert c['serve_tenant_shed_total{tenant="free"}'] == 1
    # Only the request admitted after the clear ran speculative steps.
    assert 0 < c["spec_verify_steps"] < c["serve_decode_steps"]


RECOVER_MODES = {"plain": {}, "prefix_cache": {"config": {"prefix_cache": True}},
                 "speculative": {"spec_k": 2}}


@pytest.mark.parametrize("mode", sorted(RECOVER_MODES))
def test_recover_mid_run_as_jax(tiny, mode):
    """A recovery after three steps requeues the in-flight requests, keeps
    the prefix cache's pages and rebuilds the books as the JAX engine does;
    every stream still equals offline greedy."""
    pre = tiny.prompts[3][:9]
    prompts = [np.concatenate([pre, p[:4]]) for p in tiny.prompts]
    results = []
    for build in (port_engine, jax_engine):
        kw = {k: dict(v) if isinstance(v, dict) else v for k, v in RECOVER_MODES[mode].items()}
        engine = build(tiny, **kw)
        reqs = [engine.submit(p, MAX_NEW) for p in prompts]
        for _ in range(6):
            engine.step()
        stats = engine.recover()
        engine.run_until_idle()
        engine.pool.check()
        results.append((stats, [r.generated for r in reqs]))
    assert results[0] == results[1]
    assert results[0][0]["requeued"] >= 1
    assert results[0][1] == [offline(tiny.model, p) for p in prompts]


# -- serve_lm's engine flags --------------------------------------------------

CLI_MODEL = ["--device", "cpu", "--num_layers", "2", "--num_heads", "4", "--head_dim", "16",
             "--d_model", "64", "--d_ff", "128", "--num_requests", "6", "--rate", "1000",
             "--max_new_tokens", "6", "--max_slots", "3", "--block_size", "4",
             "--num_blocks", "48", "--max_blocks_per_seq", "8", "--prefill_chunk", "8"]
CLI_CASES = {
    "int8": (["--kv_dtype", "int8"], "int8 KV: acceptance"),
    "prefix_cache": (["--prefix_cache", "--prompt_len_min", "9", "--prompt_len_max", "9"],
                     "selftest prefix cache:"),
    "speculative": (["--spec_k", "2", "--draft_layers", "2"], "selftest speculative:"),
    "warmup_buckets": (["--warmup", "--decode_buckets", "2,3", "--max_hold_steps", "2"],
                       "warmup: 4 programs"),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_serve_lm_engine_flags(case, capsys):
    from deeplearning_mpi_tpu_torch.cli.serve_lm import main

    flags, expect = CLI_CASES[case]
    rc = main(["--selftest", *CLI_MODEL, *flags])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert expect in err and "selftest OK: 6 requests" in err, err


def test_serve_lm_refuses_spec_without_draft(capsys):
    from deeplearning_mpi_tpu_torch.cli.serve_lm import main

    assert main(["--selftest", *CLI_MODEL, "--spec_k", "2"]) == 1
    assert "--draft_layers" in capsys.readouterr().err
