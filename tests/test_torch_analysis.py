"""The port's dmt-lint and runtime sanitizer (``deeplearning_mpi_tpu_torch.analysis``)
against the reference's (``deeplearning_mpi_tpu.analysis``).

Lint:
- the PyTorch-idiom fixture corpus (``tests/fixtures/torch_lint/``, one
  seeded violation per rule): each rule catches its violation at the exact
  line and no other rule fires there; the clean fixture passes every rule;
- DMT004-DMT008 over the reference's corpus (``tests/fixtures/lint/``) give
  the reference's passes' (rule, line) set;
- the port's tree lints clean with the port's suppression file, whose
  every entry names a real file and a reason; ``--list-rules`` prints the
  catalog with DMT001 / DMT002's n/a.

Sanitizer:
- the same pool operation sequences give the same outcomes, trip classes
  and counts under the port's ``PagedKVPool`` as under the reference's;
  a pool that forgets to poison is caught by that comparison;
- the engine's retrace tripwire fires only after ``warmup()``, on a
  capture and on an eager decode at an uncaptured width, never on the
  warmed engine's traffic;
- the donation canary trips on an in-place update mid-save and costs
  nothing with the sanitizer off; trips are mirrored into the registry.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.analysis import sanitizer as ref_san
from deeplearning_mpi_tpu.analysis.core import run_lint as ref_run_lint
from deeplearning_mpi_tpu.analysis.passes import all_rules as ref_rules
from deeplearning_mpi_tpu_torch.analysis import sanitizer
from deeplearning_mpi_tpu_torch.analysis.core import (
    REPO_ROOT,
    SUPPRESSIONS,
    load_suppressions,
    run_lint,
)
from deeplearning_mpi_tpu_torch.analysis.lint import main as lint_main
from deeplearning_mpi_tpu_torch.analysis.passes import all_rules

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures" / "torch_lint"
REF_FIXTURES = Path(__file__).parent / "fixtures" / "lint"
SEEDED_RE = re.compile(r"#\s*seeded:\s*(DMT\d+)")


def _seeded(path: Path) -> tuple[str, int]:
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        m = SEEDED_RE.search(line)
        if m:
            return m.group(1), lineno
    raise AssertionError(f"no seeded marker in {path}")


FIXTURE_FILES = sorted(FIXTURES.glob("viol_*.py"))


# -- lint ---------------------------------------------------------------------------

def test_every_rule_has_a_seeded_fixture():
    assert {_seeded(f)[0] for f in FIXTURE_FILES} == {r.id for r in all_rules()}
    assert [r.id for r in all_rules()] == [r.id for r in ref_rules()]


@pytest.mark.parametrize("fixture", FIXTURE_FILES, ids=lambda p: p.stem)
def test_rule_catches_seeded_violation_at_exact_line(fixture):
    rule_id, line = _seeded(fixture)
    hits = [f for f in run_lint([fixture], suppressions={}) if not f.suppressed]
    assert [(f.rule, f.line) for f in hits] == [(rule_id, line)], (
        f"{fixture.name}: expected exactly ({rule_id}, {line}), got "
        f"{[(f.rule, f.line) for f in hits]}")


def test_clean_fixture_passes_every_rule():
    assert run_lint([FIXTURES / "clean.py"], suppressions={}) == []


def test_host_side_rules_match_the_reference_on_its_corpus():
    """DMT004-DMT008 carry over as they are: on the reference's fixture
    corpus the port's passes give the reference's (rule, file, line)s."""
    host = {"DMT004", "DMT005", "DMT006", "DMT007", "DMT008"}
    ours = {(f.rule, f.path, f.line) for f in run_lint(
        [REF_FIXTURES], rules=[r for r in all_rules() if r.id in host], suppressions={})}
    theirs = {(f.rule, f.path, f.line) for f in ref_run_lint(
        [REF_FIXTURES], rules=[r for r in ref_rules() if r.id in host], suppressions={})}
    assert ours == theirs and len(ours) >= 6


def test_port_tree_lints_clean():
    """The gate: zero unsuppressed findings over the port and chip_smoke.py,
    every suppressed one with its justification."""
    findings = run_lint()
    loud = [f.render() for f in findings if not f.suppressed]
    assert loud == [], "\n".join(loud)
    assert findings and all(f.justification for f in findings if f.suppressed)
    # The audited syncs of the decode path are inline disables, with a why.
    audited = {(f.path, f.rule) for f in findings if f.justification == "inline disable"}
    assert ("deeplearning_mpi_tpu_torch/serving/engine.py", "DMT003") in audited
    assert ("deeplearning_mpi_tpu_torch/serving/speculative.py", "DMT003") in audited


def test_suppression_entries_name_real_files_and_reasons():
    table = load_suppressions(SUPPRESSIONS)
    assert table, "the port's suppression file must parse"
    for (path, rule), why in table.items():
        assert path.startswith("deeplearning_mpi_tpu_torch/"), path
        assert (REPO_ROOT / path).is_file(), f"stale suppression: {path}"
        assert re.fullmatch(r"DMT00\d", rule) and why


def test_prefix_cache_calls_with_canonical_names():
    """The prefix cache's counters are called by their schema names, so
    DMT007 resolves them (no suppression)."""
    found = run_lint([REPO_ROOT / "deeplearning_mpi_tpu_torch/serving/prefix_cache.py"],
                     suppressions={})
    assert [f for f in found if f.rule == "DMT007"] == []


def test_cli_exit_codes_and_catalog(capsys):
    assert lint_main(["--no-suppressions", str(FIXTURES)]) == 1
    assert lint_main(["--no-suppressions", str(FIXTURES / "clean.py")]) == 0
    assert lint_main([]) == 0
    out = capsys.readouterr()
    assert "DMT001" in out.out and "0 finding(s)" in out.err
    assert lint_main(["--list-rules"]) == 0
    catalog = capsys.readouterr().out
    for rule in all_rules():
        assert rule.id in catalog
    assert catalog.count("n/a as") == 2


def test_unparseable_file_and_inline_disable(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert [f.rule for f in run_lint([bad], suppressions={})] == ["DMT000"]
    f = tmp_path / "mod.py"
    f.write_text("def record(registry):\n"
                 "    registry.counter('nope_a')  # dmt-lint: disable=DMT007 — test\n"
                 "    registry.counter('nope_b')\n")
    assert {x.line: x.suppressed for x in run_lint([f], suppressions={})} == {2: True, 3: False}


# -- sanitizer: the pool ----------------------------------------------------------------

@pytest.fixture()
def sanitize_on(monkeypatch):
    monkeypatch.setenv("DMT_SANITIZE", "1")
    for s in (sanitizer, ref_san):
        s.reset_trips()
    yield
    for s in (sanitizer, ref_san):
        s.reset_trips()
        s.attach_registry(None)


def _ops(seed: int, n: int = 60) -> list[tuple]:
    """A seeded sequence of pool operations, wrong ones included: double
    frees, writes to freed or shared blocks, torn refcounts."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["alloc", "free", "free_again", "share", "fill", "tear"],
                          p=[0.3, 0.25, 0.1, 0.1, 0.2, 0.05])
        ops.append((str(kind), int(rng.integers(1, 4)), int(rng.integers(0, 1 << 30))))
    return ops


def _replay(pool_cls, san, ops) -> tuple[list[str], dict[str, int]]:
    """Apply ``ops`` to a fresh pool; each op's outcome: ok, the trip class,
    or the plain error's type."""
    pool = pool_cls(12, 4)
    held: list[list[int]] = []
    freed: list[list[int]] = []
    outcomes = []
    for kind, n, pick in ops:
        try:
            if kind == "alloc":
                got = pool.alloc(n)
                if got is not None:
                    held.append(got)
            elif kind == "free" and held:
                blocks = held.pop(pick % len(held))
                pool.free(blocks)
                freed.append(blocks)
            elif kind == "free_again" and freed:
                pool.free(freed[pick % len(freed)])
            elif kind == "share" and held:
                pool.share(held[pick % len(held)][:1])
            elif kind == "fill":
                pool_blocks = held + freed
                if pool_blocks:
                    pool.record_fill(pool_blocks[pick % len(pool_blocks)])
            elif kind == "tear" and held:
                pool._refcount[held[pick % len(held)][0]] = 0
            outcomes.append("ok")
        except san.SanitizerError as err:
            outcomes.append(re.match(r"\[(\w+)\]", str(err)).group(1))
        except ValueError:
            outcomes.append("ValueError")
    return outcomes, san.trip_counts()


def _pools():
    from deeplearning_mpi_tpu.serving.kv_pool import PagedKVPool as RefPool
    from deeplearning_mpi_tpu_torch.serving.kv_pool import PagedKVPool

    return RefPool, PagedKVPool


@pytest.mark.parametrize("seed", range(6))
def test_pool_sequences_trip_as_the_reference(seed, sanitize_on):
    ref_pool, port_pool = _pools()
    want = _replay(ref_pool, ref_san, _ops(seed))
    got = _replay(port_pool, sanitizer, _ops(seed))
    assert got == want
    assert sum(got[1].values()) > 0, "the sequence must exercise a trip"


def test_drill_sequence_trips_as_the_reference(sanitize_on):
    """The reference drill's four injections, in its order."""
    def drill(pool_cls, san):
        pool, out = pool_cls(8, 4), []

        def attempt(fn):
            try:
                fn()
                out.append("ok")
            except san.SanitizerError as err:
                out.append(str(err).split("]")[0][1:])

        blocks = pool.alloc(2)
        pool.free(blocks)
        attempt(lambda: pool.free(blocks))
        stale = pool.alloc(2)
        pool.free(stale)
        attempt(lambda: pool.record_fill(stale))
        torn = pool.alloc(1)
        pool._refcount[torn[0]] = 0
        attempt(lambda: pool.free(torn))
        del pool._refcount[torn[0]]
        pool.free(torn)
        shared = pool.alloc(1)
        pool.share(shared)
        attempt(lambda: pool.record_fill(shared))
        pool.free(shared)
        attempt(lambda: pool.record_fill(shared))
        pool.free(shared)
        pool.check()
        return out, san.trip_counts()

    ref_pool, port_pool = _pools()
    want, got = drill(ref_pool, ref_san), drill(port_pool, sanitizer)
    assert got == want
    assert got[0] == [sanitizer.KV_DOUBLE_FREE, sanitizer.KV_USE_AFTER_FREE,
                      sanitizer.KV_REFCOUNT_UNDERFLOW, sanitizer.KV_COW_VIOLATION, "ok"]


def test_a_pool_that_forgets_to_poison_is_caught(sanitize_on, monkeypatch):
    """The bar rejects the wrong copy: without the poison on free, the
    double free is a plain ValueError, and the comparison fails."""
    ref_pool, port_pool = _pools()
    monkeypatch.setattr(sanitizer.KVPoolSanitizer, "on_free", lambda self, blocks: None)
    pool = port_pool(8, 4)
    blocks = pool.alloc(2)
    pool.free(blocks)
    with pytest.raises(ValueError) as err:
        pool.free(blocks)
    assert not isinstance(err.value, sanitizer.SanitizerError)
    assert any(_replay(port_pool, sanitizer, _ops(s)) != _replay(ref_pool, ref_san, _ops(s))
               for s in range(6))


def test_sanitizer_off_builds_no_hooks(monkeypatch):
    monkeypatch.delenv("DMT_SANITIZE", raising=False)
    assert not sanitizer.enabled()
    monkeypatch.setenv("DMT_SANITIZE", "0")
    assert not sanitizer.enabled()
    _, port_pool = _pools()
    pool = port_pool(8, 4)
    assert pool._san is None
    blocks = pool.alloc(2)
    pool.free(blocks)
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(blocks)
    assert sanitizer.trip_counts() == {}


# -- sanitizer: the engine's tripwire -------------------------------------------------

def _engine(registry=None):
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32,
                          device="cpu").init_weights(0)
    return ServingEngine(model, EngineConfig(max_slots=2, block_size=8, num_blocks=16,
                                             max_blocks_per_seq=4, prefill_chunk=8,
                                             max_queue=8), registry=registry)


def test_compile_tick_trips_only_post_warmup_as_the_reference(sanitize_on):
    for san in (ref_san, sanitizer):
        san.check_compile_tick(post_warmup=False)
        with san.allow_compiles():
            san.check_compile_tick(post_warmup=True)
        with pytest.raises(san.SanitizerError, match="AFTER warmup"):
            san.check_compile_tick(post_warmup=True)
    assert sanitizer.trip_counts() == ref_san.trip_counts() == {sanitizer.RETRACE_TRIPS: 1}


def test_engine_retrace_tripwire_fires_only_after_warmup(sanitize_on):
    from deeplearning_mpi_tpu_torch.serving import RequestState
    from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    eng = _engine(reg)
    S = eng.engine.max_slots
    rogue = (np.zeros((S, 3), np.int64), np.zeros(S, np.int64), np.zeros(S, np.int64),
             np.zeros(S, bool))
    eng._decode_fn(*rogue)  # before warmup: the eager program, no trip
    eng.warmup()  # warmup's own captures tick serve_compile_total: no trip
    assert eng.counters["serve_compile_total"] == 3
    req = eng.submit(np.arange(1, 9, dtype=np.int32), 4)
    eng.run_until_idle()
    assert req.state is RequestState.FINISHED
    assert sanitizer.trip_counts() == {}
    with pytest.raises(sanitizer.SanitizerError, match="captured AFTER warmup"):
        eng.warmup()
    with pytest.raises(sanitizer.SanitizerError, match="uncaptured|did not capture"):
        eng._decode_fn(*rogue)
    assert sanitizer.trip_counts() == {sanitizer.RETRACE_TRIPS: 2}
    assert reg.counter(sanitizer.RETRACE_TRIPS).value == 2


def test_engine_without_sanitizer_never_trips(monkeypatch):
    monkeypatch.delenv("DMT_SANITIZE", raising=False)
    sanitizer.reset_trips()
    eng = _engine()
    eng.warmup()
    eng.warmup()
    S = eng.engine.max_slots
    eng._decode_fn(np.zeros((S, 3), np.int64), np.zeros(S, np.int64), np.zeros(S, np.int64),
                   np.zeros(S, bool))
    assert sanitizer.trip_counts() == {}


# -- sanitizer: the donation canary ---------------------------------------------------

def _train_state():
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.trainer import build_optimizer

    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32,
                          device="cpu").init_weights(0)
    return create_train_state(model, build_optimizer("adam", 1e-3))


def test_donation_canary_as_the_reference(sanitize_on):
    """The reference's dict-state canary case on both packages."""
    for san in (ref_san, sanitizer):
        state = {"w": np.arange(12, dtype=np.float32), "b": np.zeros(2)}
        if san is sanitizer:
            state = {k: torch.from_numpy(v) for k, v in state.items()}
        canary = san.donation_canary(state)
        canary.verify(state)
        state["b"][0] = 7.0
        with pytest.raises(san.SanitizerError, match="changed across"):
            canary.verify(state)
    assert sanitizer.trip_counts() == ref_san.trip_counts() == {sanitizer.DONATION_TRIPS: 1}


def test_checkpoint_canary_trips_on_an_in_place_update_mid_save(sanitize_on, tmp_path):
    from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    reg = MetricsRegistry()
    sanitizer.attach_registry(reg)
    state = _train_state()
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state, epoch=0)
    assert sanitizer.trip_counts() == {}
    canary = sanitizer.donation_canary(state)
    assert canary.leaf_path == "['opt_state']['count']"
    write = ckpt._write

    def racing(arrays, epoch, *, corrupt=False):
        state.opt_state["count"].add_(1)
        write(arrays, epoch, corrupt=corrupt)

    ckpt._write = racing
    with pytest.raises(sanitizer.SanitizerError, match="changed across checkpoint save"):
        ckpt.save(state, epoch=1)
    assert sanitizer.trip_counts() == {sanitizer.DONATION_TRIPS: 1}
    assert reg.counter(sanitizer.DONATION_TRIPS).value == 1


def test_canary_costs_nothing_when_off(monkeypatch, tmp_path):
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    monkeypatch.delenv("DMT_SANITIZE", raising=False)
    calls = []
    monkeypatch.setattr(sanitizer, "_canary_digest", lambda state: calls.append(1) or ("", ""))
    ckpt = Checkpointer(tmp_path)
    ckpt.save(_train_state(), epoch=0)
    assert calls == []


def test_trip_dumps_span_recorders_and_mirrors(sanitize_on, tmp_path):
    from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry, SpanRecorder

    rec = SpanRecorder(tmp_path / "trace.jsonl")
    rec.event("before_trip")
    reg = MetricsRegistry()
    sanitizer.attach_registry(reg)
    with pytest.raises(sanitizer.SanitizerError):
        sanitizer.trip(sanitizer.RETRACE_TRIPS, "test trip")
    assert reg.counter(sanitizer.RETRACE_TRIPS).value == 1
    assert any(p.name.startswith("flight-") and "sanitizer" in p.name
               for p in tmp_path.iterdir())
    rec.close()
