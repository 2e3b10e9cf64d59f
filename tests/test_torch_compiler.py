"""The compiler layer's tuning DB and kernel build cache against the reference.

``deeplearning_mpi_tpu.compiler.autotune`` and the port's
``compiler.autotune`` in one process: the keys (``tuning_key``,
``step_tuning_key``, ``spec_k_key``) and ``pow2_bucket`` /
``expected_tokens_per_step`` equal over a grid, the same backend string
given to both; ``step_candidates`` equal to the reference's less its
JAX-only ``donate`` field; the reference's ``TestTuningDB`` cases; step
tuning (a verified winner persisted, an unsupported candidate recorded, a
math-changing candidate ``rejected: "numerics"``, never-raise consults);
the n/a tuners raising. Then ``compiler/cache.py`` over a fake build command
that writes files (no ``nvcc``): content-key hits and misses, a source
change a miss whatever its mtime, quarantine of a corrupted or unloadable
library, LRU eviction, the counters.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.compiler import autotune as ref
from deeplearning_mpi_tpu_torch.compiler import autotune
from deeplearning_mpi_tpu_torch.compiler.cache import CompileCache
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig
from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

F32 = torch.float32
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


# -- keys ------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_keys_equal_the_reference(backend):
    for ours, theirs in DTYPES:
        for kernel, shape in (("flash_attention", (1, 64, 2, 16)),
                              ("flash_decode", (8, 1024, 4, 64)), ("x", (3,))):
            assert autotune.tuning_key(kernel, shape, ours, backend) == ref.tuning_key(
                kernel, shape, theirs, backend)
        for mesh in (None, {"data": 2}, {"data": 2, "pipe": 1, "model": 2}, "data4", {"data": 1}):
            for shape in ((8, 16), (4, 2048)):
                want = ref.step_tuning_key("lm", shape, "1" if mesh is None else mesh, theirs,
                                           backend=backend)
                assert autotune.step_tuning_key("lm", shape, mesh, ours, backend) == want
        for cfg in (TransformerConfig.tiny(), TransformerConfig()):
            for layers in (1, 2):
                assert autotune.spec_k_key(cfg, layers, ours, backend) == ref.spec_k_key(
                    cfg, layers, theirs, backend)


def test_buckets_and_expected_tokens_equal_the_reference():
    for n in range(0, 70):
        for cap in (None, 1, 8, 32):
            assert autotune.pow2_bucket(n, cap) == ref.pow2_bucket(n, cap)
    for a in (0.0, 0.3, 0.5, 0.99, 1.0, 2.0, -1.0):
        for k in range(6):
            assert autotune.expected_tokens_per_step(a, k) == ref.expected_tokens_per_step(a, k)


def test_step_candidates_equal_the_reference_less_donate():
    for dp in (1, 2, 4):
        for grad_accums in ((1, 2), (1, 2, 4), (1,)):
            want = [{k: v for k, v in c.items() if k != "donate"}
                    for c in ref.step_candidates(dp, grad_accums=grad_accums)]
            assert autotune.step_candidates(dp, grad_accums=grad_accums) == want


# -- the tuning DB (the reference's TestTuningDB) ---------------------------------
class TestTuningDB:
    def test_round_trip(self, tmp_path):
        db = autotune.TuningDB(tmp_path / "t.json")
        db.record("flash_attention", (1, 64, 2, 16), F32, {"block_q": 32, "block_k": 64},
                  backend="cpu", best_seconds=0.01)
        db.record("flash_decode", (2, 64, 2, 16), F32, {"schedule": "einsum", "block": None},
                  backend="cpu")
        db.save()
        back = autotune.TuningDB.load(tmp_path / "t.json")
        assert len(back) == 2
        assert back.lookup("flash_attention", (1, 64, 2, 16), F32,
                           backend="cpu") == {"block_q": 32, "block_k": 64}
        # The reference reads the port's file and finds the same entry.
        theirs = ref.TuningDB.load(tmp_path / "t.json")
        assert theirs.lookup("flash_attention", (1, 64, 2, 16), jnp.float32,
                             backend="cpu") == {"block_q": 32, "block_k": 64}

    def test_corrupt_file_loads_empty_and_saves(self, tmp_path):
        p = tmp_path / "t.json"
        p.write_text("{not json")
        db = autotune.TuningDB.load(p)
        assert len(db) == 0
        db.record("flash_attention", (1, 8, 1, 8), F32, {"block_q": 8, "block_k": 8},
                  backend="cpu")
        db.save()  # the path survived the corrupt load
        assert len(autotune.TuningDB.load(p)) == 1

    def test_version_mismatch_ignored(self, tmp_path):
        p = tmp_path / "t.json"
        p.write_text('{"version": 99, "entries": {"x": {}}}')
        assert len(autotune.TuningDB.load(p)) == 0
        p.write_text("[1, 2]")  # valid JSON of another shape
        assert len(autotune.TuningDB.load(p)) == 0

    def test_lookup_is_exact_key_only(self):
        db = autotune.TuningDB()
        db.record("flash_attention", (1, 64, 2, 16), F32, {"block_q": 32, "block_k": 64},
                  backend="cpu")
        assert db.lookup("flash_attention", (1, 128, 2, 16), F32, backend="cpu") is None
        assert db.lookup("flash_attention", (1, 64, 2, 16), F32, backend="cuda") is None
        assert db.lookup("flash_attention", (1, 64, 2, 16), torch.bfloat16,
                         backend="cpu") is None

    def test_env_var_default_db(self, tmp_path, monkeypatch):
        db = autotune.TuningDB(tmp_path / "env.json")
        db.record("flash_attention", (1, 64, 2, 16), F32, {"block_q": 16, "block_k": 16})
        db.save()
        monkeypatch.setenv(autotune.ENV_DB, str(tmp_path / "env.json"))
        autotune.set_default_db(None)  # re-arm the env fallback
        try:
            loaded = autotune.default_db()
            assert loaded is not None and len(loaded) == 1
        finally:
            monkeypatch.delenv(autotune.ENV_DB)
            autotune.set_default_db(None)


def test_kernel_tuners_have_no_counterpart():
    for tuner in (autotune.tune_flash_attention, autotune.tune_flash_decode,
                  autotune.tune_decode_buckets):
        with pytest.raises(NotImplementedError, match="n/a in the port"):
            tuner((1, 64, 2, 16), F32)
    assert autotune.tuned_attention_blocks((1, 64, 2, 16), F32) is None
    assert autotune.tuned_decode_schedule((2, 64, 2, 16), F32) is None
    assert autotune.tuned_decode_bucket(2, 40, (2, 64, 2, 16), F32) is None


# -- step tuning --------------------------------------------------------------------
class TestStepTuning:
    def test_tune_persists_verified_winner_and_round_trips(self, tmp_path):
        db = autotune.TuningDB(tmp_path / "t.json")
        params = autotune.tune_step_schedule(
            "lm", batch_size=8, seq_len=16, db=db, device="cpu", steps=3, repeats=1,
            candidates=[{"remat": "none", "grad_accum": 1, "overlap": False},
                        {"remat": "dots", "grad_accum": 2, "overlap": False},
                        # 8 % 3 != 0: recorded unsupported, not attempted
                        {"remat": "none", "grad_accum": 3, "overlap": False},
                        # no data parallelism to overlap with
                        {"remat": "none", "grad_accum": 1, "overlap": True}])
        assert set(params) == {"remat", "grad_accum", "overlap"}
        db.save()
        payload = json.loads((tmp_path / "t.json").read_text())
        (entry,) = payload["entries"].values()
        assert [c.get("rejected") for c in entry["candidates"]] == [
            None, None, "unsupported", "unsupported"]
        assert entry["backend"] == "cpu" and entry["mesh"] == "1"
        back = autotune.TuningDB.load(tmp_path / "t.json")
        assert autotune.tuned_step_schedule("lm", (8, 16), None, F32, db=back) == params
        assert back.consulted and back.consulted[0]["key"] == "step|lm|8x16|1|float32|cpu"
        assert back.consulted[0]["best_seconds"] > 0

    def test_a_candidate_that_changes_the_math_is_rejected(self):
        from deeplearning_mpi_tpu_torch.train import make_train_step

        def dropping(cand, state):  # grad_accum 2 that drops the second chunk
            step = make_train_step("lm", grad_accum=2)
            if not cand.get("drop"):
                return step
            return lambda st, b: step(st, {k: v[: v.shape[0] // 2] for k, v in b.items()})

        db = autotune.TuningDB()
        params = autotune.tune_step_schedule(
            "lm", batch_size=8, seq_len=16, db=db, device="cpu", steps=3, repeats=1,
            candidates=[{"remat": "none", "grad_accum": 2, "overlap": False, "drop": True},
                        {"remat": "none", "grad_accum": 2, "overlap": False}],
            step_factory=dropping)
        (entry,) = db.entries.values()
        assert entry["candidates"][0]["rejected"] == "numerics"
        assert "rejected" not in entry["candidates"][1]
        assert params == {"remat": "none", "grad_accum": 2, "overlap": False}

    def test_tuned_step_schedule_never_raises(self, tmp_path):
        mesh = {"data": 2}
        assert autotune.tuned_step_schedule("lm", (8, 16), mesh, F32,
                                            db=autotune.TuningDB()) is None
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        assert autotune.tuned_step_schedule("lm", (8, 16), mesh, F32,
                                            db=autotune.TuningDB.load(p)) is None

        class Broken:
            def lookup_key(self, *a, **k):
                raise RuntimeError("boom")

        assert autotune.tuned_step_schedule("lm", (8, 16), mesh, F32, db=Broken()) is None
        autotune._default_db = Broken()
        try:
            assert autotune.tuned_step_schedule("lm", (8, 16), mesh, F32) is None
            assert autotune.tuned_spec_k(TransformerConfig.tiny(), 1, F32) is None
        finally:
            autotune.set_default_db(None)

    def test_non_lm_model_rejected(self):
        with pytest.raises(ValueError, match="lm"):
            autotune.tune_step_schedule("classification", batch_size=8, seq_len=16,
                                        device="cpu", steps=1, repeats=1)


def test_tune_spec_k_records_winner(tmp_path):
    db = autotune.TuningDB(tmp_path / "t.json")
    params = autotune.tune_spec_k(draft_layers=1, db=db, candidates=(0, 2), num_requests=2,
                                  max_new_tokens=6, device="cpu")
    assert params["spec_k"] in (0, 2)
    (key, entry), = db.entries.items()
    assert key == ref.spec_k_key(TransformerConfig.tiny(), 1, jnp.float32, "cpu")
    by_k = {c["spec_k"]: c for c in entry["candidates"]}
    assert by_k[0]["accept_rate"] is None and 0.0 <= by_k[2]["accept_rate"] <= 1.0
    db.save()
    autotune.set_default_db(tmp_path / "t.json")
    try:
        assert autotune.tuned_spec_k(TransformerConfig.tiny(), 1, F32) == params
    finally:
        autotune.set_default_db(None)


# -- the kernel build cache -----------------------------------------------------------
COPY = "import shutil, sys; shutil.copy(sys.argv[1], sys.argv[2])"


def fake_command(source, out):
    """A build command that writes files: the "library" is the source's bytes."""
    return [sys.executable, "-c", COPY, str(source), str(out)]


def fake_loader(path):
    with open(path, "rb") as f:
        if b"UNLOADABLE" in f.read():
            raise OSError(f"{path}: invalid ELF header")
    return path


def make_cache(tmp_path, **kw):
    csrc = tmp_path / "csrc"
    if not csrc.exists():
        csrc.mkdir()
        (csrc / "common.cuh").write_text("// shared\n")
        for name in ("a", "b", "c"):
            (csrc / f"{name}.cu").write_text(f'#include "common.cuh"\n// kernel {name}\n')
    return CompileCache(tmp_path / "build", csrc=csrc, command=fake_command,
                        toolchain=lambda: "fake nvcc 1.0", loader=fake_loader, **kw)


def test_cache_hit_and_miss_by_content_key(tmp_path):
    registry = MetricsRegistry()
    cache = make_cache(tmp_path, registry=registry)
    lib = cache.load("a")
    assert (cache.misses, cache.hits, cache.builds) == (1, 0, 1)
    assert os.path.basename(lib) == f"liba-{cache.key('a')[:16]}.so"
    again = make_cache(tmp_path)  # a fresh process's cache
    assert again.load("a") == lib and (again.misses, again.hits, again.builds) == (0, 1, 0)
    assert again.verify() == []
    snap = registry.snapshot()
    assert snap["compile_cache_miss_total"] == 1 and snap["compile_cache_hit_total"] == 0
    # The key covers the command line and the toolchain.
    other = CompileCache(cache.path, csrc=cache.csrc, command=fake_command,
                         toolchain=lambda: "fake nvcc 2.0", loader=fake_loader)
    assert other.key("a") != cache.key("a") and other.lookup("a") is None


def test_cache_source_change_is_a_miss_whatever_its_mtime(tmp_path):
    cache = make_cache(tmp_path)
    old = cache.load("a")
    header = cache.csrc / "common.cuh"
    header.write_text("// shared, changed\n")
    os.utime(header, (1_000, 1_000))  # older than the library
    fresh = make_cache(tmp_path)
    new = fresh.load("a")
    assert new != old and (fresh.misses, fresh.builds) == (1, 1)
    assert open(new).read().startswith('#include "common.cuh"')
    assert fresh.sources("a") == [cache.csrc / "a.cu", header]


def test_cache_quarantines_a_corrupted_or_unloadable_library(tmp_path):
    registry = MetricsRegistry()
    cache = make_cache(tmp_path, registry=registry)
    lib = cache.load("a")
    with open(lib, "ab") as f:
        f.write(b"bit rot")
    assert cache.verify() == [os.path.basename(lib)]
    assert not os.path.exists(lib) and (cache.path / "quarantine" / os.path.basename(lib)).is_file()
    assert cache.quarantined == 1 and registry.snapshot()["compile_cache_quarantined_total"] == 1
    assert cache.load("a") == lib and open(lib).read().endswith("// kernel a\n")  # rebuilt
    # A library the loader refuses: quarantined on load, rebuilt once.
    (cache.csrc / "b.cu").write_text('#include "common.cuh"\n// UNLOADABLE\n')
    bad = cache.library("b")
    cache.build(["b"])
    (cache.csrc / "b.cu").write_text('#include "common.cuh"\n// kernel b\n')
    good = cache.library("b")
    os.replace(bad, good)  # stale bytes under the current key
    with cache._manifest() as digests:
        digests.pop(good.name, None)  # unrecorded: only dlopen can tell
    assert cache.load("b") == str(good) and cache.quarantined == 2
    assert open(good).read().endswith("// kernel b\n")


def test_cache_lru_eviction_and_stats(tmp_path):
    registry = MetricsRegistry()
    cache = make_cache(tmp_path, registry=registry)
    libs = {name: cache.load(name) for name in ("a", "b", "c")}
    for age, name in enumerate(("b", "c", "a")):  # b least recently used
        os.utime(libs[name], (10_000 + age, 10_000 + age))
    assert [e.name for e in cache.entries()] == [os.path.basename(libs[n]) for n in "bca"]
    size = cache.stats()["size_bytes"]
    one = os.path.getsize(libs["a"])
    evicted = cache.evict(size - one)
    assert [e.name for e in evicted] == [os.path.basename(libs["b"])]
    stats = cache.stats()
    assert stats["entries"] == 2 and stats["evicted"] == 1 and stats["builds"] == 3
    assert registry.snapshot()["compile_cache_evicted_total"] == 1
    assert os.path.basename(libs["b"]) not in cache.recorded()
    assert cache.lookup("b") is None and str(cache.lookup("a")) == libs["a"] and cache.hits == 1
    assert cache.evict(0) and cache.stats()["entries"] == 0
    assert np.isclose(cache.stats()["size_bytes"], 0)


SLOW_RANDOM_BUILD = ("import os, sys, time; time.sleep(0.4); "
                     "open(sys.argv[2], 'wb').write(open(sys.argv[1], 'rb').read() + os.urandom(16))")
_BUILD_AT_ONCE = r"""
import sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[4])
from deeplearning_mpi_tpu_torch.compiler.cache import CompileCache
cache = CompileCache(Path(sys.argv[1]), csrc=Path(sys.argv[2]),
                     command=lambda src, out: [sys.executable, "-c", sys.argv[3], str(src), str(out)],
                     toolchain=lambda: "fake nvcc 1.0", loader=lambda p: p)
while time.time() < float(sys.argv[5]):
    time.sleep(0.001)
lib = cache.load("a")
print(cache.builds, cache.hits, cache.quarantined, lib)
"""


def test_two_processes_building_one_kernel_at_once(tmp_path):
    """Two processes load one missing kernel at the same instant, each
    build writing different bytes: the kernel's lock makes one build and
    the other hit its library, digest and all; nothing is quarantined."""
    import subprocess
    import time

    cache = make_cache(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    go = str(time.time() + 1.5)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AT_ONCE, str(cache.path),
                               str(cache.csrc), SLOW_RANDOM_BUILD, root, go],
                              stdout=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert sorted(int(o[0]) for o in outs) == [0, 1]  # one build, one hit
    assert all(int(o[2]) == 0 for o in outs) and outs[0][3] == outs[1][3]
    assert not (cache.path / "quarantine").exists()
    assert cache.verify(quarantine=False) == []
