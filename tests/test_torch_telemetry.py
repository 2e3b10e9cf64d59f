"""The port's telemetry modules against the reference's, in one process.

- Schema: ``METRICS`` and ``LABEL_KEYS`` equal the reference's.
- Registry: the same observation sequences give the same histogram
  summaries and percentiles; ``emit`` the same record keys; ``record_step``
  reads nothing into the host and ``flush_steps`` makes exactly one read
  (one ``torch.stack(...).cpu()``), for scalars of mixed dtypes; a wrong
  copy that calls ``.item()`` in ``record_step`` is caught by the same
  count; a raising sink never reaches the caller.
- FLOPs and collective bytes: every count equal to the reference's within
  1e-12 relative over a grid (the 110M LM, GQA, a sliding window, the MoE
  LM, remat full / dots, ResNet-18/50, the UNet in 2-D and 3-D; every byte
  formula at n = 1, 2, 4, 8); ``param_count`` on the leaves of a tp-2, a
  pp-2 and an ep-2 rank equal to the reference's count of the whole
  model.
- Spans: the reference's nesting, orphan, flight-ring, torn-line and
  clock-offset cases on the port's recorder; a port trace file read by the
  reference's ``load_trace_file`` and merged by ``tools/trace_report.py``.
- Trace annotations, device memory on the CPU, the step timer, the
  profiler, the NaN debug mode and the run log.
"""

import json
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.telemetry import comms as ref_comms
from deeplearning_mpi_tpu.telemetry import flops as ref_flops
from deeplearning_mpi_tpu.telemetry import registry as ref_registry
from deeplearning_mpi_tpu.telemetry import schema as ref_schema
from deeplearning_mpi_tpu.telemetry import spans as ref_spans
from deeplearning_mpi_tpu.utils import profiling as ref_profiling
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.telemetry import comms, flops, memory, registry, schema, spans, trace
from deeplearning_mpi_tpu_torch.utils import profiling
from deeplearning_mpi_tpu_torch.utils.logging import RunLogger

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-12


# -- schema ---------------------------------------------------------------------
def test_schema_equals_the_reference():
    assert schema.METRICS == ref_schema.METRICS
    assert schema.LABEL_KEYS == ref_schema.LABEL_KEYS
    for name in ("serve_ttft_s", 'serve_shed_total{reason="deadline"}', "not_a_metric"):
        assert schema.is_canonical(name) == ref_schema.is_canonical(name)


# -- registry -------------------------------------------------------------------
class HostReads:
    """Counts the reads of tensors into the host inside the block: ``item``,
    ``float``, ``int``, ``bool``, ``tolist``, ``numpy`` and ``cpu``. A read
    of a tensor that a counted ``cpu()`` returned is already on the host and
    is not counted again."""

    NAMES = ("item", "__float__", "__int__", "__bool__", "tolist", "numpy", "cpu")

    def __enter__(self):
        self.count, self.saved = 0, {}
        self.host: list[torch.Tensor] = []  # kept alive, so their ids stay theirs
        for name in self.NAMES:
            orig = self.saved[name] = getattr(torch.Tensor, name)

            def read(t, *args, _orig=orig, _name=name, **kw):
                out = _orig(t, *args, **kw)
                if not any(t is h for h in self.host):
                    self.count += 1
                    if _name == "cpu":
                        self.host.append(out)
                return out

            setattr(torch.Tensor, name, read)
        return self

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            setattr(torch.Tensor, name, orig)


class ItemRegistry(registry.MetricsRegistry):
    """A wrong copy: reads each scalar as it is recorded."""

    def record_step(self, step, scalars):
        super().record_step(step, {k: v.item() for k, v in scalars.items()})


def _scalars(i):
    return {"loss": torch.tensor(2.5 + i), "finite": torch.tensor(1.0),
            "grad_norm": torch.tensor(0.25 * i, dtype=torch.float64),
            "tokens": torch.tensor(128 * i), "moe_dropped_frac": torch.tensor(0.5).bfloat16()}


def reads_of(reg, steps=4):
    """Host reads made by ``record_step`` (all steps) and by ``flush_steps``."""
    with HostReads() as rec:
        for i in range(steps):
            reg.record_step(i, _scalars(i))
    with HostReads() as flush:
        out = reg.flush_steps(extra={"epoch": 0})
    return rec.count, flush.count, out


def test_record_step_reads_nothing_and_flush_reads_once():
    sink = registry.InMemorySink()
    n_record, n_flush, out = reads_of(registry.MetricsRegistry([sink]))
    assert (n_record, n_flush) == (0, 1)
    assert [r["step"] for r in out] == [0, 1, 2, 3] and sink.records == out
    assert out[3]["loss"] == 5.5 and out[3]["grad_norm"] == 0.75 and out[3]["tokens"] == 384.0
    assert out[2]["moe_dropped_frac"] == 0.5 and out[0]["epoch"] == 0
    assert all(isinstance(v, float) for r in out for k, v in r.items() if k not in ("kind", "step", "epoch"))


def test_a_registry_that_syncs_in_record_step_is_caught():
    n_record, _, _ = reads_of(ItemRegistry())
    assert n_record == 4 * len(_scalars(0))


def test_histograms_and_records_match_the_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 40):
        obs = rng.exponential(size=n).tolist()
        mine, ref = registry.Histogram("h"), ref_registry.Histogram("h")
        for v in obs:
            mine.observe(v)
            ref.observe(v)
        assert mine.summary() == ref.summary()
        for q in (0.0, 0.5, 0.9, 0.95, 1.0):
            assert mine.percentile(q) == ref.percentile(q)
    values = {"loss": 1.5, "nan": float("nan"), "n": 3, "flag": True, "name": "x",
              "np": np.float32(2.0), "none": None}
    mine = registry.MetricsRegistry([registry.InMemorySink()]).emit("epoch", values)
    ref = ref_registry.MetricsRegistry([ref_registry.InMemorySink()]).emit("epoch", values)
    mine.pop("ts"), ref.pop("ts")
    assert mine == ref
    assert registry.labeled("serve_shed_total", reason="deadline", b="1") == \
        ref_registry.labeled("serve_shed_total", reason="deadline", b="1")


def test_snapshot_drop_and_broken_sink():
    class Broken:
        def write(self, record):
            raise OSError("disk gone")

        def close(self):
            raise OSError("disk gone")

    sink = registry.InMemorySink()
    reg = registry.MetricsRegistry([Broken(), sink])
    reg.counter("c").inc(2)
    reg.gauge("g").set(3)
    reg.histogram("h").observe(1.0)
    reg.record_step(0, {"loss": torch.tensor(1.0)})
    assert reg.drop_pending_steps() == 1 and reg.flush_steps() == []
    reg.emit("x", reg.snapshot())
    assert sink.records[0]["c"] == 2.0 and sink.records[0]["h_count"] == 1.0
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    reg.record_step(1, {"loss": torch.tensor(2.0)})
    reg.close()  # flushes, and the broken sink's close is swallowed
    assert sink.records[-1]["kind"] == "step" and sink.records[-1]["loss"] == 2.0


def test_jsonl_and_logger_sinks(tmp_path, monkeypatch):
    reg = registry.MetricsRegistry([registry.JsonlSink(tmp_path / "m" / "metrics.jsonl")])
    logger = RunLogger(tmp_path / "log", echo=False, run_name="run")
    reg.add_sink(registry.LoggerSink(logger))
    rec = reg.emit("epoch", {"loss": 1.0})
    logger.log("Epoch 0: loss 1.0")
    reg.close()
    assert json.loads((tmp_path / "m" / "metrics.jsonl").read_text()) == rec
    assert json.loads((tmp_path / "log" / "run.metrics.jsonl").read_text()) == rec
    assert (tmp_path / "log" / "run.log").read_text().rstrip().endswith("] Epoch 0: loss 1.0")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # not installed
    with pytest.raises(ImportError, match="torch.utils.tensorboard"):
        registry.TensorBoardSink(tmp_path / "tb")


# -- FLOPs and bytes --------------------------------------------------------------
LM_CONFIGS = {
    "110m": {},
    "gqa": {"num_kv_heads": 4},
    "window": {"attention_window": 512},
    "moe": {"moe_experts": 8, "moe_top_k": 2},
    "gqa_moe_window": {"num_kv_heads": 3, "moe_experts": 4, "moe_top_k": 1,
                       "attention_window": 100},
}


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_transformer_flops_match_the_reference(name):
    kw = LM_CONFIGS[name]
    mine, ref = TransformerConfig(**kw), JaxConfig(**kw)
    for batch, seq in ((8, 2048), (2, 512), (1, 100)):
        for fn in ("transformer_fwd_flops", "transformer_train_flops"):
            a = getattr(flops, fn)(mine, batch, seq)
            b = getattr(ref_flops, fn)(ref, batch, seq)
            assert _close(a, b) and a > 0, (fn, a, b)
        for remat in ("none", "dots", "full", True, False):
            for fn in ("transformer_remat_flops", "transformer_issued_flops"):
                a = getattr(flops, fn)(mine, batch, seq, remat=remat)
                b = getattr(ref_flops, fn)(ref, batch, seq, remat=remat)
                assert _close(a, b), (fn, remat, a, b)
    with pytest.raises(ValueError):
        flops.transformer_remat_flops(mine, 1, 8, remat="some")


def test_cnn_flops_match_the_reference():
    for arch in ("resnet18", "resnet50"):
        for stem in ("cifar", "imagenet"):
            for size in (32, 224):
                a = flops.resnet_train_flops(arch, 128, size, stem=stem)
                assert _close(a, ref_flops.resnet_train_flops(arch, 128, size, stem=stem))
    for dim, size in ((2, 256), (2, 64), (3, 32)):
        kw = dict(in_channels=3 if dim == 2 else 1, out_channels=1, dim=dim)
        assert _close(flops.unet_train_flops(16, size, **kw),
                      ref_flops.unet_train_flops(16, size, **kw))
        assert _close(flops.unet_fwd_flops(2, size, dim=dim), ref_flops.unet_fwd_flops(2, size, dim=dim))


def test_mfu_overlap_and_gap_match_the_reference(monkeypatch):
    for args in ((1e12, 0.1), (3.3e15, 0.137), (0.0, 1.0), (1e12, 0.0)):
        for n in (1, 4):
            assert flops.mfu(*args, n_devices=n, peak_flops_per_device=989e12) == \
                ref_flops.mfu(*args, n_devices=n, peak_flops_per_device=989e12)
    for comm, issued in ((0.0, 1e12), (1e9, 1e12), (1e12, 1e9), (1.0, 0.0), (-1.0, 1e9)):
        kw = dict(n_devices=4, peak_flops_per_device=989e12, link_bandwidth_per_device=900e9)
        assert flops.overlap_fraction(comm, issued, **kw) == ref_flops.overlap_fraction(comm, issued, **kw)
    phases = {"data_wait": 0.1, "h2d": 0.02, "compute": 1.5, "collective_tail": 0.3, "other": 0.08}
    for kw in (dict(mfu_issued=0.4, mfu_gap=0.1), dict(mfu_issued=None, mfu_gap=None)):
        got = flops.mfu_gap_attribution(phases, 2.0, **kw)
        assert got == ref_flops.mfu_gap_attribution(phases, 2.0, **kw)
        if got:
            assert math.isclose(sum(got.values()), 0.1)
    # The peak table by device name, the overrides, and the CPU's nominal peak.
    assert flops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.device_peak_flops("NVIDIA H100 PCIe") == 756.5e12
    assert flops.device_link_bandwidth("NVIDIA H100 80GB HBM3") == 900e9
    assert flops.device_peak_flops("cpu") == flops.CPU_NOMINAL_PEAK_FLOPS == ref_flops.CPU_NOMINAL_PEAK_FLOPS
    assert flops.device_link_bandwidth() == flops.CPU_NOMINAL_LINK_BANDWIDTH
    monkeypatch.setenv("DMT_PEAK_FLOPS", "1.5e12")
    monkeypatch.setenv("DMT_LINK_BANDWIDTH", "2e9")
    assert flops.device_peak_flops("NVIDIA H100 PCIe") == 1.5e12 == ref_flops.device_peak_flops()
    assert flops.device_link_bandwidth() == 2e9 == ref_flops.device_link_bandwidth()
    assert flops.mfu(1.5e12, 1.0) == 1.0  # world size 1 without a group


DTYPES = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_collective_bytes_match_the_reference(n):
    for fn in ("allreduce_bytes", "reduce_scatter_bytes", "all_gather_bytes", "all_to_all_bytes",
               "ppermute_bytes"):
        for buf in (0.0, 4096.0, 3.3e8):
            assert getattr(comms, fn)(buf, n) == getattr(ref_comms, fn)(buf, n)
    for tdt, jdt in DTYPES:
        for zero in (False, True):
            assert _close(comms.dp_grad_allreduce_bytes(109_529_856, n, dtype=tdt, zero=zero),
                          ref_comms.dp_grad_allreduce_bytes(109_529_856, n, dtype=jdt, zero=zero))
        for kv in (None, 4):
            for training in (True, False):
                kw = dict(kv_heads=kv, num_layers=12, training=training)
                assert _close(comms.ulysses_attention_bytes(2, 2048, 12, 64, n, dtype=tdt, **kw),
                              ref_comms.ulysses_attention_bytes(2, 2048, 12, 64, n, dtype=jdt, **kw))
                for rot in (None, 1, 3):
                    assert _close(
                        comms.ring_attention_bytes(2, 2048, 12, 64, n, rotations=rot, dtype=tdt, **kw),
                        ref_comms.ring_attention_bytes(2, 2048, 12, 64, n, rotations=rot, dtype=jdt,
                                                       **kw))
        for m in (1, 4):
            assert _close(comms.pipeline_bytes((2, 2048, 768), m, n, dtype=tdt),
                          ref_comms.pipeline_bytes((2, 2048, 768), m, n, dtype=jdt))
        for top_k, cf in ((1, 1.0), (2, 1.25)):
            kw = dict(top_k=top_k, capacity_factor=cf, num_layers=12)
            assert _close(comms.moe_dispatch_bytes(4096, 768, n, dtype=tdt, **kw),
                          ref_comms.moe_dispatch_bytes(4096, 768, n, dtype=jdt, **kw))


def _fake(cls, size, rank, **attrs):
    """A process-group shard object for ``rank`` of ``size``, without a group
    (only the leaves' shapes are read)."""
    obj = cls.__new__(cls)
    obj.group, obj.size, obj.rank = None, size, rank
    for k, v in attrs.items():
        setattr(obj, k, v)
    return obj


def test_param_count_of_a_rank_is_the_whole_model():
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.parallel.expert_parallel import ExpertShards
    from deeplearning_mpi_tpu_torch.parallel.pipeline import GroupPipe
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import GroupTP

    kw = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=32, d_model=128, d_ff=512)
    dense, moe = dict(kw), dict(kw, moe_experts=4, moe_top_k=2)

    def ref_count(cfg_kw):
        model = JaxLM(config=JaxConfig(**cfg_kw), dtype=jnp.float32)
        shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
        params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
        return ref_comms.param_count(params)

    cpu = torch.device("cpu")
    ranks = {
        "tp2": (dense, lambda c: TransformerLM(c, dtype=torch.float32, device="cpu",
                                               tp=_fake(GroupTP, 2, 1, ranks=[1], devices=[cpu]))),
        "pp2": (dense, lambda c: PipelinedLM(c, num_stages=2, num_microbatches=2,
                                             dtype=torch.float32, device="cpu",
                                             pipe=_fake(GroupPipe, 2, 1, stage_ids=[1], device=cpu))),
        "ep2": (moe, lambda c: TransformerLM(c, dtype=torch.float32, device="cpu",
                                             expert_shards=ExpertShards(None, 2, 1))),
    }
    want = {"dense": ref_count(dense), "moe": ref_count(moe)}
    for name, (cfg_kw, build) in ranks.items():
        model = build(TransformerConfig(**cfg_kw))
        whole = want["moe" if cfg_kw is moe else "dense"]
        local = sum(p.numel() for p in model.parameters())
        assert local < whole and comms.param_count(model) == whole, (name, local, whole)
    flat = TransformerLM(TransformerConfig(**dense), dtype=torch.float32, device="cpu")
    assert comms.param_count(flat) == comms.param_count(dict(flat.named_parameters())) == want["dense"]


# -- spans --------------------------------------------------------------------------
def _clock(start=0.0):
    t = [start]

    def advance(dt):
        t[0] += dt

    return (lambda: t[0]), advance


def test_span_nesting_and_orphans(tmp_path):
    clock, advance = _clock(100.0)
    rec = spans.SpanRecorder(tmp_path / "trace_t.jsonl", proc="t", clock=clock,
                             epoch_clock=lambda: 1e9)
    root = rec.begin("request", trace="r1", rid=1)
    advance(0.25)
    child = rec.begin("prefill", trace="r1", parent=root.sid)
    advance(0.5)
    rec.end(child)
    advance(0.25)
    rec.end(root)
    rec.record_span("decode", 1.0, 2.0, trace="r7", parent="dead-proc/999:0")
    rec.close()
    meta, records = ref_spans.load_trace_file(rec.path)  # the reference's reader
    assert meta["proc"] == "t" and meta["pid"] == rec.pid
    assert [s["name"] for s in records] == ["prefill", "request", "decode"]
    by_sid, children, orphans = ref_spans.span_tree(records)
    assert [c["name"] for c in children[root.sid]] == ["prefill"]
    assert by_sid[child.sid]["t1"] - by_sid[child.sid]["t0"] == 0.5
    assert by_sid[root.sid]["labels"] == {"rid": 1}
    assert [o["parent"] for o in orphans] == ["dead-proc/999:0"]
    assert spans.span_tree(records) == ref_spans.span_tree(records)


def test_flight_ring_dump_all_and_dropped_writes(tmp_path):
    reg = registry.MetricsRegistry()
    rec = spans.SpanRecorder(tmp_path / "trace_t.jsonl", proc="t", ring=4, clock=lambda: 0.0,
                             epoch_clock=lambda: 0.0, flight_dir=tmp_path / "flight",
                             registry=reg)
    for i in range(10):
        rec.record_span(f"s{i}", float(i), float(i) + 0.5, trace="r0")
    out = rec.dump_flight("unit test")
    assert out is not None and "unit-test" in out.name
    payload = json.loads(out.read_text())
    assert payload["spans_total"] == 10
    assert [r["name"] for r in payload["ring"]] == ["s6", "s7", "s8", "s9"]
    assert spans.dump_all("again") == [tmp_path / "flight" / f"flight-t-{rec.pid}-again.json"]
    rec._f.close()
    rec.record_span("decode", 0.0, 1.0)  # a dead file: counted, never raised
    assert rec.dropped_total == 1 and reg.snapshot()["span_dropped_total"] == 1.0
    assert reg.snapshot()["span_recorded_total"] == 11.0 and reg.snapshot()["flight_dump_total"] == 2.0
    rec.close()
    assert spans.dump_all("closed") == []


def test_torn_line_and_clock_offset(tmp_path):
    rec = spans.SpanRecorder(tmp_path / "trace_t.jsonl", proc="t", clock=lambda: 400.0,
                             epoch_clock=lambda: 1000.0)
    rec.record_span("queue", 1.0, 2.0, trace="r0")
    rec.close()
    with rec.path.open("a") as f:
        f.write('{"kind": "span", "name": "pref')
    assert rec.mono_offset == 600.0
    for load in (spans.load_trace_file, ref_spans.load_trace_file):
        meta, records = load(rec.path)
        assert meta["mono_offset"] == 600.0 and meta["ts"] == 1000.0
        assert [r["name"] for r in records] == ["queue"]


def test_port_traces_merge_with_trace_report(tmp_path):
    """Two port recorders whose monotonic clocks differ by hours merge onto
    one wall-clock timeline in the reference's tool, and its Perfetto
    export holds their spans."""
    wall = 1.75e9
    a = spans.SpanRecorder(tmp_path / "trace_a.jsonl", proc="a", clock=lambda: 10.0,
                           epoch_clock=lambda: wall)
    b = spans.SpanRecorder(tmp_path / "trace_b.jsonl", proc="b", clock=lambda: 9010.0,
                           epoch_clock=lambda: wall)
    root = a.record_span("request", 10.0, 10.5, trace="r0")
    a.record_span("queue", 10.0, 10.1, trace="r0", parent=root.sid)
    a.record_span("prefill", 10.1, 10.2, trace="r0", parent=root.sid)
    a.record_span("decode", 10.2, 10.5, trace="r0", parent=root.sid)
    b.record_span("compute", 9010.5, 9010.6, trace="step:0")
    a.close()
    b.close()
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_report.py"), str(tmp_path),
                          "--out", str(tmp_path / "t.json")], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    events = json.loads((tmp_path / "t.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {e.get("name") for e in events}
    assert {"request", "queue", "prefill", "decode", "compute"} <= names
    x = {e["name"]: e for e in events if e.get("ph") == "X"}
    assert x["compute"]["ts"] == pytest.approx(x["request"]["ts"] + 0.5e6, abs=1.0)
    assert "orphan" in out.stdout.lower()


# -- annotations, memory, timing, profiler, NaN mode ---------------------------------
def test_annotate_is_metadata_and_switchable(tmp_path):
    @trace.annotate_fn("unit/fn")
    def fn(x):
        return x * 2

    prof = profiling.Profiler(tmp_path)
    with prof:
        with trace.annotate("unit/range"):
            y = fn(torch.ones(3))
    names = {e["name"] for e in json.loads(prof.traces[0].read_text())["traceEvents"]}
    assert {"unit/range", "unit/fn"} <= names
    assert trace.set_enabled(False) is True
    try:
        with trace.annotate("unit/off"):
            z = fn(torch.ones(3))
        assert not trace.enabled()
    finally:
        trace.set_enabled(True)
    assert torch.equal(y, z)
    with pytest.raises(NotImplementedError, match="no PyTorch counterpart"):
        prof.start_server()


def test_memory_is_none_on_the_cpu():
    assert memory.device_memory_stats("cpu") is None
    assert memory.hbm_usage() is None and memory.hbm_usage(["cpu"]) is None


def test_step_timer_matches_the_reference_summary():
    durations = [0.12, 0.1, 0.11, 0.5, 0.1, 0.13, 0.09]
    mine, ref = profiling.StepTimer(), ref_profiling.StepTimer()
    mine.durations_s = list(durations)
    ref.durations_s = list(durations)
    got, want = mine.summary(items_per_step=64), ref.summary(items_per_step=64)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "items_per_s_per_device"} == \
        {k: v for k, v in want.items() if k != "items_per_s_per_device"}
    assert got["items_per_s_per_device"] == got["items_per_s"]  # one process, no group
    timer = profiling.StepTimer(sync_every=2)
    for i in range(5):
        timer.tick(torch.tensor(float(i)))
    assert timer.summary()["steps_timed"] == 4.0  # the first tick opens the window
    assert profiling.measure_collective_latency()["axis_size"] == 1.0


def test_nan_debug_mode_names_the_first_module():
    model = TransformerLM(TransformerConfig.tiny(), dtype=torch.float32, device="cpu").init_weights(0)
    with torch.no_grad():
        model.layers[1].mlp.up_proj.weight[0, 0] = float("nan")
    tokens = torch.arange(8)[None]
    model(tokens)  # poisoned, and nothing raises without the mode
    profiling.nan_debug_mode(True, model)
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match=r"module 'layers\.1\.mlp\.up_proj'"):
            model(tokens)
    finally:
        profiling.nan_debug_mode(False, model)
    assert not torch.is_anomaly_enabled()
    model(tokens)  # the hooks are gone
