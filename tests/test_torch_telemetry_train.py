"""The port's trainer telemetry and the telemetry flags against the reference.

- The trainer: the tiny LM from one init (``models/convert.py``) runs one
  epoch of 4 steps and its eval in the reference ``Trainer`` (one CPU
  device) and in the port's, each with an ``InMemorySink``: the same
  sequence of record kinds and the same keys in each record, per-step
  losses within 1e-5 (relative), ``flops_per_step`` and
  ``comm_bytes_per_step`` equal; with a span recorder the same keys again
  and the port's phases summing to ``duration_s``.
- The flags: ``train_lm --metrics_dir --log_dir --profile_dir
  --metrics_every 2`` on the CPU writes ``metrics.jsonl`` (rendered by
  ``tools/metrics_report.py`` with its required rows), the run log and a
  sidecar holding the same records, and a profiler trace; ``--debug_nans``
  raises at the first module a poisoned input reaches and names it; the
  four flags are out of ``UNPORTED_FLAGS``.
- ``comm_bytes_per_step`` of ``train_lm --dp 2 --sp 2 --attention ring``
  over 4 gloo ranks equals the reference CLI's on the same flags.
"""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.models import TransformerLM as JaxLM
from deeplearning_mpi_tpu.runtime.mesh import MeshSpec, create_mesh
from deeplearning_mpi_tpu.telemetry import InMemorySink as JaxSink
from deeplearning_mpi_tpu.telemetry import comms as ref_comms
from deeplearning_mpi_tpu.telemetry import flops as ref_flops
from deeplearning_mpi_tpu.train import Trainer as JaxTrainer
from deeplearning_mpi_tpu.train import create_train_state as jax_create_state
from deeplearning_mpi_tpu.train.trainer import build_optimizer as jax_optimizer
from deeplearning_mpi_tpu_torch.data import SyntheticTokens
from deeplearning_mpi_tpu_torch.models.convert import lm_params_from_jax
from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deeplearning_mpi_tpu_torch.telemetry import InMemorySink, SpanRecorder, comms, flops
from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state
from deeplearning_mpi_tpu_torch.utils import config
from deeplearning_mpi_tpu_torch.utils.profiling import nan_debug_mode

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS = 8, 16, 4
TINY = ["--num_layers", "2", "--num_heads", "2", "--head_dim", "8", "--d_model", "16",
        "--d_ff", "32"]


class _Loader:
    """Fixed numpy batches, as jax or torch arrays."""

    def __init__(self, batches, to):
        self.batches, self.to = batches, to

    def epoch(self, epoch):
        for tokens in self.batches:
            yield {"tokens": self.to(tokens)}


def _records(sink):
    return [{k: v for k, v in r.items() if k != "ts"} for r in sink.records]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """One epoch (4 steps, then its eval) in each trainer, untraced and traced."""
    ds = SyntheticTokens(STEPS * B + B, S, seed=3)
    rows = np.stack([ds[i]["tokens"] for i in range(len(ds))])
    train = [rows[i * B:(i + 1) * B] for i in range(STEPS)]
    evalb = [rows[STEPS * B:]]
    jc = JaxConfig.tiny()
    jm = JaxLM(config=jc, dtype=jnp.float32)
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    tc = TransformerConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(TransformerConfig)})
    out = {}
    for traced in (False, True):
        jstate = jax_create_state(jm, jax.random.key(0), jnp.zeros((1, S), jnp.int32),
                                  jax_optimizer("adam", 1e-3, clip_norm=1.0))
        model = TransformerLM(tc, dtype=torch.float32, device="cpu")
        model.load_state_dict(lm_params_from_jax(jax.device_get(jstate.params)))
        tstate = create_train_state(model, build_optimizer("adam", 1e-3, clip_norm=1.0))
        tdir = tmp_path_factory.mktemp("spans")
        jax_tracer = port_tracer = None
        if traced:
            from deeplearning_mpi_tpu.telemetry.spans import SpanRecorder as JaxRecorder

            jax_tracer = JaxRecorder(tdir / "trace_ref.jsonl", proc="ref")
            port_tracer = SpanRecorder(tdir / "trace_port.jsonl", proc="port")
        kw = dict(flops_per_step=ref_flops.transformer_train_flops(jc, B, S),
                  issued_flops_per_step=ref_flops.transformer_issued_flops(jc, B, S, remat="full"),
                  comm_bytes_per_step=ref_comms.dp_grad_allreduce_bytes(
                      ref_comms.param_count(jstate.params), 4))
        jsink, tsink = JaxSink(), InMemorySink()
        jt = JaxTrainer(jstate, "lm", mesh, tracer=jax_tracer, **kw)
        jt.metrics.add_sink(jsink)
        jt.fit(_Loader(train, jnp.asarray), 1, eval_loader=_Loader(evalb, jnp.asarray))
        port_kw = dict(flops_per_step=flops.transformer_train_flops(tc, B, S),
                       issued_flops_per_step=flops.transformer_issued_flops(tc, B, S, remat="full"),
                       comm_bytes_per_step=comms.dp_grad_allreduce_bytes(
                           comms.param_count(model), 4))
        tt = Trainer(tstate, "lm", log=lambda msg: None, tracer=port_tracer, **port_kw)
        tt.metrics.add_sink(tsink)
        tt.fit(_Loader(train, torch.from_numpy), 1, eval_loader=_Loader(evalb, torch.from_numpy))
        for tracer in (jax_tracer, port_tracer):
            if tracer is not None:
                tracer.close()
        out[traced] = {"ref": _records(jsink), "port": _records(tsink), "ref_kw": kw,
                       "port_kw": port_kw, "port_tracer": port_tracer}
    return out


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_trainer_records_match_the_reference(trainer_runs, traced):
    run = trainer_runs[traced]
    ref, port = run["ref"], run["port"]
    assert [r["kind"] for r in port] == [r["kind"] for r in ref] == ["step"] * STEPS + ["epoch"]
    for i, (a, b) in enumerate(zip(port, ref)):
        assert set(a) == set(b), (i, sorted(set(a) ^ set(b)))
    for a, b in zip(port[:STEPS], ref[:STEPS]):
        assert a["step"] == b["step"] and a["epoch"] == b["epoch"] == 0
        assert math.isclose(a["loss"], b["loss"], rel_tol=1e-5), (a["loss"], b["loss"])
        assert a["comm_bytes"] == b["comm_bytes"]
    assert run["port_kw"] == run["ref_kw"]
    for key in ("comm_bytes_per_step", "epoch", "eval_loss"):
        assert math.isclose(port[-1][key], ref[-1][key], rel_tol=1e-5), key
    assert port[-1]["mfu_issued"] > port[-1]["mfu"] > 0


def test_traced_phases_tile_the_epoch(trainer_runs):
    epoch = trainer_runs[True]["port"][-1]
    phases = {k: v for k, v in epoch.items() if k.startswith("phase_")}
    assert set(phases) == {f"phase_{p}_s" for p in ("data_wait", "h2d", "compute",
                                                    "collective_tail", "other")}
    assert math.isclose(sum(phases.values()), epoch["duration_s"], rel_tol=1e-12)
    gaps = {k: v for k, v in epoch.items() if k.startswith("mfu_gap_")}
    assert math.isclose(sum(gaps.values()), epoch["mfu_gap"], rel_tol=1e-9, abs_tol=1e-15)
    from deeplearning_mpi_tpu.telemetry.spans import load_trace_file

    _, records = load_trace_file(trainer_runs[True]["port_tracer"].path)
    names = [r["name"] for r in records if r["kind"] == "span"]
    assert names == ["data_wait", "h2d", "compute", "collective_tail"] * STEPS


def test_train_lm_telemetry_flags(tmp_path, capsys):
    from deeplearning_mpi_tpu_torch.cli import train_lm

    dirs = {k: tmp_path / k for k in ("metrics", "log", "profile")}
    rc = train_lm.main(["--device", "cpu", "--attention", "flash", *TINY, "--seq_len", "32",
                        "--batch_size", "4", "--train_sequences", "40", "--num_epochs", "2",
                        "--metrics_dir", str(dirs["metrics"]), "--log_dir", str(dirs["log"]),
                        "--profile_dir", str(dirs["profile"]), "--metrics_every", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "Epoch 1: loss" in out
    metrics = dirs["metrics"] / "metrics.jsonl"
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    kinds = [r["kind"] for r in records]
    # 9 steps an epoch, every 2nd recorded (global steps 0, 2, ..., 16).
    assert [r["step"] for r in records if r["kind"] == "step"] == list(range(0, 18, 2))
    assert kinds[-3:] == ["epoch", "final_eval", "run_summary"] and kinds.count("epoch") == 2
    logs = sorted(dirs["log"].iterdir())
    assert [p.suffix for p in logs] == [".log", ".jsonl"]
    assert [json.loads(line) for line in logs[1].read_text().splitlines()] == records
    text = logs[0].read_text()
    assert "system: " in text and "hyperparameters: " in text and "] Epoch 1: loss" in text
    trace = json.loads(next(dirs["profile"].iterdir()).read_text())
    assert sum(e.get("name") == "trainer/train_step" for e in trace["traceEvents"]) == 3
    report = subprocess.run([sys.executable, str(ROOT / "tools" / "metrics_report.py"),
                             str(metrics)], capture_output=True, text=True, timeout=60)
    assert report.returncode == 0, report.stderr
    for row in ("steps recorded", "loss first", "epochs recorded", "step latency p50 (ms)",
                "MFU (mean)", "MFU issued (mean)", "collective bytes/step/device",
                "Last eval (final_eval)"):
        assert row in report.stdout, (row, report.stdout)


def test_unported_flags_are_ported():
    assert not {"profile_dir", "metrics_dir", "log_dir", "debug_nans"} & set(config.UNPORTED_FLAGS)
    from deeplearning_mpi_tpu_torch.cli import train_lm, train_resnet

    for parser in (train_lm.build_parser(), train_resnet.build_parser()):
        args = parser.parse_args(["--metrics_dir", "m", "--log_dir", "l", "--profile_dir", "p",
                                  "--debug_nans", "--metrics_every", "3"])
        config.reject_unported(args)  # no refusal
        assert args.metrics_every == 3 and args.debug_nans


def test_debug_nans_names_the_first_module():
    """``train_resnet --arch vit_tiny --debug_nans``: a NaN in the input
    image raises at the first module it reaches, by name."""
    from deeplearning_mpi_tpu_torch.cli import train_resnet

    run = train_resnet.build(["--device", "cpu", "--arch", "vit_tiny", "--synthetic",
                              "--num_epochs", "1", "--batch_size", "4", "--train_samples", "8",
                              "--debug_nans", "--optimizer", "adam"])
    model = run.trainer.state.model
    try:
        assert torch.is_anomaly_enabled()
        batch = next(iter(run.train_loader.epoch(0)))
        order = []
        hooks = [m.register_forward_hook(lambda m, i, o, n=n: order.append(n))
                 for n, m in model.named_modules() if not list(m.children())]
        with torch.no_grad():
            model(batch["image"])
        for h in hooks:
            h.remove()
        batch["image"] = batch["image"].clone()
        batch["image"][0, 0, 0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match=f"module '{order[0]}'"):
            run.trainer.train_step(run.trainer.state, batch)
    finally:
        nan_debug_mode(False, model)
    assert not torch.is_anomaly_enabled()


def test_comm_bytes_of_a_ring_run_match_the_reference_cli(tmp_path, monkeypatch):
    """4 gloo ranks of the port's CLI against the reference CLI on the same
    flags, stopped where it hands its count to ``build_observability``
    (on 4 of the test session's 8 virtual devices)."""
    flags = ["--dp", "2", "--sp", "2", "--attention", "ring", "--num_layers", "2",
             "--num_heads", "4", "--head_dim", "8", "--d_model", "32", "--d_ff", "64",
             "--seq_len", "32", "--batch_size", "4", "--train_sequences", "5",
             "--num_epochs", "1", "--dtype", "bfloat16"]
    metrics = tmp_path / "metrics"
    port = subprocess.run(
        [sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.train_lm", "--device", "cpu",
         "--nproc", "4", *flags, "--metrics_dir", str(metrics)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert port.returncode == 0, port.stderr[-3000:]
    epoch = next(json.loads(line) for line in (metrics / "metrics.jsonl").read_text().splitlines()
                 if json.loads(line)["kind"] == "epoch")

    from deeplearning_mpi_tpu.cli import train_lm as ref_cli
    from deeplearning_mpi_tpu.runtime import mesh as ref_mesh
    from deeplearning_mpi_tpu.utils import config as ref_config

    class Captured(Exception):
        pass

    seen = {}

    def capture(args, trainer, **kw):
        seen.update(kw)
        raise Captured

    make_mesh = ref_mesh.create_mesh
    monkeypatch.setattr(ref_mesh, "create_mesh",
                        lambda spec=None, devices=None: make_mesh(spec, devices=jax.devices()[:4]))
    monkeypatch.setattr(ref_config, "build_observability", capture)
    with pytest.raises(Captured):
        ref_cli.main(["--platform", "cpu", *flags, "--model_dir", str(tmp_path / "ref"),
                      "--log_dir", str(tmp_path / "ref_logs")])
    assert seen["comm_bytes_per_step"] > 0
    assert epoch["comm_bytes_per_step"] == seen["comm_bytes_per_step"]
    assert epoch["mfu"] > 0
