"""ZeRO-1 in the port against ``deeplearning_mpi_tpu``'s placement and the
port's data-parallel step.

- The placement: for every optimizer leaf of the 110M config (shapes only)
  and of ``TP_SHAPE``, the port's ``zero1_dim`` (on the port's ``[out,
  in]`` layout) is the reference's ``zero1_spec`` at dp 2, 4 and 8, alone
  and beside tp 2 (``gate_proj``'s moments ``P("data", "model")``); and
  ``plan_buckets`` is the reference's plan on the same tree.
- ONE spawn of 4 gloo ranks (``tests/torch_tp_ranks.py``), ``dp 4`` with
  clip (half the first step's gradient norm, so it engages and so a
  gradient scaled wrong shows through it) and EMA 0.9, 3 Adam steps:
  ``--zero`` bitwise equal to the data-parallel step (losses, parameters,
  the gathered moments, the EMA) in float32 and float64; the overlapped
  schedule within 1e-7 relative of it in float64 (with and without
  ``grad_accum`` 2) and, in float32, within ``split_batch_rule`` of one
  process (2x the worst of ``dp 4`` in the same spawn); each wrong copy
  (the clip on the local shard's norm, the mean divided by dp twice, a
  bucket launched before the last ``grad_accum`` chunk) over that 1e-7;
  each rank's moments the reference's shard; the logged fallback of
  every case the overlapped schedule refuses; and ``--zero`` on the CNN
  trainer bitwise its data-parallel step.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from deeplearning_mpi_tpu.models import TransformerConfig as JaxConfig
from deeplearning_mpi_tpu.parallel.tensor_parallel import param_spec as ref_param_spec
from deeplearning_mpi_tpu.parallel.zero import plan_buckets as ref_plan_buckets
from deeplearning_mpi_tpu.parallel.zero import zero1_spec as ref_zero1_spec
from deeplearning_mpi_tpu_torch.parallel import tensor_parallel as tpm
from deeplearning_mpi_tpu_torch.parallel import zero

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_moe_ranks as moe_ranks  # noqa: E402
import torch_tp_ranks as ranks  # noqa: E402
from test_torch_tp import CONFIGS, reference_leaves, spec_dim, to_reference_dim  # noqa: E402

# Tiny shapes: one intra-op thread is faster than many, and the suite's
# workers share the cores.
torch.set_num_threads(1)

#: relative error of the overlapped schedule against the data-parallel
#: step, float64.
F64_TOL = 1e-7
B, S = 8, 32


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("config", ["110m", "tp_shape"])
def test_zero_placement_equals_reference(config, dp, tp):
    """Every optimizer leaf (the moments mirror the parameters): the port's
    ZeRO-1 dim is the reference's ``zero1_spec`` over its TP spec."""
    for path, name, shape, leaf in reference_leaves(CONFIGS[config]):
        base = ref_param_spec(leaf, tp=tp, path=path)
        want = spec_dim(ref_zero1_spec(leaf, base, dp), "data")
        tp_dim = tpm.param_spec(name, shape, tp)
        got = to_reference_dim(name, shape, zero.param_zero_dim(name, shape, dp, tp_dim))
        assert got == want, (name, got, want)
        if config == "110m" and tp == 2 and "gate_proj" in name:
            assert tuple(ref_zero1_spec(leaf, base, dp)) == ("data", "model")
            assert zero.zero1_spec(tuple(leaf.shape), tuple(base), dp) == ("data", "model")


@pytest.mark.parametrize("bucket_bytes", [zero.BUCKET_BYTES, 1 << 16])
@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("config", ["110m", "tp_shape"])
def test_plan_buckets_equals_reference(config, dp, bucket_bytes):
    """The same leaves in the reference's order: the same buckets, the same
    replicated leaves, the shard dims through the transpose."""
    leaves = reference_leaves(CONFIGS[config])
    want = ref_plan_buckets([leaf for _, _, _, leaf in leaves], dp, bucket_bytes=bucket_bytes)
    got = zero.plan_buckets([(name, shape, 4) for _, name, shape, _ in leaves], dp,
                            bucket_bytes=bucket_bytes)
    assert got.buckets == want.buckets and got.replicated == want.replicated
    assert [to_reference_dim(name, shape, d) for (_, name, shape, _), d
            in zip(leaves, got.shard_dims)] == list(want.shard_dims)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """ONE spawn of 4 gloo ranks of ``torch_tp_ranks.worker_zero``; beside
    it one process's float32 run on the global batches, and the fallback
    logged at dp 1."""
    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.train import (
        Trainer,
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    out = tmp_path_factory.mktemp("zero_ranks")
    model = TransformerLM(ranks.lm_config(ranks.ZERO_CFG), dtype=torch.float32,
                          device="cpu").init_weights(0)
    ds = SyntheticTokens(3 * B, S, seed=2)
    batches = [torch.stack([torch.from_numpy(ds[i * B + j]["tokens"]) for j in range(B)])
               for i in range(3)]
    inputs = {"zero_params": model.state_dict(), "zero_batches": batches}
    probe = ranks.lm_model(ranks.ZERO_CFG, inputs["zero_params"], torch.float64)
    _, metrics = make_train_step("lm", guard_metrics=True)(
        create_train_state(probe, build_optimizer("adam", 1e-3)), {"tokens": batches[0]})
    inputs["clip"] = 0.5 * float(metrics["grad_norm"])
    torch.save(inputs, out / "inputs.pt")
    lines = []
    Trainer(create_train_state(probe, build_optimizer("adam", 1e-3)), "lm", zero_overlap=True,
            log=lines.append)
    return {"ranks": ranks.spawn(out, ranks.worker_zero), "dp1": lines,
            "one": ranks.zero_run(inputs, None, clip=inputs["clip"])}


RUN_KEYS = ("params", "mu", "nu", "ema")


def run_errors(got: dict, want: dict) -> list:
    """Relative errors of a run's losses and whole trees, worst first."""
    errs = [(abs(a - b) / abs(b), "loss", i)
            for i, (a, b) in enumerate(zip(got["losses"], want["losses"]))]
    errs += [(e, key, n) for key in RUN_KEYS for n, e in ranks.tree_errors(got[key], want[key])]
    return sorted(errs, reverse=True)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_zero_is_bitwise_the_data_parallel_step(spawned, dtype):
    """``--zero`` over 3 steps with clip and EMA: the losses, parameters,
    gathered moments and EMA equal the data-parallel step's bit for bit."""
    for res in spawned["ranks"]:
        got, want = res[f"zero_{dtype}"], res[f"dp_{dtype}"]
        assert got["losses"] == want["losses"]
        for key in RUN_KEYS:
            assert all(torch.equal(got[key][n], t) for n, t in want[key].items()), key


def test_zero_is_bitwise_the_data_parallel_step_on_the_cnn(spawned):
    """``--zero`` on the classification trainer (a ResNet-18 at 8 filters,
    BatchNorm over the data group, SGD with momentum and weight decay), 2
    steps: parameters, statistics and the gathered momentum bitwise those
    of the data-parallel step, with some leaves sharded."""
    for res in spawned["ranks"]:
        got, want = res["cnn_zero"], res["cnn_dp"]
        assert got["sharded"] > 0
        for key in ("params", "batch_stats", "trace"):
            assert all(torch.equal(got[key][n], t) for n, t in want[key].items()), key


@pytest.mark.parametrize("case", ["f64", "accum"])
def test_zero_overlap_matches_data_parallel_f64(spawned, case):
    """The bucketed schedule in float64 within 1e-7 relative of the
    data-parallel step (with ``grad_accum`` 2 too); the ranks' parameters
    bitwise equal."""
    results = spawned["ranks"]
    for res in results:
        worst = run_errors(res[f"overlap_{case}"], res[f"dp_{case}"])
        assert worst[0][0] <= F64_TOL, worst[:5]
    for res in results[1:]:
        assert all(torch.equal(res[f"overlap_{case}"]["params"][n], t)
                   for n, t in results[0][f"overlap_{case}"]["params"].items())


def test_zero_overlap_f32_within_split_batch_rule(spawned):
    """The bucketed schedule in float32 against one process on the global
    batches: each parameter and moment within 2x the worst error of its
    class in ``dp 4`` (``torch_moe_ranks.split_batch_rule``), the losses
    within 1e-6 relative."""
    results = [res["overlap_f32"] for res in spawned["ranks"]]
    over, bars = moe_ranks.split_batch_rule(results, [res["dp_f32"] for res in spawned["ranks"]],
                                            spawned["one"], keys=("params", "mu", "nu"))
    assert not over, (bars, over[:10])
    for got in results:
        np.testing.assert_allclose(got["losses"], spawned["one"]["losses"], rtol=1e-6)


@pytest.mark.parametrize("kind", ranks.WRONG_ZERO)
def test_zero_overlap_bar_rejects_wrong_copy(spawned, kind):
    """Each wrong copy of the schedule's pieces leaves the data-parallel
    step by more than 1e-7."""
    want = "dp_accum" if kind == "early_bucket" else "dp_f64"
    for res in spawned["ranks"]:
        assert run_errors(res[kind], res[want])[0][0] > F64_TOL


def test_zero_moments_are_the_reference_shard(spawned):
    """Each rank's moment of each leaf holds the numel of the reference's
    ZeRO-1 placement at dp 4, a quarter for the sharded leaves."""
    expect = {}
    for path, name, _, leaf in reference_leaves(JaxConfig(**ranks.ZERO_CFG)):
        spec = ref_zero1_spec(leaf, ref_param_spec(leaf, tp=1, path=path), 4)
        expect[name] = leaf.size // (4 if "data" in spec else 1)
    for res in spawned["ranks"]:
        assert res["zero_f32"]["local_numel"] == expect
        assert res["dp_f32"]["local_numel"] == {
            name: leaf.size for _, name, _, leaf in reference_leaves(JaxConfig(**ranks.ZERO_CFG))}
    print("moment bytes a rank:", spawned["ranks"][0]["zero_f32"]["local_bytes"], "with --zero,",
          spawned["ranks"][0]["dp_f32"]["local_bytes"], "without")


@pytest.mark.parametrize("case,reason", [
    ("dp1", "no data parallelism"), ("tp", "non-data mesh axes in use (['model'])"),
    ("aux_weight", "aux_weight"), ("loss_chunk", "loss_chunk"), ("batch_stats", "batch_stats"),
    ("not_mirrored", "does not mirror"),
])
def test_overlap_fallback_logs_its_reason(spawned, case, reason):
    """Each case the reference's ``_check_supported`` refuses: the trainer
    falls back to ``--zero`` and logs why."""
    lines = spawned["dp1"] if case == "dp1" else spawned["ranks"][0]["fallbacks"][case]
    assert any("falling back" in line and reason in line for line in lines), lines
