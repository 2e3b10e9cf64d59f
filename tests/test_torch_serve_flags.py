"""``serve_lm``'s resilience flags on the CPU: ``--tenants`` parsed as the
reference parses it, ``--chaos`` through one engine and a disaggregated
pair (recovered, books balanced, every stream equal to offline greedy),
``--disagg`` beside ``--prefix_cache`` and ``--warmup``; the custom-width
draft (``--draft_d_model`` / ``--draft_d_ff`` / ``--draft_heads`` /
``--draft_head_dim`` / ``--draft_seed``: a seeded random init of those
widths, the reference's ``draft_config`` shape, streams equal to offline
greedy); the reference flags that are n/a on PyTorch refused by name with
exit 2.
"""

from __future__ import annotations

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning_mpi_tpu.cli.serve_lm import _parse_tenants as ref_parse_tenants
from deeplearning_mpi_tpu_torch.cli import serve_lm

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--num_layers", "2", "--num_heads", "2", "--head_dim", "8",
        "--d_model", "16", "--d_ff", "32", "--num_requests", "8"]

NAME = st.text("abcdefgh_", min_size=1, max_size=6)
ENTRY = st.one_of(
    st.tuples(NAME, st.integers(0, 10_000), st.one_of(st.none(), st.floats(-2, 2))).map(
        lambda t: f"{t[0]}={t[1]}" + ("" if t[2] is None else f":{t[2]}")),
    st.sampled_from(["bad", "x=", "x=1:y", "=3", "a=b", "p=1:2:3"]),
)


@settings(max_examples=200, deadline=None)
@given(st.lists(ENTRY, max_size=4).map(",".join))
def test_tenants_parse_as_the_reference(spec):
    def parse(fn):
        try:
            return fn(spec)
        except SystemExit as refusal:
            return ("refused", str(refusal.code))

    assert parse(serve_lm._parse_tenants) == parse(ref_parse_tenants)


@pytest.mark.parametrize("flags,expect", [
    (["--chaos", "serve_crash@step:3,serve_crash@step:9"],
     ["chaos: 2 fault(s) injected, 2 recovered, 0 rolled back", "serving: recovered"]),
    (["--disagg", "--chaos", "handoff_stall@step:4,serve_crash@step:6",
      "--tenants", "prod=4096:1,batch=1024:0"],
     ["chaos: 2 fault(s) injected, 2 recovered, 0 rolled back", "1 stalled step(s)"]),
    (["--disagg", "--prefix_cache", "--warmup"], ["prefill->decode handoffs", "warmup: "]),
], ids=["serve_crash", "disagg_chaos", "disagg_prefix_warmup"])
def test_serve_lm_resilience_flags(flags, expect, capsys):
    assert serve_lm.main(["--selftest", *TINY, *flags]) == 0
    out = capsys.readouterr()
    text = out.out + out.err
    assert "selftest OK: 8 requests bit-identical to offline greedy" in text
    for line in expect:
        assert line in text, line


def test_chaos_falls_back_to_the_environment(monkeypatch, capsys):
    monkeypatch.setenv("DMT_CHAOS", "handoff_stall@step:2")
    assert serve_lm.main(["--selftest", *TINY]) == 1  # one engine has no handoff
    assert "handoff_stall" in capsys.readouterr().err
    assert serve_lm.main(["--selftest", *TINY, "--disagg"]) == 0
    assert "chaos: 1 fault(s) injected, 1 recovered" in capsys.readouterr().err


DRAFT = ["--vocab_size", "16", "--num_heads", "4", "--head_dim", "16", "--d_model", "64",
         "--d_ff", "128", "--spec_k", "2", "--draft_layers", "1", "--draft_d_model", "32",
         "--draft_d_ff", "64", "--draft_heads", "2", "--draft_head_dim", "16"]


def test_custom_width_draft(capsys):
    """A random-init draft of the flags' widths from ``--draft_seed``, the
    reference's ``draft_config`` shape; every stream equal to offline greedy
    (``--selftest``), proposed = accepted + rolled back. Vocab 16: a random
    draft at vocab 256 matches no token, and the selftest's "speculative
    path inert" gate (the reference's) would fail on it."""
    from deeplearning_mpi_tpu.models.transformer import TransformerConfig as RefConfig
    from deeplearning_mpi_tpu.models.transformer import draft_config as ref_draft_config

    args = serve_lm.build_parser().parse_args(["--selftest", *TINY, *DRAFT, "--draft_seed", "3"])
    args.spec_k = 2
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=16, num_layers=2, num_heads=4, head_dim=16, d_model=64,
                            d_ff=128)
    target = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(0)
    draft = serve_lm.build_draft(args, target)
    want = ref_draft_config(RefConfig(vocab_size=16, num_layers=2, num_heads=4, head_dim=16,
                                      d_model=64, d_ff=128), 1, d_model=32, d_ff=64,
                            num_heads=2, head_dim=16)
    assert {k: getattr(draft.config, k) for k in ("vocab_size", "num_layers", "num_heads",
                                                  "head_dim", "d_model", "d_ff")} == {
        k: getattr(want, k) for k in ("vocab_size", "num_layers", "num_heads", "head_dim",
                                      "d_model", "d_ff")}
    again = serve_lm.build_draft(args, target)
    assert all(torch.equal(a, b) for a, b in zip(draft.parameters(), again.parameters()))
    args.draft_seed = 4
    other = serve_lm.build_draft(args, target)
    assert not torch.equal(next(draft.parameters()), next(other.parameters()))
    assert serve_lm.main(["--selftest", *TINY, *DRAFT, "--draft_seed", "3"]) == 0
    err = capsys.readouterr().err
    assert "selftest OK" in err and "selftest speculative:" in err


@pytest.mark.parametrize("cli,flag", [
    ("train_lm", "--platform"), ("train_resnet", "--platform"), ("train_unet", "--platform"),
    ("generate", "--platform"), ("serve_lm", "--platform"), ("hello_world", "--platform"),
    ("import_torch", "--platform"), ("generate", "--n_virtual_devices"),
    ("serve_lm", "--use_kernel"),
])
def test_not_applicable_flags_refused_by_name(cli, flag, capsys):
    import importlib

    mod = importlib.import_module(f"deeplearning_mpi_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit) as exit_:
        mod.build_parser().parse_args([flag, "x"] if flag != "--use_kernel" else [flag])
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not applicable to the PyTorch port" in err and "unrecognized" not in err


def test_tp_help_and_docstring_say_what_tp_does(capsys):
    """``--tp`` shards each fleet replica (the help and the module
    docstring say so, and no longer "refused above 1"); a degree the port's
    rule cannot split (heads it does not divide) is refused before any
    replica spawns, naming the heads."""
    with pytest.raises(SystemExit):
        serve_lm.build_parser().parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "tensor-parallel degree per replica" in text and "refused above 1" not in text
    assert "cuda:((r * tp + j) mod device_count)" in text
    doc = " ".join(serve_lm.__doc__.split())
    assert "``--tp T`` shards each replica" in doc and "item 8.6" not in doc
    # H * D = 48 splits 3 ways, the 2 heads do not: the port splits whole heads.
    assert serve_lm.main(["--selftest", "--device", "cpu", "--num_heads", "2", "--head_dim",
                          "24", "--d_model", "64", "--d_ff", "96", "--replicas", "2",
                          "--tp", "3"]) == 1
    assert "must divide num_heads" in capsys.readouterr().err
