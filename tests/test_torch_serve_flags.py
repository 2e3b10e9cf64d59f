"""``serve_lm``'s resilience flags on the CPU: ``--tenants`` parsed as the
reference parses it, ``--chaos`` through one engine and a disaggregated
pair (recovered, books balanced, every stream equal to offline greedy),
``--disagg`` beside ``--prefix_cache`` and ``--warmup``.
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
