"""The port's ``dmt-lint``: run the static contract passes over the port.

    python -m deeplearning_mpi_tpu_torch.analysis.lint                  # the port + chip_smoke.py
    python -m deeplearning_mpi_tpu_torch.analysis.lint tests/fixtures/torch_lint --no-suppressions
    python -m deeplearning_mpi_tpu_torch.analysis.lint --list-rules     # the catalog
    python -m deeplearning_mpi_tpu_torch.analysis.lint --show-suppressed

Port of ``deeplearning_mpi_tpu/analysis/lint.py``. Exit code 0 iff no
unsuppressed findings. Suppressions need a one-line justification: an
inline ``# dmt-lint: disable=DMT003 — why`` on the flagged line, or a
``path:RULE: why`` entry in ``analysis/lint_suppressions.txt``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from deeplearning_mpi_tpu_torch.analysis.core import SUPPRESSIONS, load_suppressions, run_lint
from deeplearning_mpi_tpu_torch.analysis.passes import all_rules

#: The reference's rule each port rule stands for, where the idiom changed.
#: DMT001 and DMT002 are JAX idioms (donation, trace-time constants): on
#: PyTorch the rules check their CUDA-graph counterparts.
NOT_APPLICABLE = {
    "DMT001": "n/a as donation-safety: PyTorch donates no buffer; checks a CUDA graph's "
              "static output read after the next replay instead",
    "DMT002": "n/a as retrace-hazard: PyTorch traces nothing; checks host state frozen into "
              "a captured CUDA graph instead",
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="dmt-lint (port)", description=__doc__.split("\n")[0])
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/dirs to lint (default: the port and chip_smoke.py)")
    parser.add_argument("--rules", default=None, help="comma-separated rule ids (default all)")
    parser.add_argument("--suppressions", type=Path, default=SUPPRESSIONS,
                        help="suppression/baseline file")
    parser.add_argument("--no-suppressions", action="store_true",
                        help="ignore the suppression file AND inline disables (fixture mode)")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="print suppressed findings too")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.name:<22} {r.contract}")
            if r.id in NOT_APPLICABLE:
                print(f"        {'':<22} {NOT_APPLICABLE[r.id]}")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",")}
        rules = [r for r in rules if r.id in wanted]
        if not rules:
            parser.error(f"no rule matches {args.rules!r}")

    suppressions = {} if args.no_suppressions else load_suppressions(args.suppressions)
    findings = run_lint(args.paths or None, rules=rules, suppressions=suppressions)
    if args.no_suppressions:
        for f in findings:
            f.suppressed = False
    failures = [f for f in findings if not f.suppressed]
    for f in findings if args.show_suppressed else failures:
        print(f.render())
    n_sup = sum(1 for f in findings if f.suppressed)
    print(f"dmt-lint: {len(failures)} finding(s), {n_sup} suppressed, {len(rules)} rule(s)",
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
