"""dmt-lint pass framework for the port: findings, suppressions, the walker.

Port of ``deeplearning_mpi_tpu/analysis/core.py``; what differs is the tree
it gates and where its suppressions live.

A *rule* is a named check over one parsed source file; it returns
:class:`Finding`s with a stable rule id (``DMT001``...) and an exact
``file:line``. The framework owns everything rules should not reimplement:

- **Walking** — :func:`default_roots` is the scanned tree (the port's
  package and ``chip_smoke.py``; *not* ``tests/`` — test code deliberately
  exercises anti-patterns, and the seeded fixture corpora under
  ``tests/fixtures/`` would otherwise fail the gate by design).
- **Suppression** — two mechanisms, both requiring a justification trail:
  an inline ``# dmt-lint: disable=DMT003`` comment suppresses findings on
  that line, and the suppression file (lines of ``path:RULE:
  justification``) suppresses a rule for a whole
  file (:data:`SUPPRESSIONS`, the port's own file). Suppressed findings are still produced (marked), so ``--strict``
  tooling and the tests can audit them; only unsuppressed findings fail
  the build. The suppression file doubles as the *baseline*: a standing
  contract exception lives there with a one-line why, never silently.
- **Markers** — fixtures and out-of-tree code can opt into rule scopes the
  repo configures by path: ``# dmt-lint: hot-loop`` on a ``def`` line
  marks that function as a device hot loop (DMT003), ``# dmt-lint:
  captured`` marks it as a function captured into a CUDA graph (DMT002),
  and a module-level ``# dmt-lint: scope=resilience`` makes the atomic-IO
  rule treat the file as IO-critical (DMT004) outside the
  ``resilience/serving/compiler`` directories.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Iterable, Sequence

__all__ = [
    "Finding",
    "Rule",
    "SUPPRESSIONS",
    "SourceFile",
    "default_roots",
    "iter_sources",
    "load_suppressions",
    "run_lint",
]

#: Repo root (three levels up from this file: analysis/ -> package -> repo).
REPO_ROOT = Path(__file__).resolve().parent.parent.parent
#: The port's suppression / baseline file.
SUPPRESSIONS = Path(__file__).resolve().parent / "lint_suppressions.txt"

_DISABLE_RE = re.compile(r"#\s*dmt-lint:\s*disable=([A-Z0-9,\s]+)")
_SCOPE_RE = re.compile(r"#\s*dmt-lint:\s*scope=(\w+)")
_HOT_RE = re.compile(r"#\s*dmt-lint:\s*hot-loop")
_CAPTURED_RE = re.compile(r"#\s*dmt-lint:\s*captured")


@dataclasses.dataclass
class Finding:
    """One rule violation at an exact source position."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    suppressed: bool = False
    justification: str | None = None

    def render(self) -> str:
        tag = "  [suppressed: %s]" % self.justification if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tag}"


class SourceFile:
    """A parsed module plus the per-line metadata rules share."""

    def __init__(self, path: Path, text: str, *, rel: str | None = None) -> None:
        self.path = path
        self.rel = rel or _relpath(path)
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        # Parent links let rules ask "what function/class am I inside?".
        self.parent: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node

    # -- marker queries -----------------------------------------------------
    def line_disables(self, line: int) -> set[str]:
        """Rule ids disabled by an inline comment on ``line`` (1-based)."""
        if not 1 <= line <= len(self.lines):
            return set()
        m = _DISABLE_RE.search(self.lines[line - 1])
        if not m:
            return set()
        return {r.strip() for r in m.group(1).split(",") if r.strip()}

    def declared_scope(self) -> str | None:
        """Module-level ``# dmt-lint: scope=<name>`` marker (first 10 lines)."""
        for raw in self.lines[:10]:
            m = _SCOPE_RE.search(raw)
            if m:
                return m.group(1)
        return None

    def is_marked_hot(self, func: ast.AST) -> bool:
        """True when the ``def`` line carries ``# dmt-lint: hot-loop``."""
        line = getattr(func, "lineno", 0)
        if not 1 <= line <= len(self.lines):
            return False
        return bool(_HOT_RE.search(self.lines[line - 1]))

    def is_marked_captured(self, func: ast.AST) -> bool:
        """True when the ``def`` line carries ``# dmt-lint: captured``."""
        line = getattr(func, "lineno", 0)
        if not 1 <= line <= len(self.lines):
            return False
        return bool(_CAPTURED_RE.search(self.lines[line - 1]))

    # -- scope helpers ------------------------------------------------------
    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parent.get(cur)
        return None

    def enclosing_class(self, node: ast.AST) -> ast.ClassDef | None:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parent.get(cur)
        return None

    def functions(self) -> Iterable[ast.FunctionDef | ast.AsyncFunctionDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


@dataclasses.dataclass
class Rule:
    """A registered static pass. ``check`` maps one source file to findings."""

    id: str
    name: str
    contract: str  # one line: the invariant / originating bug
    check: Callable[[SourceFile], list[Finding]]


def _relpath(path: Path) -> str:
    try:
        return path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


def default_roots() -> list[Path]:
    """The tree the port's lint gates: its package and ``chip_smoke.py``."""
    return [REPO_ROOT / "deeplearning_mpi_tpu_torch", REPO_ROOT / "chip_smoke.py"]


def iter_sources(roots: Sequence[Path]) -> Iterable[SourceFile]:
    seen: set[Path] = set()
    for root in roots:
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            f = f.resolve()
            if f in seen or not f.is_file():
                continue
            seen.add(f)
            try:
                text = f.read_text()
                yield SourceFile(f, text)
            except (SyntaxError, UnicodeDecodeError) as e:
                # A file the parser rejects is ruff/py_compile's finding,
                # not ours — report it as a framework-level finding so the
                # gate still fails loud instead of silently skipping.
                yield _unparseable(f, e)


class _Unparseable(SourceFile):
    def __init__(self, path: Path, err: Exception) -> None:  # no parse
        self.path = path
        self.rel = _relpath(path)
        self.text = ""
        self.lines = []
        self.tree = ast.Module(body=[], type_ignores=[])
        self.parent = {}
        self.error = err


def _unparseable(path: Path, err: Exception) -> SourceFile:
    return _Unparseable(path, err)


def load_suppressions(path: Path) -> dict[tuple[str, str], str]:
    """Parse a suppression/baseline file.

    Format, one entry per line (``#`` comments and blanks skipped)::

        <repo-relative-path>:<RULE_ID>: <one-line justification>

    A justification is mandatory — an entry without one is a parse error,
    because the file exists to *record why*, not to mute.
    """
    out: dict[tuple[str, str], str] = {}
    if not path.is_file():
        return out
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^(?P<path>[^:]+):(?P<rule>DMT\d+):\s*(?P<why>.+)$", line)
        if not m:
            raise ValueError(
                f"{path}:{lineno}: bad suppression entry (want "
                f"'path:RULEID: justification'): {line!r}"
            )
        out[(m.group("path"), m.group("rule"))] = m.group("why").strip()
    return out


def run_lint(
    roots: Sequence[Path] | None = None,
    *,
    rules: Sequence[Rule] | None = None,
    suppressions: dict[tuple[str, str], str] | None = None,
) -> list[Finding]:
    """Run every registered rule over ``roots``; returns all findings with
    suppression state resolved (inline markers and the suppression file)."""
    from deeplearning_mpi_tpu_torch.analysis.passes import all_rules

    rules = list(rules) if rules is not None else all_rules()
    if suppressions is None:
        suppressions = load_suppressions(SUPPRESSIONS)
    findings: list[Finding] = []
    for src in iter_sources(roots if roots is not None else default_roots()):
        if isinstance(src, _Unparseable):
            findings.append(
                Finding("DMT000", src.rel, 1, f"file does not parse: {src.error}")
            )
            continue
        per_file: list[Finding] = []
        for rule in rules:
            per_file.extend(rule.check(src))
        # Dedupe (a line can trip the same rule through several signals).
        uniq: dict[tuple[str, int, str], Finding] = {}
        for f in per_file:
            uniq.setdefault((f.rule, f.line, f.message), f)
        for f in uniq.values():
            if f.rule in src.line_disables(f.line):
                f.suppressed = True
                f.justification = "inline disable"
            else:
                why = suppressions.get((f.path, f.rule))
                if why is not None:
                    f.suppressed = True
                    f.justification = why
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
