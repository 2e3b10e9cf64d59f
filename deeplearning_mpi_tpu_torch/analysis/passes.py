"""The port's dmt-lint rule catalog.

Port of ``deeplearning_mpi_tpu/analysis/passes.py``. DMT004-DMT008 are
host-side contracts and carry over as they are, over the port's paths and
its ``telemetry/schema.py``. DMT003 speaks PyTorch. DMT001 and DMT002 are
JAX idioms (donated buffers, values baked in at trace time); each has a
PyTorch counterpart over CUDA-graph capture (``compiler/aot.py``):

| id     | name                  | contract                                    |
|--------|-----------------------|---------------------------------------------|
| DMT001 | captured-output-reuse | a captured program's static output must not |
|        |                       | be read after the next replay (the port's   |
|        |                       | donation: a replay rewrites the buffer)     |
| DMT002 | capture-frozen-state  | no per-call host state (clocks, Python or   |
|        |                       | numpy RNGs, Python values made tensors) in  |
|        |                       | a function captured into a CUDA graph: it   |
|        |                       | is frozen at capture                        |
| DMT003 | host-sync-in-hot-loop | no .item()/.cpu()/.tolist()/.numpy()/       |
|        |                       | torch.cuda.synchronize()/torch.tensor(...,  |
|        |                       | device=) in decode or train step hot loops  |
|        |                       | beyond the audited syncs                    |
| DMT004 | atomic-io             | JSON under resilience/serving/compiler goes |
|        |                       | through atomic_write_json                   |
| DMT005 | jsonl-single-writer   | one sanctioned writer per JSONL stream      |
| DMT006 | supervisor-ordering   | liveness queries must not follow a kill     |
| DMT007 | telemetry-schema      | metric names and label keys at call sites   |
|        |                       | are in telemetry/schema.py                  |
| DMT008 | clock-injection       | clock-pure policy modules never call time.* |

The runtime half of DMT001 is the sanitizer's donation canary around a
checkpoint save; of DMT002, its retrace tripwire (a capture after warmup).
Rules are syntactic and local; audited exceptions are recorded inline
(``# dmt-lint: disable=...`` with a why) or in
``analysis/lint_suppressions.txt``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from deeplearning_mpi_tpu_torch.analysis.core import Finding, Rule, SourceFile

__all__ = ["all_rules"]


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _has_jsonl_literal(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Constant)
        and isinstance(n.value, str)
        and ".jsonl" in n.value
        for n in ast.walk(node)
    )


def _walk_body(func: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested defs — a nested
    function runs on its own schedule, so ordering rules must not conflate
    the two scopes."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


# --------------------------------------------------------------------------
# DMT001 captured-output-reuse
# --------------------------------------------------------------------------
#
# The reference's DMT001 flags a value read after it was donated to a
# jitted call. PyTorch donates nothing; its counterpart is a CUDA graph's
# static output: ``CapturedProgram.__call__`` returns the same tensor every
# replay, so an output kept across the next call of a captured program
# (they share one graph pool) reads the NEXT step's values. Statically: a
# local name bound to ``CapturedProgram(...)`` / ``WarmProgram(...)`` marks
# its call sites; a name assigned from one call and loaded after a later
# call of any such program in the same scope (with no rebind between) is
# flagged. Programs held on ``self`` are out of static reach; the
# sanitizer's donation canary covers the checkpoint half at run time.

_PROGRAM_CTORS = ("CapturedProgram", "WarmProgram", "aot.CapturedProgram", "aot.WarmProgram")


def _check_captured_output(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for func in src.functions():
        nodes = sorted(
            (n for n in _walk_body(func) if hasattr(n, "lineno")),
            key=lambda n: (n.lineno, n.col_offset),
        )
        programs: set[str] = set()
        #: output name -> (line of the call that produced it, stale from line)
        outputs: dict[str, list[int | None]] = {}
        calls: list[int] = []
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and (_dotted(node.value.func) or "") in _PROGRAM_CTORS:
                programs.update(t.id for t in node.targets if isinstance(t, ast.Name))
        if not programs:
            continue
        for node in nodes:
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in programs:
                calls.append(node.lineno)
                for name, (line, stale) in outputs.items():
                    if stale is None and node.lineno > line:
                        outputs[name][1] = node.lineno
                parent = src.parent.get(node)
                if isinstance(parent, ast.Assign):
                    for tgt in parent.targets:
                        for n in ast.walk(tgt):
                            if isinstance(n, ast.Name):
                                outputs[n.id] = [node.lineno, None]
        for node in nodes:
            if not isinstance(node, ast.Name) or node.id not in outputs:
                continue
            line, stale = outputs[node.id]
            if isinstance(node.ctx, ast.Load) and stale is not None and node.lineno > stale:
                findings.append(Finding(
                    "DMT001", src.rel, node.lineno,
                    f"`{node.id}` is a captured program's static output (line {line}) read "
                    f"after the program replayed again at line {stale}: the replay rewrote "
                    "it — clone the output before the next call",
                ))
    return findings


# --------------------------------------------------------------------------
# DMT002 capture-frozen-state
# --------------------------------------------------------------------------
#
# The reference's DMT002 flags per-call host state inside a jitted body
# (baked in at trace time). A CUDA graph freezes the same things at
# capture: a wall clock read, a Python / numpy RNG draw, or a Python value
# made into a tensor inside the captured function runs once, at capture,
# and every replay reuses its value. Captured functions: a ``def`` or a
# lambda passed as the first argument of ``CapturedProgram(...)`` /
# ``CapturedStep(...)`` in the same module, or a ``def`` marked ``#
# dmt-lint: captured``.

_FROZEN_CALLS = re.compile(
    r"^(time\.(time|perf_counter|monotonic|time_ns)"
    r"|random\.\w+"
    r"|np\.random\.\w+|numpy\.random\.\w+"
    r"|datetime\.(datetime\.)?(now|utcnow|today)"
    r"|torch\.(tensor|as_tensor))$"
)
_CAPTURE_CTORS = ("CapturedProgram", "CapturedStep", "aot.CapturedProgram", "aot.CapturedStep")


def _captured_bodies(src: SourceFile) -> list[ast.AST]:
    named: set[str] = set()
    bodies: list[ast.AST] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call) and (_dotted(node.func) or "") in _CAPTURE_CTORS \
                and node.args:
            fn = node.args[0]
            if isinstance(fn, ast.Lambda):
                bodies.append(fn)
            elif isinstance(fn, ast.Name):
                named.add(fn.id)
    for func in src.functions():
        if func.name in named or src.is_marked_captured(func):
            bodies.append(func)
    return bodies


def _check_capture_frozen(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for body in _captured_bodies(src):
        nodes = ast.walk(body.body) if isinstance(body, ast.Lambda) else _walk_body(body)
        for node in nodes:
            if isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                if _FROZEN_CALLS.match(name):
                    findings.append(Finding(
                        "DMT002", src.rel, node.lineno,
                        f"`{name}()` inside a function captured into a CUDA graph: it runs "
                        "once, at capture, and every replay reuses that value",
                    ))
    return findings


# --------------------------------------------------------------------------
# DMT003 host-sync-in-hot-loop
# --------------------------------------------------------------------------
#
# The decode loop and the train step drive the card; a host sync there
# (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``int()`` of a
# ``torch.*`` result, ``torch.cuda.synchronize()``, a
# ``torch.tensor(..., device=...)`` made
# from host values: the sync phase 19b of chip_smoke.py found in the
# step) stalls the pipeline once per step. The audited syncs — the one
# sampled-token fetch per decode step, the verify fetch, the draft's
# proposal fetch — carry inline disables with their justification.
# Hot scopes are configured by path; any function can be marked with
# ``# dmt-lint: hot-loop`` on its def line.

_HOT_SCOPES: dict[str, set[str]] = {
    "deeplearning_mpi_tpu_torch/serving/engine.py": {
        "step", "_plain_decode", "_spec_decode", "_prefill_one",
    },
    "deeplearning_mpi_tpu_torch/serving/disagg.py": {"step"},
    "deeplearning_mpi_tpu_torch/serving/speculative.py": {"propose"},
    "deeplearning_mpi_tpu_torch/train/trainer.py": {"step", "loss_and_grads"},
}
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")


def _check_host_sync(src: SourceFile) -> list[Finding]:
    hot_names = _HOT_SCOPES.get(src.rel, set())
    findings: list[Finding] = []
    for func in src.functions():
        if func.name not in hot_names and not src.is_marked_hot(func):
            continue
        for node in _walk_body(func):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func) or ""
            np_computed = name in ("np.asarray", "np.array", "numpy.asarray") and node.args \
                and isinstance(node.args[0], ast.Call)
            to_device = name in ("torch.tensor", "torch.as_tensor") and any(
                kw.arg == "device" for kw in node.keywords)
            # int(torch.argmax(x)): a Python number of a tensor result.
            scalar = name in ("int", "float", "bool") and node.args \
                and isinstance(node.args[0], ast.Call) \
                and (_dotted(node.args[0].func) or "").startswith("torch.")
            if name == "torch.cuda.synchronize" or np_computed or to_device or scalar:
                findings.append(Finding(
                    "DMT003", src.rel, node.lineno,
                    f"`{name}` in hot loop `{func.name}`: host-device sync stalls the step "
                    "pipeline (audited syncs need an inline disable with a why)",
                ))
            elif isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS \
                    and not node.args:
                findings.append(Finding(
                    "DMT003", src.rel, node.lineno,
                    f"`.{node.func.attr}()` in hot loop `{func.name}`: host-device sync "
                    "stalls the step pipeline",
                ))
    return findings


# --------------------------------------------------------------------------
# DMT004 atomic-io
# --------------------------------------------------------------------------
#
# Under resilience/, serving/, and compiler/ every JSON artifact is part of
# a crash-recovery or IPC contract: a reader may race a writer that is
# mid-write or freshly SIGKILLed. atomic_write_json (tmp sibling + fsync +
# rename) is the one sanctioned way to produce them; a bare json.dump /
# write_text(json.dumps(...)) / open(.., "w") leaves a torn file exactly
# when it matters. Out-of-tree files opt in with ``# dmt-lint:
# scope=resilience``.

_IO_CRITICAL = ("deeplearning_mpi_tpu_torch/resilience/",
                "deeplearning_mpi_tpu_torch/serving/",
                "deeplearning_mpi_tpu_torch/compiler/")


def _open_write_mode(call: ast.Call) -> bool:
    """open(..., "w"/"wb") or path.open("w"/"a"...) — write-mode open."""
    name = _dotted(call.func) or ""
    is_open = name == "open" or (
        isinstance(call.func, ast.Attribute) and call.func.attr == "open"
    )
    if not is_open:
        return False
    mode = None
    args = call.args
    if name == "open" and len(args) >= 2:
        mode = _const_str(args[1])
    elif name != "open" and args:
        mode = _const_str(args[0])
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = _const_str(kw.value)
    return mode is not None and "w" in mode


def _check_atomic_io(src: SourceFile) -> list[Finding]:
    in_scope = any(src.rel.startswith(p) for p in _IO_CRITICAL)
    if not in_scope and src.declared_scope() not in (
        "resilience", "serving", "compiler"
    ):
        return []
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        func = src.enclosing_function(node)
        if func is not None and func.name == "atomic_write_json":
            continue  # the sanctioned implementation itself
        name = _dotted(node.func) or ""
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if name == "json.dump":
            findings.append(Finding(
                "DMT004", src.rel, node.lineno,
                "bare `json.dump` in an IO-critical tree: a mid-write kill "
                "leaves a torn file — use resilience.integrity."
                "atomic_write_json",
            ))
        elif attr == "write_text" and node.args and any(
            isinstance(a, ast.Call) and (_dotted(a.func) or "") == "json.dumps"
            for a in node.args
        ):
            findings.append(Finding(
                "DMT004", src.rel, node.lineno,
                "`write_text(json.dumps(...))` in an IO-critical tree is "
                "not atomic — use atomic_write_json",
            ))
        elif _open_write_mode(node):
            findings.append(Finding(
                "DMT004", src.rel, node.lineno,
                "write-mode `open` in an IO-critical tree: artifacts here "
                "are crash-recovery contracts — write via atomic_write_json "
                "(or record the exception with a why)",
            ))
    return findings


# --------------------------------------------------------------------------
# DMT005 jsonl-single-writer
# --------------------------------------------------------------------------
#
# The fleet IPC contract: a JSONL stream is recoverable after a
# mid-write SIGKILL only because it has exactly ONE writer appending
# newline-terminated records — readers consume terminated lines and a
# second writer would interleave torn records. telemetry's JsonlSink and
# the control plane's SupervisorJournal (resilience/cluster.py — the
# write-ahead journal; incarnation fencing guarantees one live writer) are
# the sanctioned writer classes; raw write-mode opens of ``*.jsonl``
# anywhere else must be explicitly audited (the fleet's per-attempt
# inbox/outbox opens are — see analysis/lint_suppressions.txt).

_JSONL_WRITER_CLASSES = {"JsonlSink", "SupervisorJournal"}


def _check_jsonl_writer(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or ""
        is_open = name == "open" or (
            isinstance(node.func, ast.Attribute) and node.func.attr == "open"
        )
        if not is_open:
            continue
        mode = None
        if name == "open" and len(node.args) >= 2:
            mode = _const_str(node.args[1])
        elif name != "open" and node.args:
            mode = _const_str(node.args[0])
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = _const_str(kw.value)
        if mode is None or not ("w" in mode or "a" in mode):
            continue
        if not _has_jsonl_literal(node):
            continue
        cls = src.enclosing_class(node)
        if cls is not None and cls.name in _JSONL_WRITER_CLASSES:
            continue  # a sanctioned single-writer class
        findings.append(Finding(
            "DMT005", src.rel, node.lineno,
            "raw write-mode open of a .jsonl stream outside the sanctioned "
            "writer classes (JsonlSink, SupervisorJournal): the single-"
            "writer IPC contract requires one audited writer per stream "
            "(suppress with the writer-ownership justification)",
        ))
    return findings


# --------------------------------------------------------------------------
# DMT006 supervisor-ordering
# --------------------------------------------------------------------------
#
# The bug this rule records: survivors were computed AFTER the teardown SIGKILL, so the
# liveness query always saw an empty world and every failure escalated.
# Rule: in one function body, a call that *queries* liveness/survivorship
# (poll/is_alive/verdicts/survivors/...) must not appear textually after a
# kill call — snapshot liveness first, then kill. Loop-carried re-polls
# (top of the next iteration) are textually before the kill and pass.

_KILL_ATTRS = {"kill", "killpg", "terminate", "send_signal", "_kill_all"}
_LIVENESS_RE = re.compile(r"(survivor|is_alive|verdict|liveness|poll)\w*$", re.I)


def _check_supervisor_ordering(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for func in src.functions():
        kill_line: int | None = None
        nodes = sorted(
            (n for n in _walk_body(func) if isinstance(n, ast.Call)),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for node in nodes:
            callee = (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name) else ""
            )
            if callee in _KILL_ATTRS or (_dotted(node.func) or "") == "os.kill":
                if kill_line is None:
                    kill_line = node.lineno
                continue
            if kill_line is not None and node.lineno > kill_line and _LIVENESS_RE.match(callee or ""):
                findings.append(Finding(
                    "DMT006", src.rel, node.lineno,
                    f"liveness query `{callee}` after a kill at line "
                    f"{kill_line}: snapshot survivors BEFORE tearing down "
                    "(a post-SIGKILL survivor computation sees an empty "
                    "world)",
                ))
    return findings


# --------------------------------------------------------------------------
# DMT007 telemetry-schema
# --------------------------------------------------------------------------
#
# One canonical metric schema (telemetry/schema.py): every literal metric
# name and label key at a call site must be registered there. A typo'd
# counter name is a silent hole in the dashboards and breaks the
# reconciliation invariants the drills assert; the schema makes "metric
# exists" a lint-time fact instead of a grep.

_INSTRUMENT_FUNCS = {"counter", "gauge", "histogram", "_inc", "labeled"}


def _resolve_metric_names(src: SourceFile, node: ast.Call) -> list[tuple[str, int]]:
    """Literal metric names reachable from a call's first argument:
    direct string constants, a nested wrapping call (``_role_name("x")``,
    ``labeled("x", ...)``), an ALL_CAPS module constant, or a ``for`` loop
    variable iterating a tuple of string constants."""
    if not node.args:
        return []
    arg = node.args[0]
    direct = _const_str(arg)
    if direct is not None:
        return [(direct, node.lineno)]
    if isinstance(arg, ast.Call):
        inner = _const_str(arg.args[0]) if arg.args else None
        return [(inner, node.lineno)] if inner is not None else []
    if isinstance(arg, ast.Name):
        # Module-level ALL_CAPS string constant.
        if arg.id.isupper():
            for top in src.tree.body:
                if isinstance(top, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == arg.id
                    for t in top.targets
                ):
                    v = _const_str(top.value)
                    if v is not None:
                        return [(v, node.lineno)]
        # ``for name in ("a", "b"): registry.counter(name)``
        cur = src.parent.get(node)
        while cur is not None:
            if isinstance(cur, ast.For) and isinstance(cur.target, ast.Name) \
                    and cur.target.id == arg.id and isinstance(cur.iter, ast.Tuple):
                out = []
                for el in cur.iter.elts:
                    v = _const_str(el)
                    if v is not None:
                        out.append((v, node.lineno))
                return out
            cur = src.parent.get(cur)
    return []


def _check_telemetry_schema(src: SourceFile) -> list[Finding]:
    try:
        from deeplearning_mpi_tpu_torch.telemetry.schema import LABEL_KEYS, METRICS
    except ImportError:  # schema missing entirely — one loud finding
        return [Finding(
            "DMT007", src.rel, 1,
            "telemetry/schema.py is missing — the canonical metric schema "
            "is the contract this rule checks against",
        )]
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = (
            node.func.attr if isinstance(node.func, ast.Attribute)
            else node.func.id if isinstance(node.func, ast.Name) else ""
        )
        if callee not in _INSTRUMENT_FUNCS:
            continue
        for name, line in _resolve_metric_names(src, node):
            if name not in METRICS:
                findings.append(Finding(
                    "DMT007", src.rel, line,
                    f"metric `{name}` is not in telemetry/schema.py — "
                    "typo, or register the new metric in the canonical "
                    "schema",
                ))
        if callee == "labeled":
            for kw in node.keywords:
                if kw.arg is not None and kw.arg not in LABEL_KEYS:
                    findings.append(Finding(
                        "DMT007", src.rel, node.lineno,
                        f"label key `{kw.arg}` is not in telemetry/"
                        "schema.py LABEL_KEYS",
                    ))
    return findings


# --------------------------------------------------------------------------
# DMT008 clock-injection
# --------------------------------------------------------------------------
#
# The serving policy stack (autoscaler decide loop, router scoring/hedging,
# scheduler admission, prefix cache) is clock-pure by contract: every method
# takes ``now`` as an argument (or holds an injected ``clock`` callable),
# and the fake-clock simulator (sim/) replays the SAME objects against
# whole-day traces in seconds. One direct ``time.monotonic()`` call breaks
# that replay silently — sim results would mix two clocks and every sweep
# verdict would be garbage. Rule: in the configured policy modules (opt-in
# elsewhere with ``# dmt-lint: scope=policy``), a *call* of a wall-clock
# read is flagged. Passing ``time.monotonic`` as a default clock VALUE
# (router's injectable ctor default) is fine — the reference is the
# injection point, the call is the violation.

_CLOCK_PURE_PATHS = (
    "deeplearning_mpi_tpu_torch/serving/autoscaler.py",
    "deeplearning_mpi_tpu_torch/serving/router.py",
    "deeplearning_mpi_tpu_torch/serving/scheduler.py",
    "deeplearning_mpi_tpu_torch/serving/prefix_cache.py",
    "deeplearning_mpi_tpu_torch/sim/",
)

_CLOCK_CALLS = re.compile(
    r"^(time\.(time|perf_counter|monotonic|time_ns|perf_counter_ns|"
    r"monotonic_ns|sleep)"
    r"|datetime\.(datetime\.)?(now|utcnow|today))$"
)


def _check_clock_injection(src: SourceFile) -> list[Finding]:
    in_scope = any(
        src.rel == p or (p.endswith("/") and src.rel.startswith(p))
        for p in _CLOCK_PURE_PATHS
    )
    if not in_scope and src.declared_scope() != "policy":
        return []
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or ""
        if _CLOCK_CALLS.match(name):
            findings.append(Finding(
                "DMT008", src.rel, node.lineno,
                f"`{name}()` in a clock-pure policy module: clocks are "
                "injected (take `now` as an argument) so the fake-clock "
                "simulator can replay this exact object — a direct wall-"
                "clock read silently splits sim and production behavior",
            ))
    return findings


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def all_rules() -> list[Rule]:
    return [
        Rule("DMT001", "captured-output-reuse",
             "a captured program's static output is not read after the next replay "
             "(the reference's donation-safety; its runtime half is the donation canary)",
             _check_captured_output),
        Rule("DMT002", "capture-frozen-state",
             "no per-call host state inside a function captured into a CUDA graph "
             "(the reference's retrace-hazard; its runtime half is the retrace tripwire)",
             _check_capture_frozen),
        Rule("DMT003", "host-sync-in-hot-loop",
             "no unaudited host-device syncs in decode/train hot loops",
             _check_host_sync),
        Rule("DMT004", "atomic-io",
             "IO-critical JSON goes through atomic_write_json",
             _check_atomic_io),
        Rule("DMT005", "jsonl-single-writer",
             "one audited writer per JSONL stream (fleet IPC contract)",
             _check_jsonl_writer),
        Rule("DMT006", "supervisor-ordering",
             "snapshot liveness before killing",
             _check_supervisor_ordering),
        Rule("DMT007", "telemetry-schema",
             "metric names/labels match telemetry/schema.py",
             _check_telemetry_schema),
        Rule("DMT008", "clock-injection",
             "clock-pure policy modules never call time.* (sim replay contract)",
             _check_clock_injection),
    ]
