"""Repo lint pass (port of ``repro.analysis.lint``) — AST checks for the
pitfalls this codebase has actually hit, plus runtime registry-consistency
checks.  The AST rules and their waivers are the reference's, word for
word, so both lints give the same findings on the same source; the
registry checks read the port's kernel registry and ``tune.search``
spaces.

Static (AST) checks over library code:

  * **REPRO001 materialize-in-library** — a ``.materialize()`` call in
    ``src/``: the dense concatenation defeats the O(block) streaming
    pipeline the moment a trace crosses ``cost_engine.STREAM_THRESHOLD``
    ops (the pre-PR-4 failure mode: million-op serving traces shaped their
    full (ops × 16) matrix just to be costed).  Deliberate dense variants
    (e.g. ``VMResult.trace``) carry a ``# lint: allow-materialize`` waiver
    on the call line or the line above.
  * **REPRO002 one-shot-iterator-into-TraceStream** — ``TraceStream(g())``
    where ``g`` is a generator function in the same module, or
    ``TraceStream(iter(...))``: the stream then supports a single pass, and
    every pre-guard call site that priced a second pass priced 0 cycles.
    Pass the generator FUNCTION (a zero-arg callable) for a re-iterable
    stream.  Deliberately single-pass streams (the prefetch pipeline in
    ``cost_engine`` — a pool of in-flight construction futures cannot be
    rewound) carry a ``# lint: allow-one-shot-stream`` waiver.
  * **REPRO006 per-block-re-lowering** — ``lower_archs(...)`` or
    ``cost_many(...)`` called inside a ``for`` loop iterating a trace's
    ``.blocks(...)`` / ``.iter_blocks(...)``: the arch-table lowering (and
    a full engine entry) is re-done O(blocks) times when one hoisted call
    — or ``cost_many`` over the stream itself — prices everything in one
    pass.  This is the exact anti-pattern the streaming engine exists to
    remove; a deliberate per-block call (e.g. a bench that measures that
    overhead) carries a ``# lint: allow-per-block-lowering`` waiver.
  * **REPRO005 swallowed-exception** — a bare ``except:`` clause, or an
    ``except`` whose entire body is ``pass``/``...``: in a
    fault-tolerant serving stack (``repro_torch.runtime.faults``) a
    silently eaten error turns a recoverable fault into wrong tokens.
    Catch a concrete exception type and handle or re-raise it; a
    deliberate suppression (e.g. best-effort cleanup) carries a
    ``# lint: allow-silent-except`` waiver on the ``except`` line or the
    line above.

Runtime registry checks (cheap imports, no jax tracing):

  * **REPRO003 kernel-registry-completeness** — registered kernels missing
    the ``trace`` / ``blocks`` / ``symbolic`` entry points the unified
    Trace pipeline and the conflict prover rely on.  Covers every module
    that self-registers kernels — the seven ``repro_torch.kernels``
    packages AND the ``repro_torch.models`` traffic lowerings
    (attn_decode / moe_a2a / ssm_scan): the check imports the registry's
    full builtin set itself rather than trusting whatever a caller
    happened to import first (kernels registered outside the kernel
    packages would otherwise stay invisible to the lint until something
    imported them).
  * **REPRO004 arch-name-round-trip** — every registered architecture name
    (and every ``ArchSpace`` grid name, including the ``{B}B-offset-s{K}``
    shifted points) must parse back through the arch-name parser to the
    same spec, or string-keyed caching (``bench.run_cells`` lowering keys,
    ``tune.search`` results) would silently alias distinct architectures.

``python -m repro_torch.analysis --lint src`` runs every check; findings
are returned as data so tests can pin both the positives and the
waivers.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Finding", "lint_file", "lint_paths", "registry_findings",
           "run_all"]

_WAIVER = "lint: allow-materialize"
_WAIVER_SILENT = "lint: allow-silent-except"
_WAIVER_ONE_SHOT = "lint: allow-one-shot-stream"
_WAIVER_PER_BLOCK = "lint: allow-per-block-lowering"


@dataclass(frozen=True)
class Finding:
    code: str            # "REPRO001" ...
    path: str
    line: int            # 1-indexed; 0 for runtime (non-file) findings
    message: str

    def __str__(self) -> str:
        where = f"{self.path}:{self.line}" if self.line else self.path
        return f"{where}: {self.code} {self.message}"


# --------------------------------------------------------------------------
# AST checks (REPRO001 / REPRO002)
# --------------------------------------------------------------------------

def _generator_names(tree: ast.AST) -> set:
    """Names of function defs anywhere in the module whose body yields."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                    # yields inside a NESTED def belong to that def
                    owner = node
                    for cand in ast.walk(node):
                        if (isinstance(cand, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                                and cand is not node):
                            if any(s is sub for s in ast.walk(cand)):
                                owner = cand
                                break
                    out.add(owner.name)
    return out


def _waived(lines: list, first: int, last: int,
            token: str = _WAIVER) -> bool:
    """True when any 1-indexed line of the node span — or the line above
    it — carries the waiver ``token`` (multi-line calls put
    ``.materialize()`` lines below the node's ``lineno``)."""
    for ln in range(first - 1, last + 1):
        if 1 <= ln <= len(lines) and token in lines[ln - 1]:
            return True
    return False


def _silent_body(body: list) -> bool:
    """True when an except body does nothing: only ``pass`` / ``...``."""
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is Ellipsis):
            continue
        return False
    return True


def lint_file(path, source: str | None = None) -> list:
    """AST-lint one python file; returns its ``Finding`` list."""
    p = Path(path)
    src = p.read_text() if source is None else source
    try:
        tree = ast.parse(src, filename=str(p))
    except SyntaxError as e:
        return [Finding("REPRO000", str(p), e.lineno or 0,
                        f"syntax error: {e.msg}")]
    lines = src.splitlines()
    gens = _generator_names(tree)
    findings = []
    seen_per_block: set = set()     # REPRO006 dedup across nested For nodes
    for node in ast.walk(tree):
        # REPRO005: bare except / except body that swallows the error
        if isinstance(node, ast.ExceptHandler):
            waived = _waived(lines, node.lineno,
                             node.end_lineno or node.lineno, _WAIVER_SILENT)
            if node.type is None and not waived:
                findings.append(Finding(
                    "REPRO005", str(p), node.lineno,
                    "bare `except:` — catches SystemExit/KeyboardInterrupt "
                    "and hides real faults from the recovery layer; catch "
                    "a concrete exception type, or waive a deliberate "
                    f"suppression with `# {_WAIVER_SILENT}`"))
            elif _silent_body(node.body) and not waived:
                findings.append(Finding(
                    "REPRO005", str(p), node.lineno,
                    "exception swallowed (except body is only pass/...) — "
                    "a silently eaten error turns a recoverable fault into "
                    "wrong results; handle or re-raise it, or waive a "
                    f"deliberate suppression with `# {_WAIVER_SILENT}`"))
            continue
        # REPRO006: lower_archs/cost_many re-done per block inside a
        # streaming loop (for ... in <trace>.blocks(...)/.iter_blocks(...))
        if isinstance(node, ast.For):
            it = node.iter
            g = it.func if isinstance(it, ast.Call) else None
            if isinstance(g, ast.Attribute) and g.attr in ("blocks",
                                                           "iter_blocks"):
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    h = sub.func
                    callee = (h.id if isinstance(h, ast.Name)
                              else h.attr if isinstance(h, ast.Attribute)
                              else None)
                    if callee not in ("lower_archs", "cost_many"):
                        continue
                    where = (str(p), sub.lineno)
                    if where in seen_per_block or _waived(
                            lines, sub.lineno, sub.end_lineno or sub.lineno,
                            _WAIVER_PER_BLOCK):
                        continue
                    seen_per_block.add(where)
                    findings.append(Finding(
                        "REPRO006", str(p), sub.lineno,
                        f"{callee}() inside a loop over .{g.attr}() — the "
                        f"arch lowering / engine entry is repeated "
                        f"O(blocks) times; hoist it above the loop (lower "
                        f"once, or cost_many the stream itself), or waive "
                        f"a deliberate per-block call with "
                        f"`# {_WAIVER_PER_BLOCK}`"))
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        # REPRO001: <anything>.materialize() without a waiver
        if (isinstance(f, ast.Attribute) and f.attr == "materialize"
                and not node.args and not node.keywords
                and not _waived(lines, node.lineno,
                                node.end_lineno or node.lineno)):
            findings.append(Finding(
                "REPRO001", str(p), node.lineno,
                "dense .materialize() in library code — defeats O(block) "
                "streaming above cost_engine.STREAM_THRESHOLD ops; cost "
                "the stream directly, or waive a deliberate dense variant "
                f"with `# {_WAIVER}`"))
        # REPRO002: TraceStream(one-shot iterator)
        if isinstance(f, ast.Name) and f.id == "TraceStream" and node.args:
            arg = node.args[0]
            one_shot = None
            if isinstance(arg, ast.Call):
                g = arg.func
                if isinstance(g, ast.Name) and g.id == "iter":
                    one_shot = "iter(...)"
                elif isinstance(g, ast.Name) and g.id in gens:
                    one_shot = f"generator {g.id}()"
            if one_shot and not _waived(lines, node.lineno,
                                        node.end_lineno or node.lineno,
                                        _WAIVER_ONE_SHOT):
                findings.append(Finding(
                    "REPRO002", str(p), node.lineno,
                    f"TraceStream fed a one-shot iterator ({one_shot}) — "
                    f"the stream supports a single pass and a second "
                    f"iteration raises; pass the generator FUNCTION "
                    f"(zero-arg callable) for a re-iterable stream, or "
                    f"waive a deliberately single-pass pipeline with "
                    f"`# {_WAIVER_ONE_SHOT}`"))
    return findings


def lint_paths(paths) -> list:
    """AST-lint files and/or directory trees (``*.py``, recursively)."""
    findings = []
    for path in paths:
        p = Path(path)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f))
    return findings


# --------------------------------------------------------------------------
# Runtime registry checks (REPRO003 / REPRO004)
# --------------------------------------------------------------------------

def registry_findings() -> list:
    """Check the kernel and architecture registries for the contract the
    rest of the repo assumes (see module docstring)."""
    import importlib

    findings = []

    from repro_torch.kernels import registry as kreg
    # Hold EVERY self-registering module to the contract — the kernel
    # packages and the repro_torch.models traffic lowerings alike.
    # Explicit imports (not just kreg.names()'s ensure hook) so the lint
    # stays complete even if the registry's builtin list regresses.
    for pkg in kreg._BUILTIN_PACKAGES:
        importlib.import_module(f"repro_torch.kernels.{pkg}")
    for mod in set(kreg._BUILTIN_MODULES) | {"repro_torch.models.trace"}:
        importlib.import_module(mod)
    for name in kreg.names():
        k = kreg.get(name)
        for attr in ("trace", "blocks", "symbolic"):
            if getattr(k, attr) is None:
                findings.append(Finding(
                    "REPRO003", f"kernel:{name}", 0,
                    f"kernel {name!r} has no {attr!r} entry point — the "
                    f"unified Trace pipeline (trace/blocks) and the "
                    f"symbolic prover (symbolic) expect all three"))

    from repro_torch.core import arch as _arch
    from repro_torch.tune.search import EXTENDED_SPACE, PAPER_SPACE
    checked = set()
    for name in (list(_arch.names()) + PAPER_SPACE.names()
                 + EXTENDED_SPACE.names()):
        if name in checked:
            continue
        checked.add(name)
        parsed = _arch._parse(name)
        if parsed is None:
            findings.append(Finding(
                "REPRO004", f"arch:{name}", 0,
                f"registered arch name {name!r} does not parse back "
                f"through the arch-name parser"))
            continue
        if parsed.name != name:
            findings.append(Finding(
                "REPRO004", f"arch:{name}", 0,
                f"arch name {name!r} round-trips to {parsed.name!r} — "
                f"string-keyed caches would alias distinct points"))
        registered = _arch.get(name)
        if registered.spec != parsed.spec:
            findings.append(Finding(
                "REPRO004", f"arch:{name}", 0,
                f"arch name {name!r} parses to a different spec than the "
                f"registered architecture"))
    return findings


def run_all(paths=("src",)) -> list:
    """The full lint pass: AST checks over ``paths`` + registry checks."""
    return lint_paths(paths) + registry_findings()
