"""The tmlint engine: one AST walk per file, checkers subscribe to
node events. The port's copy of `tendermint_tpu/analysis/engine.py`,
scanning the port's own tree.

Model:

- `Engine([checkers]).run(paths)` parses each file once and walks the
  tree recursively, maintaining lexical context (class stack, function
  stack, `with self._lock:` lock set, loop depth) in a `FileContext`.
  Each checker declares the node types it wants in `events`; the engine
  dispatches `checker.visit(node, ctx)` for exactly those, so adding a
  checker never adds another tree walk.
- Checkers report through `ctx.report(checker_id, node, message)`.
  Findings carry file:line + checker id.
- Suppression: `# tmlint: allow(<id>): <justification>` on the finding
  line or the line directly above swallows that checker's findings
  there. A pragma with no justification, or one that suppresses
  nothing, is itself a finding — pragmas must stay honest and live.

Checkers are plain objects; see analysis/checkers/ for the real ones.
`parse_guard_annotations` is shared with the runtime lock watcher
(analysis/lockwatch.py).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(
    r"#\s*tmlint:\s*allow\(([a-z0-9_-]+)\)\s*:?\s*(.*?)\s*$")
GUARDED_RE = re.compile(r"#:\s*guarded_by\s+([A-Za-z_]\w*)")

#: the default scan set, relative to the repo root: the port's package
#: and its chip script
DEFAULT_SCAN = ("tendermint_tpu_torch", "chip_smoke.py")


@dataclass
class Finding:
    checker: str
    path: str      # repo-relative
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"

    def to_obj(self) -> dict:
        return {"checker": self.checker, "path": self.path,
                "line": self.line, "message": self.message}


@dataclass
class Pragma:
    path: str
    line: int
    checker: str
    justification: str
    used: bool = False

    def to_obj(self) -> dict:
        return {"path": self.path, "line": self.line,
                "checker": self.checker,
                "justification": self.justification}


class Checker:
    """Base: subclasses set `id`, `events` (ast node types) and
    implement visit(); begin_file/end_file bracket each file."""

    id: str = "checker"
    events: Tuple[type, ...] = ()

    def begin_file(self, ctx: "FileContext") -> None:
        pass

    def visit(self, node: ast.AST, ctx: "FileContext") -> None:
        pass

    def end_file(self, ctx: "FileContext") -> None:
        pass


class FileContext:
    """Per-file state handed to every checker callback."""

    def __init__(self, engine: "Engine", path: str, rel: str,
                 source: str, tree: ast.AST):
        self.engine = engine
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # lexical context maintained by the walk
        self.class_stack: List[str] = []
        self.func_stack: List[ast.AST] = []
        self.held_locks: List[str] = []   # `with self.<name>:` nesting
        self.loop_depth = 0               # resets inside each function
        self._loop_depths: List[int] = []
        # scratch space for checkers (keyed by checker id)
        self.scratch: dict = {}

    # -- conveniences for checkers -----------------------------------

    @property
    def cls(self) -> Optional[str]:
        return self.class_stack[-1] if self.class_stack else None

    @property
    def func(self) -> Optional[ast.AST]:
        return self.func_stack[-1] if self.func_stack else None

    @property
    def func_name(self) -> Optional[str]:
        f = self.func
        return getattr(f, "name", None) if f is not None else None

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def report(self, checker_id: str, node, message: str) -> None:
        line = node if isinstance(node, int) else \
            getattr(node, "lineno", 0)
        self.engine._report(Finding(checker_id, self.rel, line, message))


class Engine:
    def __init__(self, checkers: Sequence[Checker], root: str = "."):
        self.checkers = list(checkers)
        self.root = os.path.abspath(root)
        self.findings: List[Finding] = []
        self.pragmas: List[Pragma] = []
        self.n_files = 0
        self._by_type: dict = {}
        for c in self.checkers:
            for t in c.events:
                self._by_type.setdefault(t, []).append(c)

    # -- collection --------------------------------------------------

    def _report(self, finding: Finding) -> None:
        self.findings.append(finding)

    def _scan_pragmas(self, rel: str, lines: List[str]) -> None:
        for i, text in enumerate(lines, start=1):
            m = PRAGMA_RE.search(text)
            if m:
                self.pragmas.append(
                    Pragma(rel, i, m.group(1), m.group(2)))

    # -- file walking ------------------------------------------------

    def run_source(self, source: str, rel: str = "<string>",
                   path: str = "") -> List[Finding]:
        """Analyze one source string (fixtures/tests). Returns the new
        findings this file produced, post-suppression."""
        before = len(self.findings)
        n_pragmas = len(self.pragmas)
        tree = ast.parse(source, filename=rel)
        ctx = FileContext(self, path or rel, rel, source, tree)
        self._scan_pragmas(rel, ctx.lines)
        for c in self.checkers:
            c.begin_file(ctx)
        self._walk(tree, ctx)
        for c in self.checkers:
            c.end_file(ctx)
        new = self.findings[before:]
        kept = self._suppress(new, self.pragmas[n_pragmas:])
        self.findings[before:] = kept
        self.n_files += 1
        return kept

    def run(self, paths: Optional[Iterable[str]] = None,
            final: bool = True):
        """Walk every .py file under `paths` (default DEFAULT_SCAN,
        resolved against root). Returns (findings, pragmas, n_files)."""
        for path in self._collect_files(paths):
            rel = os.path.relpath(path, self.root)
            try:
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                self.run_source(source, rel=rel, path=path)
            except SyntaxError as e:
                self._report(Finding(
                    "engine", rel, e.lineno or 0,
                    f"syntax error: {e.msg}"))
        if final:
            self.finish()
        return self.findings, self.pragmas, self.n_files

    def finish(self) -> List[Finding]:
        """Run end-of-run checks (pragma hygiene) — run() does this
        automatically; run_source() callers invoke it explicitly."""
        self._finish_pragmas()
        return self.findings

    def _collect_files(self, paths: Optional[Iterable[str]]):
        out = []
        for p in (paths if paths is not None else DEFAULT_SCAN):
            full = p if os.path.isabs(p) else os.path.join(self.root, p)
            if os.path.isfile(full):
                out.append(full)
            elif os.path.isdir(full):
                for dirpath, dirnames, filenames in os.walk(full):
                    dirnames[:] = sorted(d for d in dirnames
                                         if d not in ("__pycache__",
                                                      "_build"))
                    for fn in sorted(filenames):
                        if fn.endswith(".py"):
                            out.append(os.path.join(dirpath, fn))
        return out

    def _walk(self, node: ast.AST, ctx: FileContext) -> None:
        for checker in self._by_type.get(type(node), ()):
            checker.visit(node, ctx)
        if isinstance(node, ast.ClassDef):
            ctx.class_stack.append(node.name)
            for child in ast.iter_child_nodes(node):
                self._walk(child, ctx)
            ctx.class_stack.pop()
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ctx.func_stack.append(node)
            ctx._loop_depths.append(ctx.loop_depth)
            ctx.loop_depth = 0
            for child in ast.iter_child_nodes(node):
                self._walk(child, ctx)
            ctx.loop_depth = ctx._loop_depths.pop()
            ctx.func_stack.pop()
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            locks = [_self_attr_name(item.context_expr)
                     for item in node.items]
            locks = [name for name in locks if name]
            ctx.held_locks.extend(locks)
            for child in ast.iter_child_nodes(node):
                self._walk(child, ctx)
            del ctx.held_locks[len(ctx.held_locks) - len(locks):]
        elif isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            # the iterable/condition evaluates OUTSIDE the loop body
            pre = (node.iter,) if hasattr(node, "iter") else \
                (node.test,)
            for child in pre:
                self._walk(child, ctx)
            ctx.loop_depth += 1
            for child in ast.iter_child_nodes(node):
                if child not in pre:
                    self._walk(child, ctx)
            ctx.loop_depth -= 1
        else:
            for child in ast.iter_child_nodes(node):
                self._walk(child, ctx)

    # -- suppression -------------------------------------------------

    def _suppress(self, findings: List[Finding],
                  pragmas: List[Pragma]) -> List[Finding]:
        by_key = {}
        for p in pragmas:
            # a pragma covers its own line and the line below it (so it
            # can sit above a long statement)
            by_key[(p.checker, p.line)] = p
            by_key.setdefault((p.checker, p.line + 1), p)
        kept = []
        for f in findings:
            p = by_key.get((f.checker, f.line))
            if p is not None:
                p.used = True
            else:
                kept.append(f)
        return kept

    def _finish_pragmas(self) -> None:
        """Pragma hygiene: every allow() must carry a justification and
        actually suppress something (stale pragmas rot into lies)."""
        # "metrics" and "taint" run outside the AST engine (registry
        # import / call-graph pass), so their pragmas are collected here
        # but used elsewhere: accept the ids, and leave staleness
        # policing to the passes that actually consume them.
        known = {c.id for c in self.checkers} | {"metrics", "taint"}
        for p in self.pragmas:
            if p.checker not in known:
                self._report(Finding(
                    "pragma", p.path, p.line,
                    f"allow({p.checker}) names no known checker"))
            elif not p.justification:
                self._report(Finding(
                    "pragma", p.path, p.line,
                    f"allow({p.checker}) carries no justification — "
                    f"say why the rule does not apply here"))
            elif not p.used and p.checker not in ("metrics", "taint"):
                self._report(Finding(
                    "pragma", p.path, p.line,
                    f"allow({p.checker}) suppresses nothing — stale "
                    f"pragma, remove it"))


def _self_attr_name(expr: ast.AST) -> Optional[str]:
    """`self._lock` -> '_lock' (also unwraps `self._lock.acquire()`-less
    plain attribute context managers). Non-self expressions -> None."""
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return expr.attr
    return None


@dataclass
class GuardAnnotation:
    cls: str
    attr: str
    lock: str
    line: int


def parse_guard_annotations(source: str) -> List[GuardAnnotation]:
    """`self.<attr> = ...  #: guarded_by <lock>` lines, with the class
    each belongs to. Shared by the static lock-discipline checker and
    the runtime lockwatch attribute watcher."""
    out: List[GuardAnnotation] = []
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return out
    lines = source.splitlines()
    annotated = {}
    for i, text in enumerate(lines, start=1):
        m = GUARDED_RE.search(text)
        if m:
            am = re.search(r"self\.(\w+)\s*[:=]", text)
            if am:
                annotated[i] = (am.group(1), m.group(1))

    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
            else:
                if cls and isinstance(child, (ast.Assign, ast.AnnAssign)) \
                        and child.lineno in annotated:
                    attr, lock = annotated.pop(child.lineno)
                    out.append(GuardAnnotation(cls, attr, lock,
                                               child.lineno))
                walk(child, cls)

    walk(tree, None)
    return out
