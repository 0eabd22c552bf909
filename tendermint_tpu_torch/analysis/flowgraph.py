"""flowgraph — project-wide call graph for inter-procedural analysis:
the port's copy of `tendermint_tpu/analysis/flowgraph.py`, over the
port's package and chip_smoke.py.

The per-file AST engine (analysis/engine.py) sees one function at a
time, which is why the determinism checker is a lexical
pattern-matcher scoped to four directories: it cannot know that
`self.mempool.reap()` inside the proposer lands in a function that
walks an insertion-ordered map. This module builds the whole-program
view the taint pass (analysis/checkers/taint.py) walks:

- every function/method definition in the scan set, under a stable
  qualified name (`tendermint_tpu_torch.mempool.mempool.Mempool.reap`);
- every call site inside each of them, resolved to candidate callees:

    direct    bare `foo()` to a function in the same module
    alias     `foo()` / `mod.foo()` through `import`/`from-import`
              (asname tracking included — `import x.y as z; z.f()`)
    class     `Cls.method()` / `Cls()` where Cls is a project class
              (constructor calls resolve to `Cls.__init__`)
    self      `self.meth()` / `cls.meth()` resolved through the
              enclosing class and its project-resolvable bases
    method    `obj.meth()` duck-resolved to every project class that
              defines `meth`, when at most DUCK_FANOUT_MAX do — the
              deliberate over-approximation that lets taint cross
              `self.mempool.reap()` without type inference
    external  stdlib/builtin/third-party roots (`os.`, `hashlib.`,
              `json.`) — never an edge, never counted unresolved
    unresolved  everything else (lambdas, dynamic dispatch, fan-out
              wider than DUCK_FANOUT_MAX)

`FlowGraph.stats()` reports the size and the resolution rate so a
refactor that silently degrades coverage is visible
(`python -m tendermint_tpu_torch.analysis.lint --graph-stats`, gated by
tests/test_torch_lint.py).

Build cost is one `ast.parse` per file plus a linear link pass; the
whole 160+-file tree builds in well under a second, so the taint
checker can rebuild it on every lint run.
"""

from __future__ import annotations

import ast
import builtins
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from tendermint_tpu_torch.analysis.engine import DEFAULT_SCAN

#: `obj.meth()` duck-resolution gives up past this many candidate
#: classes — wider fan-out means the method name is too generic to be
#: a meaningful edge (e.g. `get`, `update` on stdlib types).
DUCK_FANOUT_MAX = 6

#: duck-resolution never fires for these — they collide with stdlib
#: container/IO methods so often that an edge would be noise, not flow.
DUCK_SKIP = frozenset((
    "get", "put", "add", "pop", "append", "remove", "clear", "copy",
    "items", "keys", "values", "update", "close", "open", "read",
    "write", "send", "recv", "join", "start", "stop", "run", "wait",
    "acquire", "release", "encode", "decode", "hex", "digest", "strip",
    "split", "format", "lower", "upper", "startswith", "endswith",
    "to_obj", "from_obj", "setdefault", "extend", "insert", "index",
    "count", "sort", "reverse", "flush", "seek", "tell", "name",
    "submit", "result", "set", "group", "match", "search", "findall",
))

_BUILTIN_NAMES = frozenset(dir(builtins))


@dataclass
class CallSite:
    """One call expression inside a function body."""
    lineno: int
    label: str                       # display form, e.g. "self.mempool.reap"
    kind: str                        # direct|alias|class|self|method|external|unresolved
    targets: Tuple[str, ...] = ()    # candidate callee qnames


@dataclass
class FunctionInfo:
    qname: str
    module: str
    cls: Optional[str]               # enclosing class name, None for free fns
    name: str
    rel: str                         # repo-relative file path
    lineno: int
    node: ast.AST = field(repr=False, default=None)
    calls: List[CallSite] = field(default_factory=list)


@dataclass
class ClassInfo:
    qname: str
    name: str
    module: str
    bases: Tuple[str, ...]           # base names as written (resolved lazily)
    methods: Dict[str, str] = field(default_factory=dict)  # name -> qname


class ModuleInfo:
    def __init__(self, qname: str, rel: str, tree: ast.AST):
        self.qname = qname
        self.rel = rel
        self.tree = tree
        #: local name -> dotted import target ("os",
        #: "tendermint_tpu_torch.x.y", "tendermint_tpu_torch.x.y.f" for
        #: from-imports of functions/classes)
        self.imports: Dict[str, str] = {}
        self.functions: Dict[str, str] = {}   # bare name -> qname (module level)
        self.classes: Dict[str, ClassInfo] = {}


def module_qname(rel: str) -> str:
    """Repo-relative path -> dotted module name
    (`tendermint_tpu_torch/ops/merkle.py` -> `tendermint_tpu_torch.ops.merkle`,
    `chip_smoke.py` -> `chip_smoke`)."""
    rel = rel.replace("\\", "/")
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    return rel.replace("/", ".")


class FlowGraph:
    def __init__(self):
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        #: method name -> [qname, ...] across every project class
        self.methods_by_name: Dict[str, List[str]] = {}
        self.n_files = 0
        self.parse_errors: List[Tuple[str, str]] = []

    # ------------------------------------------------------------ build

    @classmethod
    def build(cls, root: str = ".",
              paths: Optional[Iterable[str]] = None) -> "FlowGraph":
        g = cls()
        root = os.path.abspath(root)
        for path in _collect_files(root, paths):
            rel = os.path.relpath(path, root)
            try:
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                g.add_source(source, rel)
            except SyntaxError as e:
                g.parse_errors.append((rel, str(e)))
        g.link()
        return g

    def add_source(self, source: str, rel: str) -> None:
        """Index one file (tests feed fixture strings through here)."""
        tree = ast.parse(source, filename=rel)
        mod = ModuleInfo(module_qname(rel), rel, tree)
        self.modules[mod.qname] = mod
        self.n_files += 1
        self._index_imports(mod)
        self._index_defs(mod)

    def _index_imports(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    mod.imports[local] = target
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative import: resolve against package
                    pkg = mod.qname.rsplit(".", node.level)[0] \
                        if mod.qname.count(".") >= node.level else ""
                    base = f"{pkg}.{node.module}" if node.module else pkg
                else:
                    base = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    mod.imports[local] = f"{base}.{alias.name}" if base \
                        else alias.name

    def _index_defs(self, mod: ModuleInfo) -> None:
        def walk(node, qprefix: str, cls: Optional[ClassInfo]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    info = ClassInfo(
                        qname=f"{qprefix}.{child.name}",
                        name=child.name, module=mod.qname,
                        bases=tuple(_base_name(b) for b in child.bases))
                    mod.classes[child.name] = info
                    walk(child, info.qname, info)
                elif isinstance(child,
                                (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qname = f"{qprefix}.{child.name}"
                    fi = FunctionInfo(
                        qname=qname, module=mod.qname,
                        cls=cls.name if cls else None,
                        name=child.name, rel=mod.rel,
                        lineno=child.lineno, node=child)
                    self.functions[qname] = fi
                    if cls is not None:
                        cls.methods[child.name] = qname
                        self.methods_by_name.setdefault(
                            child.name, []).append(qname)
                    elif qprefix == mod.qname:
                        mod.functions[child.name] = qname
                    # nested defs resolve under the parent's qname
                    walk(child, qname, None if cls is None else None)
                else:
                    walk(child, qprefix, cls)

        walk(mod.tree, mod.qname, None)

    # ------------------------------------------------------------- link

    def link(self) -> None:
        """Resolve every call site in every indexed function."""
        for fi in self.functions.values():
            fi.calls = []
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    fi.calls.append(self._resolve_call(node, fi))

    def _resolve_call(self, node: ast.Call, fi: FunctionInfo) -> CallSite:
        mod = self.modules[fi.module]
        f = node.func
        chain = _attr_chain(f)
        label = ".".join(chain) if chain else _expr_label(f)

        if chain and len(chain) == 1:
            return self._resolve_bare(node, chain[0], fi, mod)
        if chain:
            return self._resolve_chain(node, chain, fi, mod)
        # call on a computed expression: `factory().verify(...)`
        if isinstance(f, ast.Attribute):
            return self._duck(node, f.attr, label)
        return CallSite(node.lineno, label, "unresolved")

    def _resolve_bare(self, node, name, fi, mod) -> CallSite:
        target = mod.functions.get(name)
        if target:
            return CallSite(node.lineno, name, "direct", (target,))
        if name in mod.classes:
            return self._ctor(node, name, mod.classes[name])
        imp = mod.imports.get(name)
        if imp:
            return self._resolve_imported(node, name, imp)
        if name in _BUILTIN_NAMES:
            return CallSite(node.lineno, name, "external")
        return CallSite(node.lineno, name, "unresolved")

    def _ctor(self, node, label, cls_info: ClassInfo) -> CallSite:
        init = cls_info.methods.get("__init__")
        if init:
            return CallSite(node.lineno, label, "class", (init,))
        # no local __init__: a constructor edge into the first
        # project-resolvable base's __init__ keeps the chain alive
        for base in self._iter_bases(cls_info):
            init = base.methods.get("__init__")
            if init:
                return CallSite(node.lineno, label, "class", (init,))
        return CallSite(node.lineno, label, "class", ())

    def _resolve_imported(self, node, label, target) -> CallSite:
        if target in self.modules:
            return CallSite(node.lineno, label, "external")  # module called?
        head, _, tail = target.rpartition(".")
        m = self.modules.get(head)
        if m is not None:
            if tail in m.functions:
                return CallSite(node.lineno, label, "alias",
                                (m.functions[tail],))
            if tail in m.classes:
                return self._ctor(node, label, m.classes[tail])
        if _is_project(target):
            return CallSite(node.lineno, label, "unresolved")
        return CallSite(node.lineno, label, "external")

    def _resolve_chain(self, node, chain, fi, mod) -> CallSite:
        root, attr = chain[0], chain[-1]
        label = ".".join(chain)

        if root in ("self", "cls") and fi.cls is not None:
            if len(chain) == 2:
                target = self._resolve_self_method(mod, fi.cls, attr)
                if target:
                    return CallSite(node.lineno, label, "self", (target,))
            # `self.attr.meth()` — dispatch through an attribute of
            # unknown type: duck-resolve on the method name
            return self._duck(node, attr, label)

        imp = mod.imports.get(root)
        if imp is not None:
            # walk the dotted chain into modules: `mod.sub.f()` /
            # `mod.Cls.meth()` / `mod.Cls()` — try the longest module
            # prefix first
            dotted = imp + "".join("." + c for c in chain[1:-1])
            m = self.modules.get(dotted)
            if m is not None:
                if attr in m.functions:
                    return CallSite(node.lineno, label, "alias",
                                    (m.functions[attr],))
                if attr in m.classes:
                    return self._ctor(node, label, m.classes[attr])
            # `from x import Cls; Cls.meth()` or `import x; x.Cls.meth()`
            cls_info = self._class_by_dotted(imp, chain[1:-1])
            if cls_info is not None:
                target = cls_info.methods.get(attr) or \
                    self._resolve_base_method(cls_info, attr)
                if target:
                    return CallSite(node.lineno, label, "class", (target,))
                return CallSite(node.lineno, label, "unresolved")
            if not _is_project(imp):
                return CallSite(node.lineno, label, "external")
            return self._duck(node, attr, label)

        if root in mod.classes and len(chain) == 2:
            cls_info = mod.classes[root]
            target = cls_info.methods.get(attr) or \
                self._resolve_base_method(cls_info, attr)
            if target:
                return CallSite(node.lineno, label, "class", (target,))

        if root in _BUILTIN_NAMES and root not in ("self", "cls"):
            return CallSite(node.lineno, label, "external")
        return self._duck(node, attr, label)

    def _class_by_dotted(self, imp: str, mids) -> Optional[ClassInfo]:
        """`imp` may already name a class (`from x import Cls`) or a
        module containing one (`import x; x.Cls.meth()`)."""
        if not mids:
            head, _, tail = imp.rpartition(".")
            m = self.modules.get(head)
            if m is not None and tail in m.classes:
                return m.classes[tail]
            return None
        dotted = imp + "".join("." + c for c in mids[:-1])
        m = self.modules.get(dotted)
        if m is not None and mids[-1] in m.classes:
            return m.classes[mids[-1]]
        return None

    def _resolve_self_method(self, mod: ModuleInfo, cls_name: str,
                             attr: str) -> Optional[str]:
        cls_info = mod.classes.get(cls_name)
        if cls_info is None:
            return None
        if attr in cls_info.methods:
            return cls_info.methods[attr]
        return self._resolve_base_method(cls_info, attr)

    def _resolve_base_method(self, cls_info: ClassInfo,
                             attr: str) -> Optional[str]:
        for base in self._iter_bases(cls_info):
            if attr in base.methods:
                return base.methods[attr]
        return None

    def _iter_bases(self, cls_info: ClassInfo, _seen=None):
        """Project-resolvable base classes, depth-first (the `self.meth`
        dispatch ladder; cycles guarded)."""
        _seen = _seen if _seen is not None else set()
        mod = self.modules.get(cls_info.module)
        for base_name in cls_info.bases:
            if not base_name or base_name in _seen:
                continue
            _seen.add(base_name)
            base = None
            if mod is not None and base_name in mod.classes:
                base = mod.classes[base_name]
            elif mod is not None:
                imp = mod.imports.get(base_name.split(".")[0])
                if imp is not None:
                    base = self._class_by_dotted(
                        imp, base_name.split(".")[1:])
            if base is not None:
                yield base
                yield from self._iter_bases(base, _seen)

    def _duck(self, node, attr: str, label: str) -> CallSite:
        if attr in DUCK_SKIP or attr.startswith("__"):
            return CallSite(node.lineno, label, "unresolved")
        candidates = self.methods_by_name.get(attr, ())
        if 0 < len(candidates) <= DUCK_FANOUT_MAX:
            return CallSite(node.lineno, label, "method",
                            tuple(candidates))
        return CallSite(node.lineno, label, "unresolved")

    # ------------------------------------------------------------ query

    def callees(self, qname: str) -> List[CallSite]:
        fi = self.functions.get(qname)
        return fi.calls if fi is not None else []

    def stats(self) -> dict:
        kinds: Dict[str, int] = {}
        n_calls = 0
        for fi in self.functions.values():
            for cs in fi.calls:
                n_calls += 1
                kinds[cs.kind] = kinds.get(cs.kind, 0) + 1
        resolvable = n_calls - kinds.get("external", 0)
        resolved = sum(v for k, v in kinds.items()
                       if k not in ("external", "unresolved"))
        return {
            "files": self.n_files,
            "modules": len(self.modules),
            "functions": len(self.functions),
            "classes": sum(len(m.classes) for m in self.modules.values()),
            "call_sites": n_calls,
            "by_kind": dict(sorted(kinds.items())),
            "resolution_rate": round(resolved / resolvable, 4)
            if resolvable else 0.0,
            "parse_errors": len(self.parse_errors),
        }


# ------------------------------------------------------------- helpers

def _collect_files(root: str, paths: Optional[Iterable[str]]):
    out = []
    for p in (paths if paths is not None else DEFAULT_SCAN):
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            out.append(full)
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", "_build"))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
    return out


def _attr_chain(expr: ast.AST) -> Optional[List[str]]:
    """`a.b.c` -> ["a", "b", "c"]; None when any link is not a plain
    Name/Attribute (subscripts, calls, literals)."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return list(reversed(parts))
    return None


def _expr_label(expr: ast.AST) -> str:
    if isinstance(expr, ast.Attribute):
        return f"<expr>.{expr.attr}"
    return type(expr).__name__


def _base_name(expr: ast.AST) -> str:
    chain = _attr_chain(expr)
    return ".".join(chain) if chain else ""


def _is_project(dotted: str) -> bool:
    return dotted.split(".")[0] in ("tendermint_tpu_torch", "chip_smoke")
