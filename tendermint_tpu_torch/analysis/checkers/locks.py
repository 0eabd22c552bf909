"""lock-discipline — guarded attributes stay under their lock; threads
don't leak.

Two rules, both born from shipped bugs (a stats race, a two-reader
nonce interleave):

1. Guarded attributes. An attribute annotated at its birth assignment

       self._queue = []  #: guarded_by _cond

   may be read or written only lexically inside `with self._cond:`.
   Exemptions the codebase already relies on:
   - `__init__` (the object is not shared yet),
   - methods whose name ends in `_locked` (the caller-holds-the-lock
     convention, e.g. SecretConnection._read_frames_locked — the
     checker verifies the DISCIPLINE at the call boundary, the name
     documents the contract).
   Anything else needs a justified allow pragma for this checker.
   The annotations double as the runtime watch list: lockwatch's
   attribute watcher (analysis/lockwatch.py) installs descriptors for
   exactly these attrs under TM_CUDA_LOCKCHECK=on.

2. Thread lifecycle. Every `threading.Thread(...)` must either be
   daemon=True or be joined somewhere in its enclosing function (the
   connect-helper pattern) — a non-daemon, never-joined thread pins
   process exit and leaks across tests.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import List

from tendermint_tpu_torch.analysis.engine import (
    Checker,
    FileContext,
    parse_guard_annotations,
)


@dataclass
class _Access:
    cls: str
    attr: str
    line: int
    held: tuple
    func: str
    is_store: bool


class LockDisciplineChecker(Checker):
    id = "lock-discipline"
    events = (ast.Attribute, ast.Call)

    def begin_file(self, ctx: FileContext) -> None:
        ctx.scratch[self.id] = {
            "guards": {(a.cls, a.attr): a.lock
                       for a in parse_guard_annotations(ctx.source)},
            "accesses": [],
        }

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Call):
            self._check_thread(node, ctx)
            return
        if not (isinstance(node.value, ast.Name) and
                node.value.id == "self" and ctx.cls):
            return
        s = ctx.scratch[self.id]
        s["accesses"].append(_Access(
            ctx.cls, node.attr, node.lineno, tuple(ctx.held_locks),
            ctx.func_name or "", isinstance(node.ctx, ast.Store)))

    def end_file(self, ctx: FileContext) -> None:
        s = ctx.scratch[self.id]
        guards = s["guards"]
        if not guards:
            return
        for a in s["accesses"]:
            lock = guards.get((a.cls, a.attr))
            if lock is None:
                continue
            if a.func == "__init__" or a.func.endswith("_locked"):
                continue
            if lock in a.held:
                continue
            verb = "written" if a.is_store else "read"
            ctx.report(self.id, a.line,
                       f"{a.cls}.{a.attr} is guarded_by {lock} but "
                       f"{verb} outside `with self.{lock}:` (in "
                       f"{a.func or 'module scope'}) — hold the lock, "
                       f"or rename the method *_locked if the caller "
                       f"holds it")

    # -- thread lifecycle -------------------------------------------

    def _check_thread(self, node: ast.Call, ctx: FileContext) -> None:
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        if name != "Thread":
            return
        if isinstance(f, ast.Attribute) and not (
                isinstance(f.value, ast.Name) and
                f.value.id == "threading"):
            return  # some other .Thread attribute
        for kw in node.keywords:
            if kw.arg == "daemon" and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value is True:
                return
        # not daemon: accept if the enclosing function joins threads
        # (the start-then-join helper pattern)
        func = ctx.func
        if func is not None:
            for n in ast.walk(func):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "join":
                    return
        ctx.report(self.id, node,
                   "Thread is neither daemon=True nor joined in its "
                   "enclosing function — it will pin process exit "
                   "(join it in close()/stop(), or mark daemon)")
