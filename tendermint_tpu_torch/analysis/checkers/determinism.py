"""determinism — no nondeterminism sources in consensus-critical code.

Scope: tendermint_tpu_torch/{consensus,types,state,ops}/ — the hashing,
voting and block-execution paths whose outputs must be byte-identical
across every node (the paper's core premise: a single divergent
timestamp or iteration order forks consensus).

Flags:
- wall-clock reads: time.time / time.time_ns / datetime.now / utcnow.
  Protocol timestamps must come from utils/clock.now_ns() — the one
  place tests and the chaos plane can substitute a deterministic or
  skewed source. Interval clocks (time.monotonic / perf_counter) are
  fine: they never become protocol data.
- unseeded module-level random.* calls (random.Random(seed) instances
  are fine — the chaos plane is built on them).
- iteration directly over a set expression (`for x in {…}` / `set(…)` /
  a set comprehension): set order is salted per process, so anything
  derived from it (hashes, vote order, wire bytes) diverges. Iterating
  a set VARIABLE is not flagged statically — wrap in sorted() when the
  order can reach protocol bytes.
"""

from __future__ import annotations

import ast

from tendermint_tpu_torch.analysis.engine import Checker, FileContext

SCOPE_PREFIXES = ("tendermint_tpu_torch/consensus/",
                  "tendermint_tpu_torch/types/",
                  "tendermint_tpu_torch/state/", "tendermint_tpu_torch/ops/")

_WALLCLOCK_TIME = {"time", "time_ns"}
_WALLCLOCK_DT = {"now", "utcnow", "today"}
_UNSEEDED_RANDOM = {"random", "randint", "randrange", "choice",
                    "choices", "shuffle", "sample", "uniform",
                    "getrandbits", "randbytes", "gauss"}


def _in_scope(rel: str) -> bool:
    return rel.replace("\\", "/").startswith(SCOPE_PREFIXES)


class DeterminismChecker(Checker):
    id = "determinism"
    events = (ast.ImportFrom, ast.Call, ast.For)

    def begin_file(self, ctx: FileContext) -> None:
        ctx.scratch[self.id] = {"time_names": set(), "dt_names": set(),
                                "rand_names": set()}

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if not _in_scope(ctx.rel):
            return
        s = ctx.scratch[self.id]
        if isinstance(node, ast.ImportFrom):
            # `from time import time` makes bare time() a wall-clock read
            for alias in node.names:
                name = alias.asname or alias.name
                if node.module == "time" and \
                        alias.name in _WALLCLOCK_TIME:
                    s["time_names"].add(name)
                if node.module == "datetime" and \
                        alias.name == "datetime":
                    s["dt_names"].add(name)
                if node.module == "random" and \
                        alias.name in _UNSEEDED_RANDOM:
                    s["rand_names"].add(name)
        elif isinstance(node, ast.Call):
            self._check_call(node, ctx, s)
        elif isinstance(node, ast.For):
            self._check_set_iter(node, ctx)

    def _check_call(self, node: ast.Call, ctx: FileContext, s) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            base, attr = f.value, f.attr
            if isinstance(base, ast.Name):
                if base.id == "time" and attr in _WALLCLOCK_TIME:
                    ctx.report(self.id, node,
                               f"wall-clock time.{attr}() in a "
                               f"consensus-critical path — protocol "
                               f"timestamps go through "
                               f"utils/clock.now_ns()")
                elif base.id == "random" and attr in _UNSEEDED_RANDOM:
                    ctx.report(self.id, node,
                               f"unseeded random.{attr}() in a "
                               f"consensus-critical path — use a "
                               f"seeded random.Random instance")
                elif attr in _WALLCLOCK_DT and (
                        base.id == "datetime" or
                        base.id in s["dt_names"]):
                    ctx.report(self.id, node,
                               f"wall-clock datetime {attr}() in a "
                               f"consensus-critical path — use "
                               f"utils/clock.now_ns()")
            elif isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "datetime" and \
                    base.attr == "datetime" and attr in _WALLCLOCK_DT:
                ctx.report(self.id, node,
                           f"wall-clock datetime.datetime.{attr}() — "
                           f"use utils/clock.now_ns()")
        elif isinstance(f, ast.Name):
            if f.id in s["time_names"]:
                ctx.report(self.id, node,
                           f"wall-clock {f.id}() (imported from time) — "
                           f"use utils/clock.now_ns()")
            elif f.id in s["rand_names"]:
                ctx.report(self.id, node,
                           f"unseeded {f.id}() (imported from random) — "
                           f"use a seeded random.Random instance")

    def _check_set_iter(self, node: ast.For, ctx: FileContext) -> None:
        it = node.iter
        direct_set = isinstance(it, (ast.Set, ast.SetComp)) or (
            isinstance(it, ast.Call) and
            isinstance(it.func, ast.Name) and it.func.id == "set")
        if direct_set:
            ctx.report(self.id, node,
                       "iterating a set expression: order is salted "
                       "per process — wrap in sorted() so derived "
                       "bytes are deterministic")
