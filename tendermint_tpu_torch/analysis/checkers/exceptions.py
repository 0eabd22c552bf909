"""exception-hygiene — reactor/dispatch loops must not swallow blind.

A broad handler (`except Exception:` / bare `except:`) that is
lexically inside a loop and whose body neither calls anything (no
logging, no telemetry counter bump, no cleanup call) nor re-raises is
an invisible failure treadmill: the send routine that dies a little on
every iteration, the reactor callback that never reports. The fix is
one line — log it or bump a counter — or narrow the except to the
exception actually expected (queue.Empty on a poll loop).

Handlers outside loops are not flagged (one-shot teardown guards are a
legitimate idiom), and neither are handlers that do ANY call — the
checker enforces visibility, not a logging framework.
"""

from __future__ import annotations

import ast

from tendermint_tpu_torch.analysis.engine import Checker, FileContext

_BROAD = ("Exception", "BaseException")


def _is_broad(type_node) -> bool:
    if type_node is None:
        return True  # bare except
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(e) for e in type_node.elts)
    return False


class ExceptionHygieneChecker(Checker):
    id = "exception-hygiene"
    events = (ast.ExceptHandler,)

    def visit(self, node: ast.ExceptHandler, ctx: FileContext) -> None:
        if ctx.loop_depth == 0 or not _is_broad(node.type):
            return
        for stmt in node.body:
            for n in ast.walk(stmt):
                if isinstance(n, (ast.Call, ast.Raise)):
                    return  # it does something visible
        ctx.report(self.id, node,
                   "broad except swallows silently inside a loop — "
                   "log it, bump a telemetry counter, or narrow to "
                   "the exception you actually expect")
