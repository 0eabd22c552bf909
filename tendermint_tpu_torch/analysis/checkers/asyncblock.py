"""async-blocking — no blocking calls inside loop-marked modules.

The async reactor core (p2p/conn/loop.py) runs every peer socket, gossip
routine and RPC connection of a node on ONE event loop thread; a single
blocking call there stalls the whole node. This checker makes that a
lint invariant instead of a code-review hope: any module that declares

    TMLINT_LOOP_MODULE = True

at module level gets every *potentially blocking* call flagged:

- ``time.sleep(...)``
- blocking socket ops: ``.recv`` / ``.recv_into`` / ``.accept`` /
  ``.sendall`` / ``.connect`` / ``.makefile``
- thread parks: ``.wait`` / ``.wait_for`` (Condition/Event),
  ``selector.select``
- blocking ``Queue.get``: any ``.get(...)`` whose receiver looks like a
  queue (name contains "queue"/"q") or that passes ``block=``/
  ``timeout=``

Legitimate sites — the loop's own select, O_NONBLOCK socket calls that
cannot park, waits provably reachable only from non-loop threads — are
suppressed with the standard justified pragma
(``tmlint: allow(async-blocking): why this cannot block the loop``),
which keeps every exemption visible, justified, and counted against
the tree's pragma budget.
"""

from __future__ import annotations

import ast

from tendermint_tpu_torch.analysis.engine import Checker, FileContext

_SOCKET_ATTRS = frozenset((
    "recv", "recv_into", "recv_multi", "accept", "sendall", "connect",
    "makefile"))
_WAIT_ATTRS = frozenset(("wait", "wait_for", "select"))


def _receiver_name(node: ast.AST) -> str:
    """Best-effort name of a call receiver: `self._queue.get` ->
    '_queue', `q.get` -> 'q'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class AsyncBlockingChecker(Checker):
    id = "async-blocking"
    events = (ast.Assign, ast.Call)

    def begin_file(self, ctx: FileContext) -> None:
        ctx.scratch[self.id] = False

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Assign):
            # the module marker must be a top-level assignment (outside
            # any class/function), conventionally right after imports
            if ctx.func is None and not ctx.class_stack and any(
                    isinstance(t, ast.Name) and
                    t.id == "TMLINT_LOOP_MODULE" for t in node.targets):
                ctx.scratch[self.id] = True
            return
        if not ctx.scratch.get(self.id):
            return
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            return
        attr = fn.attr
        if attr == "sleep" and isinstance(fn.value, ast.Name) and \
                fn.value.id == "time":
            ctx.report(self.id, node,
                       "time.sleep inside a loop-marked module blocks "
                       "the whole reactor")
        elif attr in _SOCKET_ATTRS:
            ctx.report(self.id, node,
                       f"blocking socket call .{attr}() inside a "
                       f"loop-marked module (use the non-blocking loop "
                       f"path, or pragma with the O_NONBLOCK proof)")
        elif attr in _WAIT_ATTRS:
            ctx.report(self.id, node,
                       f".{attr}() parks the calling thread — the "
                       f"reactor loop must never wait here")
        elif attr == "get":
            kw = {k.arg for k in node.keywords}
            recv = _receiver_name(fn.value).lower()
            if ("block" in kw or "timeout" in kw or
                    "queue" in recv or recv in ("q", "_q")):
                ctx.report(self.id, node,
                           "blocking Queue.get inside a loop-marked "
                           "module (drain with get_nowait on the loop)")
