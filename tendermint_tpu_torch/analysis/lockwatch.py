"""lockwatch — the runtime lock-order watchdog: the port's copy of
`tendermint_tpu/analysis/lockwatch.py`.

With TM_CUDA_LOCKCHECK=on, `install()` replaces threading.Lock/RLock
with watched wrappers that

- record, per thread, the set of watched locks currently held, and on
  every acquire add `held-site -> acquired-site` edges to a global
  acquisition-order graph. A cycle in that graph (site A locked while
  holding B somewhere, B locked while holding A somewhere else) is a
  potential ABBA deadlock even if this run never interleaved fatally —
  `cycles()` reports them after the run.
- optionally install descriptors for `#: guarded_by` annotated
  attributes (`watch_annotated()`): a thread touching a guarded
  attribute of an instance another thread has used, without holding
  the guarding lock, is recorded as a violation (not raised — the run
  finishes and the report tells everything).

Locks are keyed by ALLOCATION SITE (file:line inside
tendermint_tpu_torch), not instance: two MConnection._cond instances are
the same node in the order graph, which is what makes cycles meaningful
across a fleet of peers. Same-site edges are ignored (peer-pair locks of
one class are ordered by address or protocol, which the graph cannot
see).

Locks created outside tendermint_tpu_torch (torch, stdlib pools) are
handed the real primitive untouched. Locks created BEFORE install()
(module-level registries) are not watched; install early (run_chaos
does it before building nodes).

ChaosNet doubles as the race harness: run_chaos() installs the watch
when the knob is on and embeds `report()` into its result.

The `#: guarded_by` annotations are read with the static engine's
`parse_guard_annotations` (analysis/engine.py), the one reader the
lock-discipline checker uses too.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from typing import Dict, List, Optional

from tendermint_tpu_torch.analysis.engine import parse_guard_annotations
from tendermint_tpu_torch.utils import knobs


def _original(name: str, fallback):
    """threading's own factory, or `fallback` when a lock watcher
    (this one, or the JAX package's in a process holding both) has
    replaced it."""
    f = getattr(threading, name)
    return fallback if f.__name__.startswith("lockwatch_") else f


_real_Lock = _original("Lock", _thread.allocate_lock)
_real_RLock = _original("RLock", threading._CRLock or threading._PyRLock)

_PKG_MARKER = os.sep + "tendermint_tpu_torch" + os.sep
_THREADING_FILE = threading.__file__


class _TLS(threading.local):
    def __init__(self):
        self.held: List["_WatchedLock"] = []


_tls = _TLS()


class _State:
    def __init__(self):
        self.lock = _real_Lock()
        # site -> {other_site: (thread_name,)} — first-seen edge info
        self.edges: Dict[str, Dict[str, tuple]] = {}
        self.n_locks = 0
        self.installed = False
        self.attr_violations: List[dict] = []
        self.watched_classes: List[tuple] = []  # (cls, [attr])


_state = _State()


def enabled() -> bool:
    return knobs.knob_bool("TM_CUDA_LOCKCHECK", default=False)


# ---------------------------------------------------------------- wrapper


class _WatchedLock:
    """Wraps a real Lock/RLock; speaks enough of the protocol for
    threading.Condition to use it as its underlying lock (acquire /
    release / _is_owned / _release_save / _acquire_restore)."""

    def __init__(self, inner, site: str, kind: str):
        self._inner = inner
        self.site = site
        self.kind = kind

    # -- bookkeeping --------------------------------------------------

    def _record_acquired(self) -> None:
        held = _tls.held
        if self not in held:
            me = threading.current_thread().name
            with _state.lock:
                for h in held:
                    if h.site != self.site:
                        _state.edges.setdefault(
                            h.site, {}).setdefault(self.site, (me,))
        held.append(self)

    def _forget(self, all_entries: bool = False) -> int:
        held = _tls.held
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                n += 1
                if not all_entries:
                    break
        return n

    # -- lock protocol ------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._record_acquired()
        return ok

    def release(self) -> None:
        self._inner.release()
        self._forget()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration ---------------------------------------
    # Condition.wait() releases the lock behind our back unless these
    # exist; they keep the held-set honest across waits.

    def _release_save(self):
        if hasattr(self._inner, "_release_save"):  # RLock: full unwind
            state = self._inner._release_save()
            n = self._forget(all_entries=True)
            return ("r", state, n)
        self._inner.release()
        n = self._forget(all_entries=True)
        return ("p", None, n)

    def _acquire_restore(self, saved) -> None:
        kind, state, n = saved
        if kind == "r":
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._record_acquired()
        for _ in range(n - 1):
            _tls.held.append(self)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain-Lock heuristic (same one threading.Condition uses)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def held_by_me(self) -> bool:
        return self in _tls.held

    def __repr__(self) -> str:
        return f"<lockwatch {self.kind} {self.site}>"


def _caller_site() -> Optional[str]:
    """Allocation site inside tendermint_tpu_torch, or None for foreign
    locks.
    One threading.Condition.__init__ hop is looked through (a bare
    `threading.Condition()` allocates its RLock from threading.py)."""
    f = sys._getframe(2)  # past factory + this helper's caller
    hops = 0
    while f is not None and hops < 4:
        fn = f.f_code.co_filename
        if fn == _THREADING_FILE:
            is_cond = type(f.f_locals.get("self")).__name__ == "Condition"
            if not is_cond:
                return None  # Thread/Event internals: not our lock
            f = f.f_back
            hops += 1
            continue
        if _PKG_MARKER in fn or fn.endswith("tendermint_tpu_torch"):
            short = fn.split(_PKG_MARKER)[-1] if _PKG_MARKER in fn else fn
            return f"{short}:{f.f_lineno}"
        return None
    return None


def _watched_factory(kind: str, real):
    def factory():
        lock = real()
        site = _caller_site()
        if site is None:
            return lock
        with _state.lock:
            _state.n_locks += 1
        return _WatchedLock(lock, site, kind)
    factory.__name__ = f"lockwatch_{kind}"
    return factory


def make_lock(kind: str = "Lock", site: Optional[str] = None):
    """An explicitly watched lock regardless of allocation site — for
    unit tests and ad-hoc harnesses outside the package tree."""
    real = _real_RLock if kind == "RLock" else _real_Lock
    if site is None:
        f = sys._getframe(1)
        site = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    with _state.lock:
        _state.n_locks += 1
    return _WatchedLock(real(), site, kind)


# ---------------------------------------------------------------- control


def install() -> None:
    """Start watching lock creation (idempotent). Only locks allocated
    from tendermint_tpu_torch code after this call are wrapped."""
    with _state.lock:
        if _state.installed:
            return
        _state.installed = True
    threading.Lock = _watched_factory("Lock", _real_Lock)
    threading.RLock = _watched_factory("RLock", _real_RLock)


def uninstall() -> None:
    """Restore the real primitives. Already-wrapped locks keep working
    (they delegate); the recorded graph survives until clear()."""
    threading.Lock = _real_Lock
    threading.RLock = _real_RLock
    with _state.lock:
        _state.installed = False
    _unwatch_classes()


def clear() -> None:
    with _state.lock:
        _state.edges.clear()
        _state.n_locks = 0
        _state.attr_violations.clear()


def maybe_install() -> bool:
    if enabled():
        install()
        watch_annotated()
        return True
    return False


# ---------------------------------------------------------------- analysis


def cycles() -> List[List[str]]:
    """Cycles in the site-order graph (Tarjan SCCs with >1 node). Each
    is a list of sites that lock each other in both orders somewhere —
    a potential deadlock even if no run has interleaved fatally yet."""
    with _state.lock:
        graph = {a: list(bs) for a, bs in _state.edges.items()}
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan (chaos graphs are small, but recursion depth
        # is the caller's stack, not ours to spend)
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            advanced = False
            succs = graph.get(node, ())
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    out.append(sorted(scc))
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for v in graph:
        if v not in index:
            strongconnect(v)
    return out


def report() -> dict:
    with _state.lock:
        edges = [{"from": a, "to": b, "thread": info[0]}
                 for a, bs in sorted(_state.edges.items())
                 for b, info in sorted(bs.items())]
        violations = list(_state.attr_violations)
        n_locks = _state.n_locks
    return {"locks_watched": n_locks, "edges": edges,
            "cycles": cycles(), "attr_violations": violations}


# ------------------------------------------------------- guarded attrs


class _GuardedAttr:
    """Data descriptor enforcing `#: guarded_by` at runtime: a touch
    from a second thread without the guarding lock held is recorded
    (never raised). Storage stays in the instance dict under the SAME
    name (a data descriptor shadows the dict on lookup but can use it
    as its backing store), so instances created before the watch — and
    instances outliving it — see a seamless attribute."""

    def __init__(self, name: str, lockname: str, clsname: str):
        self.name = name
        self.lockname = lockname
        self.clsname = clsname
        self.owner_slot = "_lockwatch$owner$" + name

    def _check(self, obj) -> None:
        lock = getattr(obj, self.lockname, None)
        if isinstance(lock, threading.Condition):
            lock = lock._lock  # guarded_by _cond means the cond's lock
        if not isinstance(lock, _WatchedLock):
            # pre-install or foreign lock: we cannot see whether it is
            # held, so enforcing would only produce false positives
            # (instances created before install() keep working quietly)
            return
        if lock.held_by_me():
            return
        me = threading.get_ident()
        owner = obj.__dict__.get(self.owner_slot)
        if owner is None:
            obj.__dict__[self.owner_slot] = me
            return
        if owner != me:
            with _state.lock:
                if len(_state.attr_violations) < 200:
                    _state.attr_violations.append({
                        "class": self.clsname, "attr": self.name,
                        "lock": self.lockname,
                        "thread": threading.current_thread().name})

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj)
        try:
            return obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value) -> None:
        self._check(obj)
        obj.__dict__[self.name] = value

    def __delete__(self, obj) -> None:
        obj.__dict__.pop(self.name, None)


#: modules whose guarded_by annotations get runtime enforcement under
#: watch_annotated() — the concurrency-heavy planes
WATCH_MODULES = (
    "tendermint_tpu_torch.models.coalescer",
    "tendermint_tpu_torch.models.verifier",
    "tendermint_tpu_torch.p2p.conn.mconn",
    "tendermint_tpu_torch.p2p.conn.secret",
)


def watch_annotated(module_names=WATCH_MODULES) -> int:
    """Install guarded-attr descriptors for every `#: guarded_by`
    annotation in `module_names`. Returns how many attrs are watched.
    Reversed by uninstall()/unwatch."""
    import importlib
    import inspect

    n = 0
    for mod_name in module_names:
        mod = importlib.import_module(mod_name)
        try:
            anns = parse_guard_annotations(inspect.getsource(mod))
        except OSError:
            continue
        for a in anns:
            cls = getattr(mod, a.cls, None)
            if cls is None or isinstance(
                    cls.__dict__.get(a.attr), _GuardedAttr):
                continue
            if hasattr(cls, "__slots__"):
                continue  # a descriptor would shadow the slot
            setattr(cls, a.attr, _GuardedAttr(a.attr, a.lock, a.cls))
            with _state.lock:
                _state.watched_classes.append((cls, a.attr))
            n += 1
    return n


def _unwatch_classes() -> None:
    with _state.lock:
        watched, _state.watched_classes = _state.watched_classes, []
    for cls, attr in watched:
        if isinstance(cls.__dict__.get(attr), _GuardedAttr):
            delattr(cls, attr)
