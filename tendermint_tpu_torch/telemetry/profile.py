"""Sampling profiler — dep-free thread-granularity CPU attribution.

The causal spans say WHICH consensus stages dominate a height's
wall-clock; they cannot say WHY — which threads burn the CPU inside a
stage, which locks serialize the reactor plane. The reference stack
leans on Go's built-in pprof for that question; this module is the
Python rebuild's equivalent, with the same zero-dependency discipline
as the metrics registry:

- a daemon thread walks ``sys._current_frames()`` at a knob-controlled
  rate (TM_CUDA_PROF_HZ, default 13 Hz — a sweep over a node's ~40
  threads costs ~0.7ms, so the default keeps even FOUR nodes sharing
  one core under ~4% total, and a one-node-per-core deployment under
  1%; raise it for short windows) and classifies every live thread's
  stack. Holding the GIL during the walk makes each sweep a
  consistent snapshot; the sweep's own cost is measured into
  ``tmcuda_prof_sweep_seconds`` so the overhead claim is itself observable.
- samples attribute to SUBSYSTEMS by module path: the innermost frame
  inside the ``tendermint_tpu_torch`` package names the subsystem (its first
  path component — ``consensus/state.py`` -> ``consensus``; top-level
  modules attribute by stem — ``node.py`` -> ``node``). Stacks that
  never enter the package (library internals, scripts) are ``other``.
- LOCK-WAIT attribution: a leaf frame executing inside ``threading.py``
  (Condition.wait, Lock-via-wait, queue.get's wait) or ``selectors.py``
  (the RPC accept loop) is a BLOCKED thread, not a busy one. Those
  samples are excluded from the CPU-share counters and charged to
  ``tmcuda_prof_lock_wait_samples_total{subsystem}`` against the nearest
  in-tree frame — the "which lock serializes the reactor plane"
  evidence. Python can't see threads parked in C calls (socket.recv
  shows its CALLER's frame), so shares are wall-clock for C-blocked
  threads; the known-idle markers remove the dominant Python-visible
  parks.
- collapsed-stack output (``root;frame;frame N`` lines, one per
  distinct stack, flamegraph.pl / speedscope format) with a hard cap
  on distinct stacks — overflow aggregates under a ``(truncated)``
  frame and counts ``tmcuda_prof_stacks_dropped_total``, so a pathological
  workload can't grow the table without bound.

Everything is gated on TM_CUDA_PROF (env > config.base.prof > off).
Off means: no thread, and every entry point is one flag check — the
consensus hot path is byte-for-byte unprofiled (test-asserted).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.utils import knobs

_m_samples = telemetry.counter(
    "prof_samples_total",
    "Profiler samples attributed to busy (non-wait) stacks",
    ("subsystem", "thread"))
_m_lock_wait = telemetry.counter(
    "prof_lock_wait_samples_total",
    "Profiler samples parked in threading/selector waits, charged to "
    "the nearest in-tree frame", ("subsystem",))
_m_sweep = telemetry.histogram(
    "prof_sweep_seconds",
    "Cost of one profiler sweep over every live thread",
    buckets=(.0001, .00025, .0005, .001, .0025, .005, .01, .05))
_m_dropped = telemetry.counter(
    "prof_stacks_dropped_total",
    "Distinct stacks aggregated into the (truncated) bucket at the "
    "table cap")
_m_threads = telemetry.gauge(
    "prof_threads", "Threads seen by the last profiler sweep")

DEFAULT_HZ = 13.0  # prime: avoids lockstep with periodic pollers
MAX_STACKS = 8192
MAX_DEPTH = 48

# Leaf frames in these files are Python-visible thread parks, not CPU
# burn: Condition.wait / Event.wait / queue.get spin inside
# threading.py; the RPC accept loop sits in selectors.py/socketserver;
# concurrent.futures workers park in thread.py on a C-level
# SimpleQueue.get; a leaf in socket.py is a blocking accept/recv/
# connect (C call under a socket.py wrapper frame).
_WAIT_FILES = ("threading.py", "selectors.py", "socketserver.py",
               "queue.py", "thread.py", "socket.py")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) \
    + os.sep

# The async reactor core's machinery files are TRANSPARENT to
# attribution: a consensus gossip pass or an RPC handler running as a
# loop callback must charge its samples to consensus/rpc, not to one
# opaque bucket under the loop's module path. Frames in these files
# never claim the subsystem; when a stack never leaves them (selector
# dispatch, seal/flush bookkeeping) the ``__owner__`` tag carried by
# ReactorLoop._invoke names the subsystem that scheduled the callback,
# and a stack with neither (the idle select park) lands in ``loop``.
# They are the port's own files, matched on the whole path: the JAX
# package's loop (its directory shares the prefix `tendermint_tpu`) is a
# foreign file here, so a mixed in-process net charges it to `other`.
_LOOP_FILES = (_PKG_DIR + os.path.join("p2p", "conn", "loop.py"),
               _PKG_DIR + os.path.join("rpc", "aserver.py"))


def _is_loop_file(filename: str) -> bool:
    return filename in _LOOP_FILES

# config.base.prof / prof_hz snapshot (node.py configure()); env wins
# inside enabled()/default_hz(), so bare components honor the knobs too.
_configured = "off"
_configured_hz = 0.0


def configure(mode: str = "off", hz: float = 0.0) -> None:
    global _configured, _configured_hz
    _configured = str(mode or "off").strip().lower()
    _configured_hz = float(hz or 0.0)


def enabled() -> bool:
    """True when the profiler auto-starts with the node. env
    TM_CUDA_PROF > config.base.prof > default off."""
    return knobs.knob_str("TM_CUDA_PROF", config=_configured,
                          default="off") not in knobs.FALSY


def default_hz() -> float:
    hz = knobs.knob_float("TM_CUDA_PROF_HZ",
                          config=_configured_hz or None,
                          default=DEFAULT_HZ)
    return hz if hz > 0 else DEFAULT_HZ


def _normalize_thread(name: str) -> str:
    """Bound the thread label's cardinality: strip the per-instance
    decorations CPython and our pools append ('Thread-12 (worker)' ->
    'Thread', 'tm-verify-fetch-3' -> 'tm-verify-fetch')."""
    name = name.split(" (", 1)[0]
    base = name.rstrip("0123456789").rstrip("-_")
    return base or name


def _subsystem_of(filename: str) -> Optional[str]:
    """Subsystem for an in-package frame, None for foreign files."""
    if not filename.startswith(_PKG_DIR):
        return None
    rel = filename[len(_PKG_DIR):]
    head, sep, _ = rel.partition(os.sep)
    if sep:  # package subdirectory: telemetry/, consensus/, p2p/, ...
        return head
    return head[:-3] if head.endswith(".py") else head  # node.py etc.


class SamplingProfiler:
    """One process-wide sampler. start()/stop() are idempotent; the
    sample table survives stop() so a post-mortem (stall flight
    recorder, RPC dump) reads whatever was collected."""

    def __init__(self, hz: Optional[float] = None,
                 max_stacks: int = MAX_STACKS):
        self.hz = float(hz) if hz else default_hz()
        if self.hz <= 0:
            raise ValueError(f"profiler hz must be > 0, got {self.hz}")
        self.max_stacks = max_stacks
        self._lock = threading.Lock()
        self._stacks: Dict[Tuple[str, ...], int] = {}  #: guarded_by _lock
        self._subsys: Dict[str, int] = {}              #: guarded_by _lock
        self._waits: Dict[str, int] = {}               #: guarded_by _lock
        self._samples = 0                              #: guarded_by _lock
        self._wait_samples = 0                         #: guarded_by _lock
        self._dropped = 0                              #: guarded_by _lock
        self._sweeps = 0                               #: guarded_by _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_ns = 0
        self._last_threads = 0   # last sweep's live-thread count

    # ------------------------------------------------------------ control

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._started_ns = time.time_ns()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tm-prof-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def clear(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._subsys.clear()
            self._waits.clear()
            self._samples = self._wait_samples = 0
            self._dropped = self._sweeps = 0

    # ----------------------------------------------------------- sampling

    def _run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            t0 = time.perf_counter()
            try:
                self._sweep()
            except Exception as e:
                # a dying interpreter/thread race must not kill the
                # sampler; note it and keep sampling
                from tendermint_tpu_torch.utils.log import get_logger
                get_logger("telemetry").debug("profiler sweep failed",
                                              err=repr(e))
            if telemetry.enabled():
                _m_sweep.observe(time.perf_counter() - t0)

    def _sweep(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        n_threads = 0
        for tid, frame in frames.items():
            if tid == me:
                continue
            n_threads += 1
            self._record(frame,
                         _normalize_thread(names.get(tid, "?")))
        self._last_threads = n_threads
        _m_threads.set(n_threads)

    def _record(self, frame, thread: str) -> None:
        stack: List[str] = []
        subsystem = None
        owner = None
        saw_loop = False
        leaf_file = frame.f_code.co_filename
        is_wait = os.path.basename(leaf_file) in _WAIT_FILES
        depth = 0
        while frame is not None and depth < MAX_DEPTH:
            code = frame.f_code
            if subsystem is None:
                if _is_loop_file(code.co_filename):
                    saw_loop = True
                    if owner is None and code.co_name == "_invoke":
                        owner = frame.f_locals.get("__owner__")
                else:
                    subsystem = _subsystem_of(code.co_filename)
            mod = os.path.basename(code.co_filename)
            if mod.endswith(".py"):
                mod = mod[:-3]
            stack.append(f"{mod}.{code.co_name}")
            frame = frame.f_back
            depth += 1
        subsystem = subsystem or owner or \
            ("loop" if saw_loop else None) or "other"
        stack.reverse()  # collapsed format is root -> leaf
        if is_wait:
            stack.append("[lock_wait]")
        key = (thread, *stack)
        with self._lock:
            self._sweeps += 1
            if is_wait:
                self._wait_samples += 1
                self._waits[subsystem] = \
                    self._waits.get(subsystem, 0) + 1
            else:
                self._samples += 1
                self._subsys[subsystem] = \
                    self._subsys.get(subsystem, 0) + 1
            if key not in self._stacks and \
                    len(self._stacks) >= self.max_stacks:
                key = (thread, "(truncated)")
                self._dropped += 1
                _m_dropped.inc()
            self._stacks[key] = self._stacks.get(key, 0) + 1
        if is_wait:
            _m_lock_wait.labels(subsystem).inc()
        else:
            _m_samples.labels(subsystem, thread).inc()

    # ------------------------------------------------------------- output

    def collapsed(self) -> str:
        """Flamegraph collapsed-stack text: ``thread;root;..;leaf N``
        per distinct stack (wait stacks carry a [lock_wait] leaf)."""
        with self._lock:
            items = sorted(self._stacks.items())
        return "\n".join(f"{';'.join(k)} {n}" for k, n in items)

    def subsystem_shares(self) -> Dict[str, float]:
        """Busy-sample share per subsystem (sums to ~1.0)."""
        with self._lock:
            total = self._samples
            counts = dict(self._subsys)
        if not total:
            return {}
        return {s: round(n / total, 4)
                for s, n in sorted(counts.items(),
                                   key=lambda kv: -kv[1])}

    def top(self, n: int = 5) -> List[Tuple[str, float]]:
        return list(self.subsystem_shares().items())[:n]

    def snapshot(self) -> dict:
        """JSON-able dump: the RPC ``debug_profile dump`` payload, the
        stall flight recorder's embedded profile, and the input shape
        ``merge_dumps`` consumes."""
        with self._lock:
            doc = {
                "hz": self.hz,
                "running": self.running,
                "samples": self._samples,
                "wait_samples": self._wait_samples,
                "stacks": len(self._stacks),
                "stacks_dropped": self._dropped,
                "subsystems": dict(self._subsys),
                "lock_wait": dict(self._waits),
                "n_threads": self._last_threads,
            }
        doc["shares"] = self.subsystem_shares()
        doc["collapsed"] = self.collapsed()
        doc["started_ns"] = self._started_ns
        doc["wall_ns"] = time.time_ns()
        return doc


# ------------------------------------------------------------- singleton

_prof_lock = threading.Lock()
_prof: Optional[SamplingProfiler] = None    #: guarded_by _prof_lock


def get() -> Optional[SamplingProfiler]:
    with _prof_lock:
        return _prof


def start(hz: Optional[float] = None) -> SamplingProfiler:
    """Start (or return the already-running) process profiler."""
    global _prof
    with _prof_lock:
        if _prof is not None and _prof.running:
            return _prof
        if _prof is None or (hz and _prof.hz != float(hz)):
            _prof = SamplingProfiler(hz=hz)
        _prof.start()
        return _prof


def stop() -> Optional[SamplingProfiler]:
    """Stop sampling; the table stays readable for dumps."""
    with _prof_lock:
        p = _prof
    if p is not None:
        p.stop()
    return p


def maybe_start() -> Optional[SamplingProfiler]:
    """node.py boot hook: start only when the knob says so."""
    if not enabled():
        return None
    return start()


def snapshot() -> dict:
    """The process profiler's state, {} while never started — safe to
    embed unconditionally (healthz, stall dumps)."""
    p = get()
    if p is None:
        return {"enabled": enabled(), "running": False, "samples": 0}
    doc = p.snapshot()
    doc["enabled"] = enabled()
    return doc


# ---------------------------------------------------------------- merging

def merge_dumps(dumps: List[dict]) -> dict:
    """N per-node ``debug_profile dump`` payloads -> one cluster
    profile: collapsed stacks re-rooted under ``node:<id>`` frames
    (one flamegraph, one tree per node), subsystem totals summed, and
    cluster-wide shares recomputed over every busy sample."""
    collapsed: List[str] = []
    subsys: Dict[str, int] = {}
    waits: Dict[str, int] = {}
    samples = waits_total = 0
    nodes = []
    threads_per_node: Dict[str, int] = {}
    for d in dumps:
        prof = d.get("profile", d)  # RPC envelope or bare snapshot
        node = str(d.get("node", "") or f"n{len(nodes)}")
        nodes.append(node)
        if prof.get("n_threads"):
            threads_per_node[node] = int(prof["n_threads"])
        for line in (prof.get("collapsed") or "").splitlines():
            if line.strip():
                collapsed.append(f"node:{node};{line}")
        for s, n in (prof.get("subsystems") or {}).items():
            subsys[s] = subsys.get(s, 0) + int(n)
        for s, n in (prof.get("lock_wait") or {}).items():
            waits[s] = waits.get(s, 0) + int(n)
        samples += int(prof.get("samples", 0))
        waits_total += int(prof.get("wait_samples", 0))
    shares = {}
    if samples:
        shares = {s: round(n / samples, 4)
                  for s, n in sorted(subsys.items(),
                                     key=lambda kv: -kv[1])}
    return {"nodes": nodes, "samples": samples,
            "wait_samples": waits_total, "subsystems": subsys,
            "lock_wait": waits, "shares": shares,
            "threads_per_node": threads_per_node,
            "collapsed": "\n".join(collapsed)}
