"""Lightweight tracing — a bounded in-memory event ring dumpable as
Chrome-trace JSON (chrome://tracing / Perfetto "traceEvents" format).

The consensus state machine records its per-height/round timeline here
(one complete event per step interval, one instant per committed block);
the verifier records dispatch spans. Everything is gated on the same
process-wide enabled flag as the metrics registry, so `TM_CUDA_TELEMETRY=
off` makes a span a single flag check.

Timestamps are perf_counter-relative microseconds (Chrome trace's native
unit); `pid` is the real process id so multi-node testnet dumps can be
merged by concatenating traceEvents.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

from tendermint_tpu_torch.telemetry.registry import _state

# Default ring capacity: one consensus step is ~5 events; 65536 holds a
# few thousand heights of timeline before the oldest roll off.
DEFAULT_CAPACITY = 65536

# Ring overflow accounting, shared with the causal span ring
# (telemetry/causal.py): long soaks stay bounded BY DESIGN, and the
# counter is how a dump consumer learns its window was truncated.
from tendermint_tpu_torch.telemetry.registry import REGISTRY as _REGISTRY

_m_dropped = _REGISTRY.counter(
    "trace_events_dropped_total",
    "Trace ring events displaced by the capacity cap "
    "(Chrome tracer + causal span ring)", ())


def note_dropped(n: int = 1) -> None:
    _m_dropped.inc(n)


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        # explicit cap + drop accounting, NOT deque(maxlen): maxlen
        # evicts silently, and a week-long soak whose ring wrapped looks
        # exactly like a quiet node unless the drops are counted
        self._events: deque = deque()        #: guarded_by _lock
        self._capacity = max(1, int(capacity))
        self.dropped = 0                     #: guarded_by _lock
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _append_locked(self, ev: dict) -> None:
        if len(self._events) >= self._capacity:
            self._events.popleft()
            self.dropped += 1
            note_dropped()
        self._events.append(ev)

    # ------------------------------------------------------------ record

    def _ts_us(self, t_s: float) -> float:
        return (t_s - self._t0) * 1e6

    def instant(self, name: str, **args) -> None:
        """One point-in-time marker ("i" phase)."""
        if not _state.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": self._ts_us(time.perf_counter()),
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._append_locked(ev)

    def complete(self, name: str, start_s: float, end_s: float,
                 **args) -> None:
        """One complete ("X") event from perf_counter() start/end stamps
        — the shape callers use when the interval isn't a `with` block
        (consensus step intervals close when the NEXT step begins)."""
        if not _state.enabled:
            return
        ev = {"name": name, "ph": "X",
              "ts": self._ts_us(start_s),
              "dur": max(0.0, (end_s - start_s) * 1e6),
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._append_locked(ev)

    @contextmanager
    def _span_cm(self, name: str, args: dict):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.complete(name, t0, time.perf_counter(), **args)

    def span(self, name: str, **args):
        """Context manager timing a block as one complete event."""
        if not _state.enabled:
            return _NULL_SPAN
        return self._span_cm(name, args)

    # ------------------------------------------------------------- dump

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def chrome_trace(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        """Write the Chrome-trace JSON; returns the path. Loadable in
        chrome://tracing or https://ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# Process-wide tracer (the consensus timeline all nodes in-process share;
# events carry pid/tid so merged timelines stay distinguishable).
TRACER = Tracer()


def span(name: str, **args):
    return TRACER.span(name, **args)


def instant(name: str, **args) -> None:
    TRACER.instant(name, **args)


def dump_trace(path: str) -> str:
    return TRACER.dump(path)
