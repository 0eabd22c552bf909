"""Dispatch coalescer — cross-call dynamic micro-batching for the
BatchVerifier: the port's copy of `tendermint_tpu/models/coalescer.py`.

In live consensus votes arrive one at a time from many peer and reactor
threads, each a verify call of 1-4 signatures. Calls of at most the
verifier's auto threshold enqueue their items here and get back a
resolver; a dispatcher thread drains the queue, forms ONE merged batch a
window, hands it to the verifier's direct dispatch path (which routes it
as any call: host loop below the auto threshold, the verify kernels
above or on the "cuda" backend, secp256k1 split to the host) and demuxes
the verdicts back to each caller by its slice.

Batching policy (the verifier's `coalesce_wait_ms` / `coalesce_max_batch`,
config `base.verifier_coalesce_*`):

  - The dispatcher wakes on the first arrival and then lingers only
    while traffic is dense: it keeps collecting until no new call has
    arrived for ~4x the EWMA inter-arrival gap, capped at max_wait from
    the first drain, or until max_batch items are queued. A solo
    sequential caller, whose gap is its own verify latency and so above
    the cap, dispatches at once and pays only a thread handoff.

Per-call error semantics hold by ISOLATION FALLBACK: if the merged
dispatch or its resolve raises, every call is re-dispatched alone on the
same path (same device, same kernel), so one caller's malformed items
surface as that caller's exception, and a device failure (VerifierError)
reaches every caller of the merge. Nothing falls back to the host.

The JAX package's telemetry families (`verifier_coalesce_*`) are fed at
the same points as the plain counts of `stats`: submissions, merged
dispatches, the calls they merged (sum and maximum) and their items
(maximum), fallbacks and the calls they re-dispatched, and the queue
depth at a drain (maximum). Every submission is in exactly one merge, so
`merged_calls` equals `submissions` once the queue is drained, and the
direct path runs `dispatches + isolated_calls` times. The queue is
registered with the queue observatory as `verifier.coalesce`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.telemetry import queues as queue_obs

# The coalesce factor is coalesce_calls_total / dispatches_total, or the
# mean of the batch_calls histogram over a scrape window.
_m_calls = telemetry.counter(
    "verifier_coalesce_calls_total",
    "verify calls routed through the dispatch coalescer")
_m_dispatches = telemetry.counter(
    "verifier_coalesce_dispatches_total",
    "Merged dispatches formed by the coalescer")
_m_factor = telemetry.histogram(
    "verifier_coalesce_batch_calls",
    "verify() calls merged into one coalesced dispatch",
    buckets=telemetry.POW2_BUCKETS)
_m_queue = telemetry.histogram(
    "verifier_coalesce_queue_depth",
    "Calls pending in the coalescer queue at first drain",
    buckets=telemetry.POW2_BUCKETS)
_m_wait = telemetry.histogram(
    "verifier_coalesce_wait_seconds",
    "Per-call wait from submit to merged dispatch",
    buckets=(.0002, .0005, .001, .002, .004, .008, .016, .05, .1, .5))
_m_fallback = telemetry.counter(
    "verifier_coalesce_fallback_total",
    "Merged dispatches re-run per-call for error isolation")


class _Merged:
    """Shared result of one merged dispatch. The dispatcher never waits
    for the verdicts: the FIRST caller to resolve materializes the merged
    array (under a once-lock), every other caller slices it. A failure
    demotes the whole merge to per-call dispatches."""

    __slots__ = ("_dispatch", "calls", "_resolver", "_per", "_value",
                 "_done", "_lock", "_on_isolate")

    def __init__(self, dispatch: Callable, calls: list,
                 on_isolate: Callable[[int], None]):
        self._dispatch = dispatch
        self.calls = calls
        self._resolver = None
        self._per = None      # per-call (kind, payload) after fallback
        self._value = None
        self._done = False
        self._lock = threading.Lock()
        self._on_isolate = on_isolate

    def dispatch(self, items: list) -> None:
        """On the dispatcher thread: launch the merged batch."""
        try:
            self._resolver = self._dispatch(items)
        except Exception:
            self._isolate()

    def _isolate(self) -> None:
        """Per-call fallback: each caller gets its own dispatch outcome
        (resolver or exception) instead of sharing the batch's."""
        self._on_isolate(len(self.calls))
        per = []
        for c in self.calls:
            try:
                per.append(("r", self._dispatch(c.items)))
            except Exception as e:  # this caller's own failure
                per.append(("e", e))
        self._per = per

    def result_for(self, call: "_Call") -> np.ndarray:
        with self._lock:
            if not self._done:
                if self._per is None:
                    try:
                        self._value = np.asarray(self._resolver())
                    except Exception:
                        self._isolate()
                self._done = True
        if self._per is None:
            return self._value[call.lo:call.lo + call.n]
        kind, payload = self._per[call.idx]
        if kind == "e":
            raise payload
        return np.asarray(payload())


class _Call:
    __slots__ = ("items", "n", "t_submit", "event", "merged", "lo", "idx")

    def __init__(self, items: list, t_submit: float):
        self.items = items
        self.n = len(items)
        self.t_submit = t_submit
        self.event = threading.Event()
        self.merged = None
        self.lo = 0
        self.idx = 0

    def resolve(self) -> np.ndarray:
        self.event.wait()
        return self.merged.result_for(self)


class DispatchCoalescer:
    """Merge concurrent verify calls into batched dispatches.

    dispatch: callable(items) -> zero-arg resolver, the verifier's DIRECT
    (non-coalescing) path; it must never re-enter the coalescer, or the
    dispatcher deadlocks on itself.
    """

    STATS = ("submissions", "dispatches", "merged_calls", "calls_max",
             "items_max", "fallbacks", "isolated_calls", "queue_max")

    def __init__(self, dispatch: Callable, max_batch: int = 8192,
                 max_wait_s: float = 0.002):
        if max_batch < 1:
            raise ValueError(f"coalesce max_batch must be >= 1, "
                             f"got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"coalesce max_wait must be >= 0, "
                             f"got {max_wait_s}")
        self._dispatch = dispatch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._cond = threading.Condition()
        self._queue: list[_Call] = []      #: guarded_by _cond
        self._closed = False               #: guarded_by _cond
        # EWMA inter-arrival gap, seeded sparse (= no lingering) so the
        # first calls after startup never pay the window
        self._ewma_gap = max(max_wait_s, 1e-4)  #: guarded_by _cond
        self._last_arrival = 0.0           #: guarded_by _cond
        # the dispatcher thread is lazy and self-reaping: spawned on the
        # first submit, gone after idle_timeout_s without traffic
        self.idle_timeout_s = 30.0
        self._running = False              #: guarded_by _cond
        self._thread = None                #: guarded_by _cond
        #: guarded_by _cond
        self.stats = dict.fromkeys(self.STATS, 0)
        # queue observatory: items waiting for a merged dispatch vs the
        # early-out bound (an unlocked sum over a short list — a torn
        # read costs one slightly-stale gauge sample)
        self._queue_probe = queue_obs.register(
            "verifier.coalesce", self,
            depth=lambda c: sum(call.n for call in c._queue),
            capacity=max_batch)

    def snapshot(self) -> dict:
        with self._cond:
            return dict(self.stats)

    # ------------------------------------------------------------ callers

    def submit(self, items: Sequence) -> Callable[[], np.ndarray]:
        """Enqueue one call's items; returns a zero-arg resolver yielding
        this call's own bool[N] verdicts (or raising this call's own
        dispatch failure). Blocks only inside the resolver."""
        now = time.perf_counter()
        call = _Call(list(items), now)
        with self._cond:
            if self._closed:
                raise RuntimeError("coalescer is closed")
            if self._last_arrival:
                gap = now - self._last_arrival
                self._ewma_gap += 0.25 * (gap - self._ewma_gap)
            self._last_arrival = now
            self._queue.append(call)
            self.stats["submissions"] += 1
            if not self._running:
                self._running = True
                self._thread = threading.Thread(
                    target=self._run, name="tm-verify-coalesce",
                    daemon=True)
                self._thread.start()
            self._cond.notify()
        _m_calls.inc()
        return call.resolve

    def close(self, timeout: float = 5.0) -> None:
        """Stop the dispatcher; queued calls are still dispatched."""
        self._queue_probe.close()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    # --------------------------------------------------------- dispatcher

    def _window_s_locked(self) -> float:
        """Linger budget for the current drain: ~4 inter-arrival gaps
        when traffic is dense enough that more arrivals are imminent,
        zero when the EWMA gap says waiting can't coalesce anything."""
        gap = self._ewma_gap
        if gap >= self.max_wait_s:
            return 0.0
        return min(self.max_wait_s, 4.0 * gap)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    if not self._cond.wait(self.idle_timeout_s):
                        if not self._queue and not self._closed:
                            self._running = False
                            return
                if not self._queue and self._closed:
                    self._running = False
                    return
                t0 = time.perf_counter()
                calls = self._queue
                self._queue = []
                n = sum(c.n for c in calls)
                self.stats["queue_max"] = max(self.stats["queue_max"],
                                              len(calls))
                if telemetry.enabled():
                    _m_queue.observe(len(calls))
                # linger for the rest of the burst: quiesce after ~4
                # gaps without a new arrival, hard cap max_wait from
                # the first drain, early out at max_batch
                hard = t0 + self.max_wait_s
                deadline = t0 + self._window_s_locked()
                while not self._closed and n < self.max_batch:
                    now = time.perf_counter()
                    if now >= deadline:
                        break
                    self._cond.wait(deadline - now)
                    if self._queue:
                        calls += self._queue
                        self._queue = []
                        n = sum(c.n for c in calls)
                        deadline = min(hard, time.perf_counter()
                                       + self._window_s_locked())
                st = self.stats
                st["dispatches"] += 1
                st["merged_calls"] += len(calls)
                st["calls_max"] = max(st["calls_max"], len(calls))
                st["items_max"] = max(st["items_max"], n)
            self._dispatch_merged(calls)

    def _count_fallback(self, n_calls: int) -> None:
        _m_fallback.inc()
        with self._cond:
            self.stats["fallbacks"] += 1
            self.stats["isolated_calls"] += n_calls

    def _dispatch_merged(self, calls: list) -> None:
        items = []
        for idx, c in enumerate(calls):
            c.idx = idx
            c.lo = len(items)
            items.extend(c.items)
        merged = _Merged(self._dispatch, calls, self._count_fallback)
        merged.dispatch(items)
        if telemetry.enabled():
            now = time.perf_counter()
            _m_dispatches.inc()
            _m_factor.observe(len(calls))
            for c in calls:
                _m_wait.observe(now - c.t_submit)
        for c in calls:
            c.merged = merged
            c.event.set()
