"""Queue observatory — every bounded queue in the tree, one catalog.

The tree grew bounded queues independently: mconn per-channel send
queues, the mempool CList, EventBus subscriber buffers, the verifier
coalescer's pending calls, the fast-sync request window, the statesync
chunk fetcher. Each had (at best) its own gauge; none answered the
backpressure question the span plane leaves open — WHICH queue saturates first
when the reactor plane backs up. This module is the single catalog:

- owners ``register(kind, owner, depth, capacity)`` one probe per
  queue instance at construction time (a dict append under a lock —
  nothing on the per-item hot path). Probes hold only a WEAK reference
  to the owner, so a dead connection/subscription drops off the
  catalog at the next poll without the owner having to remember to
  unregister (close() is still available for prompt removal).
- a watcher thread (TM_CUDA_QUEUE_WATCH: off | on | <poll seconds>,
  default on at 0.25s) sweeps the catalog: per KIND it exports
  depth / capacity / high-water / instance-count / wait-seconds /
  saturation gauges (depth and saturation are the FULLEST instance's —
  backpressure is a max phenomenon, not a mean), where wait-seconds is
  the age of the kind's current backlog episode (how long the fullest
  instance has been continuously non-empty).
- a SATURATION WATCHDOG rides the same sweep: any kind sitting above
  SATURATION_THRESHOLD (80%) full fires ONCE per episode (re-armed
  when it drains below) — a warn log, the
  ``tmcuda_queue_saturation_events_total`` counter, a ``queue.saturated``
  causal point when tracing is on, and any registered callbacks
  (tests). The same discipline as the causal plane's StallDetector: an
  episode is one line of evidence, not a log flood.

``table()`` returns the whole catalog as JSON — the ``/healthz``
verdict input and the stall flight recorder's embedded high-water
table. With TM_CUDA_QUEUE_WATCH off, ``register`` returns a no-op probe
and no thread ever starts: zero cost, byte-for-byte untouched owners.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple, Union

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.utils import knobs

_m_depth = telemetry.gauge(
    "queue_depth", "Items in the kind's fullest instance at last poll",
    ("queue",))
_m_capacity = telemetry.gauge(
    "queue_capacity", "Configured bound of the kind's fullest instance",
    ("queue",))
_m_high_water = telemetry.gauge(
    "queue_high_water", "Highest depth any instance ever reached",
    ("queue",))
_m_instances = telemetry.gauge(
    "queue_instances", "Live registered instances of the kind",
    ("queue",))
_m_wait = telemetry.gauge(
    "queue_wait_seconds",
    "Age of the current backlog episode (seconds the fullest instance "
    "has been continuously non-empty)", ("queue",))
_m_saturation = telemetry.gauge(
    "queue_saturation",
    "depth/capacity of the kind's fullest instance (0..1)", ("queue",))
_m_events = telemetry.counter(
    "queue_saturation_events_total",
    "Watchdog episodes: a kind crossed the saturation threshold",
    ("queue",))

SATURATION_THRESHOLD = 0.80
DEFAULT_POLL_S = 0.25

_configured = "on"


def configure(mode: str = "on") -> None:
    """config.base.queue_watch snapshot (node.py); env wins inside
    resolve()."""
    global _configured
    _configured = str(mode or "on").strip().lower()


def resolve() -> Tuple[bool, float]:
    """(enabled, poll_s). TM_CUDA_QUEUE_WATCH: FALSY -> disabled;
    on/auto/unset -> default poll; a number -> that poll interval."""
    v = knobs.knob_spec("TM_CUDA_QUEUE_WATCH", config=_configured,
                        default="on").strip().lower()
    if v in knobs.FALSY:
        return False, 0.0
    try:
        poll = float(v)
    except ValueError:
        poll = DEFAULT_POLL_S
    return True, max(0.01, poll or DEFAULT_POLL_S)


class _NoopProbe:
    __slots__ = ()

    def close(self) -> None:
        pass


_NOOP_PROBE = _NoopProbe()


class QueueProbe:
    """One registered queue instance. ``depth`` takes the (weakly held)
    owner and returns the current item count; ``capacity`` is an int or
    a callable for bounds that move (statesync: chunks per manifest)."""

    __slots__ = ("kind", "_ref", "_depth", "_capacity", "closed",
                 "high_water")

    def __init__(self, kind: str, owner, depth: Callable,
                 capacity: Union[int, Callable]):
        self.kind = kind
        self._ref = weakref.ref(owner)
        self._depth = depth
        self._capacity = capacity
        self.closed = False
        self.high_water = 0

    def read(self) -> Optional[Tuple[int, int]]:
        """(depth, capacity), or None when the owner is gone/broken."""
        if self.closed:
            return None
        owner = self._ref()
        if owner is None:
            return None
        try:
            depth = int(self._depth(owner))
            cap = self._capacity
            if callable(cap):
                cap = cap(owner)
            return depth, max(1, int(cap))
        except Exception:
            # a mid-teardown owner (closed socket, cleared dict) must
            # not break the sweep; the probe is pruned
            return None

    def close(self) -> None:
        self.closed = True


class _KindState:
    """Aggregated episode state per kind (watchdog bookkeeping)."""

    __slots__ = ("high_water", "nonempty_since", "armed", "events",
                 "saturated_since", "last_depth", "last_capacity",
                 "last_saturation", "instances")

    def __init__(self):
        self.high_water = 0
        self.nonempty_since = 0.0
        self.saturated_since = 0.0
        self.armed = True
        self.events = 0
        self.last_depth = 0
        self.last_capacity = 0
        self.last_saturation = 0.0
        self.instances = 0


_lock = threading.Lock()
_probes: List[QueueProbe] = []              #: guarded_by _lock
_kinds: Dict[str, _KindState] = {}          #: guarded_by _lock
_callbacks: List[Callable[[str, float, int], None]] = []
_watch_thread: Optional[threading.Thread] = None  #: guarded_by _lock
_watch_stop = threading.Event()


def register(kind: str, owner, depth: Callable,
             capacity: Union[int, Callable]):
    """Add one queue instance to the catalog; returns a probe whose
    ``close()`` removes it promptly (the weakref prunes it lazily
    otherwise). With the observatory off this is one knob check."""
    on, _ = resolve()
    if not on:
        return _NOOP_PROBE
    probe = QueueProbe(kind, owner, depth, capacity)
    with _lock:
        _probes.append(probe)
        _kinds.setdefault(kind, _KindState())
    return probe


def on_saturation(cb: Callable[[str, float, int], None]) -> None:
    """cb(kind, saturation, depth) on each watchdog episode."""
    _callbacks.append(cb)


def clear_callbacks() -> None:
    del _callbacks[:]


def poll() -> Dict[str, dict]:
    """One sweep: prune dead probes, update the gauges, run the
    watchdog, return the per-kind table. The watcher thread calls this
    on its interval; tests and /healthz may call it directly."""
    now = time.monotonic()
    fired: List[Tuple[str, float, int]] = []
    with _lock:
        live: List[QueueProbe] = []
        agg: Dict[str, Tuple[int, int, int]] = {}  # depth, cap, count
        for p in _probes:
            reading = p.read()
            if reading is None:
                continue
            live.append(p)
            depth, cap = reading
            p.high_water = max(p.high_water, depth)
            d0, c0, n0 = agg.get(p.kind, (0, 1, 0))
            # the fullest instance wins: saturation is a max phenomenon
            if n0 == 0 or depth / cap > d0 / c0:
                d0, c0 = depth, cap
            agg[p.kind] = (d0, c0, n0 + 1)
        _probes[:] = live
        for kind, st in _kinds.items():
            depth, cap, n = agg.get(kind, (0, 1, 0))
            sat = depth / cap if n else 0.0
            st.last_depth, st.last_capacity = depth, cap
            st.last_saturation = sat
            st.instances = n
            st.high_water = max(st.high_water, depth)
            if depth > 0:
                if not st.nonempty_since:
                    st.nonempty_since = now
            else:
                st.nonempty_since = 0.0
            if sat > SATURATION_THRESHOLD:
                if not st.saturated_since:
                    st.saturated_since = now
                if st.armed:
                    st.armed = False  # once per episode
                    st.events += 1
                    fired.append((kind, sat, depth))
            else:
                st.saturated_since = 0.0
                st.armed = True
            if telemetry.enabled():
                wait = now - st.nonempty_since \
                    if st.nonempty_since else 0.0
                _m_depth.labels(kind).set(depth)
                _m_capacity.labels(kind).set(cap)
                _m_high_water.labels(kind).set(st.high_water)
                _m_instances.labels(kind).set(n)
                _m_wait.labels(kind).set(round(wait, 3))
                _m_saturation.labels(kind).set(round(sat, 4))
    for kind, sat, depth in fired:
        _fire(kind, sat, depth)
    return table()


def _fire(kind: str, sat: float, depth: int) -> None:
    _m_events.labels(kind).inc()
    from tendermint_tpu_torch.utils.log import get_logger
    get_logger("telemetry").error(
        "queue saturated", queue=kind, depth=depth,
        saturation=round(sat, 3))
    from tendermint_tpu_torch.telemetry import causal
    causal.point("queue.saturated", 0, queue=kind, depth=depth,
                 saturation=round(sat, 3))
    for cb in list(_callbacks):
        try:
            cb(kind, sat, depth)
        except Exception as e:
            get_logger("telemetry").error(
                "queue saturation callback failed", err=repr(e))


def table() -> Dict[str, dict]:
    """The catalog as JSON: per kind, the last sweep's depth/capacity/
    saturation, the all-time high water, the live instance count, the
    backlog-episode age, and the episode counter. Embedded in /healthz
    and the stall flight recorder."""
    now = time.monotonic()
    out: Dict[str, dict] = {}
    with _lock:
        for kind in sorted(_kinds):
            st = _kinds[kind]
            out[kind] = {
                "depth": st.last_depth,
                "capacity": st.last_capacity,
                "saturation": round(st.last_saturation, 4),
                "high_water": st.high_water,
                "instances": st.instances,
                "wait_s": round(now - st.nonempty_since, 3)
                if st.nonempty_since else 0.0,
                "saturated_s": round(now - st.saturated_since, 3)
                if st.saturated_since else 0.0,
                "events": st.events,
            }
    return out


def saturated() -> List[str]:
    """Kinds currently above the threshold (the /healthz verdict)."""
    with _lock:
        return sorted(k for k, st in _kinds.items()
                      if st.last_saturation > SATURATION_THRESHOLD)


def ensure_watch() -> bool:
    """Start the process-wide watcher thread (idempotent). False when
    the knob disables the observatory."""
    global _watch_thread
    on, poll_s = resolve()
    if not on:
        return False
    with _lock:
        if _watch_thread is not None and _watch_thread.is_alive():
            return True
        _watch_stop.clear()
        _watch_thread = threading.Thread(
            target=_watch_run, args=(poll_s,), daemon=True,
            name="tm-queue-watch")
        _watch_thread.start()
    return True


def _watch_run(poll_s: float) -> None:
    while not _watch_stop.wait(poll_s):
        try:
            poll()
        except Exception as e:
            from tendermint_tpu_torch.utils.log import get_logger
            get_logger("telemetry").debug("queue sweep failed",
                                          err=repr(e))


def stop_watch() -> None:
    global _watch_thread
    _watch_stop.set()
    with _lock:
        t = _watch_thread
        _watch_thread = None
    if t is not None:
        t.join(timeout=2.0)


def reset() -> None:
    """Drop every probe and kind (unit tests building fresh worlds)."""
    stop_watch()
    with _lock:
        del _probes[:]
        _kinds.clear()
    clear_callbacks()
