"""Causal consensus tracing — the cluster-wide per-height span plane.

The Tracer (telemetry/trace.py) is a process-local Chrome-trace
ring: useful for one node's flamegraph, useless for attributing a
HEIGHT's wall-clock across a cluster — its events carry no height key
a merger could join on, and nothing correlates a part leaving node A
with the same part arriving at node B. This module is the causal
layer on top:

- every consensus span/point is keyed (height, round) and stamped with
  WALL-clock nanoseconds (`utils/clock.wall_ns`, `time.time_ns` unless
  a test pins it), so per-node buffers from
  different processes can be merged onto one timeline once their clock
  offsets are estimated;
- p2p consensus/mempool envelopes are stamped on the way out
  (`stamp()`: a compact ``tr = [trace_id, origin_node, send_ns]``
  key) and consumed on the way in (`take()`: records a receive-side
  link span carrying the sender's clock reading) — those paired
  (send, recv) readings are exactly the samples
  `telemetry.merge.estimate_offsets` aligns clocks with;
- the bounded span ring is exposed via the `dump_height_timeline` RPC
  route and the raw `GET /debug/timeline` endpoint, and
  `telemetry.merge` turns N node dumps into one Perfetto file
  plus a per-height stage-attribution table;
- a `StallDetector` watches height progress and fires a flight-recorder
  callback when the chain stops moving (node.py dumps the timeline +
  consensus state).

Everything is gated on TM_CUDA_TRACE (env > config.base.trace > off).
With the knob off, `stamp()` returns its argument UNTOUCHED — the wire
format is byte-for-byte the untraced one (test-asserted) — and every
other entry point is a single knob check.

Span names are a closed catalog (SPAN_CATALOG): `record()` refuses an
undeclared name, the same discipline the metric registry gets.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from tendermint_tpu_torch.telemetry.trace import note_dropped
from tendermint_tpu_torch.utils import clock, knobs

# The closed span-name catalog: `record()` refuses names outside it,
# the same discipline the metric registry gets. Stage semantics:
#
#   height.begin     enter_new_round: the height's work starts
#   propose          proposer: block build + part gossip (span)
#   proposal.recv    a valid signed proposal accepted
#   part.first       first proposal block part present
#   block.full       part set complete, block decodable
#   quorum.prevote   +2/3 prevotes for a block observed
#   quorum.precommit +2/3 precommits observed (enter commit)
#   verify.dispatch  signature-verifier device/host dispatch (span)
#   apply            BlockExecutor.apply_block (span)
#   flush            height's store writes committed (span)
#   wal.fsync        the ENDHEIGHT WAL fsync (span)
#   commit           finalize complete, next height schedulable
#   p2p.recv         receive-side wire link span (carries origin+send ts)
#   mempool.recv     tx-gossip batch receive link span
#   stall            stall detector fired (flight recorder)
#   snapshot.restore state-sync restore apply (assemble/verify/bootstrap)
#   sync.chunk       one verified snapshot chunk landed (origin + bytes)
#   queue.saturated  queue-observatory watchdog episode (kind + depth)
#   slo.sample       a sampled tx completed delivery (hash + e2e ms) —
#                    the SLO plane's join key into the span timeline
#   block.reconstruct  compact relay: block rebuilt from mempool txs
#                    (span; outcome + missing-tx count ride as args)
#   votes.agg        one aggregated vote batch applied through the
#                    bulk VoteSet path (span; vote count rides as arg)
#   transition.digest  the height's canonical transition digest
#                    (analysis/divergence.py) stamped at commit — a
#                    cross-node trace diff localizes a state fork
SPAN_CATALOG = frozenset((
    "height.begin", "propose", "proposal.recv", "part.first",
    "block.full", "quorum.prevote", "quorum.precommit",
    "verify.dispatch", "apply", "flush", "wal.fsync", "commit",
    "p2p.recv", "mempool.recv", "stall",
    "snapshot.restore", "sync.chunk", "queue.saturated", "slo.sample",
    "block.reconstruct", "votes.agg", "transition.digest",
))

DEFAULT_CAPACITY = 65536

# config.base.trace snapshot (node.py configure()); env wins inside
# enabled(), so components built without a Node honor the knob too.
_configured = "off"

_lock = threading.Lock()
_ring: deque = deque()                      #: guarded_by _lock
_cap: Optional[int] = None                  #: guarded_by _lock
_node = ""          # short node id stamped into wire envelopes + dumps
_rtt_provider: Optional[Callable[[], Dict[str, float]]] = None


def configure(mode: str = "off") -> None:
    global _configured
    _configured = str(mode or "off").strip().lower()


def enabled() -> bool:
    """True when the causal plane records/stamps. env TM_CUDA_TRACE >
    config.base.trace > default off. Any FALSY spelling disables."""
    return knobs.knob_str("TM_CUDA_TRACE", config=_configured,
                          default="off") not in knobs.FALSY


def set_node(node_id: str) -> None:
    global _node
    _node = str(node_id or "")


def node() -> str:
    return _node


def set_rtt_provider(fn: Optional[Callable[[], Dict[str, float]]]) -> None:
    """Install the per-peer keepalive-RTT reader (node.py wires the
    switch's peer set); samples ride along in dump() so the merger can
    sanity-check its clock-offset estimates against measured RTTs."""
    global _rtt_provider
    _rtt_provider = fn


def _capacity() -> int:
    global _cap
    if _cap is None:
        _cap = max(1, knobs.knob_int("TM_CUDA_TRACE_CAP",
                                     default=DEFAULT_CAPACITY))
    return _cap


def set_capacity(n: Optional[int]) -> None:
    """Override the ring capacity (None re-reads the knob). Tests."""
    global _cap
    with _lock:
        _cap = n if n is None else max(1, int(n))


# ------------------------------------------------------------- recording

def record(name: str, height: int, round_: int = -1,
           t0_ns: Optional[int] = None, dur_ns: int = 0, **args) -> None:
    """Append one span to the ring. Oldest events roll off at capacity
    and are COUNTED (tmcuda_trace_events_dropped_total) — a long soak must
    never grow the buffer, and the drop counter tells the merger its
    window is truncated."""
    if not enabled():
        return
    if name not in SPAN_CATALOG:
        raise ValueError(f"span {name!r} not in SPAN_CATALOG "
                         f"(telemetry/causal.py)")
    ev = {"n": name, "h": int(height), "r": int(round_),
          "t": clock.wall_ns() if t0_ns is None else int(t0_ns),
          "d": int(dur_ns)}
    if args:
        ev["a"] = args
    with _lock:
        cap = _capacity()
        while len(_ring) >= cap:
            _ring.popleft()
            note_dropped()
        _ring.append(ev)


def point(name: str, height: int, round_: int = -1, **args) -> None:
    record(name, height, round_, **args)


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "height", "round_", "args", "_t0_ns", "_t0")

    def __init__(self, name, height, round_, args):
        self.name, self.height, self.round_ = name, height, round_
        self.args = args

    def __enter__(self):
        self._t0_ns = clock.wall_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_ns = int((time.perf_counter() - self._t0) * 1e9)
        record(self.name, self.height, self.round_,
               t0_ns=self._t0_ns, dur_ns=dur_ns, **self.args)
        return False


def span(name: str, height: int, round_: int = -1, **args):
    """Context manager recording one complete span (wall-clock anchor,
    perf_counter duration)."""
    if not enabled():
        return _NULL_SPAN
    return _Span(name, height, round_, args)


def null_span():
    """The no-op span, for callers gating on their own snapshot of the
    knob (ConsensusState resolves once at construction)."""
    return _NULL_SPAN


# ------------------------------------------------------- wire propagation

def stamp(msg: dict, height: int, round_: int = -1) -> dict:
    """Attach the trace context to an outgoing p2p envelope:
    ``tr = [trace_id, origin_node, send_ns]``. With tracing off the
    envelope is returned UNTOUCHED — the encoded wire bytes are
    byte-for-byte the untraced format (test-asserted). Call only on
    freshly-built envelope dicts (the reactor gossip/broadcast sites);
    the stamp mutates in place to avoid a copy per packet."""
    if not enabled():
        return msg
    msg["tr"] = [f"{int(height)}.{int(round_)}", _node, clock.wall_ns()]
    return msg


def take(msg: dict, kind: str = "") -> Optional[list]:
    """Pop the trace context off a received envelope (so reactor state
    and the consensus WAL see exactly the untraced message shape) and
    record the receive-side link span: local recv wall time plus the
    SENDER's clock reading — the (send, recv) pair cross-node clock
    alignment is estimated from. Returns the stamp, or None."""
    tr = msg.pop("tr", None)
    if tr is None or not enabled():
        return tr
    try:
        tid, origin, sent_ns = tr[0], tr[1], int(tr[2])
        h_s, _, r_s = str(tid).partition(".")
        height, round_ = int(h_s), int(r_s or -1)
    except (ValueError, TypeError, IndexError):
        return tr  # malformed stamp from a peer: ignore, keep running
    name = "mempool.recv" if kind in ("tx", "txs") else "p2p.recv"
    record(name, height, round_, origin=origin, sent=sent_ns,
           kind=kind)
    return tr


# ------------------------------------------------------------------ dump

def dump(min_height: int = 0, max_height: int = 0) -> dict:
    """The node's span buffer + merge metadata, JSON-able. Heights are
    filtered when bounds are given (0 = unbounded); link spans
    (p2p/mempool recv) always ride along — they are the clock-alignment
    samples and cost little."""
    with _lock:
        spans = list(_ring)
    if min_height or max_height:
        spans = [e for e in spans
                 if e["n"] in ("p2p.recv", "mempool.recv")
                 or ((not min_height or e["h"] >= min_height) and
                     (not max_height or e["h"] <= max_height))]
    rtt = {}
    if _rtt_provider is not None:
        try:
            rtt = {k: v for k, v in _rtt_provider().items() if v > 0}
        except Exception:
            rtt = {}  # a dying switch must not break the dump route
    import os
    return {"node": _node, "pid": os.getpid(),
            "wall_ns": clock.wall_ns(), "enabled": enabled(),
            "capacity": _capacity(), "events": len(spans),
            "rtt_s": rtt, "spans": spans}


def clear() -> None:
    with _lock:
        _ring.clear()


# --------------------------------------------------------- stall detector

class StallDetector:
    """Flight recorder trigger: when `height_fn()` makes no progress for
    `window_s`, call `on_stall(height, stalled_s)` ONCE per stall
    episode (re-armed by the next height change). The callback runs on
    the detector thread — it should dump and return, not block."""

    def __init__(self, height_fn: Callable[[], int],
                 on_stall: Callable[[int, float], None],
                 window_s: float, poll_s: Optional[float] = None):
        self._height_fn = height_fn
        self._on_stall = on_stall
        self.window_s = float(window_s)
        self._poll_s = poll_s if poll_s is not None else \
            max(0.05, self.window_s / 4.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = 0
        # True from the moment an episode fires until the next height
        # change — the /healthz verdict's "currently stalled" bit
        self.stalled = False

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="trace-stall-detector")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        last_h = self._height_fn()
        last_change = time.monotonic()
        armed = True
        while not self._stop.wait(self._poll_s):
            try:
                h = self._height_fn()
            except Exception as e:
                # node tearing down or mid-restart: note it and poll
                # again (the stop event ends the loop)
                from tendermint_tpu_torch.utils.log import get_logger
                get_logger("telemetry").debug(
                    "stall detector height probe failed", err=repr(e))
                continue
            now = time.monotonic()
            if h != last_h:
                last_h, last_change, armed = h, now, True
                self.stalled = False
                continue
            if armed and now - last_change >= self.window_s:
                armed = False  # once per episode
                self.fired += 1
                self.stalled = True
                stalled = now - last_change
                point("stall", h, stalled_s=round(stalled, 3))
                try:
                    self._on_stall(h, stalled)
                except Exception:
                    point("stall", h, dump_failed=True)
