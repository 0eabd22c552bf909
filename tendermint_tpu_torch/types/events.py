"""EventBus — typed pub/sub with a query language: the port's copy of
`tendermint_tpu/types/events.py` (types/events.go, types/event_bus.go,
tmlibs/pubsub).

Every cross-module notification (new block, vote, round step, tx result)
flows through here; subscribers attach with query strings like:

    tm.event = 'NewBlock'
    tm.event = 'Tx' AND tx.hash = 'ABCD'
    tm.event = 'Tx' AND account.number > 3

Synchronous fan-out: subscribers get events on the publisher's thread
into bounded buffers they drain. Drops are counted on the bus and in
`event_dropped_total`; each subscriber buffer is registered with the
queue observatory (`event.subscriber`), and `publish_tx` stamps the SLO
plane's `publish` stage before the fan-out.
"""

from __future__ import annotations

import hashlib
import queue
import re
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.telemetry import queues as queue_obs
from tendermint_tpu_torch.telemetry import slo as slo_obs

_m_dropped = telemetry.counter(
    "event_dropped_total",
    "Events dropped from full per-subscriber buffers (oldest-first)")

# reserved event types (types/events.go:12-32)
EventNewBlock = "NewBlock"
EventNewBlockHeader = "NewBlockHeader"
EventNewRound = "NewRound"
EventNewRoundStep = "NewRoundStep"
EventCompleteProposal = "CompleteProposal"
EventPolka = "Polka"
EventUnlock = "Unlock"
EventRelock = "Relock"
EventLock = "Lock"
EventTimeoutPropose = "TimeoutPropose"
EventTimeoutWait = "TimeoutWait"
EventVote = "Vote"
EventProposalHeartbeat = "ProposalHeartbeat"
EventTx = "Tx"
EventValidatorSetUpdates = "ValidatorSetUpdates"

# reserved tags (types/event_bus.go:137-146)
TagEvent = "tm.event"
TagTxHash = "tx.hash"
TagTxHeight = "tx.height"


def _num(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _ordered(op):
    def cmp(a, b):
        x, y = _num(a), _num(b)
        return x is not None and y is not None and op(x, y)
    return cmp


_CMP = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": _ordered(lambda x, y: x > y),
    "<": _ordered(lambda x, y: x < y),
    ">=": _ordered(lambda x, y: x >= y),
    "<=": _ordered(lambda x, y: x <= y),
    "CONTAINS": lambda a, b: isinstance(a, str) and str(b) in a,
}

_COND_RE = re.compile(
    r"\s*([\w.]+)\s*(=|!=|>=|<=|>|<|CONTAINS)\s*"
    r"(?:'([^']*)'|\"([^\"]*)\"|(\S+?))(\s+AND\s+|\s*$)")


class Query:
    """AND-composed conditions over event tags (tmlibs/pubsub/query).

    Parsed condition by condition (not split on " AND ") so quoted
    values may contain " AND " and separators tolerate any whitespace."""

    def __init__(self, s: str):
        self.source = s.strip()
        self.conds: List[tuple] = []
        pos = 0
        while pos < len(self.source):
            m = _COND_RE.match(self.source, pos)
            if not m:
                raise ValueError(
                    f"bad query condition at {self.source[pos:]!r}")
            key, op = m.group(1), m.group(2)
            val = next(g for g in m.groups()[2:5] if g is not None)
            self.conds.append((key, op, val))
            pos = m.end()

    def matches(self, tags: Dict[str, Any]) -> bool:
        for key, op, want in self.conds:
            have = tags.get(key)
            if have is None:
                return False
            if isinstance(have, (list, tuple, set)):
                if not any(_CMP[op](str(h), want) for h in have):
                    return False
            elif not _CMP[op](str(have), want):
                return False
        return True

    def __eq__(self, other):
        return isinstance(other, Query) and self.source == other.source

    def __hash__(self):
        return hash(self.source)


@dataclass
class EventItem:
    query: str
    tags: Dict[str, Any]
    data: Any


class Subscription:
    """Bounded per-subscriber buffer. When full, the OLDEST buffered
    event is evicted and counted: a slow subscriber loses history, not
    the most recent event. (The reference's buffered channels block the
    publisher instead; dropping oldest keeps consensus wait-free.)"""

    def __init__(self, query: Query, capacity: int = 1024):
        self.query = query
        self.capacity = max(1, int(capacity))
        self.cancelled = False
        self.dropped = 0
        # optional push hook (the async RPC server): called after every
        # put(), outside the buffer lock, on the publisher's thread; the
        # loop plane's WebSocket fan-out schedules its drain here
        # instead of running a pump thread a subscriber
        self.on_put: Optional[Callable[[], None]] = None
        self._items: "deque[EventItem]" = deque()
        self._cond = threading.Condition()
        # queue observatory: a saturated subscriber buffer means a slow
        # consumer is about to lose history (drop-oldest); the probe
        # weak-refs this subscription, so abandoned subscribers prune
        # themselves — unsubscribe closes promptly below
        self._queue_probe = queue_obs.register(
            "event.subscriber", self, depth=lambda s: len(s._items),
            capacity=self.capacity)

    def put(self, item: EventItem) -> bool:
        """Buffer an event; True when an older one was evicted."""
        with self._cond:
            dropped = len(self._items) >= self.capacity
            if dropped:
                self._items.popleft()
                self.dropped += 1
            self._items.append(item)
            self._cond.notify()
        hook = self.on_put
        if hook is not None:
            hook()
        return dropped

    def get(self, timeout: Optional[float] = None) -> EventItem:
        """Blocking pop; raises queue.Empty on timeout."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._items,
                                       timeout=timeout):
                raise queue.Empty
            return self._items.popleft()

    def get_nowait(self) -> Optional[EventItem]:
        with self._cond:
            return self._items.popleft() if self._items else None

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def empty(self) -> bool:
        return self.qsize() == 0


class EventBus:
    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[tuple, Subscription] = {}  # (subscriber, query.source)
        self._dropped_total = 0

    def subscribe(self, subscriber: str, query_str: str,
                  capacity: int = 1024) -> Subscription:
        q = Query(query_str)
        with self._lock:
            key = (subscriber, q.source)
            if key in self._subs:
                raise ValueError(f"already subscribed: {key}")
            sub = Subscription(q, capacity)
            self._subs[key] = sub
            return sub

    def unsubscribe(self, subscriber: str, query_str: str) -> None:
        with self._lock:
            sub = self._subs.pop((subscriber, Query(query_str).source), None)
            if sub:
                sub.cancelled = True
                sub._queue_probe.close()

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._lock:
            for key in [k for k in self._subs if k[0] == subscriber]:
                sub = self._subs.pop(key)
                sub.cancelled = True
                sub._queue_probe.close()

    def publish(self, event_type: str, data: Any,
                tags: Optional[Dict[str, Any]] = None) -> None:
        tags = dict(tags or {})
        tags[TagEvent] = event_type
        with self._lock:
            subs = list(self._subs.values())
        # tmlint: allow(taint): fan-out order is per-subscriber-queue local; every subscriber receives the same already-built EventItem
        for sub in subs:
            if sub.query.matches(tags):
                if sub.put(EventItem(sub.query.source, tags, data)):
                    _m_dropped.inc()
                    with self._lock:
                        self._dropped_total += 1

    @property
    def dropped_total(self) -> int:
        """Events evicted across every subscription of this bus."""
        with self._lock:
            return self._dropped_total

    def n_subscriptions(self) -> int:
        with self._lock:
            return len(self._subs)

    # typed helpers (types/event_bus.go)

    def publish_new_block(self, block, block_id) -> None:
        self.publish(EventNewBlock, {"block": block, "block_id": block_id})

    def publish_new_block_header(self, header) -> None:
        self.publish(EventNewBlockHeader, {"header": header})

    def publish_vote(self, vote) -> None:
        self.publish(EventVote, {"vote": vote})

    def publish_tx(self, height: int, index: int, tx: bytes, result: Any,
                   extra_tags: Optional[Dict[str, Any]] = None) -> None:
        tags = dict(extra_tags or {})
        tags[TagTxHash] = hashlib.sha256(tx).hexdigest().upper()
        tags[TagTxHeight] = height
        # SLO publish stamp BEFORE the fan-out: the deliver stamp (a
        # subscriber socket write, possibly on the loop thread an
        # instant later) must never precede it
        slo_obs.mark_hex(tags[TagTxHash], "publish", height)
        self.publish(EventTx, {
            "height": height, "index": index, "tx": tx, "result": result},
            tags)
