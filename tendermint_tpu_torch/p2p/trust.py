"""Trust metric — per-peer reliability scoring: the port's copy of
`tendermint_tpu/p2p/trust.py` (p2p/trust/metric.go, ADR-006).

Each peer's score combines a proportional component (good/bad ratio in
the current interval), an integral component (history of past interval
ratios, fading with 1/sqrt(age)), and a derivative penalty applied only
when the score is falling. Scores persist via TrustMetricStore."""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional

PROPORTIONAL_WEIGHT = 0.4     # p2p/trust/metric.go:16-25
INTEGRAL_WEIGHT = 0.6
MAX_HISTORY = 16
DEFAULT_INTERVAL_S = 30.0


class TrustMetric:
    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 history: Optional[List[float]] = None,
                 now_fn=time.monotonic):
        self.interval_s = interval_s
        # injectable interval clock: rollover math is untestable
        # against the real monotonic clock (a test would sleep
        # interval_s per assertion), and chaos replays need the
        # interval boundary to follow their driven clock
        self._now = now_fn
        self._lock = threading.Lock()
        self.good = 0.0
        self.bad = 0.0
        self.history: List[float] = list(history or [])  # newest first
        self._interval_start = self._now()

    # ------------------------------------------------------------- events

    def good_events(self, n: float = 1.0) -> None:
        with self._lock:
            self._roll_if_due()
            self.good += n

    def bad_events(self, n: float = 1.0) -> None:
        with self._lock:
            self._roll_if_due()
            self.bad += n

    def _roll_if_due(self) -> None:
        now = self._now()
        while now - self._interval_start >= self.interval_s:
            self._roll()
            self._interval_start += self.interval_s

    def _roll(self) -> None:
        """Close the current interval into history."""
        self.history.insert(0, self._current_ratio())
        del self.history[MAX_HISTORY:]
        self.good = self.bad = 0.0

    def _current_ratio(self) -> float:
        total = self.good + self.bad
        if total == 0:
            return 1.0  # no evidence = benefit of the doubt
        return self.good / total

    def _history_value(self) -> float:
        """1/sqrt(age)-weighted average of past interval ratios
        (metric.go calcHistoryValue)."""
        if not self.history:
            return 1.0
        weights = [1.0 / math.sqrt(i + 1)
                   for i in range(len(self.history))]
        total_w = sum(weights)
        return sum(r * w for r, w in zip(self.history, weights)) / total_w

    def trust_value(self) -> float:
        """0..1 score: a*R + b*H + D (D only punishes downswings)."""
        with self._lock:
            self._roll_if_due()
            r = self._current_ratio()
            h = self._history_value()
            d = r - h
            dampened = d * PROPORTIONAL_WEIGHT if d < 0 else 0.0
            return max(0.0, min(1.0,
                                PROPORTIONAL_WEIGHT * r +
                                INTEGRAL_WEIGHT * h + dampened))

    def trust_score(self) -> int:
        """Integer 0-100 (metric.go TrustScore)."""
        return int(round(self.trust_value() * 100))

    def to_obj(self) -> dict:
        with self._lock:
            # fold the open interval in ONLY if it saw events — an empty
            # interval would persist a synthetic 1.0 entry, and repeated
            # save/restart cycles would launder a bad peer's history
            if self.good + self.bad > 0:
                history = [self._current_ratio()] + \
                    self.history[:MAX_HISTORY - 1]
            else:
                history = list(self.history)
            return {"interval_s": self.interval_s, "history": history}

    @classmethod
    def from_obj(cls, o: dict) -> "TrustMetric":
        return cls(interval_s=o.get("interval_s", DEFAULT_INTERVAL_S),
                   history=o.get("history", []))


class TrustMetricStore:
    """Per-peer metrics with db persistence (p2p/trust/store.go)."""

    _KEY = b"trust-metrics"

    def __init__(self, db, interval_s: float = DEFAULT_INTERVAL_S):
        self.db = db
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self.metrics: Dict[str, TrustMetric] = {}
        self._load()

    def get_metric(self, peer_id: str) -> TrustMetric:
        with self._lock:
            m = self.metrics.get(peer_id)
            if m is None:
                m = TrustMetric(self.interval_s)
                self.metrics[peer_id] = m
            return m

    def peer_disconnected(self, peer_id: str) -> None:
        self.save()

    def save(self) -> None:
        with self._lock:
            obj = {pid: m.to_obj() for pid, m in self.metrics.items()}
        self.db.set(self._KEY, json.dumps(obj, sort_keys=True).encode())

    def _load(self) -> None:
        raw = self.db.get(self._KEY)
        if raw is None:
            return
        for pid, o in json.loads(raw).items():
            self.metrics[pid] = TrustMetric.from_obj(o)
