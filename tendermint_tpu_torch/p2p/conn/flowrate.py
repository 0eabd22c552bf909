"""Flow-rate measurement and throttling: the port's copy of
`tendermint_tpu/p2p/conn/flowrate.py` (tmlibs/flowrate as used by
p2p/conn/connection.go:394 and blockchain/pool.go:122-143).

`rate` is a SLIDING-WINDOW average (default 10s), not the lifetime
average: the eviction signal at blockchain/pool.go:35-42 must react when
a previously-fast peer stalls — a lifetime average over a fast first
minute would stay above MIN_RECV_RATE long after the peer went silent.
The window is maintained as per-second byte buckets and evaluated at
READ time, so a peer that stops calling update() decays to 0 within one
window. `lifetime_total` / `lifetime_rate` remain available for stats.
"""

from __future__ import annotations

import threading
import time
from collections import deque

_BUCKET_HZ = 10  # 100ms window buckets: fine enough for sub-second test windows


class FlowMonitor:
    """Transfer-rate monitor with optional rate limiting.

    `update(n)` records n transferred bytes and, when a limit is set,
    sleeps just enough to keep the lifetime average at or under the
    limit — the reference throttles its send/recv routines the same way.
    """

    def __init__(self, limit_bytes_per_s: float = 0.0,
                 window_s: float = 10.0):
        self.limit = limit_bytes_per_s
        self.window_s = window_s
        self._lock = threading.Lock()
        self._start = time.monotonic()
        self._total = 0
        self._buckets: deque = deque()  # [decisecond_index, bytes]

    def update(self, n: int) -> None:
        with self._lock:
            now = time.monotonic()
            self._total += n
            slot = int(now * _BUCKET_HZ)
            if self._buckets and self._buckets[-1][0] == slot:
                self._buckets[-1][1] += n
            else:
                self._buckets.append([slot, n])
            self._trim(now)
            sleep_for = 0.0
            if self.limit > 0:
                elapsed = now - self._start
                # never ahead of limit * elapsed
                ahead = self._total - self.limit * elapsed
                if ahead > 0:
                    sleep_for = ahead / self.limit
        if sleep_for > 0:
            time.sleep(min(sleep_for, 1.0))

    def _trim(self, now: float) -> None:
        cutoff = (now - self.window_s) * _BUCKET_HZ
        while self._buckets and self._buckets[0][0] + 1 <= cutoff:
            self._buckets.popleft()

    @property
    def rate(self) -> float:
        """Windowed transfer rate in bytes/s (the eviction signal)."""
        with self._lock:
            now = time.monotonic()
            self._trim(now)
            elapsed = min(now - self._start, self.window_s)
            if elapsed <= 0:
                return 0.0
            return sum(b for _, b in self._buckets) / elapsed

    @property
    def lifetime_rate(self) -> float:
        with self._lock:
            elapsed = time.monotonic() - self._start
            return self._total / elapsed if elapsed > 0 else 0.0

    @property
    def total(self) -> int:
        with self._lock:
            return self._total
