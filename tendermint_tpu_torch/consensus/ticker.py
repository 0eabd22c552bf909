"""Timeout scheduling: the port's copy of `tendermint_tpu/consensus/
ticker.py` (consensus/ticker.go).

One pending timeout at a time; scheduling a newer (height, round, step)
replaces the old one, stale fires are dropped (consensus/ticker.go:102-113).
TimeoutTicker runs a real timer thread and delivers fires to a callback
(the consensus state machine's input queue). MockTicker (consensus tests'
mockTicker) fires only when the test asks — deterministic rounds.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from tendermint_tpu_torch.consensus.rstate import Step


@dataclass(frozen=True)
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: Step

    def to_obj(self):
        # integer nanoseconds: floats are banned in canonical encoding
        return {"duration_ns": int(self.duration_s * 1e9),
                "height": self.height,
                "round": self.round, "step": int(self.step)}

    @classmethod
    def from_obj(cls, o):
        return cls(o["duration_ns"] / 1e9, o["height"], o["round"],
                   Step(o["step"]))


def _newer(a: TimeoutInfo, b: TimeoutInfo) -> bool:
    """Is a at a later (H,R,S) than b?"""
    return (a.height, a.round, int(a.step)) > (b.height, b.round, int(b.step))


class TimeoutTicker:
    def __init__(self, on_timeout):
        self._on_timeout = on_timeout
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self._pending: TimeoutInfo | None = None
        self._stopped = False

    def schedule(self, ti: TimeoutInfo) -> None:
        with self._lock:
            if self._stopped:
                return
            if self._pending is not None and not _newer(ti, self._pending) \
                    and ti != self._pending:
                return  # stale schedule
            if self._timer is not None:
                self._timer.cancel()
            self._pending = ti
            self._timer = threading.Timer(ti.duration_s, self._fire, (ti,))
            self._timer.daemon = True
            self._timer.name = "tm-timeout"
            self._timer.start()

    def _fire(self, ti: TimeoutInfo) -> None:
        with self._lock:
            if self._stopped or ti != self._pending:
                return
            self._pending = None
        self._on_timeout(ti)

    def stop(self) -> None:
        """Cancel the armed timer and JOIN an in-flight fire: a fire that
        had already passed the cancel may be mid-callback (driving a
        consensus transition); returning before it finishes lets a test
        tear down streams the transition still logs to (the reference
        enforces the same with leaktest, glide.yaml:46-48)."""
        with self._lock:
            self._stopped = True
            timer = self._timer
            self._timer = None
        if timer is not None:
            timer.cancel()
            if timer is not threading.current_thread():
                timer.join(timeout=5.0)


class MockTicker:
    """Deterministic ticker: collects schedules; fire_next() delivers the
    most recent one on demand (consensus/common_test.go mockTicker)."""

    def __init__(self, on_timeout=None):
        self._on_timeout = on_timeout
        self.scheduled: list[TimeoutInfo] = []

    def schedule(self, ti: TimeoutInfo) -> None:
        self.scheduled.append(ti)

    def fire_next(self) -> TimeoutInfo | None:
        if not self.scheduled:
            return None
        ti = self.scheduled.pop()
        self.scheduled.clear()
        if self._on_timeout is not None:
            self._on_timeout(ti)
        return ti

    def stop(self) -> None:
        pass
