"""StepTicker — a deterministic consensus ticker on the runner's clock:
the port's copy of `tendermint_tpu/chaos/ticker.py`.

MockTicker (fire-on-demand, duration-ignored) livelocks a lossy net:
when round entry desynchronizes across nodes by a step or two, a peer
that fires its PROPOSE timeout before the (delayed) proposal arrives
prevotes nil, the discarded proposal is never re-sent, and every round
fails the same way. The real TimeoutTicker avoids this because timeout
DURATIONS dwarf gossip latency. StepTicker keeps that ratio while
staying deterministic: a scheduled timeout matures after
ceil(duration_s * skew / quantum_s) runner steps, so with the test
config's 100ms propose timeout and a 10ms quantum a proposal has ~10
steps to cross a 1-3-step-latency link before anyone gives up on it.

`skew` is the chaos plane's clock-skew fault: a node with skew k runs
its consensus clock k× slow (every timeout takes k× more steps to
mature) — the ticker-level analogue of a drifting wall clock.

Same replace-if-newer semantics as TimeoutTicker (consensus/ticker.go:
102-113): one pending timeout, newer (H, R, S) replaces it, stale
schedules are ignored.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from tendermint_tpu_torch.consensus.ticker import TimeoutInfo, _newer


class StepTicker:
    def __init__(self, on_timeout, clock: Callable[[], int],
                 quantum_s: float = 0.01, skew: float = 1.0):
        self._on_timeout = on_timeout
        self._clock = clock
        self.quantum_s = float(quantum_s)
        self.skew = float(skew)
        self._pending: Optional[TimeoutInfo] = None
        self._due = 0

    def schedule(self, ti: TimeoutInfo) -> None:
        if self._pending is not None and not _newer(ti, self._pending) \
                and ti != self._pending:
            return  # stale schedule
        self._pending = ti
        self._due = self._clock() + max(
            1, math.ceil(ti.duration_s * self.skew / self.quantum_s))

    def fire_due(self) -> Optional[TimeoutInfo]:
        """Deliver the pending timeout if it has matured (the runner
        calls this once per step per node)."""
        if self._pending is None or self._clock() < self._due:
            return None
        ti, self._pending = self._pending, None
        self._on_timeout(ti)
        return ti

    def stop(self) -> None:
        self._pending = None
