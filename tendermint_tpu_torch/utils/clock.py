"""The one wall-clock read for protocol timestamps (vote times).

A copy of `tendermint_tpu/utils/clock.py` for the port. `set_source()`
lets tests substitute a deterministic clock for the whole process.
Interval math keeps using `time.monotonic()`/`time.perf_counter()`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

_source: Optional[Callable[[], int]] = None


def now_ns() -> int:
    """Protocol-timestamp nanoseconds (vote/proposal/WAL/genesis time)."""
    if _source is not None:
        return _source()
    return time.time_ns()


def now_s() -> float:
    """The same sanctioned clock in seconds — for retry/backoff
    schedules that must follow chaos skew and replay deterministically
    (fast-sync peer backoff, state-sync chunk timeouts). Pure interval
    math with no replay/skew requirement should keep using
    time.monotonic()."""
    return now_ns() / 1e9


def set_source(source: Optional[Callable[[], int]]) -> None:
    """Install a replacement nanosecond source (None restores the real
    clock). Chaos clock-skew and deterministic replay hook in here."""
    global _source
    _source = source


# The observability planes' clocks, each with its own seam so tests pin
# them without sleeping and without touching the protocol clock: the
# causal plane stamps wall nanoseconds, the SLO plane monotonic ones.
_wall_source: Optional[Callable[[], int]] = None
_mono_source: Optional[Callable[[], int]] = None


def wall_ns() -> int:
    """Wall-clock nanoseconds of the causal span plane."""
    if _wall_source is not None:
        return _wall_source()
    return time.time_ns()


def monotonic_ns() -> int:
    """Monotonic nanoseconds of the SLO plane's stage stamps."""
    if _mono_source is not None:
        return _mono_source()
    return time.monotonic_ns()


def set_wall_source(source: Optional[Callable[[], int]]) -> None:
    global _wall_source
    _wall_source = source


def set_monotonic_source(source: Optional[Callable[[], int]]) -> None:
    global _mono_source
    _mono_source = source
