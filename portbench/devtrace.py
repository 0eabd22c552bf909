"""The device's side of a traced run, from torch.profiler's CUDA activity.

`Tracer` records the card's kernels and copies over the traced window.
Its events carry time.time_ns() timestamps, the clock of the harness's
host spans (checked on the H100: a marker kernel launched right after a
host reading starts within a millisecond of it). `summary` gives the
seconds in which anything ran on the device (the union of the kernels'
and the copies' intervals), the kernels' own summed seconds, the
operations that took the most time and the longest idle gaps, each named
by the host span that covers it.
"""

from __future__ import annotations

import time


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0_ns = self.t1_ns = 0
        self.events: list = []

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            out.append((e.name(), e.start_ns(), e.start_ns()
                        + e.duration_ns()))
        self.events = out


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _cover(spans: list, a: int, b: int) -> str:
    """The innermost host span that covers the gap's middle."""
    mid = (a + b) // 2
    best = None
    for name, s0, s1 in spans:
        if s0 <= mid <= s1 and (best is None or s1 - s0 < best[1]):
            best = (name, s1 - s0)
    return best[0] if best else "host:outside any span"


def summary(events: list, t0_ns: int, t1_ns: int, spans: list) -> dict:
    """busy_s, window_s, kernel_s (kernels only, not copies),
    device_ops [[name, s]] and idle_gaps [[host span, s]], 10 each."""
    clipped = [(n, max(a, t0_ns), min(b, t1_ns)) for n, a, b in events
               if b > t0_ns and a < t1_ns]
    busy = _union([(a, b) for _, a, b in clipped])
    busy_ns = sum(b - a for a, b in busy)
    kernel_ns = sum(b - a for n, a, b in clipped if not _is_copy(n))
    by_name: dict = {}
    for n, a, b in clipped:
        key = n[:96]
        by_name[key] = by_name.get(key, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    prev = t0_ns
    for a, b in busy + [[t1_ns, t1_ns]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_cover(spans, a, b), (b - a) / 1e9] for a, b in gaps[:10]]
    return {"busy_s": busy_ns / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "kernel_s": kernel_ns / 1e9,
            "device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": idle}
