"""What the readers of the program's own spans share. The causal plane
(`tendermint_tpu_torch/telemetry/causal.py`) records them inside the
program, stamped on time.time_ns(), the clock of the device trace.

`install(ctx)`, run before the window of a traced run, turns the plane
on, empties its ring and notes the window's start and the ring's drop
count. `spans(ctx, name)` gives (duration ns, args) for each span of
`name` that started in the window, or None if the ring dropped an event
since: a metric is never taken from a truncated window. A program that
records no such span gives an empty list, and one without the plane's
drop count (`causal.dropped`) gives None: either way the readers return
None.
"""

import time


def _plane():
    from tendermint_tpu_torch.telemetry import causal
    return causal


def install(ctx):
    if getattr(ctx, "span_window", None) is not None:
        return
    causal = _plane()
    causal.configure("on")
    causal.clear()
    count = getattr(causal, "dropped", None)
    ctx.span_window = (time.time_ns(), count() if count else None)


def spans(ctx, name):
    window = getattr(ctx, "span_window", None)
    if window is None:
        return None
    t0, drops0 = window
    causal = _plane()
    if drops0 is None or causal.dropped() != drops0:
        return None
    return [(e["d"], e.get("a", {})) for e in causal.dump()["spans"]
            if e["n"] == name and e["t"] >= t0]


def us_per_sig(ctx, *names):
    """Microseconds of the named spans per signature the window
    dispatched."""
    sigs = ctx.window_stats.get("sigs_dispatched")
    found = [spans(ctx, n) for n in names]
    if not sigs or any(s is None for s in found) or not any(found):
        return None
    return sum(d for s in found for d, _ in s) / 1e3 / sigs


def us_per_item(ctx, name):
    """Microseconds of the spans of `name` per item they covered (the sum
    of their `n`)."""
    s = spans(ctx, name)
    n = sum(a.get("n", 0) for _, a in s or ())
    if not n:
        return None
    return sum(d for d, _ in s) / 1e3 / n


def ms_per_span(ctx, name):
    s = spans(ctx, name)
    if not s:
        return None
    return sum(d for d, _ in s) / 1e6 / len(s)
