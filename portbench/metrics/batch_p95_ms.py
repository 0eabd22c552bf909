"""The 95th percentile of a request's time, from its verify_async call to
its verdicts in hand, over every request the window dispatched (the
harness's own clock around the boundary)."""

from portbench.harness import quantile


def read(ctx):
    p = quantile(ctx.window_stats.get("latencies_s", []), 0.95)
    return None if p is None else p * 1e3
