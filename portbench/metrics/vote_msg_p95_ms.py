"""The 95th percentile of one HeightVoteSet.add_votes call (a 256-vote
message), over every call of the window, by the harness's clock."""

from portbench.harness import quantile


def read(ctx):
    p = quantile(ctx.window_stats.get("msg_latencies_s", []), 0.95)
    return None if p is None else p * 1e3
