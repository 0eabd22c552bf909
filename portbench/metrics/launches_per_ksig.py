"""Kernel launches of every kernel (`ops.ladder.launches`, read before and
after the window) per 1,000 signatures dispatched in the window."""


def read(ctx):
    s = ctx.window_stats
    if not s.get("sigs_dispatched"):
        return None
    return 1000.0 * s["launches"] / s["sigs_dispatched"]
