"""Key-cache batches served from cached rows (`predecomp_stats()` hit)
over the batches routed through the cache (hit + fill + full), as the
change over the window, in percent."""


def read(ctx):
    s = ctx.window_stats
    routed = s.get("hit", 0) + s.get("fill", 0) + s.get("full", 0)
    if not routed:
        return None
    return 100.0 * s["hit"] / routed
