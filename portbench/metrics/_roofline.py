"""The share of the frozen bound (portbench/frozen/roofline.py) that the
kernels of a traced window reach: the least time for the window's
dispatched signatures, its launches and the keys new to the run, over
the device time of every kernel the profiler recorded in the window."""

from portbench.frozen import roofline


def read(ctx):
    tr, s = ctx.device_trace, ctx.window_stats
    if tr is None or not s.get("sigs_dispatched"):
        return None
    return roofline.share(s["sigs_dispatched"], s["launches"],
                          s.get("new_keys", 0), tr["kernel_s"])
