"""Percent of the traced window in which no kernel and no copy ran on the
card, from torch.profiler's CUDA activity."""


def read(ctx):
    tr = ctx.device_trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
