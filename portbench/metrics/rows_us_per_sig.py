"""Host microseconds in the program's `verify.rows` spans (the key cache's
row lookup and stack, a decompress on a fill) per signature dispatched in
the window: see _spans.py."""

from portbench.metrics._spans import install, us_per_sig  # noqa: F401


def read(ctx):
    return us_per_sig(ctx, "verify.rows")
