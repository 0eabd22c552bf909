"""Milliseconds the light client blocked on a window's verdicts (the
program's `lite.wait` spans) per window waited on: the verification that
fetching and collecting the next window did not hide. See _spans.py."""

from portbench.metrics._spans import install, ms_per_span  # noqa: F401


def read(ctx):
    return ms_per_span(ctx, "lite.wait")
