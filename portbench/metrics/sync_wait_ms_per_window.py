"""Milliseconds the window engine blocked on a window's verdicts (the
program's `sync.wait` spans) per window waited on: the verification that
apply did not hide. See _spans.py."""

from portbench.metrics._spans import install, ms_per_span  # noqa: F401


def read(ctx):
    return ms_per_span(ctx, "sync.wait")
