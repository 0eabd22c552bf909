"""Milliseconds per window in the program's `sync.collect` spans (part
sets, block ids and the commits' verify items of a window): see
_spans.py."""

from portbench.metrics._spans import install, ms_per_span  # noqa: F401


def read(ctx):
    return ms_per_span(ctx, "sync.collect")
