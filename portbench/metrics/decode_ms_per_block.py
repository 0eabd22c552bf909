"""Milliseconds per decoded block in the program's `block.decode` spans
(Block.from_bytes of a block's wire bytes): see _spans.py."""

from portbench.metrics._spans import install, ms_per_span  # noqa: F401


def read(ctx):
    return ms_per_span(ctx, "block.decode")
