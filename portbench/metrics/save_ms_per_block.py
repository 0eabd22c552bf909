"""Milliseconds per synced block in the program's `sync.save` spans
(BlockStore.save_block from the window engine): see _spans.py."""

from portbench.metrics._spans import install, ms_per_span  # noqa: F401


def read(ctx):
    return ms_per_span(ctx, "sync.save")
