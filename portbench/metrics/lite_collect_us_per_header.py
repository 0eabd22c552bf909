"""Microseconds per header in the program's `lite.collect` spans (a
window's validate_basic, set hashes and verify items): see _spans.py."""

from portbench.metrics._spans import install, us_per_item  # noqa: F401


def read(ctx):
    return us_per_item(ctx, "lite.collect")
