"""Microseconds per header in the program's `lite.check` spans (a
window's power rules, the trusted set's and the signing set's, and the
trust and stores they move): see _spans.py."""

from portbench.metrics._spans import install, us_per_item  # noqa: F401


def read(ctx):
    return us_per_item(ctx, "lite.check")
