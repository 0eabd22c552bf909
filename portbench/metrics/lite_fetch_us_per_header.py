"""Microseconds per header in the program's `lite.fetch` spans (a
window's provider reads and decoding in InquiringCertifier.certify_range):
see _spans.py."""

from portbench.metrics._spans import install, us_per_item  # noqa: F401


def read(ctx):
    return us_per_item(ctx, "lite.fetch")
