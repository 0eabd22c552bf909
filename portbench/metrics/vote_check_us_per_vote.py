"""Host microseconds in the program's `votes.check` spans (the vote set's
validation and sign bytes up to the verifier call) per vote they covered:
see _spans.py."""

from portbench.metrics._spans import install, us_per_item  # noqa: F401


def read(ctx):
    return us_per_item(ctx, "votes.check")
