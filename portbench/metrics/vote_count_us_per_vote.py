"""Host microseconds in the program's `votes.count` spans (the vote set's
bookkeeping of verified votes after the verdicts) per vote they counted:
see _spans.py."""

from portbench.metrics._spans import install, us_per_item  # noqa: F401


def read(ctx):
    return us_per_item(ctx, "votes.count")
