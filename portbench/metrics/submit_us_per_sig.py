"""Host microseconds in the program's `verify.upload` and `verify.launch`
spans (a chunk's host-to-device copies and its call into the kernel) per
signature dispatched in the window: see _spans.py."""

from portbench.metrics._spans import install, us_per_sig  # noqa: F401


def read(ctx):
    return us_per_sig(ctx, "verify.upload", "verify.launch")
