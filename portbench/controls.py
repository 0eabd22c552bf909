"""Controls: a part of the program swapped for one that breaks a stated
guarantee, so that a run must come out not correct.

`accept_all` breaks "a verdict is true only for a valid signature": the
verifier's `verify_async` answers true for every item without looking at
it. Used only by `--control accept_all` and by the tests.
"""

from __future__ import annotations

import numpy as np


def accept_all(verifier) -> None:
    def verify_async(items):
        out = np.ones(len(items), np.bool_)
        return lambda: out
    verifier.verify_async = verify_async


def install(ctx, verifier) -> None:
    if ctx.control == "accept_all":
        accept_all(verifier)
    elif ctx.control:
        raise ValueError(f"unknown control {ctx.control!r}")
