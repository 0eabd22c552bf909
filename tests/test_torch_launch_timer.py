"""The launch timer (csrc/launch_timer.cpp) with which chip_smoke.py times
the socket net's verify launches in the run, built by g++ and driven with
host callbacks in place of the driver's cuEventRecord and of the ladder
library's launchers (tm_ladder_verify, tm_ladder_verify_pre).

It must record the start event, launch with the arguments as given and
record the end event, all on the launch's stream and in that order; it
passes the launcher's result back, and a failed record as
tm_record_failed_base() + the driver's error."""

from __future__ import annotations

import ctypes

import pytest

from tendermint_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
RECORD = ctypes.CFUNCTYPE(_I, _P, _P)
LAUNCHERS = {
    "verify": ("tm_timed_verify", ctypes.CFUNCTYPE(_I, *[_P] * 6, _I, _I, _P),
               6),
    "verify_pre": ("tm_timed_verify_pre",
                   ctypes.CFUNCTYPE(_I, *[_P] * 8, _I, _I, _P), 8),
}
START, END, STREAM = 0x5000, 0x6000, 0x7000


class _Handle:
    """An event as torch.cuda.Event passes it: by `_as_parameter_`."""

    def __init__(self, value):
        self._as_parameter_ = ctypes.c_void_p(value)


def _drive(kind, launch_rc=0, start_rc=0, end_rc=0):
    lib = _build.launch_timer_lib()
    entry, proto, n_ptrs = LAUNCHERS[kind]
    calls = []

    def record(event, stream):
        calls.append(("record", event, stream))
        return start_rc if event == START else end_rc

    def launch(*args):
        calls.append(("launch", *args))
        return launch_rc

    rec_cb, launch_cb = RECORD(record), proto(launch)
    ptrs = [0x100 * (i + 1) for i in range(n_ptrs)]
    rc = getattr(lib, entry)(
        ctypes.cast(rec_cb, _P), _Handle(START), _Handle(END),
        ctypes.cast(launch_cb, _P), *[_P(p) for p in ptrs], _I(24), _I(64),
        _P(STREAM))
    return rc, calls, ptrs, lib.tm_record_failed_base()


@pytest.mark.parametrize("kind", sorted(LAUNCHERS))
def test_records_around_the_launch_on_its_stream(kind):
    rc, calls, ptrs, _ = _drive(kind)
    assert rc == 0
    assert calls == [("record", START, STREAM),
                     ("launch", *ptrs, 24, 64, STREAM),
                     ("record", END, STREAM)]


@pytest.mark.parametrize("kind", sorted(LAUNCHERS))
def test_a_failed_launch_returns_its_error_after_the_end_record(kind):
    rc, calls, _, _ = _drive(kind, launch_rc=98)
    assert rc == 98
    assert [c[0] for c in calls] == ["record", "launch", "record"]


@pytest.mark.parametrize("kind", sorted(LAUNCHERS))
def test_a_failed_start_record_launches_nothing(kind):
    rc, calls, _, base = _drive(kind, start_rc=7)
    assert rc == base + 7
    assert calls == [("record", START, STREAM)]


@pytest.mark.parametrize("kind", sorted(LAUNCHERS))
def test_a_failed_end_record_is_reported(kind):
    rc, calls, _, base = _drive(kind, end_rc=5)
    assert rc == base + 5
    assert [c[0] for c in calls] == ["record", "launch", "record"]
