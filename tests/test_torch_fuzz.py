"""The port's FuzzedLink (tendermint_tpu_torch/p2p/fuzz.py) against the
JAX package's (tendermint_tpu/p2p/fuzz.py), on the CPU, tolerance 0.

Both wrappers are driven over the same recording inner links: with a
scripted decider and with seeded FuzzConfigs in drop and delay modes,
on the scalar (write / read), burst (write_many / read_burst) and
event-loop codec (seal_frames / feed_wire) paths, with and without the
inner link's vectored API. The frames that reach the inner link, the
frames returned, the faults observed and the exception raised on a
killed connection must be equal. Then the port's wrapper carries real
frames over the port's PlainFramedConn in both modes.
"""

import socket

import pytest

from tendermint_tpu.p2p import fuzz as jfuzz
from tendermint_tpu_torch.p2p import fuzz as tfuzz
from tendermint_tpu_torch.p2p.conn.mconn import PlainFramedConn


class _RecordingLink:
    """Inner link double recording which API got each frame."""

    def __init__(self, bursts=()):
        self.calls = []
        self._bursts = [list(b) for b in bursts]

    def write(self, data):
        self.calls.append(("write", bytes(data)))
        return len(data)

    def write_many(self, chunks):
        self.calls.append(("write_many", [bytes(c) for c in chunks]))
        return sum(len(c) for c in chunks)

    def read(self):
        burst = self.read_burst()
        return burst[0] if burst else b""

    def read_burst(self):
        return self._bursts.pop(0) if self._bursts else []

    def seal_frames(self, chunks):
        self.calls.append(("seal", [bytes(c) for c in chunks]))
        return b"|".join(chunks)

    def feed_wire(self, data):
        return [f for f in bytes(data).split(b"|") if f]

    def close(self):
        self.calls.append(("close",))


class _ScalarOnlyLink(_RecordingLink):
    """No vectored API: the wrapper degrades to per-frame calls."""
    write_many = None
    read_burst = None

    def __init__(self, frames=()):
        super().__init__()
        self._frames = list(frames)

    def read(self):
        return self._frames.pop(0) if self._frames else b""


BURSTS = [[b"p", b"q"], [b"r"], [b"s", b"t", b"u"], [b"v"]] * 6


def _script(link):
    """Every path of the wrapper, in a fixed order; returns what the
    caller saw."""
    out = []
    for k in range(8):
        out.append(link.write(b"w%d" % k))
        out.append(link.write_many([b"a%d" % k, b"b%d" % k, b"c%d" % k]))
        out.append(link.seal_frames([b"s%d" % k, b"t%d" % k]))
        out.append(link.feed_wire(b"x%d|y%d|z%d" % (k, k, k)))
        out.append(link.read_burst())
        out.append(link.read())
    link.close()
    return out


def _run(mod, make_inner, **kw):
    inner = make_inner()
    faults = []
    link = mod.FuzzedLink(inner, on_fault=faults.append, **kw)
    try:
        seen = _script(link)
        err = None
    except Exception as e:   # a killed connection
        seen, err = None, (type(e).__name__, str(e))
    return seen, err, inner.calls, faults


def _pattern(actions):
    def make():
        it = iter(actions)
        return lambda op: next(it, None)
    return make


PATTERN = (["drop", None, ("delay", 0.0), None, "pass"] * 60)


@pytest.mark.parametrize("inner", ["burst", "scalar"])
def test_scripted_decider_matches_jax(inner):
    make_inner = (lambda: _RecordingLink(BURSTS)) if inner == "burst" \
        else (lambda: _ScalarOnlyLink([b"f%d" % i for i in range(40)]))
    got = _run(tfuzz, make_inner, decider=_pattern(PATTERN)())
    want = _run(jfuzz, make_inner, decider=_pattern(PATTERN)())
    assert got == want
    assert "drop" in got[3] and "delay" in got[3]


@pytest.mark.parametrize("cfg", [
    dict(mode="drop", prob_drop_rw=0.3, seed=123),
    dict(mode="drop", prob_drop_rw=0.2, prob_drop_conn=0.02, seed=5),
    dict(mode="delay", prob_sleep=0.5, max_delay_s=0.0, seed=9),
    dict(mode="drop", prob_drop_rw=0.0, seed=1)])
def test_seeded_config_matches_jax(cfg):
    got = _run(tfuzz, lambda: _RecordingLink(BURSTS),
               config=tfuzz.FuzzConfig(**cfg))
    want = _run(jfuzz, lambda: _RecordingLink(BURSTS),
                config=jfuzz.FuzzConfig(**cfg))
    assert got == want


def test_unknown_action_raises_as_in_jax():
    errs = []
    for mod in (tfuzz, jfuzz):
        link = mod.FuzzedLink(_RecordingLink(), decider=lambda op: "warp")
        with pytest.raises(ValueError) as e:
            link.write(b"x")
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert tfuzz.FuzzConfig() == tfuzz.FuzzConfig(
        **vars(jfuzz.FuzzConfig()))


@pytest.mark.parametrize("vectored", [True, False])
def test_burst_and_scalar_paths_carry_frames_over_sockets(vectored):
    """Frames written through a fuzzed link arrive through a fuzzed
    link on the port's PlainFramedConn, the dropped one never."""
    s1, s2 = socket.socketpair()
    drops = iter([True, False, False, False])
    tx = tfuzz.FuzzedLink(PlainFramedConn(s1),
                          decider=lambda op: "drop" if next(drops, False)
                          else None)
    rx = tfuzz.FuzzedLink(PlainFramedConn(s2), decider=lambda op: None)
    try:
        frames = [b"f1", b"f2", b"f3", b"f4"]
        if vectored:
            tx.write_many(frames)
        else:
            for f in frames:
                tx.write(f)
        got = []
        while len(got) < 3:
            burst = rx.read_burst() if vectored else [rx.read()]
            assert burst, "EOF before the surviving frames arrived"
            got.extend(burst)
        assert got == [b"f2", b"f3", b"f4"]
    finally:
        tx.close()
        rx.close()
