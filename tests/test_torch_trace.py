"""The port's causal plane and timeline merge (telemetry/causal.py,
telemetry/merge.py, telemetry/trace.py) against the JAX package's, on
the CPU, tolerance 0.

- Off: stamp() returns each envelope untouched, and its bytes under the
  port's codec are the JAX package's untraced bytes; take() on an
  untraced envelope changes nothing.
- On, with the node ids and the wall clocks pinned (the port's through
  utils/clock.set_wall_source, the JAX module's time reads patched):
  the stamped envelopes' bytes are equal, and a stamp made by either
  package is taken by the other, which records the same link span.
- The ring: the span catalog, capacity and drop count, the null span of
  replay, dump() with height bounds and the RTT provider, as the JAX
  module's.
- Merge: estimate_offsets, pair_rtt_floor_s, attribution, to_perfetto
  and merge_report give equal outputs on the same numpy-seeded dumps.
- StallDetector: fires once an episode, re-arms on progress, as JAX's.
- A mixed TCP net (two port and two JAX validators, trace on in both
  packages): each package's ring holds p2p.recv links whose origin is
  the other package's node id.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.telemetry import causal as jcausal
from tendermint_tpu.telemetry import merge as jmerge
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu_torch.telemetry import causal as tcausal
from tendermint_tpu_torch.telemetry import merge as tmerge
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.utils import clock as tclock

BOTH = (jcausal, tcausal)


def _reset():
    for c in BOTH:
        c.configure("off")
        c.clear()
        c.set_capacity(None)
        c.set_node("")
        c.set_rtt_provider(None)
    tclock.set_wall_source(None)


@pytest.fixture(autouse=True)
def _trace_reset(monkeypatch):
    """The causal plane is process-global in each package; every test
    starts and ends from the off/empty state."""
    monkeypatch.delenv("TM_TPU_TRACE", raising=False)
    monkeypatch.delenv("TM_CUDA_TRACE", raising=False)
    _reset()
    yield
    _reset()


@pytest.fixture
def pinned(monkeypatch):
    """Both wall clocks on one counter that ticks 1 ms at every read."""
    t = [1_700_000_000_000_000_000]

    def now():
        t[0] += 1_000_000
        return t[0]
    monkeypatch.setattr(jcausal, "time", SimpleNamespace(
        time_ns=now, perf_counter=time.perf_counter,
        monotonic=time.monotonic))
    tclock.set_wall_source(now)
    return t


_ENVELOPES = [
    {"type": "proposal", "proposal": {"height": 7, "round": 0,
                                      "block_parts_header":
                                          {"total": 3, "hash": "aa"}}},
    {"type": "block_part", "height": 7, "round": 0,
     "part": {"index": 1, "bytes": "00ff", "proof": []}},
    {"type": "vote", "vote": {"height": 7, "round": 0, "type": 1,
                              "validator_index": 2}},
    {"type": "vote_agg", "votes": [{"height": 7, "round": 1, "type": 2}]},
    {"type": "new_round_step", "height": 7, "round": 0, "step": 3,
     "last_commit_round": 0},
    {"type": "has_vote", "height": 7, "round": 0, "vote_type": 1,
     "index": 2},
    {"type": "compact_block", "height": 7, "round": 2, "ids": ["0a"]},
    {"type": "txs", "txs": ["aabb", "ccdd"]},
    {"type": "tx", "tx": "aabb"},
]


def test_wire_bytes_untouched_when_off():
    assert not tcausal.enabled()
    for msg in _ENVELOPES:
        baseline = jenc.cdumps(msg)
        out = tcausal.stamp(msg, 7, 0)
        assert out is msg and "tr" not in msg
        assert tenc.cdumps(out) == baseline, msg["type"]
        before = dict(msg)
        assert tcausal.take(msg, msg["type"]) is None
        assert msg == before
    assert tcausal.dump()["spans"] == []


@pytest.mark.parametrize("i", range(len(_ENVELOPES)))
def test_stamped_bytes_equal_jax(pinned, i):
    for c in BOTH:
        c.configure("on")
        c.set_node("node-a")
    h, r = 7 + i, i % 3 - 1
    pinned_start = pinned[0]
    jmsg = jcausal.stamp(dict(_ENVELOPES[i]), h, r)
    pinned[0] = pinned_start
    tmsg = tcausal.stamp(dict(_ENVELOPES[i]), h, r)
    assert tenc.cdumps(tmsg) == jenc.cdumps(jmsg)
    assert tmsg["tr"] == [f"{h}.{r}", "node-a", pinned_start + 1_000_000]


@pytest.mark.parametrize("src,dst", [(jcausal, tcausal),
                                     (tcausal, jcausal)],
                         ids=["jax_to_port", "port_to_jax"])
def test_stamps_cross_between_packages(pinned, src, dst):
    for c in BOTH:
        c.configure("on")
    src.set_node("sender")
    dst.set_node("receiver")
    for msg in _ENVELOPES:
        wire = (jenc if src is jcausal else tenc).cdumps(
            src.stamp(dict(msg), 9, 1))
        got = (tenc if dst is tcausal else jenc).cloads(wire)
        tr = dst.take(got, msg["type"])
        assert tr[1] == "sender" and "tr" not in got
        assert got == msg
    spans = dst.dump()["spans"]
    assert len(spans) == len(_ENVELOPES)
    kinds = [ev["n"] for ev in spans]
    assert kinds.count("mempool.recv") == 2
    assert all(ev["a"]["origin"] == "sender" and ev["h"] == 9
               and ev["r"] == 1 and ev["a"]["sent"] < ev["t"]
               for ev in spans)


def _ring_script(c):
    c.configure("on")
    c.set_node("n0")
    c.set_capacity(5)
    with pytest.raises(ValueError):
        c.record("not.a.span", 1)
    for h in range(1, 9):
        c.point("commit", h, 0, txs=h)
    with c.span("apply", 9, txs=3):
        pass
    c.record("verify.dispatch", -1, t0_ns=5, dur_ns=7, n=4,
             backend="cuda")
    c.take(c.stamp({"type": "vote", "vote": {}}, 3, 0), "vote")
    c.set_rtt_provider(lambda: {"p1": 0.002, "p2": 0.0})
    with c.null_span():
        pass
    out = []
    for lo, hi in ((0, 0), (7, 8), (9, 0)):
        d = c.dump(lo, hi)
        for k in ("pid", "wall_ns"):
            d.pop(k)
        out.append(d)
    return out


@pytest.fixture
def registries_on():
    """Both metric registries on, restored after: the drop counts are
    read off the families, and tests/test_compact.py's `metrics`
    fixture leaves the JAX registry off for the rest of its worker."""
    from tendermint_tpu.telemetry import registry as jreg
    from tendermint_tpu_torch.telemetry import registry as treg
    saved = [m._state.enabled for m in (jreg, treg)]
    for m in (jreg, treg):
        m.set_enabled(True)
    yield
    for m, on in zip((jreg, treg), saved):
        m._state.enabled = on


def test_ring_cap_drops_and_dump_as_jax(pinned, registries_on):
    from tendermint_tpu import telemetry as jtel
    from tendermint_tpu_torch import telemetry as ttel
    jd0 = jtel.value("trace_events_dropped_total") or 0
    td0 = ttel.value("trace_events_dropped_total") or 0
    start = pinned[0]
    got_j = _ring_script(jcausal)
    pinned[0] = start
    got_t = _ring_script(tcausal)
    # the span's duration is on the perf counter: compare all but it
    for got in (got_j, got_t):
        for d in got:
            for ev in d["spans"]:
                if ev["n"] == "apply":
                    assert ev["d"] >= 0
                    ev["d"] = 0
    assert got_t == got_j
    assert got_t[0]["events"] == 5 and got_t[0]["rtt_s"] == {"p1": 0.002}
    jd = (jtel.value("trace_events_dropped_total") or 0) - jd0
    td = (ttel.value("trace_events_dropped_total") or 0) - td0
    assert td == jd > 0


# ----------------------------------------------------------------- merge

def _dumps(seed: int, nodes=3, heights=12):
    """Seeded per-node span buffers: each node's height boundaries on a
    skewed clock, with link samples between every ordered pair."""
    rng = np.random.default_rng(seed)
    ms = 1_000_000
    skews = [0] + [int(rng.integers(-80, 80)) * ms
                   for _ in range(nodes - 1)]
    stages = (("height.begin", 0), ("proposal.recv", 3), ("part.first", 5),
              ("block.full", 15), ("quorum.prevote", 25),
              ("quorum.precommit", 35), ("commit", 62))
    out = []
    for n in range(nodes):
        spans = []
        for h in range(1, heights + 1):
            t0 = h * 300 * ms + int(rng.integers(0, 4)) * ms
            for name, at in stages:
                spans.append({"n": name, "h": h, "r": 0,
                              "t": t0 + at * ms + skews[n], "d": 0})
            spans.append({"n": "apply", "h": h, "r": -1,
                          "t": t0 + 36 * ms + skews[n],
                          "d": int(rng.integers(10, 20)) * ms})
            spans.append({"n": "wal.fsync", "h": h, "r": -1,
                          "t": t0 + 55 * ms + skews[n], "d": 4 * ms})
            spans.append({"n": "verify.dispatch", "h": -1, "r": -1,
                          "t": t0 + 26 * ms + skews[n], "d": 1200000,
                          "a": {"n": 4, "backend": "cuda"}})
            for m in range(nodes):
                if m == n:
                    continue
                delay = int(rng.integers(1, 5)) * ms
                sent = t0 + 10 * ms + skews[m]
                spans.append({"n": "p2p.recv", "h": h, "r": 0,
                              "t": t0 + 10 * ms + delay + skews[n],
                              "d": 0, "a": {"origin": f"node{m}",
                                            "sent": sent,
                                            "kind": "vote"}})
        out.append({"node": f"node{n}", "pid": 100 + n, "wall_ns": 0,
                    "enabled": True, "capacity": 65536,
                    "events": len(spans), "rtt_s": {}, "spans": spans})
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_merge_outputs_equal_jax(seed):
    dumps = _dumps(seed)
    off_t = tmerge.estimate_offsets(dumps)
    assert off_t == jmerge.estimate_offsets(dumps)
    assert tmerge.pair_rtt_floor_s(dumps) == jmerge.pair_rtt_floor_s(dumps)
    assert tmerge.attribution(dumps, off_t) == \
        jmerge.attribution(dumps, off_t)
    assert tmerge.to_perfetto(dumps, off_t) == \
        jmerge.to_perfetto(dumps, off_t)
    assert tmerge.merge_report(dumps) == jmerge.merge_report(dumps)
    rep = tmerge.attribution(dumps, off_t)
    assert rep["heights"] == 12 and rep["coverage_mean"] > 0.9


def test_stall_detector_fires_once_an_episode_like_jax():
    fired = {}
    for c in BOTH:
        height = [1]
        calls = []
        d = c.StallDetector(lambda: height[0],
                            lambda h, s: calls.append(h), 0.1,
                            poll_s=0.01)
        d.start()
        try:
            deadline = time.monotonic() + 5
            while not calls and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.2)                 # still stalled: no re-fire
            n1, stalled = len(calls), d.stalled
            height[0] = 2                   # progress re-arms
            deadline = time.monotonic() + 5
            while len(calls) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            d.stop()
        fired[c.__name__.split(".")[0]] = (n1, stalled, calls[:2], d.fired)
    assert fired["tendermint_tpu_torch"] == fired["tendermint_tpu"] == \
        (1, True, [1, 2], 2)


# --------------------------------------------------------- mixed TCP net

def test_mixed_net_rings_hold_each_others_links(monkeypatch):
    from tendermint_tpu_torch import pipeline as tpipeline
    from tendermint_tpu_torch.p2p import socknet
    from tests.test_torch_reactors import (CPU, WAIT_S, JaxSockNode,
                                           _bench, _jax_genesis)
    from tendermint_tpu.types.keys import PrivKey as JPrivKey
    monkeypatch.setenv("TM_TPU_PIPELINE", "off")
    monkeypatch.setattr(tpipeline, "_configured", "off")
    for c in BOTH:
        c.configure("on")
    jcausal.set_node("jaxnode")
    tcausal.set_node("portnode")
    net = socknet.SockNet(_bench(), verifier_of=lambda i: CPU)
    jkeys = [JPrivKey.generate(bytes([i + 1]) * 32) for i in range(4)]
    jax_nodes = []
    try:
        net.start(validators=[0, 1])
        for i in (2, 3):
            jax_nodes.append(JaxSockNode(i, jkeys[i], _jax_genesis(jkeys)))
            net.add_node(jax_nodes[-1])
        net.feed(0, [b"tr/k%d=v" % i for i in range(100)])
        net.wait_height(3, WAIT_S)
        assert net.disagreements() == []
    finally:
        for n in jax_nodes:
            n.close()
        net.close()
    links = {}
    for name, c in (("jax", jcausal), ("port", tcausal)):
        links[name] = {ev["a"]["origin"] for ev in c.dump()["spans"]
                       if ev["n"] in ("p2p.recv", "mempool.recv")}
    assert "portnode" in links["jax"], links
    assert "jaxnode" in links["port"], links
    port_names = {ev["n"] for ev in tcausal.dump()["spans"]}
    assert {"height.begin", "commit", "apply", "quorum.precommit",
            "verify.dispatch"} <= port_names
