"""The port's tx-lifecycle SLO plane (telemetry/slo.py) against the JAX
package's, on the CPU, tolerance 0.

- Sampling: the same seeded txs give the same hash-based decisions in
  both packages at every rate, and the knobs (TM_CUDA_SLO /
  _SLO_SAMPLE) and config keys resolve as the JAX ones do.
- Trackers on pinned clocks (one step list, drawn with numpy, drives
  both): admissions, every stage stamp (missing ones, repeats and an
  out-of-order one included), overflow eviction and timeout sweeps give
  equal snapshots (stages, windows, sketches, drops, violations), tail
  attribution, verdicts and merged snapshots.
- The port's default tracker reads utils/clock.monotonic_ns, which a test
  pins without sleeping.
- Off: no entry point records anything, and the snapshot says so.
- The stamp sites: a port mempool stamps checktx, the event bus publish
  and a delivered Tx event deliver, in order, for a tx admitted at the
  front door's route.
"""

import hashlib

import numpy as np
import pytest

from tendermint_tpu.telemetry import causal as jcausal
from tendermint_tpu.telemetry import slo as jslo
from tendermint_tpu_torch.telemetry import causal as tcausal
from tendermint_tpu_torch.telemetry import slo as tslo
from tendermint_tpu_torch.utils import clock as tclock

BOTH = (jslo, tslo)
CAUSAL = (jcausal, tcausal)


@pytest.fixture(autouse=True)
def _slo_reset(monkeypatch):
    """Each package's tracker is process-global: every test starts and
    ends off and empty. The snapshots name the causal plane's node id,
    process-global too (an earlier test may have set either package's):
    both read the same one here."""
    for k in ("TM_TPU_SLO", "TM_TPU_SLO_SAMPLE", "TM_CUDA_SLO",
              "TM_CUDA_SLO_SAMPLE"):
        monkeypatch.delenv(k, raising=False)
    nodes = [c.node() for c in CAUSAL]
    for c in CAUSAL:
        c.set_node("slo-node")
    for m in BOTH:
        m.configure("off")
        m.reset()
    yield
    for m in BOTH:
        m.configure("off")
        m.reset()
    for c, n in zip(CAUSAL, nodes):
        c.set_node(n)
    tclock.set_monotonic_source(None)


def _on(rate=1.0):
    for m in BOTH:
        m.configure("on", rate)
        m.reset()


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.93, 1.0])
def test_sampling_decisions_equal_jax(rate):
    _on(rate)
    rng = np.random.default_rng(int(rate * 100))
    txs = [rng.bytes(int(rng.integers(1, 64))) for _ in range(3000)]
    dj = [jslo.sampled(hashlib.sha256(t).digest()) for t in txs]
    dt = [tslo.sampled(hashlib.sha256(t).digest()) for t in txs]
    assert dt == dj
    assert tslo.sample_rate() == jslo.sample_rate() == rate
    assert [tslo.tx_key(t) for t in txs[:50]] == \
        [jslo.tx_key(t) for t in txs[:50]]


def test_knobs_win_over_config_as_jax(monkeypatch):
    for m in BOTH:
        m.configure("off", 0.25)
        m.reset()
    assert not tslo.enabled() and tslo.sample_rate() == 0.25
    monkeypatch.setenv("TM_CUDA_SLO", "on")
    monkeypatch.setenv("TM_CUDA_SLO_SAMPLE", "0.75")
    monkeypatch.setenv("TM_TPU_SLO", "on")
    monkeypatch.setenv("TM_TPU_SLO_SAMPLE", "0.75")
    for m in BOTH:
        m.reset()
    assert (tslo.enabled(), tslo.sample_rate()) == \
        (jslo.enabled(), jslo.sample_rate()) == (True, 0.75)


def _script(seed):
    """A step list: (op, tx index, stage, height, advance ns). Each tx
    is admitted and then stamped; some skip stages, some repeat one,
    tx 7 stamps publish a second before its commit, every 13th sits
    through a timeout sweep, and the last 30 are only admitted (an
    in-flight cap below 30 evicts the oldest)."""
    rng = np.random.default_rng(seed)
    ops = []
    stages = ("checktx", "propose", "commit", "publish", "deliver")
    for i in range(60):
        h = 1 + i // 10
        ops.append(("admit", i, "", 0, int(rng.integers(1, 3)) * 10 ** 6))
        if i % 13 == 5:
            ops.append(("sweep", i, "", 0, 130 * 10 ** 9))
        for s in stages:
            if rng.random() < 0.15 and s != "deliver" and i != 7:
                continue                    # a stage this node missed
            adv = int(rng.exponential(20)) * 10 ** 6
            if i == 7 and s == "publish":
                adv = -10 ** 9              # one out-of-order stamp
            ops.append(("mark", i, s, h, adv))
            if rng.random() < 0.1:
                ops.append(("mark", i, s, h + 1, 10 ** 6))  # repeat
    for i in range(60, 90):
        ops.append(("admit", i, "", 0, 10 ** 6))
    return ops


def _run(mod, ops, cap):
    now = [10 ** 12]
    t = mod.SLOTracker(now_ns=lambda: now[0], inflight_cap=cap,
                       timeout_s=120.0)
    txs = [b"slo-tx-%04d" % i for i in range(90)]
    for op, i, stage, h, adv in ops:
        now[0] += adv
        if op == "admit":
            t.admit(txs[i], chain="c1" if i % 2 else "")
        elif op == "mark":
            t.mark(txs[i], stage, height=h)
        else:
            t.sweep()
    return t


@pytest.mark.parametrize("seed,cap", [(1, 16384), (2, 16384), (3, 20)])
def test_tracker_snapshots_equal_jax_under_pinned_clocks(seed, cap):
    _on()
    ops = _script(seed)
    tj, tt = _run(jslo, ops, cap), _run(tslo, ops, cap)
    for w in (False, True):
        assert tt.snapshot(windows=w, sketches=True) == \
            tj.snapshot(windows=w, sketches=True)
    assert tt.tail_attribution() == tj.tail_attribution()
    assert tt.verdict() == tj.verdict()
    assert tt.monotonic_violations == tj.monotonic_violations >= 1
    assert (tt.sampled_total, tt.completed_total, tt.dropped) == \
        (tj.sampled_total, tj.completed_total, tj.dropped)
    assert tt.completed_total > 40 and tt.dropped["timeout"] >= 4
    assert (tt.dropped["overflow"] > 0) == (cap < 30)
    sj = [tj.snapshot(sketches=True), _run(jslo, _script(seed + 10),
                                           cap).snapshot(sketches=True)]
    st = [tt.snapshot(sketches=True), _run(tslo, _script(seed + 10),
                                           cap).snapshot(sketches=True)]
    assert tslo.merge_snapshots(st) == jslo.merge_snapshots(sj)


def test_default_tracker_reads_the_pinned_monotonic_clock():
    _on()
    now = [5 * 10 ** 9]
    tclock.set_monotonic_source(lambda: now[0])
    t = tslo.SLOTracker()
    t.admit(b"pinned")
    now[0] += 7 * 10 ** 6
    t.mark(b"pinned", "checktx")
    snap = t.snapshot(windows=False)
    assert snap["stages"]["checktx"]["p50_ms"] == 7.0
    assert t.monotonic_violations == 0


def test_off_records_nothing():
    assert not tslo.enabled()
    tslo.admit(b"tx")
    tslo.mark(b"tx", "checktx")
    tslo.mark_many([b"tx"], "commit", 3)
    assert len(tslo.TRACKER._inflight) == 0
    assert tslo.TRACKER.sampled_total == 0
    assert tslo.snapshot()["enabled"] is False
    assert tslo.verdict() == jslo.verdict()
    assert tslo.snapshot().keys() == jslo.snapshot().keys()


def test_stamp_sites_order_a_front_door_tx():
    """broadcast_tx_sync's admit, the mempool's checktx, the executor's
    commit, the bus's publish and a delivered Tx event's deliver."""
    _on()
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.proxy import local_client_creator
    from tendermint_tpu_torch.mempool import Mempool
    from tendermint_tpu_torch.rpc.core import RPCCore, RPCEnv
    from tendermint_tpu_torch.types.events import EventBus

    bus = EventBus()
    sub = bus.subscribe("s", "tm.event = 'Tx'")
    mp = Mempool(local_client_creator(KVStoreApp())(), height=0)
    core = RPCCore(RPCEnv(mempool=mp, event_bus=bus))
    tx = b"slo=k"
    assert core.broadcast_tx_sync(tx)["code"] == 0
    key = tslo.tx_key(tx)
    e = tslo.TRACKER._inflight[key]
    assert list(e.stamps) == ["admit", "checktx"]
    tslo.mark_many([tx], "propose", 1)
    tslo.mark_many([tx], "commit", 1)
    bus.publish_tx(1, 0, tx, None)
    assert list(e.stamps) == ["admit", "checktx", "propose", "commit",
                              "publish"]
    tslo.deliver_item(sub.get_nowait())
    assert key not in tslo.TRACKER._inflight
    assert tslo.TRACKER.completed_total == 1
    assert tslo.TRACKER.monotonic_violations == 0
