"""The port's lock-order watchdog (tendermint_tpu_torch/analysis/
lockwatch.py) against the JAX package's, on the CPU.

- The same synthetic inversions, consistent orders and Condition waits
  give both watchdogs the same cycles and edges (sites named
  explicitly, threads named the same).
- parse_guard_annotations reads the same annotations as the JAX
  engine's on every watched module of both packages, and the port's
  WATCH_MODULES are the counterparts of the JAX ones.
- install() wraps only locks allocated in the port's package;
  watch_annotated() puts descriptors on the watched classes and records
  an unguarded touch from a second thread; uninstall() restores
  threading's own factories, also when the JAX watcher ran first.
- TM_CUDA_LOCKCHECK turns maybe_install() on; TM_TPU_LOCKCHECK does not.
"""

import inspect
import importlib
import threading
import time

import pytest

from tendermint_tpu.analysis import engine as jengine
from tendermint_tpu.analysis import lockwatch as jlw
from tendermint_tpu_torch.analysis import lockwatch as tlw

REAL_LOCK, REAL_RLOCK = threading.Lock, threading.RLock


@pytest.fixture
def watches():
    for lw in (jlw, tlw):
        lw.install()
        lw.clear()
    yield jlw, tlw
    for lw in (tlw, jlw):
        lw.uninstall()
        lw.clear()
    threading.Lock, threading.RLock = REAL_LOCK, REAL_RLOCK


def _run_named(fn, name):
    t = threading.Thread(target=fn, name=name, daemon=True)
    t.start()
    t.join(10)


def _inversion(lw):
    a = lw.make_lock(site="fixture.py:A")
    b = lw.make_lock(site="fixture.py:B")
    c = lw.make_lock("RLock", site="fixture.py:C")

    def ab():
        with a:
            with b:
                with c:
                    with c:
                        pass

    def ba():
        with b:
            with a:
                pass

    def ca():
        with c:
            with a:
                pass
    for fn, name in ((ab, "t-ab"), (ba, "t-ba"), (ca, "t-ca")):
        _run_named(fn, name)
    return lw.cycles(), lw.report()


def test_inversion_report_matches_jax(watches):
    jw, tw = watches
    got, want = _inversion(tw), _inversion(jw)
    assert got == want
    assert got[0] == [["fixture.py:A", "fixture.py:B", "fixture.py:C"]]


def test_consistent_order_and_condition_waits_are_clean_as_in_jax(watches):
    out = []
    for lw in watches:
        a = lw.make_lock(site="fixture.py:A")
        b = lw.make_lock(site="fixture.py:B")
        for _ in range(3):
            with a:
                with b:
                    pass
        cond = threading.Condition(lw.make_lock("RLock", "fixture.py:C"))
        other = lw.make_lock(site="fixture.py:D")
        hits = []

        def waiter():
            with cond:
                cond.wait(timeout=5)
                hits.append(1)
        t = threading.Thread(target=waiter, name="t-wait", daemon=True)
        t.start()
        time.sleep(0.1)
        with cond:
            cond.notify_all()
        t.join(5)
        with other:
            pass
        out.append((hits, lw.cycles(), lw.report()["edges"]))
    assert out[0] == out[1]
    assert out[1][0] == [1] and out[1][1] == []


def test_guard_annotations_read_as_the_jax_engine_does():
    for name in tlw.WATCH_MODULES + tuple(
            m.replace("tendermint_tpu.", "tendermint_tpu_torch.", 1)
            for m in jlw.WATCH_MODULES):
        src = inspect.getsource(importlib.import_module(name))
        assert [vars(a) for a in tlw.parse_guard_annotations(src)] == \
            [vars(a) for a in jengine.parse_guard_annotations(src)], name
    assert tlw.WATCH_MODULES == tuple(
        m.replace("tendermint_tpu.", "tendermint_tpu_torch.", 1)
        for m in jlw.WATCH_MODULES)
    assert tlw.parse_guard_annotations("def (") == []


def test_install_wraps_only_the_ports_locks_and_restores(watches):
    from tendermint_tpu_torch.models.coalescer import DispatchCoalescer
    from tendermint_tpu_torch.p2p.conn.mconn import MConnection
    tw = watches[1]
    foreign = threading.Lock()
    assert not isinstance(foreign, tw._WatchedLock)
    c = DispatchCoalescer(lambda items: (lambda: []), max_batch=4)
    try:
        assert isinstance(c._cond._lock, tw._WatchedLock)
        assert c._cond._lock.site.startswith("models/coalescer.py:")
    finally:
        c.close()
    n = tw.watch_annotated()
    assert n > 0
    assert isinstance(vars(MConnection)["_stopped"], tw._GuardedAttr)
    tw.uninstall()
    assert "_stopped" not in vars(MConnection)
    assert threading.Lock is REAL_LOCK and threading.RLock is REAL_RLOCK


def test_unguarded_touch_from_a_second_thread_is_recorded(watches):
    tw = watches[1]

    class Box:
        pass
    Box.x = tw._GuardedAttr("x", "_lock", "Box")
    box = Box()
    box._lock = tw.make_lock(site="fixture.py:L")
    with box._lock:
        box.x = 1
    box.x = 2                      # owner: this thread
    _run_named(lambda: box.x, "t-touch")
    with box._lock:
        _ = box.x
    v = tw.report()["attr_violations"]
    assert v == [{"class": "Box", "attr": "x", "lock": "_lock",
                  "thread": "t-touch"}]


def test_knob_is_tm_cuda_lockcheck(monkeypatch):
    monkeypatch.delenv("TM_CUDA_LOCKCHECK", raising=False)
    monkeypatch.setenv("TM_TPU_LOCKCHECK", "on")
    assert not tlw.enabled() and tlw.maybe_install() is False
    monkeypatch.setenv("TM_CUDA_LOCKCHECK", "on")
    try:
        assert tlw.enabled() and tlw.maybe_install() is True
        assert threading.Lock is not REAL_LOCK
    finally:
        tlw.uninstall()
        tlw.clear()
    assert threading.Lock is REAL_LOCK
