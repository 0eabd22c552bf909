"""The port's mempool (tendermint_tpu_torch.mempool) against the JAX
package's, on the CPU.

Every CList, TxCache and Mempool case of tests/test_mempool.py (not its
reactor cases) runs in both packages on the same txs and apps, keeping
the reference test's assertions; the outcomes (reaped txs, results,
errors with their messages, tx-WAL file bytes, hook calls) must be
equal. The check_tx_batch, get_by_hash and pending_hashes surface and
the by-hash index's lockstep with the pending list are held too.
"""

import hashlib
import os
import threading
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.abci import proxy as jproxy
from tendermint_tpu.abci.apps import counter as jcounter
from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.mempool import clist as jclist
from tendermint_tpu.mempool import mempool as jmempool
from tendermint_tpu_torch.abci import proxy as tproxy
from tendermint_tpu_torch.abci.apps import counter as tcounter
from tendermint_tpu_torch.abci.apps import kvstore as tkv
from tendermint_tpu_torch.mempool import clist as tclist
from tendermint_tpu_torch.mempool import mempool as tmempool

JAX = SimpleNamespace(name="jax", proxy=jproxy, counter=jcounter.CounterApp,
                      kv=lambda: jkv.KVStoreApp(use_native=False),
                      clist=jclist, mp=jmempool)
PORT = SimpleNamespace(name="port", proxy=tproxy, counter=tcounter.CounterApp,
                       kv=tkv.KVStoreApp, clist=tclist, mp=tmempool)


def _conns(P, app):
    return P.proxy.AppConns(P.proxy.local_client_creator(app))


def make_mempool(P, app=None, **kw):
    app = app or P.counter(serial=False)
    return P.mp.Mempool(_conns(P, app).mempool, **kw), app


def _both(case, *args):
    out = {P.name: case(P, *args) for P in (JAX, PORT)}
    assert out["port"] == out["jax"]
    return out["port"]


def _raises(fn, exc):
    with pytest.raises(exc) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# ------------------------------------------------------------------- CList

def case_clist_push_iterate_remove(P):
    cl = P.clist.CList()
    els = [cl.push_back(i) for i in range(5)]
    assert len(cl) == 5
    seen = [[e.value for e in cl]]
    cl.remove(els[2])
    seen.append([e.value for e in cl])
    assert els[2].next().value == 3
    cl.remove(els[0])
    assert cl.front().value == 1
    cl.clear()
    assert len(cl) == 0 and cl.front() is None and els[4].removed
    return seen


def case_clist_next_wait_wakes_on_push(P):
    cl = P.clist.CList()
    el = cl.push_back("a")
    got = []
    t = threading.Thread(target=lambda: got.append(el.next_wait(timeout=5.0)))
    t.start()
    time.sleep(0.05)
    cl.push_back("b")
    t.join(timeout=5.0)
    assert not t.is_alive()
    return got[0].value


def case_clist_front_wait_timeout(P):
    cl = P.clist.CList()
    t0 = time.monotonic()
    assert cl.front_wait(timeout=0.05) is None
    assert time.monotonic() - t0 >= 0.04


def case_tx_cache_dedup_and_eviction(P):
    c = P.mp.TxCache(size=2)
    out = [c.push(b"a"), c.push(b"a"), c.push(b"b"), c.push(b"c"),
           c.push(b"a")]
    c.remove(b"c")
    out.append(c.push(b"c"))
    c.reset()
    out.append(c.push(b"b"))
    assert out == [True, False, True, True, True, True, True]
    return out


# ------------------------------------------------------------------ Mempool

def case_checktx_reap_order_and_dedup(P):
    mp, _ = make_mempool(P)
    res = [mp.check_tx(bytes([i])).to_obj() for i in range(10)]
    assert mp.size() == 10
    assert mp.reap(4) == [bytes([i]) for i in range(4)]
    assert mp.reap(-1) == [bytes([i]) for i in range(10)]
    return res, _raises(lambda: mp.check_tx(bytes([3])),
                        P.mp.TxAlreadyInCache)


def case_invalid_tx_not_queued_not_cached(P):
    app = P.counter(serial=True)
    mp, _ = make_mempool(P, app)
    for i in range(3):
        app.deliver_tx(i.to_bytes(8, "big"))
    bad = (1).to_bytes(8, "big")
    res = mp.check_tx(bad)
    assert not res.ok and mp.size() == 0
    res2 = mp.check_tx(bad)
    assert not res2.ok
    return res.to_obj(), res2.to_obj()


def case_update_removes_committed_and_keeps_cache(P):
    mp, _ = make_mempool(P)
    txs = [bytes([i]) for i in range(6)]
    for tx in txs:
        mp.check_tx(tx)
    mp.lock()
    mp.update(1, txs[:3])
    mp.unlock()
    assert mp.reap(-1) == txs[3:]
    return _raises(lambda: mp.check_tx(txs[0]), P.mp.TxAlreadyInCache)


def case_update_recheck_drops_newly_invalid(P):
    app = P.counter(serial=True)
    mp = P.mp.Mempool(_conns(P, app).mempool)
    good = [i.to_bytes(8, "big") for i in range(4)]
    for tx in good:
        assert mp.check_tx(tx).ok
    for tx in good[:3]:
        app.deliver_tx(tx)
    mp.update(1, good[:2])
    assert mp.reap(-1) == good[3:]
    # the hash index follows the pending list in lockstep
    assert mp.pending_hashes() == [hashlib.sha256(good[3]).digest()]
    assert mp.get_by_hash(hashlib.sha256(good[2]).digest()) is None
    return mp.reap(-1), mp.size()


def case_txs_available_fires_once_per_height(P):
    mp, _ = make_mempool(P)
    fired = []
    mp.txs_available_hook = lambda: fired.append(mp.height)
    mp.check_tx(b"x")
    mp.check_tx(b"y")
    assert fired == [0]
    mp.update(1, [b"x"])
    assert fired == [0, 1]
    mp.check_tx_batch([b"z", b"w"])
    mp.update(2, [b"y", b"z", b"w"])
    mp.check_tx_batch([b"v"])
    return fired


class _Cfg:
    recheck = True

    def __init__(self, size, cache_size):
        self.size, self.cache_size = size, cache_size


def case_mempool_full_raises(P):
    mp, _ = make_mempool(P, config=_Cfg(3, 100))
    for i in range(3):
        mp.check_tx(bytes([i]))
    return _raises(lambda: mp.check_tx(b"overflow"), P.mp.MempoolFull)


def case_wal_replay_restores_pending_txs(P, d):
    wal_dir = os.path.join(d, "mwal")
    mp, _ = make_mempool(P, wal_dir=wal_dir)
    txs = [b"\n\x00weird" + bytes([i]) for i in range(5)]
    for tx in txs:
        mp.check_tx(tx)
    mp.close()
    with open(os.path.join(wal_dir, "wal"), "rb") as f:
        data = f.read()
    mp2, _ = make_mempool(P, wal_dir=wal_dir)
    assert mp2.reap(-1) == txs
    return data


def case_wal_committed_txs_never_replay(P, d):
    wal_dir = os.path.join(d, "mwal")
    mp, _ = make_mempool(P, wal_dir=wal_dir)
    txs = [bytes([i]) for i in range(4)]
    for tx in txs:
        mp.check_tx(tx)
    mp.update(1, txs[:2])
    mp.close()
    with open(os.path.join(wal_dir, "wal"), "rb") as f:
        data = f.read()
    mp2, _ = make_mempool(P, wal_dir=wal_dir)
    assert mp2.reap(-1) == txs[2:]
    return data


def case_pending_tx_resubmit_after_cache_eviction_is_dup(P):
    mp, _ = make_mempool(P, config=_Cfg(1000, 2))
    mp.check_tx(b"T")
    mp.check_tx(b"a")
    mp.check_tx(b"b")
    err = _raises(lambda: mp.check_tx(b"T"), P.mp.TxAlreadyInCache)
    assert mp.reap(-1) == [b"T", b"a", b"b"]
    return err


def case_wal_replay_drops_torn_tail(P, d):
    wal_dir = os.path.join(d, "mwal")
    mp, _ = make_mempool(P, wal_dir=wal_dir)
    mp.check_tx(b"complete")
    mp.close()
    with open(os.path.join(wal_dir, "wal"), "ab") as f:
        f.write(b"\x00\x00\x00\xffhalf-a-record")
    mp2, _ = make_mempool(P, wal_dir=wal_dir)
    assert mp2.reap(-1) == [b"complete"]


def case_concurrent_checktx_threadsafe(P):
    mp, _ = make_mempool(P)
    errs = []

    def feed(base):
        try:
            for i in range(50):
                mp.check_tx(base + i.to_bytes(2, "big"))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=feed, args=(bytes([t]),))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and mp.size() == 200
    assert sorted(mp.reap(-1)) == sorted(
        bytes([t]) + i.to_bytes(2, "big") for t in range(4)
        for i in range(50))


def case_check_tx_batch_outcomes(P, d):
    """One batch with duplicates (pending and within the batch), an
    invalid (empty) tx and a full pool, on the kvstore app, then its tx
    WAL and the by-hash index."""
    wal_dir = os.path.join(d, "mwal")
    mp, _ = make_mempool(P, P.kv(), config=_Cfg(6, 100), wal_dir=wal_dir)
    mp.check_tx(b"k0=v")
    batch = [b"k1=v", b"k0=v", b"", b"k2=v", b"k2=v", b"k3=v", b"k4=v",
             b"k5=v", b"k6=v"]
    res = [r.to_obj() for r in mp.check_tx_batch(batch)]
    with open(os.path.join(wal_dir, "wal"), "rb") as f:
        data = f.read()
    hashes = mp.pending_hashes()
    assert hashes == [hashlib.sha256(tx).digest() for tx in mp.reap(-1)]
    assert all(mp.get_by_hash(h) == tx for h, tx in zip(hashes, mp.reap(-1)))
    mp.flush()
    assert mp.size() == 0 and mp.pending_hashes() == []
    return res, data, [e.value.counter for e in mp.txs]


MEMPOOL_CASES = [
    case_clist_push_iterate_remove,
    case_clist_next_wait_wakes_on_push,
    case_clist_front_wait_timeout,
    case_tx_cache_dedup_and_eviction,
    case_checktx_reap_order_and_dedup,
    case_invalid_tx_not_queued_not_cached,
    case_update_removes_committed_and_keeps_cache,
    case_update_recheck_drops_newly_invalid,
    case_txs_available_fires_once_per_height,
    case_mempool_full_raises,
    case_pending_tx_resubmit_after_cache_eviction_is_dup,
    case_concurrent_checktx_threadsafe,
]
FILE_CASES = [
    case_wal_replay_restores_pending_txs,
    case_wal_committed_txs_never_replay,
    case_wal_replay_drops_torn_tail,
    case_check_tx_batch_outcomes,
]


@pytest.mark.parametrize("case", MEMPOOL_CASES, ids=lambda f: f.__name__[5:])
def test_mempool_case_matches_jax(case):
    _both(case)


@pytest.mark.parametrize("case", FILE_CASES, ids=lambda f: f.__name__[5:])
def test_mempool_file_case_matches_jax(case, tmp_path):
    out = {}
    for P in (JAX, PORT):
        d = tmp_path / P.name
        d.mkdir()
        out[P.name] = case(P, str(d))
    assert out["port"] == out["jax"]


def test_counter_app_matches_jax():
    """The port's copy of the counter app, which the cases above use."""
    out = {}
    for P in (JAX, PORT):
        app = P.counter(serial=True)
        seq = [app.check_tx((i % 3).to_bytes(8, "big")).to_obj()
               for i in range(4)]
        seq += [app.deliver_tx(i.to_bytes(8, "big")).to_obj()
                for i in (0, 1, 5)]
        seq += [app.commit(), app.info().to_obj(),
                app.query("tx", b"", 0, False).to_obj(),
                app.set_option("serial", "off")]
        out[P.name] = seq
    assert out["port"] == out["jax"]
