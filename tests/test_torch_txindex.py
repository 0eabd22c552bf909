"""The port's tx indexer (state/txindex.py) against the JAX package's, on
the CPU, tolerance 0.

- KVTxIndexer: the same seeded entries (a tag name and values with '/'
  and '%' in them, numeric and string values) give the same database
  rows key for key, with index_all_tags, with a tag list and with no tags; `get`
  and every `tx_search` query (point lookup by hash, =, !=, <, <=, >, >=,
  CONTAINS, AND-composed, tx.height ranges) give the same results.
- IndexerService: EventTx events published on each package's EventBus
  index the same rows, and stop() releases the subscription.
- NullTxIndexer indexes nothing.
"""

import hashlib
import random
import time

import pytest

from tendermint_tpu.state import txindex as jtxindex
from tendermint_tpu.storage import MemDB as JMemDB
from tendermint_tpu.types.events import EventBus as JEventBus
from tendermint_tpu_torch.abci.types import ResultDeliverTx
from tendermint_tpu_torch.state import txindex as ttxindex
from tendermint_tpu_torch.storage import MemDB
from tendermint_tpu_torch.types.events import EventBus

TAGS = ("app.key", "acct.name", "fee", "amount", "odd/tag%")


def _entries(seed: int, n: int = 60):
    rng = random.Random(seed)
    out = []
    for k in range(n):
        height, index = 1 + k // 7, k % 7
        tags = {"app.key": f"k{rng.randrange(9)}",
                "acct.name": rng.choice(["al/ice", "bob", "c%arol"]),
                "fee": rng.randrange(0, 300),
                "amount": str(rng.randrange(-5, 50)),
                "odd/tag%": rng.choice(["x/y", "50%"])}
        tx = b"tx-%d-%d" % (seed, k)
        out.append({"height": height, "index": index, "tx": tx,
                    "result": {"code": 0, "data": "", "log": f"l{k}",
                               "tags": {}},
                    "tags": {t: tags[t] for t in TAGS
                             if rng.random() < 0.8}})
    return out


QUERIES = [
    "app.key = 'k3'", "app.key != 'k3'", "fee > 100", "fee >= 100",
    "fee < 20", "fee <= 20", "acct.name = 'al/ice'",
    "acct.name CONTAINS 'o'", "amount < 0", "amount >= 10 AND fee < 150",
    "tx.height = 3", "tx.height > 4 AND tx.height <= 6",
    "app.key = 'k1' AND acct.name = 'c%arol'", "app.key = 'nope'",
]


def _rows(db):
    return list(db.iterate(b""))


def _build(mod, db_cls, entries, **kw):
    db = db_cls()
    ix = mod.KVTxIndexer(db, **kw)
    ix.add_batch(entries[:30])
    ix.add_batch(entries[30:])
    return ix, db


@pytest.mark.parametrize("kw", [{"index_all_tags": True},
                                {"index_tags": ["app.key", "fee",
                                                "odd/tag%"]},
                                {}], ids=["all", "some", "none"])
def test_kv_indexer_rows_and_searches_match_jax(kw):
    entries = _entries(5)
    jix, jdb = _build(jtxindex, JMemDB, entries, **kw)
    tix, tdb = _build(ttxindex, MemDB, entries, **kw)
    assert _rows(tdb) == _rows(jdb)
    assert len(_rows(tdb)) >= 2 * len(entries)
    for e in entries[::7]:
        h = hashlib.sha256(e["tx"]).digest()
        assert tix.get(h) == jix.get(h) is not None
    assert tix.get(b"\x00" * 32) is None
    point = hashlib.sha256(entries[4]["tx"]).hexdigest()
    for q in QUERIES + [f"tx.hash = '{point}'"]:
        assert tix.search(q) == jix.search(q), q
    if kw.get("index_all_tags"):
        assert tix.search("app.key = 'k3'")


def test_bad_query_raises_as_in_jax():
    tix, _ = _build(ttxindex, MemDB, _entries(2, 5), index_all_tags=True)
    jix, _ = _build(jtxindex, JMemDB, _entries(2, 5), index_all_tags=True)
    for q in ("app.key ~ 'x'", "= 3"):
        with pytest.raises(Exception) as te:
            tix.search(q)
        with pytest.raises(Exception) as je:
            jix.search(q)
        assert (type(te.value).__name__, str(te.value)) == \
            (type(je.value).__name__, str(je.value))


def _serve(mod, db_cls, bus_cls, entries):
    bus = bus_cls()
    db = db_cls()
    ix = mod.KVTxIndexer(db, index_all_tags=True)
    svc = mod.IndexerService(ix, bus)
    svc.start()
    try:
        for e in entries:
            bus.publish_tx(e["height"], e["index"], e["tx"],
                           ResultDeliverTx(code=0, log=e["result"]["log"],
                                           tags=dict(e["tags"])))
        deadline = time.monotonic() + 20
        while len({k for k, _ in db.iterate(b"txhash/")}) < len(entries):
            assert time.monotonic() < deadline, "indexer did not catch up"
            time.sleep(0.01)
    finally:
        svc.stop()
    assert bus.n_subscriptions() == 0
    return _rows(db), ix


def test_indexer_service_indexes_published_txs_as_jax():
    entries = _entries(9, 40)
    trows, tix = _serve(ttxindex, MemDB, EventBus, entries)
    jrows, jix = _serve(jtxindex, JMemDB, JEventBus, entries)
    assert trows == jrows
    for q in QUERIES:
        assert tix.search(q) == jix.search(q), q


def test_null_indexer_indexes_nothing():
    ix = ttxindex.NullTxIndexer()
    ix.add_batch(_entries(1, 3))
    assert ix.get(b"\x00" * 32) is None and ix.search("tx.height = 1") == []
