"""The port's ABCI boundary and kvstore app (tendermint_tpu_torch.abci)
against the JAX package's.

The port's kvstore is the JAX package's pure route; its app hashes are
held to the JAX app on both of its routes (the native core, the default,
and `use_native=False`) over 20 seeded blocks, state is carried across
with `convert.app_from_jax`, and the results hash of the port's per-tx
list is held to the JAX native route's uniform results. Tolerance 0.
"""

import numpy as np
import pytest

from tendermint_tpu.abci import client as jclient
from tendermint_tpu.abci import proxy as jproxy
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.abci import app as tapp
from tendermint_tpu_torch.abci import client as tclient
from tendermint_tpu_torch.abci import proxy as tproxy
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.apps import kvstore as tkv
from tendermint_tpu_torch.state import execution as texec
from tendermint_tpu_torch.types import encoding as tenc

ROUTES = {"native": lambda: jkv.KVStoreApp(),
          "pure": lambda: jkv.KVStoreApp(use_native=False)}


def val_tx(pk: bytes, power: int) -> bytes:
    return b"val:" + pk.hex().encode() + b"/%d" % power


def _results(rs) -> list:
    return [(r.code, r.data, r.log, r.tags) for r in rs]


def _drive_kvstore(conn, abci):
    out = [conn.echo("hello"), conn.info().to_obj(), conn.check_tx(b"a=1").ok,
           conn.check_tx(b"").to_obj(), conn.set_option("k", "v")]
    conn.init_chain([abci.ValidatorUpdate(b"\x01" * 32, 10)], "chain")
    conn.begin_block(b"\xaa" * 32, {"height": 1})
    r = conn.deliver_tx(b"name=satoshi")
    out += [r.to_obj(), conn.end_block(1).to_obj(), conn.commit()]
    out.append(conn.query("/store", b"name", 0, False).to_obj())
    out.append(conn.query("/store", b"nobody", 0, False).to_obj())
    conn.begin_block(b"\xbb" * 32, {"height": 2})
    out.append(_results(conn.deliver_tx_batch(
        [b"k%d=v%d" % (i, i) for i in range(10)])))
    out += [conn.end_block(2).to_obj(), conn.commit(), conn.info().to_obj()]
    conn.close()
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kvstore_local_client_matches_jax(route):
    got = _drive_kvstore(tclient.LocalClient(tkv.KVStoreApp()), tabci)
    want = _drive_kvstore(jclient.LocalClient(ROUTES[route]()), jabci)
    assert got == want
    assert len(got[7]) == 32 and got[12] != got[7]


def _block_txs(rng, h, pks):
    """A seeded block: kv txs over a small key space (overwrites), bare
    txs stored under themselves, non-UTF-8 keys, and now and then an
    empty tx and validator txs (valid, refused, malformed)."""
    txs = []
    for i in range(int(rng.randint(0, 40))):
        k = int(rng.randint(0, 60))
        kind = rng.randint(0, 10)
        if kind == 0:
            txs.append(b"bare%d" % k)
        elif kind == 1:
            txs.append(b"\xff\xfe%d=\x00v%d" % (k, h))
        else:
            txs.append(b"key%d=val%d.%d" % (k, h, i))
    if h % 4 == 0:
        txs.insert(int(rng.randint(0, len(txs) + 1)), b"")
    if h % 5 == 1:
        txs += [val_tx(pks[h % len(pks)], int(rng.randint(0, 30))),
                val_tx(b"\x0e" * 32, 0), b"val:zz/1", b"val:0101/3"]
    return txs


def _run_blocks(app, abci, heights, pks, rng_seed):
    rng = np.random.RandomState(rng_seed)
    log = []
    for h in heights:
        txs = _block_txs(rng, h, pks)
        rs = app.deliver_tx_batch(txs)
        end = app.end_block(h)
        log.append((_results(rs), end.to_obj(), app.commit(),
                    texec.results_hash(rs) if abci is tabci
                    else jexec.results_hash(rs)))
    return log


PKS = [bytes([i]) * 32 for i in range(1, 6)]


def _seeded(app, abci):
    app.init_chain([abci.ValidatorUpdate(pk, 10) for pk in PKS[:4]], "c")
    return app


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kvstore_app_hashes_match_jax_over_20_blocks(route):
    port = _seeded(tkv.KVStoreApp(), tabci)
    ref = _seeded(ROUTES[route](), jabci)
    got = _run_blocks(port, tabci, range(1, 21), PKS, 8)
    want = _run_blocks(ref, jabci, range(1, 21), PKS, 8)
    assert got == want
    assert port.info().to_obj() == ref.info().to_obj()
    assert sorted(port.snapshot_items()) == sorted(ref.snapshot_items())
    assert len({h for _, _, h, _ in got}) > 15


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_app_from_jax_carries_state_across(route):
    ref = _seeded(ROUTES[route](), jabci)
    _run_blocks(ref, jabci, range(1, 11), PKS, 9)
    vals = sorted(ref._validators.items())
    port = convert.app_from_jax(ref.snapshot_items(), ref.height, vals)
    assert port.app_hash == ref.app_hash and port.height == ref.height == 10
    # both go on from the same state and stay equal
    assert _run_blocks(port, tabci, range(11, 21), PKS, 10) == \
        _run_blocks(ref, jabci, range(11, 21), PKS, 10)
    assert port.app_hash == ref.app_hash
    # restore_items replaces the state wholesale, as the JAX app's does
    again = ROUTES[route]()
    assert again.restore_items(port.snapshot_items(), 20, vals) == \
        port.restore_items(ref.snapshot_items(), 20, vals) == ref.app_hash


def test_commit_of_an_empty_store_matches_jax():
    for r in ROUTES.values():
        j, t = r(), tkv.KVStoreApp()
        assert t.commit() == j.commit() == b"\x00" * 32
        assert t.restore_items([], 7) == j.restore_items([], 7)
        assert t.info().to_obj() == j.info().to_obj()


def test_kvstore_validator_update_guard_matches_jax():
    """The persistent_dummy guard: removals of unknown validators and
    set-emptying batches are refused at DeliverTx, in both packages."""
    def drive(app, abci):
        a, b, c, x = (bytes([i]) * 32 for i in (1, 2, 3, 4))
        app.init_chain([abci.ValidatorUpdate(a, 10),
                        abci.ValidatorUpdate(b, 10)], "t")
        out = [app.deliver_tx(val_tx(c, 0)).to_obj(),
               app.end_block(1).to_obj()]
        out += [app.deliver_tx(t).to_obj() for t in
                (val_tx(c, 5), val_tx(a, 30), val_tx(b, 0))]
        out.append(app.end_block(1).to_obj())
        out += [app.deliver_tx(val_tx(x, 7)).to_obj(),
                app.deliver_tx(val_tx(x, 0)).to_obj(), app.end_block(2)]
        out += [app.deliver_tx(val_tx(a, 0)).to_obj(),
                app.deliver_tx(val_tx(c, 0)).to_obj(),
                app.end_block(3).to_obj()]
        unseeded = type(app)(**({} if abci is tabci
                                else {"use_native": False}))
        out += [unseeded.deliver_tx(t).code for t in
                (val_tx(a, 0), val_tx(a, 9), val_tx(a, 0))]
        return out[:8] + out[9:]

    got = drive(tkv.KVStoreApp(), tabci)
    assert got == drive(jkv.KVStoreApp(), jabci)
    assert [o["code"] for o in got[:1]] == [2]
    assert got[-5]["code"] == 3 and got[-3:] == [2, 0, 0]


def test_app_conns_share_one_app_like_jax():
    out = []
    for proxy, app in ((tproxy, tkv.KVStoreApp()),
                       (jproxy, jkv.KVStoreApp())):
        conns = proxy.AppConns(proxy.local_client_creator(app))
        assert conns.consensus.lock is conns.query.lock
        conns.consensus.deliver_tx(b"x=1")
        out.append(conns.consensus.commit())
        out.append(conns.query.query("/store", b"x", 0, False).to_obj())
        out.append(conns.mempool.check_tx(b"y=2").to_obj())
        conns.close()
    assert out[:3] == out[3:]


def test_base_application_defaults_match_jax():
    from tendermint_tpu.abci import app as japp
    t, j = tapp.BaseApplication(), japp.BaseApplication()
    assert t.echo("e") == j.echo("e")
    assert t.info().to_obj() == j.info().to_obj()
    assert t.query("", b"", 0, False).to_obj() == \
        j.query("", b"", 0, False).to_obj()
    assert t.check_tx(b"").to_obj() == j.check_tx(b"").to_obj()
    assert t.deliver_tx(b"").to_obj() == j.deliver_tx(b"").to_obj()
    assert t.end_block(1).to_obj() == j.end_block(1).to_obj()
    assert t.commit() == j.commit() and t.snapshot_items() is None
    with pytest.raises(NotImplementedError,
                       match="^BaseApplication does not support snapshot "
                             "restore$"):
        t.restore_items([], 1)


@pytest.mark.parametrize("n", [0, 1, 5, 5000])
def test_results_hash_list_and_uniform_match_jax(n):
    """The port's kvstore returns per-tx lists, the JAX native core
    uniform results: their results hashes agree, and both of the port's
    branches agree with the JAX package's."""
    keys = [b"k%d.%d" % (n % 7, i) for i in range(n)]
    tu = tabci.UniformDeliverResults(list(keys))
    ju = jabci.UniformDeliverResults(list(keys))
    tl = [tabci.ResultDeliverTx(tags={"app.key": k.decode()}) for k in keys]
    want = jexec.results_hash(ju)
    assert texec.results_hash(tu) == texec.results_hash(tl) == want
    assert texec.results_hash(tl) == jexec.results_hash(
        [jabci.ResultDeliverTx(tags={"app.key": k.decode()}) for k in keys])
    # the compact persisted form crosses and round-trips
    jr = jexec.ABCIResponses(ju, {"validator_updates": []})
    back = texec.ABCIResponses.from_obj(jr.to_obj())
    assert tenc.cdumps(back.to_obj()) == jenc.cdumps(jr.to_obj())
    assert _results(back.deliver_txs) == _results(ju)
    assert _results(tu[1:3]) == _results(ju[1:3])
    assert texec.ABCIResponses(tu, {}).results_hash() == want


def test_uniform_results_read_the_older_form_like_jax():
    o = {"code": 0, "data": "", "log": "", "tag_key": "app.key",
         "keys": [b"a".hex(), b"bc".hex()]}
    t = tabci.UniformDeliverResults.from_compact_obj(o)
    j = jabci.UniformDeliverResults.from_compact_obj(o)
    assert _results(t) == _results(j) and len(t) == 2
    assert t.to_compact_obj() == j.to_compact_obj()


def test_abci_types_round_trip_like_jax():
    objs = [
        ("ValidatorUpdate", {"pubkey": "01" * 32, "power": 3}),
        ("ResultInfo", {"data": "d", "version": "1", "last_block_height": 4,
                        "last_block_app_hash": "ab"}),
        ("ResultCheckTx", {"code": 1, "data": "cd", "log": "l",
                           "gas_wanted": 2}),
        ("ResultDeliverTx", {"code": 0, "data": "", "log": "",
                             "tags": {"a": "b"}}),
        ("ResultEndBlock", {"validator_updates": [{"pubkey": "02" * 32,
                                                   "power": 0}],
                            "consensus_param_updates": None, "tags": {}}),
        ("ResultQuery", {"code": 0, "key": "6b", "value": "76", "proof": "",
                         "height": 2, "log": "exists"}),
    ]
    for name, o in objs:
        t = getattr(tabci, name).from_obj(o)
        assert t.to_obj() == getattr(jabci, name).from_obj(o).to_obj() == o
    assert not tabci.ResultCheckTx(code=1).ok and tabci.ResultDeliverTx().ok
