"""The port's kvstore app on its native kv core (csrc/kvcore.cpp through
`native.kv()`, the default) against its pure route (`use_native=False`)
and the JAX package's default app (its native core), on the CPU,
tolerance 0.

Seeded tx streams of `k=v` txs, opaque txs, empty txs, `val:` txs (an
add, a removal of an unknown validator, a malformed one), overwrites and
repeats go through the three apps a block at a time. Per block: the
deliver results (code, data, log and tags of every tx), the results
hash, the app hash, the store contents, `query` of some keys, `info`,
end_block's validator updates, and which route the port's app took (a
block holding a val: or empty tx takes the per-tx route; every other
block the kv core).
"""

import numpy as np
import pytest

from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.state import execution as jexec
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.apps import kvstore as tkv
from tendermint_tpu_torch.state import execution as texec

N_VALS = 3


def _pubkey(rng) -> bytes:
    return rng.randint(0, 256, 32, dtype=np.uint8).tobytes()


def _stream(seed: int, n_blocks: int, special: bool):
    """Blocks of txs: keys from a small space (overwrites and repeats),
    values random; `special` blocks hold val: and empty txs too."""
    rng = np.random.RandomState(seed)
    blocks = []
    for b in range(n_blocks):
        txs = []
        for _ in range(int(rng.randint(0, 60))):
            r = rng.rand()
            k = b"k%d" % rng.randint(0, 40)
            if r < 0.7:
                txs.append(k + b"=" + rng.randint(
                    0, 256, int(rng.randint(0, 20)), dtype=np.uint8)
                    .tobytes().replace(b"=", b"+"))
            elif r < 0.85:
                txs.append(b"opaque-" + bytes(rng.randint(
                    1, 256, int(rng.randint(1, 12)), dtype=np.uint8)))
            else:
                txs.append(txs[-1] if txs else k + b"=same")
        if special and b % 3 == 1:
            txs.insert(int(rng.randint(0, len(txs) + 1)), b"")
        if special and b % 3 == 2:
            pk = _pubkey(rng)
            txs.append(b"val:" + pk.hex().encode() + b"/5")
            txs.append(b"val:" + _pubkey(rng).hex().encode() + b"/0")
            txs.append(b"val:zz/1")
        blocks.append(txs)
    return blocks


def _result(r):
    return (r.code, bytes(r.data), r.log, dict(r.tags))


def _apps():
    rng = np.random.RandomState(5)
    vals = [_pubkey(rng) for _ in range(N_VALS)]
    out = []
    for app, abci in ((tkv.KVStoreApp(), tabci),
                      (tkv.KVStoreApp(use_native=False), tabci),
                      (jkv.KVStoreApp(), jabci)):
        app.init_chain([abci.ValidatorUpdate(pk, 10) for pk in vals], "c")
        out.append(app)
    return out


def _block_outcome(app, exe, txs, height):
    results = app.deliver_tx_batch(txs)
    end = app.end_block(height)
    app_hash = app.commit()
    keys = sorted({t.partition(b"=")[0] for t in txs if t})[:5]
    return {"results": [_result(r) for r in results],
            "results_hash": exe.results_hash(results),
            "uniform": bool(getattr(results, "uniform", False)),
            "app_hash": app_hash,
            "updates": [(u.pubkey, u.power)
                        for u in end.validator_updates],
            "store": sorted(app.store.items()),
            "query": [(q.key, q.value, q.height, q.log) for q in
                      (app.query("", k, 0, False) for k in keys)],
            "info": (lambda i: (i.data, i.last_block_height,
                                i.last_block_app_hash))(app.info()),
            "tx_count": app.tx_count}


@pytest.mark.parametrize("seed,special", [(1, False), (2, True),
                                          (3, True)])
def test_native_app_matches_pure_and_jax_block_by_block(seed, special):
    native_app, pure_app, jax_app = _apps()
    for h, txs in enumerate(_stream(seed, 12, special), start=1):
        before = tkv.route_stats()
        nat = _block_outcome(native_app, texec, txs, h)
        after = tkv.route_stats()
        pure = _block_outcome(pure_app, texec, txs, h)
        jax = _block_outcome(jax_app, jexec, txs, h)
        uniform = nat.pop("uniform")
        assert uniform == jax.pop("uniform")
        assert not pure.pop("uniform")
        assert nat == jax, h
        assert nat == pure, h
        per_tx = any(not t or t.startswith(b"val:") for t in txs)
        routed = {k: after[k] - before[k] for k in after}
        if not txs:
            assert routed == {"native": 0, "per_tx": 0, "pure": 0}
        else:
            assert routed == {"native": int(not per_tx),
                              "per_tx": int(per_tx), "pure": 0}, h
            assert uniform is (not per_tx)


def test_empty_store_hash_and_restore_match():
    native_app, pure_app, jax_app = _apps()
    for app in (native_app, pure_app, jax_app):
        assert app.commit() == b"\x00" * 32
    items = [(b"a", b"1"), (b"b", b""), (b"\xff", b"\x00")]
    hashes = [app.restore_items(items, 7)
              for app in (tkv.KVStoreApp(), tkv.KVStoreApp(use_native=False),
                          jkv.KVStoreApp())]
    assert hashes[0] == hashes[1] == hashes[2]


def test_set_one_route_of_a_val_block_matches():
    """A block with a val: tx takes the per-tx route on the native core:
    its kv txs go through the core's set_one, and the next plain block
    is one deliver_batch call again."""
    native_app, pure_app, jax_app = _apps()
    rng = np.random.RandomState(11)
    blocks = [[b"x=1", b"val:" + _pubkey(rng).hex().encode() + b"/3",
               b"y=2"], [b"x=3", b"z=4"]]
    for h, txs in enumerate(blocks, start=1):
        outs = [_block_outcome(a, e, txs, h) for a, e in
                ((native_app, texec), (pure_app, texec),
                 (jax_app, jexec))]
        for o in outs:
            o.pop("uniform")
        assert outs[0] == outs[1] == outs[2]
    assert dict(native_app.store) == {b"x": b"3", b"y": b"2", b"z": b"4"}
