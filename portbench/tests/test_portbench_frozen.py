"""Each frozen copy under portbench/frozen equal to the program's today,
on seeded inputs. This is the one test module that imports the program
for the frozen copies."""

import json
import random
import re
from pathlib import Path

import pytest

from portbench.frozen import roofline, tmhash
from portbench.gen import keys as gkeys

def _rng(tag):
    return random.Random(repr(("frozen", tag)))


def _bid(r):
    return (r.randbytes(32), 1 + r.randrange(4), r.randbytes(32))


def test_merkle_roots_equal_the_programs():
    from tendermint_tpu_torch.ops import merkle
    r = _rng("merkle")
    for n in (0, 1, 2, 3, 5, 8, 33, 100):
        items = [r.randbytes(r.randrange(0, 80)) for _ in range(n)]
        assert tmhash.merkle_root(items) == merkle.root_host(items)
        assert tmhash.merkle_root(items, memo=False) == merkle.root_plain(
            items)
    same = [b"x"] * 37
    assert tmhash.merkle_root(same) == merkle.root_host(same)


def test_address_and_vote_sign_bytes_equal_the_programs():
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.keys import address_of
    from tendermint_tpu_torch.types.vote import Vote
    r = _rng("vote")
    for t in (1, 2):
        pk = r.randbytes(32)
        bid = _bid(r)
        v = Vote(address_of(pk), 7, 1 + r.randrange(10 ** 6), r.randrange(3),
                 r.randrange(10 ** 19), t,
                 BlockID(bid[0], PartSetHeader(bid[1], bid[2])),
                 r.randbytes(64))
        assert tmhash.address(pk) == address_of(pk)
        assert tmhash.vote_sign_bytes("chain-é", bid, v.height, v.round,
                                      v.timestamp_ns, t) \
            == v.sign_bytes("chain-é")
        assert tmhash.vote_obj(v.validator_address, 7, v.height, v.round,
                               v.timestamp_ns, t, bid, v.signature) \
            == v.to_obj()


def test_valset_params_and_results_hashes_equal_the_programs():
    from tendermint_tpu_torch.abci.types import ResultDeliverTx
    from tendermint_tpu_torch.state import execution as texec
    from tendermint_tpu_torch.types.params import ConsensusParams
    from tendermint_tpu_torch.types.validator_set import (Validator,
                                                          ValidatorSet)
    r = _rng("sets")
    vals = [(r.randbytes(32), 1 + r.randrange(100)) for _ in range(40)]
    vs = ValidatorSet([Validator(pk, p) for pk, p in vals])
    assert tmhash.valset_hash(tmhash.sorted_validators(vals)) == vs.hash()
    assert tmhash.params_hash() == ConsensusParams().hash()
    res = [ResultDeliverTx(code=r.randrange(3), data=r.randbytes(4))
           for _ in range(9)]
    assert tmhash.results_hash([(x.code, x.data) for x in res]) \
        == texec.results_hash(res)
    assert tmhash.results_hash([]) == texec.results_hash([])


def test_kvstore_app_hash_equals_the_programs_on_both_routes():
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    r = _rng("kv")
    apps = [KVStoreApp(), KVStoreApp(use_native=False)]
    mine = tmhash.KVStore()
    for a in apps:
        assert a.commit() == mine.commit()        # the empty store
    for _ in range(6):
        txs = [b"k%d=v%d" % (r.randrange(300), r.randrange(10 ** 6))
               for _ in range(200)] + [r.randbytes(12).hex().encode()]
        want = [(c, d) for c, d in (mine.deliver(tx) for tx in txs)]
        for a in apps:
            got = a.deliver_tx_batch(txs)
            assert [(x.code, x.data) for x in got] == want
        h = mine.commit()
        assert all(a.commit() == h for a in apps)


def _chain(seed, blocks, txs):
    from portbench.gen.chain import Chain
    cfg = json.loads((Path(__file__).parents[1] / "configs"
                      / "fastsync64.json").read_text())
    cfg.update(validators=4, key_space=8)
    return Chain(cfg, seed, blocks, txs)


@pytest.mark.parametrize("txs", [0, 30])
def test_blocks_header_parts_and_commits_equal_the_programs(txs):
    from tendermint_tpu_torch.types.block import Block
    chain = _chain(2 ** 40 + 1, 6, txs)
    for h in range(1, 7):
        blk = Block.from_bytes(chain.wire[h - 1])
        assert blk.to_bytes() == chain.wire[h - 1]
        parts = blk.make_part_set(tmhash.PART_SIZE).header()
        assert (blk.hash(), parts.total, parts.hash) == chain.block_id[h]
        blk.validate_basic()
        nxt = Block.from_bytes(chain.wire[h])
        assert nxt.last_commit.to_bytes() == chain.seen_commit[h]
        assert nxt.header.app_hash == chain.app_hash[h]
        assert nxt.header.last_results_hash == chain.results_hash[h]


def test_block_bytes_from_a_fragment_equal_the_whole_encoding():
    r = _rng("frag")
    txs = [r.randbytes(r.randrange(1, 30)) for _ in range(17)]
    hobj = {"b": 1, "a": "x"}
    cobj = tmhash.commit_obj(_bid(r), [None])
    assert tmhash.block_bytes_from(hobj, tmhash.txs_fragment(txs), cobj) \
        == tmhash.block_bytes(hobj, txs, cobj)


def test_roofline_counts_share_the_programs_constants():
    from tendermint_tpu_torch.ops import ladder
    # the square root: what decompressing the key adds to a lane
    assert roofline.SQRT_PRODUCTS == ladder.field_muls("verify") \
        - ladder.field_muls("verify_pre")
    # the least work stays below what the program's schedules run
    assert roofline.SIG_PRODUCTS < ladder.field_muls("verify_pre")
    assert roofline.PRODUCT_PRODUCTS == 441
    assert roofline.SIG_PRODUCTS == 446
    assert roofline.KEY_PRODUCTS == 66035
    text = (Path(__file__).parents[2] / "chip_smoke.py").read_text()
    slots = re.search(r"^SLOTS_PER_MUL = ([0-9+ ]+)$", text, re.M).group(1)
    assert roofline.SLOTS_PER_PRODUCT == sum(int(x) for x in
                                             slots.split("+"))
    imad = re.search(r"^IMAD_PER_SM_CLOCK = (\d+)$", text, re.M).group(1)
    assert roofline.IMAD_PER_SM_CLOCK == int(imad)


def test_roofline_is_bound_by_products_not_bytes():
    s = 10000
    compute = roofline.products(s, 2, 0) * roofline.SLOTS_PER_PRODUCT \
        / roofline.PEAK_SLOTS_PER_S
    assert roofline.least_seconds(s, 2, 0) == compute
    assert s * roofline.BYTES_PER_SIG / roofline.PEAK_BYTES_PER_S < compute


def test_roofline_share_is_none_without_device_time():
    assert roofline.share(10000, 2, 0, 0.0) is None
    assert roofline.share(0, 2, 0, 1.0) is None
    s = roofline.least_seconds(10000, 2, 0)
    assert roofline.share(10000, 2, 0, 2 * s) == pytest.approx(50.0)


def test_keys_from_the_seed_equal_the_programs_keys():
    from tendermint_tpu_torch.types.keys import PrivKey
    seed = gkeys.seed_bytes(2 ** 33, "x", 3)
    assert len(seed) == 32
    assert gkeys.pubkey(seed) == PrivKey.generate(seed).pubkey.ed25519


def test_kvstore_sums_of_new_keys_equal_its_commit():
    r = _rng("sums")
    a, b = tmhash.KVStore(), tmhash.KVStore()
    for blk in range(4):
        txs = [b"k%d.%d=v%d" % (blk, i, r.randrange(99)) for i in range(50)]
        for tx in txs:
            a.deliver(tx)
        assert a.commit() == b.commit_sums(tmhash.pair_sums(txs))
