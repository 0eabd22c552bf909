"""The fastsync64 chain: a valid chain of signed blocks made from the run's
seed, with the state a node must reach after each block.

A copy of the logic of `tendermint_tpu_torch/blockchain/builder.py` (and
of bench_fastsync's builder before it), written on the frozen hashing of
`portbench/frozen/tmhash.py` and signed by OpenSSL: validator i's key
comes from the seed, every validator has power 10, block h holds `txs`
kvstore txs `k<h % key_space>.<i>=v<h>.<tag>` (the tag from the seed) at
time h seconds, and every validator precommits it at h seconds + 1 ns.
Block h's header carries the app hash and the results hash after block
h - 1, so the chain applies each block to a frozen copy of the kvstore
app as it goes. The result is the blocks' canonical bytes (what a peer
sends) and, for each height, the block id, the app hash after it, the
results hash and the seen commit's bytes.

Per-block work that does not depend on the chain (the txs' Merkle root
and their key-value pair digests, summed by bucket) runs in a pool of
spawned workers. This needs every block to write keys no earlier block
wrote, which holds while the chain has at most `key_space` blocks with
txs; `Chain` refuses a longer one.
"""

from __future__ import annotations

import hashlib
import multiprocessing

from portbench.frozen import tmhash
from portbench.gen import keys as gkeys

PRECOMMIT = 2


def _txs(h: int, n: int, key_space: int, tag: bytes) -> list:
    return [b"k%d.%d=v%d.%s" % (h % key_space, i, h, tag) for i in range(n)]


def _block_work(job) -> tuple:
    """(data hash, {bucket: (sum of pair digests, count)}, the txs' part
    of the block bytes) of one block."""
    h, n, key_space, tag = job
    txs = _txs(h, n, key_space, tag)
    return tmhash.merkle_root(txs, memo=False), tmhash.pair_sums(txs), \
        tmhash.txs_fragment(txs)


class Chain:
    """`wire[h - 1]`: block h's bytes, for h = 1 .. blocks + 1 (the last
    one only carries the commit of block `blocks`); `block_id[h]`,
    `app_hash[h]`, `results_hash[h]`, `seen_commit[h]` (bytes), `total_txs[h]`
    for h = 1 .. blocks; `vals` (pubkey, power) in address order and their
    hash; `pubkeys`, `genesis_time_ns`, `chain_id`."""

    def __init__(self, cfg: dict, seed: int, blocks: int, txs: int):
        if txs and blocks > cfg["key_space"]:
            raise ValueError("a chain with txs may not write a key twice: "
                             f"{blocks} blocks over a key space of "
                             f"{cfg['key_space']}")
        self.chain_id = cfg["chain_id"]
        self.genesis_time_ns = cfg["genesis_time_ns"]
        n = cfg["validators"]
        signer = gkeys.Signer([gkeys.seed_bytes(seed, cfg["name"], i)
                               for i in range(n)])
        order = sorted(range(n), key=lambda i: tmhash.address(
            signer.pubkeys[i]))
        self.pubkeys = list(signer.pubkeys)
        self.vals = [(signer.pubkeys[i], cfg["power"]) for i in order]
        self.valset_hash = tmhash.valset_hash(self.vals)
        tag = hashlib.sha256(b"txtag" + seed.to_bytes(
            16, "little", signed=True)).hexdigest()[:8].encode()
        jobs = [(h, txs, cfg["key_space"], tag) for h in range(1, blocks + 2)]
        pool = None
        if txs:
            pool = multiprocessing.get_context("spawn").Pool(gkeys.workers())
            work = pool.imap(_block_work, jobs, chunksize=4)
        else:
            work = iter([(tmhash.merkle_root([]), {}, b"")] * len(jobs))
        try:
            self._build(cfg, blocks, txs, signer, order, work)
        finally:
            if pool is not None:
                pool.close()
                pool.join()
        self.blocks = blocks

    def _build(self, cfg, blocks, txs, signer, order, work) -> None:
        n = len(order)
        addrs = [tmhash.address(pk) for pk, _ in self.vals]
        params_hash = tmhash.params_hash()
        evidence_hash = tmhash.merkle_root([])
        kv = tmhash.KVStore()
        ok_results = (tmhash.results_hash([(0, b"")] * txs))
        self.wire, self.block_id, self.app_hash = [], {}, {}
        self.results_hash, self.seen_commit, self.total_txs = {}, {}, {}
        app_hash, results, last_bid, total = b"", b"", tmhash.ZERO_BLOCK_ID, 0
        last_votes: list = []
        for h in range(1, blocks + 2):
            data_hash, sums, fragment = next(work)
            cobj = tmhash.commit_obj(last_bid, last_votes)
            hobj = tmhash.header_obj(
                self.chain_id, h, h * 10 ** 9, txs, total + txs, last_bid,
                tmhash.commit_hash(last_votes), data_hash, self.valset_hash,
                params_hash, app_hash, results, evidence_hash)
            raw = tmhash.block_bytes_from(hobj, fragment, cobj)
            self.wire.append(raw)
            if h > blocks:
                break
            parts = tmhash.part_set_header(raw, cfg["part_size"])
            bid = (tmhash.header_hash(hobj), parts[0], parts[1])
            total += txs
            app_hash = kv.commit_sums(sums)
            results = ok_results
            ts = h * 10 ** 9 + 1
            msg = tmhash.vote_sign_bytes(self.chain_id, bid, h, 0, ts,
                                         PRECOMMIT)
            last_votes = [tmhash.vote_obj(addrs[j], j, h, 0, ts, PRECOMMIT,
                                          bid, signer.sign(order[j], msg))
                          for j in range(n)]
            last_bid = bid
            self.block_id[h] = bid
            self.app_hash[h] = app_hash
            self.results_hash[h] = results
            self.total_txs[h] = total
            self.seen_commit[h] = tmhash.cdumps(
                tmhash.commit_obj(bid, last_votes))
