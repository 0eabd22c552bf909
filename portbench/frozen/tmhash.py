"""Frozen copies of the hashing and encoding that the generators and the
reference need: canonical JSON, the SHA-256 Merkle tree, validator
addresses, vote sign bytes, the header, block and part-set hashes, the
validator-set and consensus-params hashes, the results hash and the
kvstore app's bucketed app hash.

They are copies of the specification of `tendermint_tpu_torch`
(types/encoding.py, ops/merkle.py, types/keys.py, types/vote.py,
types/block.py, types/part_set.py, types/validator_set.py,
types/params.py, state/execution.py, abci/apps/kvstore.py) as it stood
when the benchmark was written, in plain hashlib and Python. They import
nothing of the program, so that a later change to the program cannot move
the yardstick; `portbench/tests/test_portbench_frozen.py` holds each one
equal to the program's on seeded inputs.
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib

EMPTY_DIGEST = b"\x00" * 32
PART_SIZE = 65536
N_BUCKETS = 256
_EMPTY_BUCKET = hashlib.sha256(b"\x00").digest()

#: ConsensusParams() of the program, as its canonical object
DEFAULT_PARAMS = {
    "block_size": {"max_bytes": 22020096, "max_txs": 100000, "max_gas": -1},
    "tx_size": {"max_bytes": 10240, "max_gas": -1},
    "block_gossip": {"block_part_size_bytes": PART_SIZE},
    "evidence": {"max_age": 100000},
}


def cdumps(obj) -> bytes:
    """Canonical JSON: sorted keys, no spaces, UTF-8 (bytes already hex)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode()


# -- Merkle -------------------------------------------------------------------

def leaf_hash(item: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + item).digest()


def node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def root_from_digests(digests: list, memo: bool = True) -> bytes:
    """Leaves padded with zero digests to a power of two, a perfect tree,
    then SHA256(0x02 || uint64_le(n) || tree root). With `memo`, equal
    pairs are hashed once (a block of identical results is a tree of few
    values)."""
    n = len(digests)
    if n == 0:
        return hashlib.sha256(b"\x02" + struct.pack("<Q", 0)
                              + EMPTY_DIGEST).digest()
    m = 1
    while m < n:
        m *= 2
    level = list(digests) + [EMPTY_DIGEST] * (m - n)
    seen: dict = {}
    while len(level) > 1:
        if not memo:
            level = [node_hash(level[i], level[i + 1])
                     for i in range(0, len(level), 2)]
            continue
        nxt = []
        for i in range(0, len(level), 2):
            pair = (level[i], level[i + 1])
            h = seen.get(pair)
            if h is None:
                h = seen[pair] = node_hash(*pair)
            nxt.append(h)
        level = nxt
    return hashlib.sha256(b"\x02" + struct.pack("<Q", n) + level[0]).digest()


def merkle_root(items: list, memo: bool = True) -> bytes:
    return root_from_digests([leaf_hash(it) for it in items], memo)


# -- keys, votes ----------------------------------------------------------------

def address(pubkey: bytes) -> bytes:
    return hashlib.sha256(pubkey).digest()[:20]


def block_id_obj(bid) -> dict:
    """bid = (hash, parts_total, parts_hash)."""
    return {"hash": bid[0].hex(),
            "parts": {"total": bid[1], "hash": bid[2].hex()}}


ZERO_BLOCK_ID = (b"", 0, b"")


def vote_sign_bytes(chain_id: str, bid, height: int, round_: int,
                    timestamp_ns: int, type_: int) -> bytes:
    return cdumps({"@chain_id": chain_id, "@type": "vote",
                   "block_id": block_id_obj(bid), "height": height,
                   "round": round_, "timestamp_ns": timestamp_ns,
                   "type": type_})


def vote_obj(addr: bytes, index: int, height: int, round_: int,
             timestamp_ns: int, type_: int, bid, signature: bytes) -> dict:
    return {"validator_address": addr.hex(), "validator_index": index,
            "height": height, "round": round_,
            "timestamp_ns": timestamp_ns, "type": type_,
            "block_id": block_id_obj(bid), "signature": signature.hex()}


# -- validator sets, params, results ----------------------------------------------

def sorted_validators(vals: list) -> list:
    """(pubkey, power) pairs in the program's order: by address."""
    return sorted(vals, key=lambda v: address(v[0]))


def valset_hash(vals_sorted: list) -> bytes:
    return merkle_root([cdumps({"pubkey": pk.hex(), "voting_power": p})
                        for pk, p in vals_sorted])


def params_hash(params: dict = DEFAULT_PARAMS) -> bytes:
    return hashlib.sha256(cdumps(params)).digest()


def results_hash(codes_data: list) -> bytes:
    """Merkle root over {"code", "data"} of each DeliverTx result."""
    return merkle_root([cdumps({"code": c, "data": d.hex()})
                        for c, d in codes_data])


# -- header, block, parts ---------------------------------------------------------

def header_obj(chain_id: str, height: int, time_ns: int, num_txs: int,
               total_txs: int, last_block_id, last_commit_hash: bytes,
               data_hash: bytes, validators_hash: bytes,
               consensus_hash: bytes, app_hash: bytes,
               last_results_hash: bytes, evidence_hash: bytes) -> dict:
    return {"chain_id": chain_id, "height": height, "time_ns": time_ns,
            "num_txs": num_txs, "total_txs": total_txs,
            "last_block_id": block_id_obj(last_block_id),
            "last_commit_hash": last_commit_hash.hex(),
            "data_hash": data_hash.hex(),
            "validators_hash": validators_hash.hex(),
            "consensus_hash": consensus_hash.hex(),
            "app_hash": app_hash.hex(),
            "last_results_hash": last_results_hash.hex(),
            "evidence_hash": evidence_hash.hex()}


def header_hash(hobj: dict) -> bytes:
    """Merkle root over the sorted one-field canonical leaves."""
    return merkle_root([cdumps({k: hobj[k]}) for k in sorted(hobj)])


def commit_obj(bid, votes: list) -> dict:
    """votes: vote objects (vote_obj), None where a validator is absent."""
    return {"block_id": block_id_obj(bid), "precommits": list(votes)}


def commit_hash(votes: list) -> bytes:
    return merkle_root([cdumps(v) for v in votes])


def block_bytes(hobj: dict, txs: list, cobj: dict) -> bytes:
    return cdumps({"header": hobj, "data": {"txs": [t.hex() for t in txs]},
                   "evidence": {"evidence": []}, "last_commit": cobj})


def txs_fragment(txs: list) -> bytes:
    """The txs' part of a block's bytes: their hex strings, comma-joined."""
    return ",".join('"%s"' % t.hex() for t in txs).encode()


def block_bytes_from(hobj: dict, fragment: bytes, cobj: dict) -> bytes:
    """block_bytes, with the txs given by txs_fragment: the same bytes,
    since canonical JSON orders the keys data, evidence, header,
    last_commit."""
    return (b'{"data":{"txs":[' + fragment + b']},"evidence":{"evidence":[]},'
            b'"header":' + cdumps(hobj) + b',"last_commit":' + cdumps(cobj)
            + b"}")


def part_set_header(data: bytes, part_size: int = PART_SIZE) -> tuple:
    """(total, root) of the block bytes split into part_size chunks."""
    chunks = [data[i:i + part_size]
              for i in range(0, len(data), part_size)] or [b""]
    return len(chunks), merkle_root(chunks)


# -- the kvstore app ------------------------------------------------------------------

class KVStore:
    """The kvstore app's store and app hash: a Merkle root over 256
    bucket digests, each committing to the sum mod 2^256 of its keys'
    pair digests and its key count; 32 zero bytes for an empty store.
    Txs are `key=value`, or opaque bytes stored under themselves."""

    def __init__(self):
        self.store: dict = {}
        self._pair: dict = {}
        self._acc = [0] * N_BUCKETS
        self._cnt = [0] * N_BUCKETS
        self._digest = [_EMPTY_BUCKET] * N_BUCKETS
        self._dirty: set = set()
        self._keys = 0
        self.app_hash = b""

    def deliver(self, tx: bytes) -> tuple:
        """(code, data) of DeliverTx."""
        if not tx:
            return 1, b""
        if tx.startswith(b"val:"):
            raise ValueError("validator txs are not generated")
        if b"=" in tx:
            k, _, v = tx.partition(b"=")
        else:
            k = v = tx
        self.store[k] = v
        self._dirty.add(k)
        return 0, b""

    def commit(self) -> bytes:
        sha = hashlib.sha256
        sums: dict = {}
        for k in self._dirty:
            b = zlib.crc32(k) & (N_BUCKETS - 1)
            v = self.store[k]
            d = int.from_bytes(sha(len(k).to_bytes(4, "little") + k
                                   + len(v).to_bytes(4, "little") + v)
                               .digest(), "little")
            old = self._pair.get(k)
            s, c = sums.get(b, (0, 0))
            if old is not None:
                s -= old
            else:
                c += 1
            sums[b] = (s + d, c)
            self._pair[k] = d
        self._dirty.clear()
        return self.commit_sums(sums)

    def commit_sums(self, sums: dict) -> bytes:
        """The app hash after adding, to each bucket, a change of its sum
        of pair digests and of its key count: {bucket: (sum, count)}, as
        `pair_sums` gives them for keys no earlier block wrote."""
        for b, (s, c) in sums.items():
            self._acc[b] += s
            self._cnt[b] += c
            self._keys += c
            self._digest[b] = hashlib.sha256(
                b"\x00" + (self._acc[b] % (1 << 256)).to_bytes(32, "little")
                + self._cnt[b].to_bytes(8, "little")).digest()
        self.app_hash = (root_from_digests(self._digest) if self._keys
                         else b"\x00" * 32)
        return self.app_hash


def pair_sums(txs: list) -> dict:
    """{bucket: (sum of pair digests, count)} of `key=value` txs whose
    keys are all distinct and new to the store."""
    sums: dict = {}
    sha = hashlib.sha256
    for tx in txs:
        k, _, v = tx.partition(b"=")
        b = zlib.crc32(k) & (N_BUCKETS - 1)
        d = int.from_bytes(sha(len(k).to_bytes(4, "little") + k
                               + len(v).to_bytes(4, "little") + v).digest(),
                           "little")
        s, c = sums.get(b, (0, 0))
        sums[b] = (s + d, c + 1)
    return sums
