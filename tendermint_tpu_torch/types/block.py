"""Block, Header, Data, EvidenceData, Commit, BlockID and PartSetHeader.

Counterpart of `tendermint_tpu/types/block.py`, with the same canonical
objects, bytes and Merkle hashes (the host half of `ops/merkle.py`). A
block serializes to canonical JSON and is split into a PartSet for
gossip. The caches of header hash, commit objects and block bytes are
invalidated as the JAX package's are: any header field write drops the
header hash, and the block bytes and part set are keyed on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.vote import Vote, VoteType


@dataclass
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def to_obj(self):
        return {"total": self.total, "hash": self.hash.hex()}

    @classmethod
    def from_obj(cls, o):
        return cls(o["total"], bytes.fromhex(o["hash"]))


@dataclass
class BlockID:
    hash: bytes = b""
    parts: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return not self.hash and self.parts.is_zero()

    def __setattr__(self, name, value):
        # a field write drops the cached key (parts are replaced, never
        # mutated in place)
        if not name.startswith("_"):
            self.__dict__.pop("_key", None)
        object.__setattr__(self, name, value)

    def key(self) -> str:
        """The dict key of the full id (hash, parts total, parts hash);
        cached, since VoteSet reads it per vote."""
        k = self.__dict__.get("_key")
        if k is None:
            k = (self.hash.hex() + "/" + str(self.parts.total) + "/"
                 + self.parts.hash.hex())
            self.__dict__["_key"] = k
        return k

    def short(self) -> str:
        return self.hash.hex()[:8] if self.hash else "<nil>"

    def to_obj(self):
        return {"hash": self.hash.hex(), "parts": self.parts.to_obj()}

    @classmethod
    def from_obj(cls, o):
        return cls(bytes.fromhex(o["hash"]), PartSetHeader.from_obj(o["parts"]))

    def __eq__(self, other):
        return isinstance(other, BlockID) and self.hash == other.hash \
            and self.parts.total == other.parts.total \
            and self.parts.hash == other.parts.hash

    def __hash__(self):
        return hash((self.hash, self.parts.total, self.parts.hash))


@dataclass
class Header:
    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    num_txs: int = 0
    total_txs: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""

    def to_obj(self):
        return {
            "chain_id": self.chain_id, "height": self.height,
            "time_ns": self.time_ns, "num_txs": self.num_txs,
            "total_txs": self.total_txs,
            "last_block_id": self.last_block_id.to_obj(),
            "last_commit_hash": self.last_commit_hash.hex(),
            "data_hash": self.data_hash.hex(),
            "validators_hash": self.validators_hash.hex(),
            "consensus_hash": self.consensus_hash.hex(),
            "app_hash": self.app_hash.hex(),
            "last_results_hash": self.last_results_hash.hex(),
            "evidence_hash": self.evidence_hash.hex(),
        }

    @classmethod
    def from_obj(cls, o):
        return cls(
            chain_id=o["chain_id"], height=o["height"], time_ns=o["time_ns"],
            num_txs=o["num_txs"], total_txs=o["total_txs"],
            last_block_id=BlockID.from_obj(o["last_block_id"]),
            last_commit_hash=bytes.fromhex(o["last_commit_hash"]),
            data_hash=bytes.fromhex(o["data_hash"]),
            validators_hash=bytes.fromhex(o["validators_hash"]),
            consensus_hash=bytes.fromhex(o["consensus_hash"]),
            app_hash=bytes.fromhex(o["app_hash"]),
            last_results_hash=bytes.fromhex(o["last_results_hash"]),
            evidence_hash=bytes.fromhex(o["evidence_hash"]))

    def __setattr__(self, name, value):
        # any field write drops the cached hash: a stale header hash
        # would certify a header that was changed after signing
        if not name.startswith("_"):
            self.__dict__.pop("_hash", None)
        object.__setattr__(self, name, value)

    def hash(self) -> bytes:
        """Merkle root over the sorted one-field canonical leaves; b""
        while validators_hash is empty (an unfilled header). Cached."""
        if not self.validators_hash:
            return b""
        h = self.__dict__.get("_hash")
        if h is None:
            obj = self.to_obj()
            h = merkle.root_host([encoding.cdumps({k: obj[k]})
                                  for k in sorted(obj)])
            self.__dict__["_hash"] = h
        return h


@dataclass
class Data:
    txs: List[bytes] = field(default_factory=list)

    def hash(self) -> bytes:
        """Merkle root of the txs, cached behind a tuple of the tx objects
        (the tuple holds them, so a replaced tx misses the cache)."""
        fp = tuple(self.txs)
        cached = self.__dict__.get("_hash_fp")
        if cached is not None and cached[0] == fp:
            return cached[1]
        h = merkle.root_host(list(fp))
        self.__dict__["_hash_fp"] = (fp, h)
        return h

    def to_obj(self):
        return {"txs": [t.hex() for t in self.txs]}

    @classmethod
    def from_obj(cls, o):
        return cls([bytes.fromhex(t) for t in o["txs"]])


@dataclass
class Commit:
    """+2/3 precommits for a block. precommits[i] is None when validator
    i did not precommit."""
    block_id: BlockID = field(default_factory=BlockID)
    precommits: List[Optional[Vote]] = field(default_factory=list)

    def height(self) -> int:
        for v in self.precommits:
            if v is not None:
                return v.height
        return 0

    def round(self) -> int:
        for v in self.precommits:
            if v is not None:
                return v.round
        return 0

    def size(self) -> int:
        return len(self.precommits)

    def is_commit(self) -> bool:
        return len(self.precommits) > 0

    def validate_basic(self) -> None:
        if self.block_id.is_zero():
            raise ValueError("commit cannot be for nil block")
        if not any(v is not None for v in self.precommits):
            raise ValueError("no precommits in commit")
        h, r = self.height(), self.round()
        for v in self.precommits:
            if v is None:
                continue
            if v.type != VoteType.PRECOMMIT:
                raise ValueError("commit contains non-precommit vote")
            if v.height != h or v.round != r:
                raise ValueError("commit votes differ in height/round")

    def __setattr__(self, name, value):
        # any field write drops the cached hash, object and bytes
        if not name.startswith("_"):
            for k in ("_hash", "_obj", "_cbytes", "_fp"):
                self.__dict__.pop(k, None)
        object.__setattr__(self, name, value)

    def _check_cache_fresh(self) -> None:
        # __setattr__ cannot see a vote changed in place (a tampered
        # signature), so the caches are also keyed on every sign-relevant
        # field of every vote and on the commit's block id
        fp = (self.block_id.hash, self.block_id.parts.total,
              self.block_id.parts.hash,
              tuple((v.signature, v.timestamp_ns, v.height, v.round,
                     int(v.type), v.validator_address, v.validator_index,
                     v.block_id.hash, v.block_id.parts.total,
                     v.block_id.parts.hash)
                    if v is not None else None
                    for v in self.precommits))
        if self.__dict__.get("_fp") != fp:
            for k in ("_hash", "_obj", "_cbytes"):
                self.__dict__.pop(k, None)
            self.__dict__["_fp"] = fp

    def hash(self) -> bytes:
        """Merkle root over the canonical encodings of the precommits."""
        self._check_cache_fresh()
        if "_hash" not in self.__dict__:
            leaves = [encoding.cdumps(v.to_obj() if v else None)
                      for v in self.precommits]
            self.__dict__["_hash"] = merkle.root_host(leaves)
        return self.__dict__["_hash"]

    def to_obj(self):
        self._check_cache_fresh()
        if "_obj" not in self.__dict__:
            self.__dict__["_obj"] = {
                "block_id": self.block_id.to_obj(),
                "precommits": [v.to_obj() if v else None
                               for v in self.precommits]}
        return self.__dict__["_obj"]

    def to_bytes(self) -> bytes:
        self._check_cache_fresh()
        b = self.__dict__.get("_cbytes")
        if b is None:
            b = encoding.cdumps(self.to_obj())
            self.__dict__["_cbytes"] = b
        return b

    @classmethod
    def from_obj(cls, o):
        return cls(BlockID.from_obj(o["block_id"]),
                   [Vote.from_obj(v) if v else None for v in o["precommits"]])


@dataclass
class EvidenceData:
    evidence: list = field(default_factory=list)

    def hash(self) -> bytes:
        return merkle.root_host([encoding.cdumps(e.to_obj())
                                 for e in self.evidence])

    def to_obj(self):
        from tendermint_tpu_torch.types.evidence import evidence_to_obj
        return {"evidence": [evidence_to_obj(e) for e in self.evidence]}

    @classmethod
    def from_obj(cls, o):
        from tendermint_tpu_torch.types.evidence import evidence_from_obj
        return cls([evidence_from_obj(e) for e in o["evidence"]])


@dataclass
class Block:
    header: Header
    data: Data = field(default_factory=Data)
    evidence: EvidenceData = field(default_factory=EvidenceData)
    last_commit: Commit = field(default_factory=Commit)

    def fill_header(self) -> None:
        """Fill the header's derived hashes that are still empty. Each
        write goes through Header.__setattr__, which drops the header
        hash, and so the bytes and part set keyed on it."""
        h = self.header
        if not h.last_commit_hash:
            h.last_commit_hash = self.last_commit.hash()
        if not h.data_hash:
            h.data_hash = self.data.hash()
        if not h.evidence_hash:
            h.evidence_hash = self.evidence.hash()

    def validate_basic(self) -> None:
        if self.header.height < 1:
            raise ValueError("invalid block height")
        if self.header.num_txs != len(self.data.txs):
            raise ValueError("num_txs mismatch")
        if self.header.height > 1:
            self.last_commit.validate_basic()
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("last_commit_hash mismatch")
        if self.header.data_hash != self.data.hash():
            raise ValueError("data_hash mismatch")
        if self.header.evidence_hash != self.evidence.hash():
            raise ValueError("evidence_hash mismatch")

    def hash(self) -> bytes:
        self.fill_header()
        return self.header.hash()

    def to_obj(self):
        return {"header": self.header.to_obj(), "data": self.data.to_obj(),
                "evidence": self.evidence.to_obj(),
                "last_commit": self.last_commit.to_obj()}

    @classmethod
    def from_obj(cls, o):
        return cls(Header.from_obj(o["header"]), Data.from_obj(o["data"]),
                   EvidenceData.from_obj(o["evidence"]),
                   Commit.from_obj(o["last_commit"]))

    def to_bytes(self) -> bytes:
        """Canonical bytes, cached keyed on the header hash: a header
        write changes that hash and so misses the cache. (Changing data,
        evidence or the last commit without the header makes a block whose
        header hashes are stale, cached or not.)"""
        hh = self.header.hash()
        if (self.__dict__.get("_bytes_hh") == hh
                and self.__dict__.get("_bytes") is not None):
            return self.__dict__["_bytes"]
        b = encoding.cdumps(self.to_obj())
        self.__dict__["_bytes"] = b
        self.__dict__["_bytes_hh"] = hh
        return b

    @classmethod
    def from_bytes(cls, b: bytes) -> "Block":
        blk = cls.from_obj(encoding.cloads(b))
        blk.__dict__["_bytes"] = bytes(b)
        blk.__dict__["_bytes_hh"] = blk.header.hash()
        return blk

    def make_part_set(self, part_size: int):
        """The block's bytes split into parts, cached keyed on (header
        hash, part size); an unfilled header (hash b"") is never cached,
        since its hash cannot witness a later change."""
        from tendermint_tpu_torch.types.part_set import PartSet
        hh = self.header.hash()
        if hh and self.__dict__.get("_partset_key") == (hh, part_size):
            return self.__dict__["_partset"]
        ps = PartSet.from_data(self.to_bytes(), part_size)
        if hh:
            self.__dict__["_partset"] = ps
            self.__dict__["_partset_key"] = (hh, part_size)
        return ps

    def block_id(self, part_size: int) -> BlockID:
        ps = self.make_part_set(part_size)
        return BlockID(self.hash(), ps.header())
