"""PartSetHeader, BlockID, Header and Commit.

Counterpart of those types in `tendermint_tpu/types/block.py`, with the
same canonical objects and Merkle hashes. Block and Data come in a later
slice.
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

    def hash(self) -> bytes:
        """Merkle root over the canonical encodings of the precommits."""
        return merkle.root_host([encoding.cdumps(v.to_obj() if v else None)
                                 for v in self.precommits])

    def to_obj(self):
        return {"block_id": self.block_id.to_obj(),
                "precommits": [v.to_obj() if v else None
                               for v in self.precommits]}
