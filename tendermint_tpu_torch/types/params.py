"""Consensus-critical limits: ConsensusParams and its parts.

Counterpart of `tendermint_tpu/types/params.py`, with the same defaults
(a 65536-byte block part), checks, canonical object and hash.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.types import encoding


@dataclass
class BlockSize:
    max_bytes: int = 22020096  # 21 MB, matching the reference default
    max_txs: int = 100000
    max_gas: int = -1


@dataclass
class TxSize:
    max_bytes: int = 10240
    max_gas: int = -1


@dataclass
class BlockGossip:
    block_part_size_bytes: int = 65536


@dataclass
class EvidenceParams:
    max_age: int = 100000  # heights


@dataclass
class ConsensusParams:
    block_size: BlockSize = field(default_factory=BlockSize)
    tx_size: TxSize = field(default_factory=TxSize)
    block_gossip: BlockGossip = field(default_factory=BlockGossip)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)

    def validate(self) -> None:
        """types/params.go:89 semantics: positive, bounded sizes."""
        if self.block_size.max_bytes <= 0:
            raise ValueError("block_size.max_bytes must be positive")
        if self.block_size.max_bytes > 100 * 1024 * 1024:
            raise ValueError("block_size.max_bytes too large")
        if self.block_gossip.block_part_size_bytes <= 0:
            raise ValueError("block_gossip.block_part_size_bytes must be positive")
        if self.evidence.max_age <= 0:
            raise ValueError("evidence.max_age must be positive")

    def to_obj(self):
        return {
            "block_size": {"max_bytes": self.block_size.max_bytes,
                           "max_txs": self.block_size.max_txs,
                           "max_gas": self.block_size.max_gas},
            "tx_size": {"max_bytes": self.tx_size.max_bytes,
                        "max_gas": self.tx_size.max_gas},
            "block_gossip": {"block_part_size_bytes":
                             self.block_gossip.block_part_size_bytes},
            "evidence": {"max_age": self.evidence.max_age},
        }

    @classmethod
    def from_obj(cls, o) -> "ConsensusParams":
        return cls(
            BlockSize(**o["block_size"]), TxSize(**o["tx_size"]),
            BlockGossip(**o["block_gossip"]), EvidenceParams(**o["evidence"]))

    def hash(self) -> bytes:
        return encoding.chash(self.to_obj())

    def update(self, changes) -> "ConsensusParams":
        """Apply ABCI EndBlock param updates (types/params.go:121)."""
        new = ConsensusParams.from_obj(self.to_obj())
        if changes is None:
            return new
        if changes.get("block_size"):
            for k, v in changes["block_size"].items():
                setattr(new.block_size, k, v)
        if changes.get("tx_size"):
            for k, v in changes["tx_size"].items():
                setattr(new.tx_size, k, v)
        if changes.get("block_gossip"):
            for k, v in changes["block_gossip"].items():
                setattr(new.block_gossip, k, v)
        if changes.get("evidence"):
            for k, v in changes["evidence"].items():
                setattr(new.evidence, k, v)
        new.validate()
        return new
