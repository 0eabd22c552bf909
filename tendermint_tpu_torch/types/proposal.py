"""Proposal and Heartbeat: signed consensus messages.

Counterpart of `tendermint_tpu/types/proposal.py`, with the same sign
bytes, canonical objects and `str()`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader


@dataclass
class Proposal:
    height: int
    round: int
    block_parts_header: PartSetHeader
    pol_round: int = -1                      # proof-of-lock round, -1 if none
    pol_block_id: BlockID = field(default_factory=BlockID)
    timestamp_ns: int = 0
    signature: bytes = b""

    def sign_obj(self, chain_id: str):
        return {
            "@chain_id": chain_id,
            "@type": "proposal",
            "height": self.height,
            "round": self.round,
            "block_parts_header": self.block_parts_header.to_obj(),
            "pol_round": self.pol_round,
            "pol_block_id": self.pol_block_id.to_obj(),
            "timestamp_ns": self.timestamp_ns,
        }

    def sign_bytes(self, chain_id: str) -> bytes:
        return encoding.cdumps(self.sign_obj(chain_id))

    def to_obj(self):
        return {
            "height": self.height, "round": self.round,
            "block_parts_header": self.block_parts_header.to_obj(),
            "pol_round": self.pol_round,
            "pol_block_id": self.pol_block_id.to_obj(),
            "timestamp_ns": self.timestamp_ns,
            "signature": self.signature.hex(),
        }

    @classmethod
    def from_obj(cls, o):
        return cls(
            height=o["height"], round=o["round"],
            block_parts_header=PartSetHeader.from_obj(o["block_parts_header"]),
            pol_round=o["pol_round"],
            pol_block_id=BlockID.from_obj(o["pol_block_id"]),
            timestamp_ns=o["timestamp_ns"],
            signature=bytes.fromhex(o["signature"]))

    def __str__(self):
        return (f"Proposal{{{self.height}/{self.round} "
                f"{self.block_parts_header.hash.hex()[:8]} pol:{self.pol_round}}}")


@dataclass
class Heartbeat:
    validator_address: bytes
    validator_index: int
    height: int
    round: int
    sequence: int
    signature: bytes = b""

    def sign_obj(self, chain_id: str):
        return {
            "@chain_id": chain_id, "@type": "heartbeat",
            "validator_address": self.validator_address.hex(),
            "validator_index": self.validator_index,
            "height": self.height, "round": self.round,
            "sequence": self.sequence,
        }

    def sign_bytes(self, chain_id: str) -> bytes:
        return encoding.cdumps(self.sign_obj(chain_id))

    def to_obj(self):
        o = self.sign_obj("")
        del o["@chain_id"], o["@type"]
        o["signature"] = self.signature.hex()
        return o

    @classmethod
    def from_obj(cls, o):
        return cls(bytes.fromhex(o["validator_address"]), o["validator_index"],
                   o["height"], o["round"], o["sequence"],
                   bytes.fromhex(o["signature"]))
