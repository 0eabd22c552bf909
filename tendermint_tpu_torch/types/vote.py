"""Vote: a signed prevote or precommit, and its canonical sign bytes.

Counterpart of `tendermint_tpu/types/vote.py`; the sign bytes, the
canonical object and `str(vote)` (which VoteSet's messages embed) are
identical.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from tendermint_tpu_torch.types.keys import address_of
from tendermint_tpu_torch.utils import clock


class VoteType:
    PREVOTE = 1
    PRECOMMIT = 2

    @staticmethod
    def valid(t: int) -> bool:
        return t in (VoteType.PREVOTE, VoteType.PRECOMMIT)


def now_ns() -> int:
    return clock.now_ns()


def sign_bytes_template(chain_id: str, block_id, height: int, round_: int,
                        type_: int) -> tuple:
    """(prefix, suffix) around the timestamp of the canonical vote sign
    bytes: the one definition of their layout. Votes of one commit
    differ only in timestamp per block id, so a commit builds one
    template per block id."""
    cid = json.dumps(chain_id, ensure_ascii=False)
    return (
        f'{{"@chain_id":{cid},"@type":"vote",'
        f'"block_id":{{"hash":"{block_id.hash.hex()}",'
        f'"parts":{{"hash":"{block_id.parts.hash.hex()}",'
        f'"total":{block_id.parts.total}}}}},'
        f'"height":{height},"round":{round_},'
        f'"timestamp_ns":',
        f',"type":{type_}}}')


@dataclass
class Vote:
    validator_address: bytes
    validator_index: int
    height: int
    round: int
    timestamp_ns: int
    type: int
    block_id: "BlockID"          # zero BlockID = nil vote
    signature: bytes = b""

    def sign_obj(self, chain_id: str):
        """The sign-bytes content: (chain, height, round, type, block,
        time); the validator's identity is bound by its key."""
        return {
            "@chain_id": chain_id,
            "@type": "vote",
            "height": self.height,
            "round": self.round,
            "timestamp_ns": self.timestamp_ns,
            "type": self.type,
            "block_id": self.block_id.to_obj(),
        }

    def sign_bytes(self, chain_id: str) -> bytes:
        """encoding.cdumps(self.sign_obj(chain_id)), emitted directly."""
        pre, suf = sign_bytes_template(chain_id, self.block_id,
                                       self.height, self.round, self.type)
        return (pre + str(self.timestamp_ns) + suf).encode()

    def to_obj(self):
        # cached per signature object: a commit encodes its votes for the
        # block bytes and again for its hash. A vote's fields do not
        # change after signing, and a new signature misses the cache.
        # Callers treat the dict as read-only.
        sig = self.signature
        if self.__dict__.get("_obj_sig") is sig:
            return self.__dict__["_obj"]
        o = {
            "validator_address": self.validator_address.hex(),
            "validator_index": self.validator_index,
            "height": self.height,
            "round": self.round,
            "timestamp_ns": self.timestamp_ns,
            "type": self.type,
            "block_id": self.block_id.to_obj(),
            "signature": sig.hex(),
        }
        self.__dict__["_obj"] = o
        self.__dict__["_obj_sig"] = sig
        return o

    @classmethod
    def from_obj(cls, o, block_id=None) -> "Vote":
        """`block_id`, if given, is `o["block_id"]` already decoded."""
        if block_id is None:
            from tendermint_tpu_torch.types.block import BlockID
            block_id = BlockID.from_obj(o["block_id"])
        return cls(
            validator_address=bytes.fromhex(o["validator_address"]),
            validator_index=o["validator_index"],
            height=o["height"], round=o["round"],
            timestamp_ns=o["timestamp_ns"], type=o["type"],
            block_id=block_id,
            signature=bytes.fromhex(o["signature"]))

    def verify(self, chain_id: str, pubkey: bytes) -> bool:
        """One vote on the host; batches go through VoteSet."""
        if address_of(pubkey) != self.validator_address:
            return False
        from tendermint_tpu_torch.utils import ed25519_ref as ref
        return ref.verify(pubkey, self.sign_bytes(chain_id), self.signature)

    def validate_basic(self) -> None:
        if not VoteType.valid(self.type):
            raise ValueError(f"invalid vote type {self.type}")
        if self.height < 1 or self.round < 0:
            raise ValueError("invalid height/round")
        if len(self.validator_address) != 20:
            raise ValueError("bad validator address")
        if self.validator_index < 0:
            raise ValueError("bad validator index")

    def __str__(self) -> str:
        t = "prevote" if self.type == VoteType.PREVOTE else "precommit"
        return (f"Vote{{{self.validator_index}:"
                f"{self.validator_address.hex()[:8]} "
                f"{self.height}/{self.round} {t} {self.block_id.short()}}}")
