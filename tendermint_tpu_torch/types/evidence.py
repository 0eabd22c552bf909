"""Evidence of byzantine behaviour: DuplicateVoteEvidence.

Counterpart of `tendermint_tpu/types/evidence.py`: two signed votes of
one validator for the same (height, round, type) and different blocks.
`verify` checks both signatures in one verifier call, with the JAX
package's messages.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.keys import address_of
from tendermint_tpu_torch.types.vote import Vote


@dataclass
class DuplicateVoteEvidence:
    pubkey: bytes
    vote_a: Vote
    vote_b: Vote

    def height(self) -> int:
        return self.vote_a.height

    def address(self) -> bytes:
        return address_of(self.pubkey)

    def hash(self) -> bytes:
        return encoding.chash(self.to_obj())

    def verify(self, chain_id: str, pubkey: bytes, verifier=None) -> None:
        """Raises ValueError unless the votes are a real double sign by
        `pubkey`; both signatures go to the verifier in one batch."""
        from tendermint_tpu_torch.models.verifier import default_verifier
        verifier = verifier or default_verifier()
        a, b = self.vote_a, self.vote_b
        if pubkey != self.pubkey:
            raise ValueError("evidence pubkey mismatch")
        if (a.height, a.round, a.type) != (b.height, b.round, b.type):
            raise ValueError("votes are for different H/R/S")
        if a.validator_address != b.validator_address or \
                a.validator_address != address_of(self.pubkey):
            raise ValueError("validator address mismatch")
        if a.block_id == b.block_id:
            raise ValueError("votes are for the same block — not duplicity")
        ok = verifier.verify([
            (self.pubkey, a.sign_bytes(chain_id), a.signature),
            (self.pubkey, b.sign_bytes(chain_id), b.signature)])
        if not ok.all():
            raise ValueError("invalid signature in evidence")

    def to_obj(self):
        return {"type": "duplicate_vote", "pubkey": self.pubkey.hex(),
                "vote_a": self.vote_a.to_obj(), "vote_b": self.vote_b.to_obj()}

    @classmethod
    def from_obj(cls, o):
        return cls(bytes.fromhex(o["pubkey"]),
                   Vote.from_obj(o["vote_a"]), Vote.from_obj(o["vote_b"]))

    def __eq__(self, other):
        return isinstance(other, DuplicateVoteEvidence) and \
            self.to_obj() == other.to_obj()


def evidence_to_obj(ev) -> dict:
    return ev.to_obj()


def evidence_from_obj(o):
    if o["type"] == "duplicate_vote":
        return DuplicateVoteEvidence.from_obj(o)
    raise ValueError(f"unknown evidence type {o['type']}")
