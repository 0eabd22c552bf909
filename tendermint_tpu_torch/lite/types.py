"""Light-client data types.

Counterpart of `tendermint_tpu/lite/types.py`: a SignedHeader is a header
plus the commit that signed it; a FullCommit adds the validator set that
did the signing, which is everything a light client needs to certify one
height without executing blocks. The messages raised are the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types.block import BlockID, Commit, Header
from tendermint_tpu_torch.types.validator_set import ValidatorSet


class CertificationError(Exception):
    pass


class ValidatorsChangedError(CertificationError):
    """The signing set is not the trusted one: the caller should update
    through intermediate headers."""


@dataclass
class SignedHeader:
    header: Header
    commit: Commit
    block_id: BlockID

    @property
    def height(self) -> int:
        return self.header.height

    def to_obj(self):
        return {"header": self.header.to_obj(),
                "commit": self.commit.to_obj(),
                "block_id": self.block_id.to_obj()}

    @classmethod
    def from_obj(cls, o):
        return cls(Header.from_obj(o["header"]),
                   Commit.from_obj(o["commit"]),
                   BlockID.from_obj(o["block_id"]))


@dataclass
class FullCommit:
    """SignedHeader + the validator set that signed it."""
    signed_header: SignedHeader
    validators: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    def validate_basic(self, chain_id: str) -> None:
        h = self.signed_header.header
        if h.chain_id != chain_id:
            raise CertificationError(
                f"wrong chain id {h.chain_id!r} (want {chain_id!r})")
        if h.validators_hash != self.validators.hash():
            raise CertificationError(
                "validator set does not match header's validators_hash")
        if self.signed_header.block_id.hash != h.hash():
            raise CertificationError("commit is not for this header")

    def to_obj(self):
        return {"signed_header": self.signed_header.to_obj(),
                "validators": self.validators.to_obj()}

    @classmethod
    def from_obj(cls, o):
        return cls(SignedHeader.from_obj(o["signed_header"]),
                   ValidatorSet.from_obj(o["validators"]))
