"""GenesisDoc: a chain's initial conditions.

Counterpart of `tendermint_tpu/types/genesis.py`: the same checks,
canonical bytes, validator hash and file format.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.utils import clock


@dataclass
class GenesisValidator:
    pubkey: bytes
    power: int
    name: str = ""

    def to_obj(self):
        return {"pubkey": self.pubkey.hex(), "power": self.power, "name": self.name}

    @classmethod
    def from_obj(cls, o):
        return cls(bytes.fromhex(o["pubkey"]), o["power"], o.get("name", ""))


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: Optional[dict] = None

    def validate_and_complete(self) -> None:
        """types/genesis.go:55 semantics."""
        if not self.chain_id:
            raise ValueError("genesis doc must include chain_id")
        self.consensus_params.validate()
        if not self.validators:
            raise ValueError("genesis doc must include validators")
        for v in self.validators:
            if v.power <= 0:
                raise ValueError("genesis validator power must be positive")
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = clock.now_ns()

    def validator_hash(self) -> bytes:
        from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
        return ValidatorSet(
            [Validator(v.pubkey, v.power) for v in self.validators]).hash()

    def to_obj(self):
        return {
            "chain_id": self.chain_id,
            "genesis_time_ns": self.genesis_time_ns,
            "consensus_params": self.consensus_params.to_obj(),
            "validators": [v.to_obj() for v in self.validators],
            "app_hash": self.app_hash.hex(),
            "app_state": self.app_state,
        }

    @classmethod
    def from_obj(cls, o):
        return cls(
            chain_id=o["chain_id"], genesis_time_ns=o["genesis_time_ns"],
            consensus_params=ConsensusParams.from_obj(o["consensus_params"]),
            validators=[GenesisValidator.from_obj(v) for v in o["validators"]],
            app_hash=bytes.fromhex(o["app_hash"]),
            app_state=o.get("app_state"))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_obj(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            doc = cls.from_obj(json.load(f))
        doc.validate_and_complete()
        return doc

    def bytes(self) -> bytes:
        return encoding.cdumps(self.to_obj())
