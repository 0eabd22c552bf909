"""State: a value-type snapshot of the replicated state; the port's copy
of `tendermint_tpu/state/state.py` (state/state.go:28).

Holds everything consensus needs that is not the blocks themselves: heights,
current+last validator sets, consensus params, the app hash and the last
ABCI results hash. It is deliberately a cheap copyable value: the consensus
state machine holds one, the executor returns an updated one.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List

from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.block import Block, BlockID, Commit, Data, EvidenceData, Header
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet


@dataclass
class State:
    chain_id: str = ""
    last_block_height: int = 0
    last_block_total_tx: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0
    validators: ValidatorSet = None
    last_validators: ValidatorSet = None
    last_height_validators_changed: int = 1
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 1
    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def copy(self) -> "State":
        # valsets are SHARED, not copied: a published ValidatorSet is
        # never mutated in place — the only in-place mutation in the
        # codebase (increment_accum, consensus/state.py + state/
        # execution.py) always operates on a freshly .copy()'d set
        # before publishing it. Copying two valsets per State.copy was
        # a top-5 cost of the fast-sync loop.
        return replace(self)

    def is_empty(self) -> bool:
        return self.validators is None

    def equals(self, other: "State") -> bool:
        return encoding.cdumps(self.to_obj()) == encoding.cdumps(other.to_obj())

    def make_block(self, height: int, txs: List[bytes], commit: Commit,
                   time_ns: int, evidence=None) -> Block:
        """Build the next proposal block from this state (state/state.go:106).

        The proposer fills app_hash/last_results_hash from the *previous*
        height's execution, validators/consensus hashes from current state.
        """
        header = Header(
            chain_id=self.chain_id, height=height, time_ns=time_ns,
            num_txs=len(txs), total_txs=self.last_block_total_tx + len(txs),
            last_block_id=self.last_block_id,
            validators_hash=self.validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
        )
        block = Block(header, Data(list(txs)),
                      EvidenceData(list(evidence or [])), commit)
        block.fill_header()
        return block

    def to_obj(self):
        return {
            "chain_id": self.chain_id,
            "last_block_height": self.last_block_height,
            "last_block_total_tx": self.last_block_total_tx,
            "last_block_id": self.last_block_id.to_obj(),
            "last_block_time_ns": self.last_block_time_ns,
            "validators": self.validators.to_obj() if self.validators else None,
            "last_validators": (self.last_validators.to_obj()
                                if self.last_validators else None),
            "last_height_validators_changed":
                self.last_height_validators_changed,
            "consensus_params": self.consensus_params.to_obj(),
            "last_height_consensus_params_changed":
                self.last_height_consensus_params_changed,
            "last_results_hash": self.last_results_hash.hex(),
            "app_hash": self.app_hash.hex(),
        }

    @classmethod
    def from_obj(cls, o) -> "State":
        return cls(
            chain_id=o["chain_id"],
            last_block_height=o["last_block_height"],
            last_block_total_tx=o["last_block_total_tx"],
            last_block_id=BlockID.from_obj(o["last_block_id"]),
            last_block_time_ns=o["last_block_time_ns"],
            validators=(ValidatorSet.from_obj(o["validators"])
                        if o["validators"] else None),
            last_validators=(ValidatorSet.from_obj(o["last_validators"])
                             if o["last_validators"] else None),
            last_height_validators_changed=o["last_height_validators_changed"],
            consensus_params=ConsensusParams.from_obj(o["consensus_params"]),
            last_height_consensus_params_changed=
                o["last_height_consensus_params_changed"],
            last_results_hash=bytes.fromhex(o["last_results_hash"]),
            app_hash=bytes.fromhex(o["app_hash"]),
        )


def make_genesis_state(gen_doc: GenesisDoc) -> State:
    """state/state.go:151 — initial State from a validated genesis doc."""
    gen_doc.validate_and_complete()
    vals = ValidatorSet(
        [Validator(v.pubkey, v.power) for v in gen_doc.validators])
    return State(
        chain_id=gen_doc.chain_id,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time_ns=gen_doc.genesis_time_ns,
        validators=vals,
        last_validators=ValidatorSet([]),
        last_height_validators_changed=1,
        consensus_params=gen_doc.consensus_params,
        last_height_consensus_params_changed=1,
        app_hash=gen_doc.app_hash,
    )
