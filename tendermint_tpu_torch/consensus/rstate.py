"""Round state types: the port's copy of `tendermint_tpu/consensus/
rstate.py` (consensus/types/state.go, height_vote_set.go).

Every VoteSet a HeightVoteSet makes carries its verifier, so a vote of
the height is checked on the BatchVerifier the node was built with."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tendermint_tpu_torch.types.block import Block, BlockID, Commit
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote, VoteType
from tendermint_tpu_torch.types.vote_set import VoteSet


class Step(enum.IntEnum):
    """consensus/types/state.go:16-26."""
    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


@dataclass
class POLInfo:
    """Proof-of-lock: the round + block of a +2/3 prevote majority."""
    round: int
    block_id: BlockID


class HeightVoteSet:
    """round → {prevotes, precommits} for one height
    (consensus/types/height_vote_set.go:32-129). A peer's votes may
    lazily create vote sets for rounds we haven't reached — but each
    peer may open at most MAX_CATCHUP_ROUNDS such rounds (the
    reference's peerCatchupRounds bound :107-129), which keeps memory
    bounded by the peer count while still letting a node that joined
    late accept a commit that happened many rounds ahead of it."""

    MAX_CATCHUP_ROUNDS = 2

    def __init__(self, chain_id: str, height: int, valset: ValidatorSet,
                 verifier=None):
        self.chain_id = chain_id
        self.height = height
        self.valset = valset
        self.verifier = verifier
        self.round = 0
        self._sets: Dict[tuple, VoteSet] = {}
        self._peer_catchup: Dict[str, list] = {}
        self.set_round(0)

    def _make(self, round_: int) -> None:
        for t in (VoteType.PREVOTE, VoteType.PRECOMMIT):
            if (round_, t) not in self._sets:
                self._sets[(round_, t)] = VoteSet(
                    self.chain_id, self.height, round_, t, self.valset,
                    verifier=self.verifier)

    def set_round(self, round_: int) -> None:
        # pre-make EVERY round up to round_+1, like the reference's
        # SetRound/addRound: after a round-skip the gap rounds must
        # exist, or gossip for them would burn peers' catchup allowance
        for r in range(self.round, round_ + 2):
            self._make(r)
        self.round = max(self.round, round_)

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._sets.get((round_, VoteType.PREVOTE))

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._sets.get((round_, VoteType.PRECOMMIT))

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        vs = self._sets.get((vote.round, vote.type))
        if vs is None:
            if peer_id:
                rounds = self._peer_catchup.setdefault(peer_id, [])
                if vote.round not in rounds:
                    if len(rounds) >= self.MAX_CATCHUP_ROUNDS:
                        raise ValueError(
                            f"vote round {vote.round}: peer {peer_id!r} "
                            f"exhausted its catchup-round allowance")
                    rounds.append(vote.round)
            self._make(vote.round)
            vs = self._sets[(vote.round, vote.type)]
        return vs.add_vote(vote)

    def add_votes(self, round_: int, type_: int, votes: List[Vote],
                  peer_id: str = ""):
        """Bulk add for one (round, type) group — the aggregated vote
        gossip path (consensus/compact.py). Catchup-round bookkeeping
        runs ONCE for the group, then the whole batch goes through
        VoteSet.add_votes_batch: one verifier dispatch for every
        signature instead of one per vote. Returns add_votes_batch's
        (results, errors) pair."""
        vs = self._sets.get((round_, type_))
        if vs is None:
            if peer_id:
                rounds = self._peer_catchup.setdefault(peer_id, [])
                if round_ not in rounds:
                    if len(rounds) >= self.MAX_CATCHUP_ROUNDS:
                        raise ValueError(
                            f"vote round {round_}: peer {peer_id!r} "
                            f"exhausted its catchup-round allowance")
                    rounds.append(round_)
            self._make(round_)
            vs = self._sets[(round_, type_)]
        return vs.add_votes_batch(votes)

    def pol_info(self) -> Optional[POLInfo]:
        """Highest round with a +2/3 prevote majority for a block
        (consensus/types/height_vote_set.go:145)."""
        for r in sorted({r for r, t in self._sets
                         if t == VoteType.PREVOTE}, reverse=True):
            maj = self._sets[(r, VoteType.PREVOTE)].two_thirds_majority()
            if maj is not None and not maj.is_zero():
                return POLInfo(r, maj)
        return None

    def set_peer_maj23(self, round_: int, type_: int, peer_id: str,
                       block_id: BlockID) -> None:
        self._make(round_)
        self._sets[(round_, type_)].set_peer_maj23(peer_id, block_id)


@dataclass
class RoundState:
    """consensus/types/state.go:60-77 — everything mutable about the
    current height/round."""
    height: int = 1
    round: int = 0
    step: Step = Step.NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None

    def round_state_event_obj(self) -> dict:
        return {"height": self.height, "round": self.round,
                "step": int(self.step)}
