"""VoteSet: the votes of one (height, round, type), and its +2/3 majority.

Counterpart of `tendermint_tpu/types/vote_set.py`, rule for rule: one
canonical vote per validator with conflicts tracked, the quorum crossing,
peer-claimed majorities (set_peer_maj23) and make_commit, with the same
results, exception classes and messages. Signatures go through the
port's BatchVerifier: `add_votes_batch` sends a whole burst in one
`verify_async` call (on the card, the verify kernels), `add_vote` one
vote (the "auto" verifier checks it on the host).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.types.block import BlockID, Commit
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote, VoteType


class ConflictingVoteError(Exception):
    """`added` mirrors the reference AddVote's (added, err) pair: a
    conflicting vote for a peer-claimed maj23 block is COUNTED and
    still reported — the caller must both file evidence AND run its
    normal post-add transitions (quorum checks, publish) when added."""

    def __init__(self, existing: Vote, new: Vote, added: bool = False):
        super().__init__(f"conflicting vote: {existing} vs {new}")
        self.existing = existing
        self.new = new
        self.added = added


@dataclass
class _BlockVotes:
    peer_maj23: bool
    votes_by_index: Dict[int, Vote] = field(default_factory=dict)
    power: int = 0


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int, type_: int,
                 valset: ValidatorSet, verifier=None):
        assert height >= 1 and VoteType.valid(type_)
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.type = type_
        self.valset = valset
        self.verifier = verifier
        # votes[i]: the canonical vote from validator i (first non-conflicting)
        self.votes: List[Optional[Vote]] = [None] * len(valset)
        self.power = 0  # total power of all canonical votes
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[str, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    # -- adding votes --------------------------------------------------------

    def add_vote(self, vote: Vote) -> bool:
        """Returns True if added. Raises ConflictingVoteError for a
        conflicting non-duplicate vote from the same validator (the caller
        turns that into evidence), ValueError for invalid votes.
        Validation order mirrors types/vote_set.go:130-216: index/address/
        step checks, duplicate check, THEN signature."""
        return self._add_votes([vote])[0]

    def add_vote_async(self, vote: Vote):
        """Opt-in async add: dispatches the signature verification
        WITHOUT blocking (through BatchVerifier.verify_async) and
        returns a zero-arg resolver that applies
        the vote and returns add_vote's result — raising exactly what
        add_vote would. Only the crypto is offloaded: validation runs
        now, the VoteSet mutation runs inside the resolver, which must
        execute on the thread that owns this VoteSet (consensus lock
        held)."""
        finish = self._add_votes_async([vote])
        return lambda: finish()[0]

    def add_votes_batch(self, votes: List[Vote]
                        ) -> tuple[List[bool], List[tuple[int, Exception]]]:
        """Batch ingestion (replay, catch-up, gossip bursts): one
        BatchVerifier call for all signatures. One bad vote must not poison
        the batch: per-vote failures (invalid signature, conflict) are
        returned as (position, error) pairs while every other vote is still
        applied — matching the reference's per-vote AddVote error
        semantics (types/vote_set.go:130). A conflicting vote counted via
        a peer-claimed maj23 block appears in BOTH lists: results[pos] is
        True (it mutated the set, possibly crossing quorum) AND its
        ConflictingVoteError (added=True) is in errors."""
        errors: List[tuple[int, Exception]] = []
        results = self._add_votes(votes, errors)
        return results, errors

    def _add_votes(self, votes: List[Vote],
                   errors: Optional[List[tuple[int, Exception]]] = None
                   ) -> List[bool]:
        return self._add_votes_async(votes, errors)()

    def _add_votes_async(self, votes: List[Vote],
                         errors: Optional[List[tuple[int, Exception]]] = None):
        """Validation now, signature dispatch now (async), application
        in the returned zero-arg finisher — the split that lets callers
        overlap device crypto with host work."""
        from tendermint_tpu_torch.models.verifier import default_verifier
        verifier = self.verifier or default_verifier()

        def fail(pos: int, exc: Exception) -> None:
            if errors is None:
                raise exc
            errors.append((pos, exc))

        with causal.span("votes.check", self.height, self.round,
                         n=len(votes), type=self.type):
            to_verify, items = self._check(votes, fail)
        resolve_ok = verifier.verify_async(items)
        results = [False] * len(votes)

        def finish() -> List[bool]:
            ok = resolve_ok()
            with causal.span("votes.count", self.height, self.round,
                             n=len(to_verify)):
                for valid, (vote, val, pos) in zip(ok, to_verify):
                    if not valid:
                        fail(pos, ValueError(f"invalid signature on {vote}"))
                        continue
                    try:
                        results[pos] = self._add_verified(vote, val)
                    except ConflictingVoteError as e:
                        # e.added: the vote WAS counted (peer-claimed
                        # maj23 block) — the result must say applied
                        # even though the conflict is also reported, or
                        # a batch caller skips the quorum transitions
                        # the vote may have triggered
                        results[pos] = e.added
                        fail(pos, e)
            return results

        return finish

    def _check(self, votes: List[Vote], fail) -> tuple:
        """The votes that need a signature check, as (vote, val, pos),
        and their verifier items; `fail(pos, exc)` takes each vote that
        fails validation."""
        to_verify = []   # (vote, val, pos)
        for pos, vote in enumerate(votes):
            try:
                if vote is None:
                    raise ValueError("nil vote")
                vote.validate_basic()
                idx = vote.validator_index
                if (vote.height, vote.round, vote.type) != \
                        (self.height, self.round, self.type):
                    raise ValueError(
                        f"vote {vote} does not match VoteSet "
                        f"{self.height}/{self.round}/{self.type}")
                val = self.valset.get_by_index(idx)
                if val is None:
                    raise ValueError(f"validator index {idx} out of range")
                if val.address != vote.validator_address:
                    raise ValueError(
                        "vote address does not match validator index")
            except Exception as e:
                fail(pos, e)
                continue
            # duplicate detection mirrors the reference's getVote
            # (types/vote_set.go:202-216): a vote may live in the
            # canonical slot OR only in a tracked block's votesByBlock
            # (an admitted conflicting vote) — a regossiped copy of
            # either is a silent no-op, not a fresh conflict to re-file
            # evidence (and re-run crypto) for.
            existing = self.votes[idx]
            if existing is not None and existing.block_id == vote.block_id:
                continue  # duplicate; results[pos] stays False
            bv0 = self.votes_by_block.get(vote.block_id.key())
            if bv0 is not None and idx in bv0.votes_by_index:
                continue  # already counted for this block (conflict path)
            # (on conflict: still verify the signature before accusing)
            to_verify.append((vote, val, pos))
        items = [(val.pubkey, v.sign_bytes(self.chain_id), v.signature)
                 for v, val, _ in to_verify]
        return to_verify, items

    def _add_verified(self, vote: Vote, val) -> bool:
        """types/vote_set.go:219-287 addVerifiedVote, exactly:

        - A conflicting vote still COUNTS toward a block some peer
          claims +2/3 for (set_peer_maj23) — without this, one
          equivocating validator's first vote could permanently hide
          the real majority from us. It is counted AND reported
          (ConflictingVoteError raised after the bookkeeping, the
          reference's `return true, conflicting`).
        - A conflicting vote for an UNTRACKED block is dropped (raised
          without counting).
        - When a tracked block crosses quorum, its votes become the
          canonical per-validator votes — equivocators' maj23-block
          votes replace their first votes (vote_set.go:273-283).
        """
        idx = vote.validator_index
        existing = self.votes[idx]
        conflicting = None
        if existing is not None and existing.block_id != vote.block_id:
            conflicting = existing
            # replace the canonical slot only if this block IS the maj23
            if self.maj23 is not None and \
                    self.maj23.key() == vote.block_id.key():
                self.votes[idx] = vote
        elif existing is None:
            self.votes[idx] = vote
            self.power += val.voting_power

        key = vote.block_id.key()
        bv = self.votes_by_block.get(key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                raise ConflictingVoteError(existing, vote)  # not counted
        else:
            if conflicting is not None:
                # untracked block + conflict: just forget it
                raise ConflictingVoteError(existing, vote)
            bv = _BlockVotes(peer_maj23=False)
            self.votes_by_block[key] = bv
        if idx in bv.votes_by_index:
            if conflicting is not None:
                raise ConflictingVoteError(existing, vote)
            return False
        orig = bv.power
        bv.votes_by_index[idx] = vote
        bv.power += val.voting_power
        quorum = self.valset.total_voting_power() * 2 // 3 + 1
        if orig < quorum <= bv.power and self.maj23 is None:
            self.maj23 = vote.block_id
            for i, v in bv.votes_by_index.items():
                self.votes[i] = v
        if conflicting is not None:
            # counted + reported (the reference's `return true, conflicting`)
            raise ConflictingVoteError(existing, vote, added=True)
        return True

    # -- peer-claimed majorities --------------------------------------------

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id (types/vote_set.go:294-329).
        The block starts being TRACKED immediately (entry created even
        before any vote arrives) so later conflicting votes for it are
        admitted. A conflicting claim from the same peer raises — the
        reference returns an error there; callers log it."""
        prev = self.peer_maj23s.get(peer_id)
        if prev is not None:
            if prev == block_id:
                return
            raise ValueError(f"conflicting maj23 claims from peer {peer_id}")
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_id.key())
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_id.key()] = \
                _BlockVotes(peer_maj23=True)

    # -- queries -------------------------------------------------------------

    def two_thirds_majority(self) -> Optional[BlockID]:
        return self.maj23

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        return self.power * 3 > self.valset.total_voting_power() * 2

    def has_all(self) -> bool:
        return self.power == self.valset.total_voting_power()

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]

    def get_by_address(self, addr: bytes) -> Optional[Vote]:
        i, _ = self.valset.get_by_address(addr)
        return self.votes[i] if i >= 0 else None

    def bit_array(self) -> List[bool]:
        return [v is not None for v in self.votes]

    def bit_array_by_block_id(self, block_id: BlockID) -> List[bool]:
        bv = self.votes_by_block.get(block_id.key())
        out = [False] * len(self.valset)
        if bv:
            for i in bv.votes_by_index:
                out[i] = True
        return out

    def make_commit(self) -> Commit:
        """types/vote_set.go:467: requires an unambiguous +2/3 block."""
        if self.type != VoteType.PRECOMMIT:
            raise ValueError("cannot make commit from non-precommit VoteSet")
        if self.maj23 is None:
            raise ValueError("no +2/3 majority")
        precommits = [
            v if v is not None and v.block_id == self.maj23 else None
            for v in self.votes]
        return Commit(block_id=self.maj23, precommits=precommits)

    def __str__(self) -> str:
        t = "prevote" if self.type == VoteType.PREVOTE else "precommit"
        frac = f"{self.power}/{self.valset.total_voting_power()}"
        return f"VoteSet{{H:{self.height} R:{self.round} {t} {frac} maj23:{self.maj23}}}"
