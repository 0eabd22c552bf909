"""A plain vote set: the rules of Tendermint v0.16's types/vote_set.go
(AddVote, addVerifiedVote) for the votes of one height, round and type,
written from the specification for the benchmark's check. It imports
nothing of the port.

A message is a list of votes added as one batch: every vote is checked
first against the set as it stood before the message (fields, a vote
already held for the same block is skipped without a verdict), then the
votes whose signatures are valid are added in order. A vote from a
validator that already voted for another block is a conflict: it is
counted only toward a block some peer claimed +2/3 for (none here), and
reported. When a block's power crosses two thirds of the total, it is
the majority and its votes become the validators' canonical votes.
Results per message: the added flags, and (position, error class,
whether a conflicting vote was counted) for each error.
"""

from __future__ import annotations


class _Conflict(Exception):
    def __init__(self, added: bool = False):
        super().__init__()
        self.added = added


class VoteSet:
    def __init__(self, height: int, round_: int, type_: int, powers: list,
                 addrs: list):
        self.height, self.round, self.type = height, round_, type_
        self.powers, self.addrs = powers, addrs
        self.total = sum(powers)
        self.quorum = self.total * 2 // 3 + 1
        self.votes: list = [None] * len(powers)   # block key of the vote
        self.power = 0
        self.maj23 = None
        self.by_block: dict = {}     # key -> [peer_maj23, {index}, power]

    def add_message(self, votes: list) -> tuple:
        """votes: (index, address, height, round, type, block key,
        signature valid)."""
        results = [False] * len(votes)
        errors = []
        to_add = []
        for pos, (idx, addr, h, r, t, key, valid) in enumerate(votes):
            if (h, r, t) != (self.height, self.round, self.type) \
                    or not 0 <= idx < len(self.powers) \
                    or self.addrs[idx] != addr:
                errors.append((pos, "ValueError", False))
                continue
            if self.votes[idx] == key:
                continue
            held = self.by_block.get(key)
            if held is not None and idx in held[1]:
                continue
            to_add.append((pos, idx, key, valid))
        for pos, idx, key, valid in to_add:
            if not valid:
                errors.append((pos, "ValueError", False))
                continue
            try:
                results[pos] = self._add_verified(idx, key)
            except _Conflict as e:
                results[pos] = e.added
                errors.append((pos, "ConflictingVoteError", e.added))
        return results, errors

    def _add_verified(self, idx: int, key) -> bool:
        existing = self.votes[idx]
        conflicting = existing is not None and existing != key
        if conflicting:
            if self.maj23 == key:
                self.votes[idx] = key
        elif existing is None:
            self.votes[idx] = key
            self.power += self.powers[idx]
        bv = self.by_block.get(key)
        if bv is not None:
            if conflicting and not bv[0]:
                raise _Conflict()
        else:
            if conflicting:
                raise _Conflict()
            bv = self.by_block[key] = [False, set(), 0]
        if idx in bv[1]:
            if conflicting:
                raise _Conflict()
            return False
        before = bv[2]
        bv[1].add(idx)
        bv[2] += self.powers[idx]
        if before < self.quorum <= bv[2] and self.maj23 is None:
            self.maj23 = key
            for i in bv[1]:
                self.votes[i] = key
        if conflicting:
            raise _Conflict(added=True)
        return True

    def summary(self) -> tuple:
        """(power, majority block key or None, {block key: power})."""
        return (self.power, self.maj23,
                {k: v[2] for k, v in self.by_block.items()})
