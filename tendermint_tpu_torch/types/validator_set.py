"""Validator and ValidatorSet: proposer rotation and batched commit verify.

Counterpart of `tendermint_tpu/types/validator_set.py`. All signatures of
a commit are collected and dispatched to the port's BatchVerifier in one
call: on the card, a 10,000-validator commit is two kernel launches.
The structural checks and the messages raised match the JAX package's.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence

from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.keys import address_of
from tendermint_tpu_torch.types.vote import VoteType, sign_bytes_template

_address_memo = functools.lru_cache(maxsize=65536)(address_of)

# sums  = a set added up its members' powers (once a set)
# reads = total_voting_power() calls; the cache's hit share is
#         1 - sums/reads
_total_stats = {"sums": 0, "reads": 0}
_total_stats_lock = threading.Lock()


def total_stats() -> dict:
    """Snapshot of the total-power counters since the process started:
    the sets' sums of their powers and the reads of a total."""
    with _total_stats_lock:
        return dict(_total_stats)


@dataclass
class Validator:
    pubkey: bytes                # 32-byte ed25519
    voting_power: int
    accum: int = 0               # proposer-priority accumulator

    @property
    def address(self) -> bytes:
        return _address_memo(self.pubkey)

    def copy(self) -> "Validator":
        return Validator(self.pubkey, self.voting_power, self.accum)

    def compare_accum(self, other: "Validator") -> "Validator":
        """Higher accum wins; ties break to the lower address."""
        if self.accum > other.accum:
            return self
        if self.accum < other.accum:
            return other
        return self if self.address < other.address else other

    def to_obj(self):
        return {"pubkey": self.pubkey.hex(), "voting_power": self.voting_power,
                "accum": self.accum}

    @classmethod
    def from_obj(cls, o):
        return cls(bytes.fromhex(o["pubkey"]), o["voting_power"], o["accum"])


class ValidatorSet:
    """Validators sorted by address, with accum-based proposer rotation.

    Membership and powers never change in place: a change of either
    builds a new set (`update_with_changes`). The address index, the
    hash and the total power rest on that, and are kept once a set;
    only the accums and the proposer move.
    """

    def __init__(self, validators: Sequence[Validator], _fresh: bool = True):
        self.validators: List[Validator] = sorted(
            (v.copy() for v in validators), key=lambda v: v.address)
        addrs = [v.address for v in self.validators]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        self._index = {a: i for i, a in enumerate(addrs)}
        self._proposer: Optional[Validator] = None
        self._hash: Optional[bytes] = None
        self._total: Optional[int] = None
        # a fresh set runs one accum increment, so the first proposer is
        # the highest-power validator
        if _fresh and self.validators:
            self.increment_accum(1)

    def __len__(self) -> int:
        return len(self.validators)

    def copy(self) -> "ValidatorSet":
        """Copies of the validators in the same order; the address index
        is shared, since nothing changes a set's membership in place."""
        vs = ValidatorSet.__new__(ValidatorSet)
        vs.validators = [v.copy() for v in self.validators]
        vs._index = self._index
        vs._proposer = self._proposer.copy() if self._proposer else None
        vs._hash = self._hash
        vs._total = self._total
        return vs

    def total_voting_power(self) -> int:
        """Summed at the first read, then kept (the powers are fixed)."""
        with _total_stats_lock:
            _total_stats["reads"] += 1
            if self._total is None:
                _total_stats["sums"] += 1
                self._total = sum(v.voting_power for v in self.validators)
        return self._total

    def get_by_address(self, addr: bytes):
        i = self._index.get(addr, -1)
        return (i, self.validators[i]) if i >= 0 else (-1, None)

    def get_by_index(self, i: int) -> Optional[Validator]:
        return self.validators[i] if 0 <= i < len(self.validators) else None

    def has_address(self, addr: bytes) -> bool:
        return self.get_by_address(addr)[0] >= 0

    def increment_accum(self, times: int = 1) -> None:
        """Advance proposer rotation by `times` rounds: power*times lands
        on every accum once, then the running maximum is decremented
        `times` times; the last pick is the proposer."""
        if not self.validators or times <= 0:
            return
        for v in self.validators:
            v.accum += v.voting_power * times
        total = self.total_voting_power()
        for _ in range(times):
            mostest = self.validators[0]
            for v in self.validators[1:]:
                mostest = mostest.compare_accum(v)
            mostest.accum -= total
        self._proposer = mostest

    def proposer(self) -> Validator:
        if self._proposer is None:
            mostest = self.validators[0]
            for v in self.validators[1:]:
                mostest = mostest.compare_accum(v)
            self._proposer = mostest
        return self._proposer

    def hash(self) -> bytes:
        """Merkle root over (pubkey, power) leaves; cached, since
        membership and powers never change in place."""
        if self._hash is None:
            leaves = [encoding.cdumps(
                {"pubkey": v.pubkey.hex(), "voting_power": v.voting_power})
                for v in self.validators]
            self._hash = merkle.root_host(leaves)
        return self._hash

    def to_obj(self):
        o = {"validators": [v.to_obj() for v in self.validators]}
        # the proposer is state, not derivable from the accums: after an
        # increment it is the pre-decrement maximum, which the
        # post-decrement accums no longer identify
        if self._proposer is not None:
            o["proposer"] = self._proposer.address.hex()
        return o

    @classmethod
    def from_obj(cls, o):
        vs = cls([Validator.from_obj(v) for v in o["validators"]],
                 _fresh=False)
        prop = o.get("proposer")
        if prop is not None:
            i = vs._index.get(bytes.fromhex(prop), -1)
            if i < 0:
                raise ValueError(f"proposer {prop} not in validator set")
            vs._proposer = vs.validators[i]
        return vs

    # -- commit verification: the batched hot path ---------------------------

    def commit_verification_items(self, chain_id: str, block_id,
                                  height: int, commit):
        """Structural checks, then the (pubkey, sign_bytes, sig) triples
        with per-item (power, votes-for-block_id) metadata."""
        if len(self.validators) != commit.size():
            raise ValueError(
                f"commit size {commit.size()} != valset size "
                f"{len(self.validators)}")
        if height != commit.height():
            raise ValueError("commit height mismatch")
        items = []
        item_power = []
        round_ = commit.round()
        tmpl: dict = {}          # one sign-bytes template per block id
        for idx, pc in enumerate(commit.precommits):
            if pc is None:
                continue
            if pc.type != VoteType.PRECOMMIT:
                raise ValueError("commit contains non-precommit")
            if pc.height != height or pc.round != round_:
                raise ValueError("commit vote height/round mismatch")
            bid = pc.block_id
            tkey = (bid.hash, bid.parts.total, bid.parts.hash)
            t = tmpl.get(tkey)
            if t is None:
                t = sign_bytes_template(chain_id, bid, height, round_,
                                        pc.type)
                tmpl[tkey] = t
            items.append((self.validators[idx].pubkey,
                          (t[0] + str(pc.timestamp_ns) + t[1]).encode(),
                          pc.signature))
            item_power.append((self.validators[idx].voting_power,
                               bid == block_id))
        return items, item_power

    def check_commit_results(self, ok, item_power) -> None:
        """Every signature valid and +2/3 of the power on the block;
        raises ValueError otherwise."""
        power_for_block = 0
        for valid, (power, for_block) in zip(ok, item_power):
            if not valid:
                raise ValueError("invalid signature in commit")
            if for_block:
                power_for_block += power
        if not power_for_block * 3 > self.total_voting_power() * 2:
            raise ValueError(
                f"insufficient voting power: {power_for_block}/"
                f"{self.total_voting_power()}")

    def verify_commit_async(self, chain_id: str, block_id, height: int,
                            commit, verifier=None):
        """Structural checks and the signature dispatch run now; the
        returned finisher waits for the verdicts and judges the power."""
        from tendermint_tpu_torch.models.verifier import default_verifier
        verifier = verifier or default_verifier()
        items, item_power = self.commit_verification_items(
            chain_id, block_id, height, commit)
        resolve_ok = verifier.verify_async(items)

        def finish() -> None:
            self.check_commit_results(resolve_ok(), item_power)

        return finish

    def verify_commit(self, chain_id: str, block_id, height: int, commit,
                      verifier=None) -> None:
        """Verify that +2/3 of this set signed the commit, all signatures
        in one batch. Raises ValueError on failure."""
        self.verify_commit_async(chain_id, block_id, height, commit,
                                 verifier=verifier)()

    def commit_any_items(self, new_set: "ValidatorSet", chain_id: str,
                         block_id, height: int, commit):
        """verify_commit_any's structural checks, then the (pubkey,
        sign_bytes, sig) triples of the votes it counts, with each one's
        (old power, new power): only votes for block_id count, each
        against this (trusted) set's key by address; unknown validators
        are skipped, duplicates count once, and new-set power accrues
        where the new validator at that index has the same key. Raises
        ValueError."""
        if len(new_set.validators) != commit.size():
            raise ValueError("commit size != new valset size")
        if height != commit.height():
            raise ValueError("commit height mismatch")
        items = []
        powers = []
        seen = set()
        round_ = commit.round()
        tmpl = None              # every counted vote is for block_id
        for idx, pc in enumerate(commit.precommits):
            if pc is None:
                continue
            if pc.type != VoteType.PRECOMMIT or pc.height != height \
                    or pc.round != round_:
                raise ValueError("bad commit vote")
            if pc.block_id != block_id:
                continue
            oi, ov = self.get_by_address(pc.validator_address)
            if ov is None or oi in seen:
                continue
            seen.add(oi)
            if tmpl is None:
                tmpl = sign_bytes_template(chain_id, block_id, height,
                                           round_, VoteType.PRECOMMIT)
            nv = new_set.validators[idx]
            items.append((ov.pubkey,
                          (tmpl[0] + str(pc.timestamp_ns) + tmpl[1]).encode(),
                          pc.signature))
            powers.append((ov.voting_power,
                           nv.voting_power if nv.pubkey == ov.pubkey else 0))
        return items, powers

    def check_commit_any_results(self, new_set: "ValidatorSet", ok,
                                 powers) -> None:
        """Every counted signature valid, and > 2/3 of this set's power
        and > 2/3 of new_set's signed; raises ValueError otherwise."""
        old_power = new_power = 0
        for valid, (opow, npow) in zip(ok, powers):
            if not valid:
                raise ValueError("invalid signature in commit")
            old_power += opow
            new_power += npow
        if not old_power * 3 > self.total_voting_power() * 2:
            raise ValueError(
                f"insufficient old-set (trusted) voting power: got "
                f"{old_power}, need > {self.total_voting_power() * 2 / 3:g}")
        if not new_power * 3 > new_set.total_voting_power() * 2:
            raise ValueError(
                f"insufficient new-set voting power: got {new_power}, "
                f"need > {new_set.total_voting_power() * 2 / 3:g}")

    def verify_commit_any(self, new_set: "ValidatorSet", chain_id: str,
                          block_id, height: int, commit,
                          verifier=None) -> None:
        """Lite-client valset transition (v0.16 VerifyCommitAny): the
        items of commit_any_items in one batch, then the two > 2/3 rules
        of check_commit_any_results. Raises ValueError on failure."""
        from tendermint_tpu_torch.models.verifier import default_verifier
        verifier = verifier or default_verifier()
        items, powers = self.commit_any_items(new_set, chain_id, block_id,
                                              height, commit)
        self.check_commit_any_results(new_set, verifier.verify(items),
                                      powers)

    # -- updates -------------------------------------------------------------

    def update_with_changes(self,
                            changes: Sequence[Validator]) -> "ValidatorSet":
        """Apply ABCI validator updates (power 0 removes, else add or
        replace) and return a new set; accums carry over, and the new set
        is not incremented (the block's own increment follows)."""
        by_addr = {v.address: v.copy() for v in self.validators}
        for c in changes:
            if c.voting_power < 0:
                raise ValueError("negative voting power")
            if c.voting_power == 0:
                if c.address not in by_addr:
                    raise ValueError("removing unknown validator")
                del by_addr[c.address]
            else:
                prev = by_addr.get(c.address)
                accum = prev.accum if prev else 0
                by_addr[c.address] = Validator(c.pubkey, c.voting_power, accum)
        if not by_addr:
            raise ValueError("validator set would be empty")
        return ValidatorSet(list(by_addr.values()), _fresh=False)
