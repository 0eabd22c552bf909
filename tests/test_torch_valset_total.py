"""The port's ValidatorSet keeps its total voting power once a set.

The total is summed at the first read and kept, since a set's membership
and powers never change in place. These tests hold the kept total to the
plain sum through every way a set is built (constructor, copy, from_obj,
update_with_changes), hold the port's total, hash and +2/3 crossing to
the JAX package's, and count the sums and reads of one 10,000-vote batch
and of 16 threads reading at once.
"""

import sys
import threading

import numpy as np
import pytest

from tendermint_tpu.models import verifier as jverifier
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.types import vote_set as jvset
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.types import vote_set as tvset

CHAIN = "test-chain"
PRE = jvote.VoteType.PREVOTE
JAX = (jblock, jkeys, jvs, jvote, jvset, jverifier)
PORT = (tblock, tkeys, tvs, tvote, tvset, tverifier)


def _plain(vs):
    return sum(v.voting_power for v in vs.validators)


def _seeded_changes(mod, vs, rng):
    """One removal (power 0), one power change and one addition."""
    gone, moved = vs.validators[0], vs.validators[1]
    return [mod.Validator(gone.pubkey, 0),
            mod.Validator(moved.pubkey, moved.voting_power + 17),
            mod.Validator(rng.bytes(32), int(rng.randint(1, 1000)))]


def _built_sets(mod, seed):
    """(how, set) for each way a set is made, each from seeded inputs;
    the parent's total is read before each derived set is made, so a
    total carried over from it would show."""
    rng = np.random.RandomState(seed)
    vals = [mod.Validator(rng.bytes(32), int(rng.randint(1, 1000)))
            for _ in range(12)]
    base = mod.ValidatorSet(vals)
    out = [("init", base), ("copy, total unread", base.copy())]
    base.total_voting_power()
    out.append(("copy", base.copy()))
    out.append(("from_obj", mod.ValidatorSet.from_obj(base.to_obj())))
    updated = base.update_with_changes(_seeded_changes(mod, base, rng))
    out.append(("update_with_changes", updated))
    updated.total_voting_power()
    out.append(("copy of the update", updated.copy()))
    return out


@pytest.mark.parametrize("seed", [3, 41, 2026])
def test_total_matches_the_plain_sum_and_jax(seed):
    port, jax = _built_sets(tvs, seed), _built_sets(jvs, seed)
    assert [h for h, _ in port] == [h for h, _ in jax]
    for (how, p), (_, j) in zip(port, jax):
        assert p.total_voting_power() == _plain(p), how
        # a second read gives the kept value
        assert p.total_voting_power() == _plain(p), how
        assert p.total_voting_power() == j.total_voting_power(), how
        assert p.hash() == j.hash(), how
    # the update removed, changed and added: its total moved
    tot = {h: s.total_voting_power() for h, s in port}
    assert tot["update_with_changes"] != tot["init"]


# powers by key number; the vote orders put each set's vote sum exactly
# on its quorum, total * 2 // 3 + 1, at the third vote
_POWERS = [40, 30, 20, 11, 50]            # total 151, quorum 101
_ORDER = [4, 0, 3, 1, 2]                  # 50 + 40 + 11 = 101
_CHANGES = [(3, 0), (4, 45), (5, 6)]      # total 141, quorum 95
_ORDER_AFTER = [4, 1, 2, 0, 5]            # 45 + 30 + 20 = 95


def _crossings(mods):
    """The majority after each vote, on a set and then on the set that
    update_with_changes makes from it."""
    blk, keys, vsm, vt, vsetm, ver = mods
    verifier = ver.BatchVerifier("python")
    rng = np.random.RandomState(77)
    privs = [keys.PrivKey.generate(rng.bytes(32)) for _ in range(6)]
    bid = blk.BlockID(hash=b"q".ljust(32, b"\0"),
                      parts=blk.PartSetHeader(1, b"p" * 32))

    def run(vs, order):
        vset = vsetm.VoteSet(CHAIN, 1, 0, PRE, vs, verifier=verifier)
        out = []
        for k in order:
            addr = privs[k].pubkey.address
            idx, _ = vs.get_by_address(addr)
            v = vt.Vote(validator_address=addr, validator_index=idx,
                        height=1, round=0, timestamp_ns=1000 + k, type=PRE,
                        block_id=bid)
            v.signature = privs[k].sign(v.sign_bytes(CHAIN))
            assert vset.add_vote(v)
            maj = vset.two_thirds_majority()
            out.append((vset.power, None if maj is None else maj.key()))
        return out

    old = vsm.ValidatorSet([vsm.Validator(privs[k].pubkey.ed25519, p)
                            for k, p in enumerate(_POWERS)])
    before = run(old, _ORDER)
    new = old.update_with_changes([
        vsm.Validator(privs[k].pubkey.ed25519, p) for k, p in _CHANGES])
    return before, run(new, _ORDER_AFTER), new.total_voting_power()


def test_quorum_crossed_at_the_same_vote_as_jax():
    got, want = _crossings(PORT), _crossings(JAX)
    assert got == want
    before, after, total = got
    assert total == 141
    # exactly at the quorum: not at the second vote, at the third
    assert [p for p, _ in before[:3]] == [50, 90, 101]
    assert before[1][1] is None and before[2][1] is not None
    # the new set's quorum is 95; the old set's 101 would not be crossed
    assert [p for p, _ in after[:3]] == [45, 75, 95]
    assert after[1][1] is None and after[2][1] is not None


class _AcceptAll:
    """A verifier stub: every signature valid, no crypto run."""

    def verify_async(self, items):
        n = len(items)
        return lambda: [True] * n


def test_one_sum_per_set_over_a_10k_vote_batch():
    n = 10_000
    rng = np.random.RandomState(10_000)
    vs = tvs.ValidatorSet([tvs.Validator(rng.bytes(32), 1 + i % 7)
                           for i in range(n)], _fresh=False)
    bid = tblock.BlockID(hash=b"b".ljust(32, b"\0"),
                         parts=tblock.PartSetHeader(1, b"p" * 32))
    votes = [tvote.Vote(v.address, i, 5, 0, 1000 + i, PRE, bid, bytes(64))
             for i, v in enumerate(vs.validators)]
    vset = tvset.VoteSet(CHAIN, 5, 0, PRE, vs, verifier=_AcceptAll())
    s0 = tvs.total_stats()
    results, errors = vset.add_votes_batch(votes)
    s1 = tvs.total_stats()
    assert errors == [] and results == [True] * n
    assert vset.has_all() and vset.two_thirds_majority() == bid
    assert s1["sums"] - s0["sums"] <= 1
    assert s1["reads"] - s0["reads"] >= n


def test_counters_lose_no_update_across_threads():
    """16 threads read the totals of the same 100 fresh sets in the same
    order, released together, with the interpreter switching threads
    every microsecond: every read and exactly one sum a set are
    counted, and every read gives the plain sum."""
    sets = [tvs.ValidatorSet([tvs.Validator(bytes([k, i]) * 16, 1 + i)
                              for i in range(200)], _fresh=False)
            for k in range(100)]
    workers = 16
    start = threading.Barrier(workers)
    seen = [[] for _ in range(workers)]

    def read(out):
        start.wait(timeout=60)
        out.extend(s.total_voting_power() for s in sets)

    s0 = tvs.total_stats()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read, args=(out,))
                   for out in seen]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    s1 = tvs.total_stats()
    assert s1["reads"] - s0["reads"] == workers * len(sets)
    assert s1["sums"] - s0["sums"] == len(sets)
    assert seen == [[_plain(s) for s in sets]] * workers
