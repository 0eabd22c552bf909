"""The port's VoteSet against the JAX package's, scenario by scenario.

Each scenario of tests/test_types.py's VoteSet tests (quorum, nil and
mixed votes, bad votes, conflicting votes, make_commit, the majority keyed
on the full block id, conflicts under peer-claimed majorities) runs in
both packages on the same numpy-seeded keys and votes; every call's
result, exception class and message, and the set's state after each step
(majority, power, bit arrays) must be equal. The JAX package checks
signatures with its host verifier; the port with its host verifier and
with BatchVerifier("cuda", device="cpu"), whose batch path runs the plain
versions of the verify kernels. Then one add_votes_batch with a flipped
signature, a duplicate and a conflicting vote, as chip_smoke.py's block
phase feeds the card. Tolerance 0 (booleans, bytes and strings).
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

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

torch.set_num_threads(1)

CHAIN = "test-chain"
PRE, PC = jvote.VoteType.PREVOTE, jvote.VoteType.PRECOMMIT


def _pkg(mods):
    blk, vs, vt, keys, vset = mods
    return SimpleNamespace(
        BlockID=blk.BlockID, PSH=blk.PartSetHeader, Commit=blk.Commit,
        Validator=vs.Validator, ValidatorSet=vs.ValidatorSet, Vote=vt.Vote,
        PrivKey=keys.PrivKey, VoteSet=vset.VoteSet,
        Conflict=vset.ConflictingVoteError)


JAX = _pkg((jblock, jvs, jvote, jkeys, jvset))
PORT = _pkg((tblock, tvs, tvote, tkeys, tvset))


@functools.lru_cache(maxsize=None)
def _seeds(n):
    rng = np.random.RandomState(1000 + n)
    return [rng.bytes(32) for _ in range(n)]


def make_valset(P, n, power=10):
    privs = [P.PrivKey.generate(s) for s in _seeds(n)]
    vs = P.ValidatorSet([P.Validator(p.pubkey.ed25519, power) for p in privs])
    by_addr = {p.pubkey.address: p for p in privs}
    return vs, [by_addr[v.address] for v in vs.validators]


def bid_of(P, tag=b"blk", total=1, parts=b"p" * 32):
    return P.BlockID(hash=tag.ljust(32, b"\0"), parts=P.PSH(total, parts))


def signed_vote(P, priv, idx, height, round_, type_, block_id, ts=1000):
    v = P.Vote(validator_address=priv.pubkey.address, validator_index=idx,
               height=height, round=round_, timestamp_ns=ts, type=type_,
               block_id=block_id)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


class Trace:
    """Records each step's outcome and the set's state after it."""

    def __init__(self, vset=None):
        self.vset = vset
        self.steps = []

    def __call__(self, what, fn):
        try:
            out = ("ok", fn())
        except Exception as e:  # the class and message are compared
            out = ("raise", type(e).__name__, str(e),
                   getattr(e, "added", None))
        self.steps.append((what, out, self.state()))
        return out

    def state(self):
        s = self.vset
        if s is None:
            return None
        maj = s.two_thirds_majority()
        return (None if maj is None else maj.key(), s.power,
                s.has_two_thirds_any(), s.has_all(), tuple(s.bit_array()),
                tuple(sorted((k, tuple(sorted(bv.votes_by_index)), bv.power,
                              bv.peer_maj23)
                             for k, bv in s.votes_by_block.items())))


def _quorum(P, v, t):
    vs, privs = make_valset(P, 4)
    bid = bid_of(P)
    t.vset = vset = P.VoteSet(CHAIN, 1, 0, PRE, vs, verifier=v)
    for i in range(3):
        t(f"add {i}", lambda i=i: vset.add_vote(
            signed_vote(P, privs[i], i, 1, 0, PRE, bid)))


def _nil_and_mixed(P, v, t):
    vs, privs = make_valset(P, 4)
    bid, nil = bid_of(P), P.BlockID()
    t.vset = vset = P.VoteSet(CHAIN, 1, 0, PRE, vs, verifier=v)
    for i, b in enumerate((bid, nil, nil, nil)):
        t(f"add {i}", lambda i=i, b=b: vset.add_vote(
            signed_vote(P, privs[i], i, 1, 0, PRE, b)))


def _rejects_bad(P, v, t):
    vs, privs = make_valset(P, 4)
    bid = bid_of(P)
    t.vset = vset = P.VoteSet(CHAIN, 1, 0, PRE, vs, verifier=v)
    t("wrong height", lambda: vset.add_vote(
        signed_vote(P, privs[0], 0, 2, 0, PRE, bid)))
    forged = signed_vote(P, privs[0], 0, 1, 0, PRE, bid)
    forged.signature = bytes(64)
    t("forged signature", lambda: vset.add_vote(forged))
    t("index/address pairing", lambda: vset.add_vote(
        signed_vote(P, privs[1], 0, 1, 0, PRE, bid)))
    t("index out of range", lambda: vset.add_vote(
        signed_vote(P, privs[1], 9, 1, 0, PRE, bid)))
    t("wrong type", lambda: vset.add_vote(
        signed_vote(P, privs[0], 0, 1, 0, 7, bid)))


def _conflicting(P, v, t):
    vs, privs = make_valset(P, 4)
    t.vset = vset = P.VoteSet(CHAIN, 1, 0, PRE, vs, verifier=v)
    v1 = signed_vote(P, privs[0], 0, 1, 0, PRE, bid_of(P, b"a"))
    v2 = signed_vote(P, privs[0], 0, 1, 0, PRE, bid_of(P, b"b"))
    t("first", lambda: vset.add_vote(v1))
    t("duplicate", lambda: vset.add_vote(v1))
    t("conflict", lambda: vset.add_vote(v2))


def _make_commit(P, v, t):
    vs, privs = make_valset(P, 4)
    bid = bid_of(P)
    t.vset = vset = P.VoteSet(CHAIN, 3, 1, PC, vs, verifier=v)
    t("commit before quorum", lambda: vset.make_commit())
    for i in range(3):
        t(f"add {i}", lambda i=i: vset.add_vote(
            signed_vote(P, privs[i], i, 3, 1, PC, bid)))
    commit = vset.make_commit()
    commit.validate_basic()
    t("commit", lambda: (commit.block_id.key(), commit.hash().hex(),
                         [p is not None for p in commit.precommits]))
    t("verify_commit", lambda: vs.verify_commit(CHAIN, bid, 3, commit,
                                                verifier=v))
    prevotes = P.VoteSet(CHAIN, 3, 1, PRE, vs, verifier=v)
    t("commit from prevotes", lambda: prevotes.make_commit())


def _full_block_id(P, v, t):
    """test_types.py's majority-keyed-on-the-full-block-id scenario; the
    66 votes before the variants go in one add_votes_batch (each is a
    clean vote for the block, so one batch gives what 66 calls give)."""
    vs, privs = make_valset(P, 100)
    bid = P.BlockID(hash=b"R".ljust(32, b"\1"), parts=P.PSH(123, b"q" * 32))
    t.vset = vset = P.VoteSet(CHAIN, 1, 0, PRE, vs, verifier=v)
    first = [signed_vote(P, privs[i], i, 1, 0, PRE, bid) for i in range(66)]
    t("66 for the block", lambda: vset.add_votes_batch(first))
    variants = [
        P.BlockID(b"", P.PSH(0, b"")),
        P.BlockID(bid.hash, P.PSH(123, b"z" * 32)),
        P.BlockID(bid.hash, P.PSH(124, bid.parts.hash)),
        P.BlockID(b"X".ljust(32, b"\2"), bid.parts),
    ]
    for j, vbid in enumerate(variants):
        t(f"variant {j}", lambda j=j, vbid=vbid: vset.add_vote(
            signed_vote(P, privs[66 + j], 66 + j, 1, 0, PRE, vbid)))
    t("the 71st", lambda: vset.add_vote(
        signed_vote(P, privs[70], 70, 1, 0, PRE, bid)))


def _peer_maj23(P, v, t):
    vs, privs = make_valset(P, 4)
    nil_bid = P.BlockID(b"", P.PSH(0, b""))
    bid1 = P.BlockID(b"one".ljust(32, b"\1"), P.PSH(0, b""))
    bid2 = P.BlockID(b"two".ljust(32, b"\2"), P.PSH(0, b""))
    t.vset = vset = P.VoteSet(CHAIN, 1, 0, PRE, vs, verifier=v)

    def add(i, b):
        return t(f"val{i} -> {b.short()}", lambda: vset.add_vote(
            signed_vote(P, privs[i], i, 1, 0, PRE, b)))

    add(0, nil_bid)
    add(0, bid1)                      # untracked block: dropped
    t("bits bid1", lambda: vset.bit_array_by_block_id(bid1))
    t("peerA claims bid1", lambda: vset.set_peer_maj23("peerA", bid1))
    add(0, bid1)                      # tracked: counted and reported
    t("peerA switches", lambda: vset.set_peer_maj23("peerA", bid2))
    t("peerA again", lambda: vset.set_peer_maj23("peerA", bid1))
    add(0, bid2)
    add(1, bid1)
    add(2, bid2)
    t("peerB claims bid1", lambda: vset.set_peer_maj23("peerB", bid1))
    add(2, bid1)                      # tips bid1 over quorum
    add(2, bid1)                      # a regossiped copy: silent duplicate
    t("bits", lambda: (vset.bit_array_by_block_id(bid1),
                       vset.bit_array_by_block_id(bid2),
                       str(vset.get_by_index(2)),
                       str(vset.get_by_address(privs[0].pubkey.address))))


SCENARIOS = {"quorum": _quorum, "nil_and_mixed": _nil_and_mixed,
             "rejects_bad": _rejects_bad, "conflicting": _conflicting,
             "make_commit": _make_commit, "full_block_id": _full_block_id,
             "peer_maj23": _peer_maj23}


def _trace(P, scenario, verifier):
    t = Trace()
    SCENARIOS[scenario](P, verifier, t)
    return t.steps


@functools.lru_cache(maxsize=None)
def _jax_trace(scenario):
    return _trace(JAX, scenario, jverifier.BatchVerifier("python"))


@pytest.fixture(scope="module")
def port_verifiers():
    return {"python": tverifier.BatchVerifier("python"),
            "cuda_on_cpu": tverifier.BatchVerifier("cuda", device="cpu")}


@pytest.mark.parametrize("route", ["python", "cuda_on_cpu"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_vote_set_scenario_matches_jax(scenario, route, port_verifiers):
    v = port_verifiers[route]
    calls = v.stats["calls"]
    got = _trace(PORT, scenario, v)
    want = _jax_trace(scenario)
    assert [s[0] for s in got] == [s[0] for s in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert v.stats["calls"] > calls
    if route == "cuda_on_cpu":
        assert v.stats["cuda_sigs"] > 0


def test_vote_set_scenarios_reach_their_verdicts():
    """The JAX package's traces hold what tests/test_types.py asserts, so
    the scenarios above are the ones it pins."""
    q = {s[0]: s for s in _jax_trace("quorum")}
    assert q["add 1"][2][0] is None and q["add 2"][2][0] is not None
    c = {s[0]: s[1] for s in _jax_trace("conflicting")}
    assert c["duplicate"] == ("ok", False)
    assert c["conflict"][:2] == ("raise", "ConflictingVoteError")
    f = {s[0]: s for s in _jax_trace("full_block_id")}
    assert f["variant 3"][2][0] is None and f["the 71st"][2][0] is not None
    one = "val2 -> " + JAX.BlockID(b"one".ljust(32, b"\1")).short()
    adds = [s for s in _jax_trace("peer_maj23") if s[0] == one]
    assert adds[0][1][:2] == ("raise", "ConflictingVoteError")
    assert adds[0][1][3] is True and adds[0][2][0] is not None
    assert adds[1][1] == ("ok", False)


def _batch_with_extras(P, verifier, n=16):
    """n prevotes for one block, then a flipped-signature copy of one, a
    duplicate of another and a conflicting vote of a third, in one
    add_votes_batch."""
    vs, privs = make_valset(P, n)
    bid = bid_of(P, b"height", 5, b"\x33" * 32)
    other = bid_of(P, b"other", 5, b"\x44" * 32)
    votes = [signed_vote(P, privs[i], i, 2, 0, PRE, bid, ts=5000 + i)
             for i in range(n)]
    flipped = P.Vote(**{k: getattr(votes[3], k) for k in (
        "validator_address", "validator_index", "height", "round",
        "timestamp_ns", "type", "block_id")})
    sig = votes[3].signature
    flipped.signature = sig[:9] + bytes([sig[9] ^ 1]) + sig[10:]
    extras = [flipped, votes[5],
              signed_vote(P, privs[7], 7, 2, 0, PRE, other, ts=9000)]
    vset = P.VoteSet(CHAIN, 2, 0, PRE, vs, verifier=verifier)
    results, errors = vset.add_votes_batch(votes + extras)
    maj = vset.two_thirds_majority()
    return (results, [(pos, type(e).__name__, str(e),
                       getattr(e, "added", None)) for pos, e in errors],
            None if maj is None else maj.key(), vset.power,
            vset.bit_array_by_block_id(other))


def test_add_votes_batch_with_extras_matches_jax(port_verifiers):
    v = port_verifiers["cuda_on_cpu"]
    sigs = v.stats["cuda_sigs"]
    got = _batch_with_extras(PORT, v)
    want = _batch_with_extras(JAX, jverifier.BatchVerifier("python"))
    assert got == want
    # the 16 votes and the three extras went to the batch path at once
    assert v.stats["cuda_sigs"] - sigs == 19
    results, errors = got[:2]
    assert results == [True] * 16 + [False] * 3
    assert [(p, c) for p, c, _, _ in errors] == [
        (16, "ValueError"), (18, "ConflictingVoteError")]
    assert errors[0][2].startswith("invalid signature on Vote{3:")
    assert got[2] == bid_of(PORT, b"height", 5, b"\x33" * 32).key()
