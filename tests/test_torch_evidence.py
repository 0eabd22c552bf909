"""The port's evidence pool and store (tendermint_tpu_torch.evidence)
against the JAX package's, on the CPU.

Every case of tests/test_evidence.py runs in both packages on the same
keys and votes, keeping the reference test's assertions: the pending and
priority lists, the store's rows key for key, and every refusal's class
and message must be equal. The port's pool verifies on
BatchVerifier("python"), the JAX pool on its default verifier.
"""

from types import SimpleNamespace

import pytest

from tendermint_tpu.evidence import pool as jpool
from tendermint_tpu.evidence import store as jstore
from tendermint_tpu.state import state as jstate
from tendermint_tpu.state import validation as jval
from tendermint_tpu.storage import db as jdb
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import priv_validator as jpv
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.evidence import pool as tpool
from tendermint_tpu_torch.evidence import store as tstore
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.state import state as tstate
from tendermint_tpu_torch.state import validation as tval
from tendermint_tpu_torch.storage import db as tdb
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import evidence as tev
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import priv_validator as tpv
from tendermint_tpu_torch.types import vote as tvote

CHAIN = "ev-test"

JAX = SimpleNamespace(name="jax", pool=jpool, store=jstore, st=jstate,
                      val=jval, db=jdb, blk=jblock, ev=jev, gen=jgen,
                      keys=jkeys, pv=jpv, vote=jvote, verifier=None)
PORT = SimpleNamespace(name="port", pool=tpool, store=tstore, st=tstate,
                       val=tval, db=tdb, blk=tblock, ev=tev, gen=tgen,
                       keys=tkeys, pv=tpv, vote=tvote,
                       verifier=tverifier.BatchVerifier("python"))


def make_state_and_keys(P, n=3):
    keys = [P.keys.PrivKey.generate(bytes([i + 1]) * 32) for i in range(n)]
    gen = P.gen.GenesisDoc(
        chain_id=CHAIN, genesis_time_ns=1,
        validators=[P.gen.GenesisValidator(k.pubkey.ed25519, 10 + i)
                    for i, k in enumerate(keys)])
    state = P.st.make_genesis_state(gen)
    state.last_block_height = 1
    return state, keys


def make_duplicate_vote_evidence(P, key, height=1, good=True):
    pv = P.pv.PrivValidator(P.pv.LocalSigner(key))
    bid_a = P.blk.BlockID(b"\xaa" * 32, P.blk.PartSetHeader(1, b"\xab" * 32))
    bid_b = P.blk.BlockID(b"\xbb" * 32, P.blk.PartSetHeader(1, b"\xbc" * 32))
    votes = []
    for bid in (bid_a, bid_b):
        v = P.vote.Vote(pv.address, 0, height, 0, 1000,
                        P.vote.VoteType.PREVOTE, bid)
        pv.last_height, pv.last_round, pv.last_step = 0, -1, 0
        pv.sign_vote(CHAIN, v)
        votes.append(v)
    ev = P.ev.DuplicateVoteEvidence(key.pubkey.ed25519, votes[0], votes[1])
    if not good:
        ev.vote_b.signature = b"\x00" * 64
    return ev


def make_pool(P, state):
    db = P.db.MemDB()
    return P.pool.EvidencePool(P.store.EvidenceStore(db), state,
                               verifier=P.verifier), db


def _objs(evs):
    return [e.to_obj() for e in evs]


def _refusal(P, fn):
    with pytest.raises(P.val.BlockValidationError) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def case_store_add_pending_mark_committed(P):
    db = P.db.MemDB()
    store = P.store.EvidenceStore(db)
    _, keys = make_state_and_keys(P)
    ev = make_duplicate_vote_evidence(P, keys[0])
    assert store.add_new_evidence(ev, priority=10)
    assert not store.add_new_evidence(ev, priority=10)
    assert store.pending_evidence() == [ev]
    assert store.priority_evidence() == [ev]
    assert not store.is_committed(ev)
    rows = [list(db.iterate())]
    store.mark_evidence_as_committed(ev)
    assert store.pending_evidence() == [] and store.priority_evidence() == []
    assert store.is_committed(ev)
    rows.append(list(db.iterate()))
    info = store.get_info(ev.height(), ev.hash())
    return rows, info.to_bytes(), info.priority, info.committed


def case_store_priority_order(P):
    db = P.db.MemDB()
    store = P.store.EvidenceStore(db)
    _, keys = make_state_and_keys(P, 3)
    evs = [make_duplicate_vote_evidence(P, k) for k in keys]
    for ev, prio in zip(evs, (5, 50, 20)):
        store.add_new_evidence(ev, prio)
    assert store.priority_evidence() == [evs[1], evs[2], evs[0]]
    # committing evidence nobody stored still marks it
    stray = make_duplicate_vote_evidence(P, keys[0], height=2)
    store.mark_evidence_as_committed(stray)
    assert store.is_committed(stray)
    return list(db.iterate())


def case_pool_verifies_and_prioritizes(P):
    state, keys = make_state_and_keys(P)
    pool, db = make_pool(P, state)
    ev = make_duplicate_vote_evidence(P, keys[2])
    pool.add_evidence(ev)
    pool.add_evidence(ev)  # already pending: no second queue entry
    assert pool.pending_evidence() == [ev]
    assert pool.drain(timeout=0.1) == ev
    assert pool.drain(timeout=0.01) is None
    return list(db.iterate())


def case_pool_rejects_bad_signature(P):
    state, keys = make_state_and_keys(P)
    pool, _ = make_pool(P, state)
    err = _refusal(P, lambda: pool.add_evidence(
        make_duplicate_vote_evidence(P, keys[0], good=False)))
    assert pool.pending_evidence() == []
    return err


def case_pool_rejects_non_validator_and_stale(P):
    state, keys = make_state_and_keys(P)
    stranger = P.keys.PrivKey.generate(b"\x77" * 32)
    pool, _ = make_pool(P, state)
    errs = [_refusal(P, lambda: pool.add_evidence(
        make_duplicate_vote_evidence(P, stranger)))]
    state.last_block_height = state.consensus_params.evidence.max_age + 5
    errs.append(_refusal(P, lambda: pool.add_evidence(
        make_duplicate_vote_evidence(P, keys[0], height=1))))
    state.last_block_height = 1
    errs.append(_refusal(P, lambda: pool.add_evidence(
        make_duplicate_vote_evidence(P, keys[0], height=3))))
    return errs


def case_pool_update_marks_committed_and_blocks_readd(P):
    state, keys = make_state_and_keys(P)
    pool, db = make_pool(P, state)
    ev = make_duplicate_vote_evidence(P, keys[0])
    pool.add_evidence(ev)

    class FakeBlock:
        class evidence:
            evidence = [ev]

    new_state = state.copy()
    pool.update(FakeBlock(), new_state)
    assert pool.state is new_state
    assert pool.pending_evidence() == []
    pool.add_evidence(ev)
    assert pool.pending_evidence() == []
    return list(db.iterate())


EVIDENCE_CASES = [
    case_store_add_pending_mark_committed,
    case_store_priority_order,
    case_pool_verifies_and_prioritizes,
    case_pool_rejects_bad_signature,
    case_pool_rejects_non_validator_and_stale,
    case_pool_update_marks_committed_and_blocks_readd,
]


@pytest.mark.parametrize("case", EVIDENCE_CASES, ids=lambda f: f.__name__[5:])
def test_evidence_case_matches_jax(case):
    out = {P.name: case(P) for P in (JAX, PORT)}
    assert out["port"] == out["jax"]


def test_info_bytes_round_trip_across_packages():
    """An EvidenceInfo written by one package reads back in the other."""
    _, jkeys_ = make_state_and_keys(JAX)
    ev = make_duplicate_vote_evidence(JAX, jkeys_[1])
    raw = jstore.EvidenceInfo(ev, 11, False).to_bytes()
    info = tstore.EvidenceInfo.from_bytes(raw)
    assert info.to_bytes() == raw
    assert info.evidence.hash() == ev.hash()
