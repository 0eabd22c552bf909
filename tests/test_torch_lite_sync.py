"""The port's batched light-client sync (`InquiringCertifier.certify_range`)
against three walks of the same chain, one header at a time: the port's
sequential `InquiringCertifier.certify`, the JAX package's, and the plain
reference (tests/lite_reference.py). Tolerance 0: the last trusted
height, the trusted set's hash, the heights the client's store holds,
and the first failure's exception class and message.

The chains are seeded: 8 validators whose powers change at every height
(one or two validators by 1-3%), one or none absent from each commit, 40
headers served as RPC replies (the `commit` and `validators` JSON of each
height) by an in-process stand-in for a node. Windows of 4 headers, so
that the set changes and the faults straddle windows. The port verifies
on its host route (`BatchVerifier("python")`), the JAX package on its own
verifier's ("auto", which keeps these small commits on the host).
"""

import hashlib
import json
import random

import pytest
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey)

from tendermint_tpu import lite as jlite
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu_torch import lite as tlite
from tendermint_tpu_torch.lite import certifier as tcertifier
from tendermint_tpu_torch.models.verifier import BatchVerifier as TVerifier
from tests import lite_reference as ref

CHAIN = "lite-sync-test"
N_VALS = 8
TOP = 40
WINDOW = 4
_h = ref.tmhash


def _key(tag: str) -> Ed25519PrivateKey:
    return Ed25519PrivateKey.from_private_bytes(
        hashlib.sha256(tag.encode()).digest())


def _pub(k) -> bytes:
    return k.public_key().public_bytes(serialization.Encoding.Raw,
                                       serialization.PublicFormat.Raw)


def _bid_obj(bid) -> dict:
    return {"hash": bid[0].hex(), "parts": {"total": bid[1],
                                            "hash": bid[2].hex()}}


NIL = (b"", 0, b"")


class Chain:
    """Each height's (header, commit, validators) as the replies carry
    them, the keys that sign, and `forged`: the (height, commit index)
    of every signature changed after signing."""

    def __init__(self, seed: int, churn: bool = True, steady=()):
        r = random.Random(seed)
        self.keys = {}
        powers = {}
        for i in range(N_VALS):
            k = _key(f"{seed}/{i}")
            self.keys[_pub(k)] = k
            powers[_pub(k)] = r.randrange(9_000, 11_000)
        self.rows = {}
        self.forged = set()
        last_bid = NIL
        for h in range(1, TOP + 2):
            if churn and h > 1 and h not in steady:
                for pk in r.sample(sorted(powers), r.randint(1, 2)):
                    step = max(1, powers[pk] * r.randint(1, 3) // 100)
                    powers[pk] += step if r.random() < 0.5 else -step
            absent = set(r.sample(range(N_VALS), r.randint(0, 1)))
            self.rows[h] = self._signed(h, dict(powers), last_bid, absent, r)
            last_bid = self.rows[h]["bid"]

    def _signed(self, h, powers, last_bid, absent, r) -> dict:
        vals = sorted(powers.items(), key=lambda v: _h.address(v[0]))
        hobj = {"chain_id": CHAIN, "height": h, "time_ns": h * 10 ** 9,
                "num_txs": 0, "total_txs": 0,
                "last_block_id": _bid_obj(last_bid),
                "last_commit_hash": r.randbytes(32).hex(),
                "data_hash": _h.merkle_root([]).hex(),
                "validators_hash": _h.valset_hash(vals).hex(),
                "consensus_hash": r.randbytes(32).hex(),
                "app_hash": r.randbytes(32).hex(),
                "last_results_hash": "",
                "evidence_hash": _h.merkle_root([]).hex()}
        bid = (_h.header_hash(hobj), 1, r.randbytes(32))
        votes = [None if j in absent else
                 self._vote(h, j, pk, bid, h * 10 ** 9 + 1 + r.randrange(999))
                 for j, (pk, _) in enumerate(vals)]
        return {"header": hobj, "bid": bid, "votes": votes, "vals": vals}

    def _vote(self, h, j, pk, bid, ts) -> dict:
        msg = _h.cdumps({"@chain_id": CHAIN, "@type": "vote",
                         "block_id": _bid_obj(bid), "height": h, "round": 0,
                         "timestamp_ns": ts, "type": 2})
        return {"validator_address": _h.address(pk).hex(),
                "validator_index": j, "height": h, "round": 0,
                "timestamp_ns": ts, "type": 2, "block_id": _bid_obj(bid),
                "signature": self.keys[pk].sign(msg).hex()}

    def replies(self) -> dict:
        out = {}
        for h, row in self.rows.items():
            commit = {"header": row["header"],
                      "commit": {"block_id": _bid_obj(row["bid"]),
                                 "precommits": row["votes"]},
                      "canonical": True}
            vals = {"block_height": h, "validators": {"validators": [
                {"pubkey": pk.hex(), "voting_power": p, "accum": 0}
                for pk, p in row["vals"]]}}
            out[h] = (json.dumps(commit).encode(), json.dumps(vals).encode())
        return out

    # -- faults ------------------------------------------------------------

    def forge_signature(self, h: int, r: random.Random) -> None:
        """One signature of a vote for the block changed in one byte."""
        row = self.rows[h]
        j = r.choice([j for j, v in enumerate(row["votes"]) if v])
        sig = bytearray.fromhex(row["votes"][j]["signature"])
        sig[r.randrange(64)] ^= 1 + r.randrange(255)
        row["votes"][j] = dict(row["votes"][j], signature=sig.hex())
        self.forged.add((h, j))

    def nil_vote_forged(self, h: int, r: random.Random) -> None:
        """One validator precommits nil, under a changed signature: the
        update does not count it, the static rule verifies it."""
        row = self.rows[h]
        j = r.choice([j for j, v in enumerate(row["votes"]) if v])
        pk = row["vals"][j][0]
        vote = self._vote(h, j, pk, NIL, h * 10 ** 9 + 7)
        sig = bytearray.fromhex(vote["signature"])
        sig[0] ^= 0x40
        vote["signature"] = sig.hex()
        row["votes"][j] = vote
        self.forged.add((h, j))

    def unhinge_header(self, h: int) -> None:
        """The header changed after its block id was signed."""
        self.rows[h]["header"]["app_hash"] = "77" * 32

    def unknown_keys_at_two_thirds(self, h: int) -> None:
        """At h, two keys the trusted set does not know take the place of
        two of its validators. The set at h - 1 is signed again with the
        two leaving validators' powers set so that the six who stay hold
        exactly 2/3 of its power. Every signature is valid, and the whole
        new set signs h."""
        prev = self.rows[h - 1]
        powers = dict(prev["vals"])
        stay, leave = [pk for pk, _ in prev["vals"][:6]], \
            [pk for pk, _ in prev["vals"][6:]]
        kept = sum(powers[pk] for pk in stay)
        if kept % 2:
            powers[stay[0]] += 1
            kept += 1
        powers[leave[0]] = kept // 4
        powers[leave[1]] = kept // 2 - kept // 4
        r = random.Random(h)
        self.rows[h - 1] = self._signed(h - 1, powers,
                                        self.rows[h - 2]["bid"], set(), r)
        new = {pk: powers[pk] for pk in stay}
        for i in range(2):
            k = _key(f"unknown/{h}/{i}")
            self.keys[_pub(k)] = k
            new[_pub(k)] = 9_000
        self.rows[h] = self._signed(h, new, self.rows[h - 1]["bid"], set(),
                                    r)


class StandInRPC:
    """A node's `commit` and `validators` replies, parsed from their JSON
    bytes; a height it lacks raises, which a provider reads as no
    commit."""

    def __init__(self, replies: dict):
        self.replies = replies

    def call(self, method: str, height: int) -> dict:
        pair = self.replies[height]
        return json.loads(pair[0] if method == "commit" else pair[1])


class Recording:
    """A verifier that keeps every batch it is handed."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def verify_async(self, items):
        self.calls.append(list(items))
        return self.inner.verify_async(items)

    def verify(self, items):
        return self.verify_async(items)()


PORT_VERIFIER = TVerifier("python", coalesce="off")


@pytest.fixture(scope="module")
def jax_verifier():
    return JVerifier("auto", mesh="off", coalesce="off")


@pytest.fixture(autouse=True)
def _small_windows(monkeypatch):
    monkeypatch.setattr(tcertifier, "default_window", lambda n: WINDOW)


def _client(lite, rpc, verifier):
    source = lite.HTTPProvider(rpc)
    mem = lite.MemProvider()
    ic = lite.InquiringCertifier(CHAIN, source.get_by_height(1),
                                 lite.CacheProvider(mem, source),
                                 verifier=verifier)
    return ic, mem, source


def _outcome(ic, mem, err) -> dict:
    return {"height": ic.last_height, "hash": ic.cert.validators.hash(),
            "stored": sorted(mem._by_height), "error": err}


def _err(e):
    return (type(e).__name__, str(e))


def batched(rpc, verifier=PORT_VERIFIER) -> dict:
    ic, mem, _ = _client(tlite, rpc, verifier)
    err = None
    try:
        ic.certify_range(2, TOP)
    except Exception as e:
        err = _err(e)
    return _outcome(ic, mem, err)


def sequential(lite, rpc, verifier) -> dict:
    """`certify` on the provider's header at each height in turn."""
    ic, mem, source = _client(lite, rpc, verifier)
    err = None
    try:
        for h in range(2, TOP + 1):
            fc = source.get_by_height(h)
            if fc is None or fc.height != h:
                raise lite.CertificationError(
                    f"provider has no commit at height {h}")
            ic.certify(fc)
    except Exception as e:
        err = _err(e)
    return _outcome(ic, mem, err)


def reference(chain: Chain, replies: dict) -> dict:
    out = ref.sync(CHAIN, replies.get, 1, 2, TOP, chain.forged)
    return {"height": out["height"], "hash": out["valset_hash"],
            "stored": out["stored"], "error": out["error"]}


def _forged_at(h):
    return lambda c, r: c.forge_signature(h, r)


def _two_thirds(c, r):
    c.unknown_keys_at_two_thirds(17)


def _structural_after_bad_signature(c, r):
    c.forge_signature(8, r)
    c.unhinge_header(12)


def _bad_signature_after_structural(c, r):
    c.unhinge_header(12)
    c.forge_signature(19, r)


def _nil_vote_bad_signature(c, r):
    c.nil_vote_forged(15, r)


def _missing_header(c, r):
    del c.rows[23]


def _bridge(lo, hi):
    return lo, ("CertificationError", f"cannot bridge trust from {lo} to {hi}")


# case: (chain mutation, heights without a set change, (the last trusted
# height, the failure) or None for a chain certified to its top). Windows
# of 4 from height 2: 2-5, 6-9, 10-13, 14-17, ...
CASES = {
    "clean": (lambda c, r: None, (), None),
    "forged_signature": (_forged_at(7), (), _bridge(6, 7)),
    "forged_window_first_header": (_forged_at(10), (), _bridge(9, 10)),
    "forged_window_last_header": (_forged_at(13), (), _bridge(12, 13)),
    "trusted_power_two_thirds": (_two_thirds, (), _bridge(16, 17)),
    "structural_fault_a_window_after_a_bad_signature":
        (_structural_after_bad_signature, (12,), _bridge(7, 8)),
    "bad_signature_a_window_after_a_structural_fault":
        (_bad_signature_after_structural, (12,),
         (11, ("CertificationError", "commit is not for this header"))),
    # the update does not count a nil vote, so trust moves to 15's set
    # before the static rule refuses it
    "bad_signature_on_a_nil_vote":
        (_nil_vote_bad_signature, (),
         (15, ("CertificationError", "invalid signature in commit"))),
    "provider_lacks_a_header":
        (_missing_header, (),
         (22, ("CertificationError", "provider has no commit at height 23"))),
    # 2..16 under the trusted set, then a refused change: the bisection
    # trusts 9, 13, 15 and 16 through the provider before it gives up
    "bisection_across_a_gap": (_forged_at(17), tuple(range(2, 17)),
                               _bridge(16, 17)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_sync_equals_each_sequential_walk(case, jax_verifier):
    mutate, steady, outcome = CASES[case]
    chain = Chain(seed=sorted(CASES).index(case) + 11, steady=steady)
    mutate(chain, random.Random(case))
    replies = chain.replies()
    rpc = StandInRPC(replies)
    before = tlite.sync_stats()
    got = batched(rpc)
    after = tlite.sync_stats()
    want = reference(chain, replies)
    assert got == want
    assert sequential(tlite, rpc, PORT_VERIFIER) == want
    assert sequential(jlite, rpc, jax_verifier) == want
    if outcome is None:
        assert want["error"] is None and want["height"] == TOP
        assert want["stored"] == list(range(1, TOP + 1))
    else:
        assert (want["height"], want["error"]) == outcome
    if case == "clean":
        # every header is a set change, each signature sent once
        d = {k: after[k] - before[k] for k in after}
        assert d["headers"] == d["transitions"] == TOP - 1
        assert d["windows"] == -(-(TOP - 1) // WINDOW)
        assert d["sigs_dispatched"] * 2 == d["sigs_sequential"]


def test_without_set_changes_it_sends_certify_chains_dispatches():
    chain = Chain(seed=5, churn=False)
    rpc = StandInRPC(chain.replies())
    rec = Recording(PORT_VERIFIER)
    got = batched(rpc, verifier=rec)
    assert got["error"] is None and got["height"] == 1
    assert got["stored"] == list(range(1, TOP + 1))
    source = tlite.HTTPProvider(rpc)
    fcs = [source.get_by_height(h) for h in range(2, TOP + 1)]
    chained = Recording(PORT_VERIFIER)
    tlite.certify_chain(CHAIN, fcs, trusted=source.get_by_height(1)
                        .validators, verifier=chained, window=WINDOW)
    assert rec.calls == chained.calls
    assert len(rec.calls) == -(-(TOP - 1) // WINDOW)


def test_a_read_ahead_stores_nothing_uncertified():
    chain = Chain(seed=3)
    chain.forge_signature(6, random.Random(1))
    rpc = StandInRPC(chain.replies())
    ic, mem, _ = _client(tlite, rpc, PORT_VERIFIER)
    with pytest.raises(tlite.CertificationError,
                       match="cannot bridge trust from 5 to 6"):
        ic.certify_range(2, TOP)
    # windows 6..9 and 10..13 were read; only 1..5 were certified
    assert sorted(mem._by_height) == [1, 2, 3, 4, 5]
    assert ic.last_height == 5


def test_sync_stats_is_a_snapshot():
    s = tcertifier.sync_stats()
    s["headers"] += 10 ** 9
    assert tcertifier.sync_stats()["headers"] < 10 ** 9


def test_verify_commit_any_is_its_items_and_its_check():
    """The items take their sign bytes from one template, equal to each
    vote's own; the check refuses an invalid counted signature."""
    chain = Chain(seed=9)
    source = tlite.HTTPProvider(StandInRPC(chain.replies()))
    old, new = source.get_by_height(4), source.get_by_height(5)
    sh = new.signed_header
    items, powers = old.validators.commit_any_items(
        new.validators, CHAIN, sh.block_id, sh.height, sh.commit)
    votes = [pc for pc in sh.commit.precommits if pc is not None]
    assert [m for _, m, _ in items] == [pc.sign_bytes(CHAIN) for pc in votes]
    assert all(o > 0 and n > 0 for o, n in powers)
    old.validators.check_commit_any_results(
        new.validators, PORT_VERIFIER.verify(items), powers)
    ok = [True] * len(items)
    ok[0] = False
    with pytest.raises(ValueError, match="invalid signature in commit"):
        old.validators.check_commit_any_results(new.validators, ok, powers)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_mem_store_reads_as_the_jax_packages(seed):
    """MemProvider's bisected read: the commit at the largest stored
    height at or below h, for heights stored out of order and again."""
    chain = Chain(seed=seed)
    source = tlite.HTTPProvider(StandInRPC(chain.replies()))
    fcs = {h: source.get_by_height(h) for h in range(1, 11)}
    r = random.Random(seed)
    order = r.sample(range(2, 11), 6) + [r.randrange(2, 11)]
    port, jax = tlite.MemProvider(), jlite.MemProvider()
    assert port.latest_commit() is None and jax.latest_commit() is None
    for i, h in enumerate(order):
        port.store_commit(fcs[h])
        jax.store_commit(fcs[h])
        for q in range(0, 12):
            got, want = port.get_by_height(q), jax.get_by_height(q)
            assert (got and got.height) == (want and want.height), (i, q)
        assert port.latest_commit().height == jax.latest_commit().height
