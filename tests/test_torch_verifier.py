"""The slice end to end on the CPU: ValidatorSet.verify_commit ->
BatchVerifier -> the predecompression cache -> the plain verify kernels,
held against the JAX package's BatchVerifier("jax") on the same commit;
and the plain kernels themselves (verify_plain, verify_pre_plain, 64
windows) against the JAX package's jnp kernels on 64 edge lanes and 64
small-order probe lanes, the shape at which this file's JAX verifier
compiles them anyway. A batch of mixed Ed25519 and secp256k1 keys gets
the JAX package's verdicts on every backend.

Both packages verify a 64-validator commit signed with OpenSSL three
times (first sighting of the keys, then repeat traffic, then cached
rows: full -> fill -> hit), then a commit with one flipped signature
byte. Verdict arrays, raised messages and cache-outcome deltas must be
equal. The light client's certify_chain is held the same way: its
dispatches walk the cache's routes as the JAX package's do. Tolerance 0
(booleans and counters).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.asymmetric.ed25519 import \
    Ed25519PrivateKey

from tendermint_tpu import lite as jlite
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import ladder_pallas
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch import convert
from tendermint_tpu_torch import lite as tlite
from tendermint_tpu_torch.models.verifier import BatchVerifier as TVerifier
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.utils import vectors

# small tensors: one intra-op thread is faster here and leaves the
# cores to the other test workers
torch.set_num_threads(1)

CHAIN = "torch-port-test"
N_VALS = 64
HEIGHT = 7
EDGE = vectors.edge_batch(N_VALS, seed=11)   # every lane kind 8 times


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _digits(key):
    return ladder.digits_from_bytes(_t(EDGE[key]))


def test_verify_plain_matches_jax_jnp_verify():
    got = ladder.verify_plain(_t(EDGE["pk"]), _t(EDGE["rb"]),
                              _digits("s"), _digits("h"))
    want = np.asarray(jed._verify_from_bytes_jnp(
        *(jnp.asarray(EDGE[k]) for k in ("pk", "rb", "s", "h"))))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), EDGE["expect"])


def test_verify_pre_plain_matches_jax_pre():
    xnb, yb, ok = ted._decompress_to_bytes(_t(EDGE["pk"]))
    jxnb, jyb, jok = jed._decompress_to_bytes(jnp.asarray(EDGE["pk"]))
    np.testing.assert_array_equal(xnb.numpy(), np.asarray(jxnb))
    np.testing.assert_array_equal(yb.numpy(), np.asarray(jyb))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    got = ladder.verify_pre_plain(xnb, yb, ok, _t(EDGE["rb"]),
                                  _digits("s"), _digits("h"))
    want = np.asarray(jed._verify_pre_jnp(
        jxnb, jyb, jok, *(jnp.asarray(EDGE[k]) for k in ("rb", "s", "h"))))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), EDGE["expect"])


PROBE = vectors.probe_batch(N_VALS, seed=12)   # small-order lanes


@pytest.mark.parametrize("pre", [False, True], ids=["verify", "verify_pre"])
def test_plain_kernels_match_jax_on_probe_lanes(pre):
    """Torsion and mixed-order keys, torsion and non-canonical R, x = 0
    with the sign bit and y = p - 1: the plain kernels, the JAX jnp
    kernels and the oracle agree on every lane."""
    t = {k: _t(PROBE[k]) for k in ("pk", "rb", "s", "h")}
    digs = [ladder.digits_from_bytes(t[k]) for k in ("s", "h")]
    rest = [jnp.asarray(PROBE[k]) for k in ("rb", "s", "h")]
    if pre:
        dec = ted._decompress_to_bytes(t["pk"])
        got = ladder.verify_pre_plain(*dec, t["rb"], *digs)
        want = jed._verify_pre_jnp(
            *jed._decompress_to_bytes(jnp.asarray(PROBE["pk"])), *rest)
    else:
        got = ladder.verify_plain(t["pk"], t["rb"], *digs)
        want = jed._verify_from_bytes_jnp(jnp.asarray(PROBE["pk"]), *rest)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), PROBE["expect"])


def _keys(seed, n):
    rng = np.random.RandomState(seed)
    sks = [Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
           for _ in range(n)]
    pks = [k.public_key().public_bytes_raw() for k in sks]
    return sks, pks


def _commit(pkg, sks, pks, tamper=None):
    """(valset, block_id, commit) in `pkg` (the JAX package's types or
    the port's); every validator precommits with its own timestamp."""
    vsm, blk, vt = pkg
    vs = vsm.ValidatorSet([vsm.Validator(pk, 10 + i % 3)
                           for i, pk in enumerate(pks)])
    by_pk = dict(zip(pks, sks))
    bid = blk.BlockID(b"\x11" * 32, blk.PartSetHeader(1, b"\x22" * 32))
    votes = []
    for idx, val in enumerate(vs.validators):
        v = vt.Vote(val.address, idx, HEIGHT, 0, 1_000_000 + idx,
                    vt.VoteType.PRECOMMIT, bid)
        v.signature = by_pk[val.pubkey].sign(v.sign_bytes(CHAIN))
        if idx == tamper:
            v.signature = bytes([v.signature[0] ^ 1]) + v.signature[1:]
        votes.append(v)
    return vs, bid, blk.Commit(bid, votes)


JAX_TYPES = (jvs, jblock, jvote)
PORT_TYPES = (tvs, tblock, tvote)
JAX_LITE = (*JAX_TYPES, jlite)
PORT_LITE = (*PORT_TYPES, tlite)


def _delta(after, before):
    return {k: after[k] - before[k] for k in ("hit", "fill", "full")}


@pytest.fixture(scope="module")
def verifiers():
    """Both without coalescing: a coalescer whose dispatcher runs late
    (a loaded host) merges consecutive calls into one dispatch, which
    changes the cache routes (test_a_late_coalescer_merges_windows)."""
    return (JVerifier("jax", mesh="off", coalesce="off"),
            TVerifier("cuda", device="cpu", coalesce="off"))


def _run_both(verifiers, sks, pks, tamper=None):
    """verify_commit on both packages; returns per package (outcome,
    cache delta) where outcome is None or the ValueError message."""
    out = []
    for pkg, v, stats in ((JAX_TYPES, verifiers[0], jed.predecomp_stats),
                          (PORT_TYPES, verifiers[1], ted.predecomp_stats)):
        vs, bid, commit = _commit(pkg, sks, pks, tamper)
        before = stats()
        try:
            vs.verify_commit(CHAIN, bid, HEIGHT, commit, verifier=v)
            outcome = None
        except ValueError as e:
            outcome = str(e)
        out.append((outcome, _delta(stats(), before)))
    return out


def test_verify_commit_matches_jax_through_cache_routes(verifiers):
    sks, pks = _keys(101, N_VALS)
    for route in ("full", "fill", "hit"):
        jax_res, port_res = _run_both(verifiers, sks, pks)
        assert jax_res == port_res
        want = {"hit": 0, "fill": 0, "full": 0}
        want[route] = 1
        assert port_res == (None, want)
    jax_res, port_res = _run_both(verifiers, sks, pks, tamper=5)
    assert jax_res == port_res
    assert port_res == ("invalid signature in commit",
                        {"hit": 1, "fill": 0, "full": 0})


def test_verdicts_match_jax_on_tampered_items(verifiers):
    sks, pks = _keys(102, N_VALS)
    vs, bid, commit = _commit(PORT_TYPES, sks, pks)
    items, _ = vs.commit_verification_items(CHAIN, bid, HEIGHT, commit)
    items = [list(it) for it in items]
    items[1][2] = bytes([items[1][2][0] ^ 1]) + items[1][2][1:]   # R
    items[2][2] = items[2][2][:40] + bytes([items[2][2][40] ^ 1]) + \
        items[2][2][41:]                                          # s
    items[3][1] = items[3][1] + b"!"                              # message
    items[4][2] = items[4][2][:32] + b"\xff" * 32                 # s >= L
    items[5][2] = items[5][2][:63]                                # length
    items[6][0] = items[6][0][:31]                                # key len
    items[7][0] = (1 | (1 << 255)).to_bytes(32, "little")         # x=0, sign
    items[8][0] = ((1 << 255) - 18).to_bytes(32, "little")        # y = p+1
    items = [tuple(it) for it in items]
    jv = verifiers[0].verify(items)
    tv = verifiers[1].verify(items)
    np.testing.assert_array_equal(jv, tv)
    assert tv.tolist() == [i not in range(1, 9) for i in range(N_VALS)]


def test_verify_commit_any_matches_jax(verifiers):
    sks, pks = _keys(103, N_VALS)
    res = []
    for pkg, v in ((JAX_TYPES, verifiers[0]), (PORT_TYPES, verifiers[1])):
        vs, bid, commit = _commit(pkg, sks, pks)
        new_set = pkg[0].ValidatorSet(
            [pkg[0].Validator(val.pubkey, val.voting_power + 1)
             for val in vs.validators])
        vs.verify_commit_any(new_set, CHAIN, bid, HEIGHT, commit, verifier=v)
        # keep 40 of 64 votes: the old set no longer sees +2/3 (40 items
        # pad to the same 64 bucket, so the JAX side compiles nothing new)
        commit.precommits = [p if i % 8 < 5 else None
                             for i, p in enumerate(commit.precommits)]
        with pytest.raises(ValueError) as e:
            vs.verify_commit_any(new_set, CHAIN, bid, HEIGHT, commit,
                                 verifier=v)
        res.append(str(e.value))
    assert res[0] == res[1]


def test_small_auto_batch_stays_on_host():
    sks, pks = _keys(104, 5)
    items = [(pk, b"m%d" % i, sk.sign(b"m%d" % i))
             for i, (sk, pk) in enumerate(zip(sks, pks))]
    items[2] = (items[2][0], b"other", items[2][2])
    v = TVerifier("auto", device="cpu")
    got = v.verify(items)
    assert v.stats["cuda_sigs"] == 0
    np.testing.assert_array_equal(
        got, JVerifier("python", coalesce="off").verify(items))


def test_stats_time_the_dispatch_and_the_wait_not_the_callers_work():
    """A resolver handed back and called later: the caller's work in
    between is in neither dispatch_s nor wait_s. On the direct path
    (coalesce "off") the dispatch is timed before verify_async returns;
    a coalesced call (the default) is dispatched on the coalescer's
    thread, timed there."""
    sks, pks = _keys(107, 4)
    items = [(pk, b"m%d" % i, sk.sign(b"m%d" % i))
             for i, (sk, pk) in enumerate(zip(sks, pks))]
    v = TVerifier("python", coalesce="off")
    resolve = v.verify_async(items)
    dispatched = v.stats["dispatch_s"]
    assert dispatched > 0 and v.stats["wait_s"] == 0
    time.sleep(0.5)
    assert resolve().all() and resolve().all()
    assert v.stats["dispatch_s"] == dispatched
    assert 0 < v.stats["dispatch_s"] + v.stats["wait_s"] < 0.5
    v = TVerifier("python")
    try:
        resolve = v.verify_async(items)
        time.sleep(0.5)
        assert resolve().all() and resolve().all()
        assert v.stats["dispatch_s"] > 0 and v.stats["wait_s"] > 0
        assert v.stats["dispatch_s"] + v.stats["wait_s"] < 0.5
        assert (v.stats["coalesced_calls"], v.stats["calls"]) == (1, 1)
    finally:
        v.close()


def test_secp256k1_mixed_batch_matches_jax_on_every_backend(verifiers):
    """A batch holding secp256k1 keys gets verdicts equal to the JAX
    package's on every backend, its "jax" backend's mixed-key split
    included (compiled at this file's 64 lanes)."""
    from tendermint_tpu.types.keys import Secp256k1PrivKey

    sks, pks = _keys(108, 60)
    items = [(pk, b"m%d" % i, sk.sign(b"m%d" % i))
             for i, (sk, pk) in enumerate(zip(sks, pks))]
    for i in range(4):
        k = Secp256k1PrivKey.generate(bytes([0x60 + i]) * 32)
        items.insert(7 * i + 3, (k.pubkey.secp256k1, b"s%d" % i,
                                 k.sign(b"s%d" % i)))
    items[3] = (items[3][0], b"other", items[3][2])        # secp, bad
    items[5] = (items[5][0], b"other", items[5][2])        # ed25519, bad
    items.append((b"\x02" + b"\x11" * 32, b"m", b"s" * 70))  # off curve
    want = JVerifier("python", coalesce="off").verify(items)
    assert want.tolist() == [i not in (3, 5, 64) for i in range(65)]
    np.testing.assert_array_equal(verifiers[0].verify(items), want)
    for backend in ("cuda", "python", "auto"):
        got = TVerifier(backend, device="cpu").verify(items)
        np.testing.assert_array_equal(got, want)


def test_state_from_jax_round_trip():
    sks, pks = _keys(105, N_VALS)
    pk_np = np.stack([np.frombuffer(p, np.uint8) for p in pks])
    xnb, yb, ok = (np.asarray(a) for a in
                   jed._decompress_to_bytes(jnp.asarray(pk_np)))
    rows = {pks[i]: (xnb[i].copy(), yb[i].copy(), bool(ok[i]))
            for i in range(N_VALS)}
    own = ladder.tables()
    try:
        convert.state_from_jax(ladder_pallas._s_table_np(),
                               ladder_pallas._consts_np(), rows,
                               device="cpu")
        s_table, consts = ladder.tables()
        np.testing.assert_array_equal(s_table, ladder_pallas._s_table_np())
        np.testing.assert_array_equal(consts, ladder_pallas._consts_np())
        for k, (x, y, flag) in rows.items():
            got = ted._predecomp[k]
            np.testing.assert_array_equal(got[0], x)
            np.testing.assert_array_equal(got[1], y)
            assert got[2] == flag
        # the carried rows serve a batch of these keys: a cache hit
        msgs = [b"msg %d" % i for i in range(N_VALS)]
        sigs = [sk.sign(m) for sk, m in zip(sks, msgs)]
        before = ted.predecomp_stats()
        assert ted.verify_batch(pks, msgs, sigs, device="cpu").all()
        assert _delta(ted.predecomp_stats(), before)["hit"] == 1
        with pytest.raises(ValueError):
            convert.state_from_jax(s_table[:8], consts, device="cpu")
    finally:
        ladder.install_tables(*own)


def test_warmup_and_verify_one():
    sks, pks = _keys(106, 1)
    sig = sks[0].sign(b"one")
    v = TVerifier("cuda", device="cpu")
    before = ted.predecomp_stats()
    v.warmup(8)          # one zero batch of 8: below the cache's minimum
    assert _delta(ted.predecomp_stats(), before) == \
        {"hit": 0, "fill": 0, "full": 0}
    assert v.verify_one(pks[0], b"one", sig)
    assert not v.verify_one(pks[0], b"two", sig)
    assert v.stats["cuda_sigs"] == 2 and v.mesh_devices == 0


def _chain(pkg, sks, pks, n_headers):
    """FullCommits of heights 1..n_headers in `pkg`'s types, every
    validator signing each header's block id."""
    vsm, blk, vt, lite = pkg
    vs = vsm.ValidatorSet([vsm.Validator(pk, 10) for pk in pks])
    by_pk = dict(zip(pks, sks))
    fcs = []
    for h in range(1, n_headers + 1):
        header = blk.Header(chain_id=CHAIN, height=h, time_ns=h,
                            validators_hash=vs.hash(),
                            app_hash=h.to_bytes(32, "big"))
        bid = blk.BlockID(header.hash(), blk.PartSetHeader(1, b"\x22" * 32))
        votes = []
        for idx, val in enumerate(vs.validators):
            v = vt.Vote(val.address, idx, h, 0, h, vt.VoteType.PRECOMMIT, bid)
            v.signature = by_pk[val.pubkey].sign(v.sign_bytes(CHAIN))
            votes.append(v)
        fcs.append(lite.FullCommit(
            lite.SignedHeader(header, blk.Commit(bid, votes), bid), vs))
    return fcs


def test_certify_chain_routes_match_jax(verifiers):
    """8 validators x 24 headers, window 8: three 64-signature dispatches
    over keys not seen before, so full, then fill, then hit."""
    sks, pks = _keys(107, 8)
    outs = []
    for pkg, v, stats in ((JAX_LITE, verifiers[0], jed.predecomp_stats),
                          (PORT_LITE, verifiers[1], ted.predecomp_stats)):
        fcs = _chain(pkg, sks, pks, 24)
        before = stats()
        pkg[3].certify_chain(CHAIN, fcs, verifier=v, window=8)
        outs.append(_delta(stats(), before))
    assert outs[0] == outs[1] == {"hit": 1, "fill": 1, "full": 1}


def test_a_late_coalescer_merges_windows_and_changes_the_routes():
    """Why the verifiers above do not coalesce. certify_chain submits
    window k+1 while window k resolves; a dispatcher that drains its
    queue late (here a 500 ms linger stands in for a starved thread)
    merges windows 2 and 3 into one 128-signature dispatch: full, fill
    and no hit, where a verifier without coalescing walks full, fill,
    hit. So the route test holds two verifiers that do not coalesce:
    on a loaded host a coalescing one walks either way."""
    sks, pks = _keys(109, 8)
    outs = []
    for v in (TVerifier("cuda", device="cpu", coalesce="auto",
                        coalesce_wait_ms=500.0),
              TVerifier("cuda", device="cpu", coalesce="off")):
        fcs = _chain(PORT_LITE, sks, pks, 24)
        before = ted.predecomp_stats()
        tlite.certify_chain(CHAIN, fcs, verifier=v, window=8)
        outs.append((_delta(ted.predecomp_stats(), before),
                     v.coalescer_stats()["dispatches"]))
        v.close()
        sks, pks = _keys(110, 8)   # unseen keys for the second verifier
    assert outs == [({"hit": 0, "fill": 1, "full": 1}, 2),
                    ({"hit": 1, "fill": 1, "full": 1}, 0)]
