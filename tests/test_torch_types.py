"""The port's host types against the JAX package's, byte for byte: keys and
addresses, signatures, vote sign bytes, valset and commit hashes, the
host Merkle root, and the scalar verify on OpenSSL's leniency-gap
encodings. Tolerance 0 (bytes and booleans)."""

import numpy as np
import pytest

from tendermint_tpu.ops import merkle as jmerkle
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.ops import merkle as tmerkle
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.utils import ed25519_fast, ed25519_ref

_rng = np.random.RandomState(31)
SEEDS = [_rng.bytes(32) for _ in range(6)]


def test_keys_and_signatures_match_jax():
    for seed in SEEDS:
        jk, tk = jkeys.PrivKey(seed), tkeys.PrivKey(seed)
        assert tk.pubkey.ed25519 == jk.pubkey.ed25519
        assert ed25519_fast.public_key(seed) == ed25519_ref.public_key(seed)
        assert tk.pubkey.address == jk.pubkey.address
        msg = seed[::-1]
        assert tk.sign(msg) == jk.sign(msg)
        a, prefix = ed25519_ref.secret_expand(seed)
        assert ed25519_fast.sign_expanded(a, prefix, tk.pubkey.ed25519,
                                          msg) == jk.sign(msg)


def test_scalar_verify_matches_jax_on_leniency_gap():
    seed = SEEDS[0]
    pk = tkeys.PrivKey(seed).pubkey.ed25519
    sig = tkeys.PrivKey(seed).sign(b"m")
    p = ed25519_ref.P
    cases = [(pk, b"m", sig), (pk, b"n", sig), (pk[:31], b"m", sig),
             ((p + 1).to_bytes(32, "little"), b"m", sig),
             ((1 | (1 << 255)).to_bytes(32, "little"), b"m", sig),
             (pk, b"m", b"\xff" * 64)]
    # a secp256k1 key gets the JAX package's verdict, not an exception
    secp = jkeys.Secp256k1PrivKey.generate(seed)
    cases += [(b"\x03" + b"\x01" * 32, b"m", sig),
              (secp.pubkey.secp256k1, b"m", secp.sign(b"m")),
              (secp.pubkey.secp256k1, b"n", secp.sign(b"m"))]
    for c in cases:
        assert tkeys.verify_any(*c) == jkeys.verify_any(*c)
    assert tkeys.verify_many(cases) == jkeys.verify_many(cases)
    assert tkeys.verify_many(cases)[-2:] == [True, False]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_merkle_root_matches_jax(n):
    items = [_rng.bytes(int(_rng.randint(0, 40))) for _ in range(n)]
    assert tmerkle.root_host(items) == jmerkle.root_host(items)
    digests = [tmerkle.leaf_hash(it) for it in items]
    assert tmerkle.root_from_digests_host(b"".join(digests)) == \
        jmerkle.root_from_digests_host(digests)


def _valset_and_commit(vsm, blk, vt):
    privs = [(jkeys if vsm is jvs else tkeys).PrivKey(s) for s in SEEDS]
    vs = vsm.ValidatorSet([vsm.Validator(p.pubkey.ed25519, 5 + i)
                           for i, p in enumerate(privs)])
    by_pk = {p.pubkey.ed25519: p for p in privs}
    bid = blk.BlockID(b"\x01" * 32, blk.PartSetHeader(3, b"\x02" * 32))
    votes = []
    for idx, val in enumerate(vs.validators):
        v = vt.Vote(val.address, idx, 9, 1, 777 + idx,
                    vt.VoteType.PRECOMMIT, bid)
        v.signature = by_pk[val.pubkey].sign(v.sign_bytes("chain-é"))
        votes.append(v if idx != 2 else None)
    return vs, bid, blk.Commit(bid, votes)


def test_valset_commit_and_sign_bytes_match_jax():
    jv, jbid, jc = _valset_and_commit(jvs, jblock, jvote)
    tv, tbid, tc = _valset_and_commit(tvs, tblock, tvote)
    assert tv.hash() == jv.hash()
    assert tv.proposer().address == jv.proposer().address
    assert tc.hash() == jc.hash()
    assert tenc.cdumps(tc.to_obj()) == jenc.cdumps(jc.to_obj())
    for a, b in zip(jc.precommits, tc.precommits):
        if a is None:
            assert b is None
            continue
        assert b.sign_bytes("chain-é") == a.sign_bytes("chain-é")
        assert b.sign_bytes("x") == tenc.cdumps(b.sign_obj("x"))
    j_items, j_power = jv.commit_verification_items("chain-é", jbid, 9, jc)
    t_items, t_power = tv.commit_verification_items("chain-é", tbid, 9, tc)
    assert t_items == j_items and t_power == j_power
    tc.validate_basic()
    with pytest.raises(ValueError) as te:
        tv.commit_verification_items("chain-é", tbid, 10, tc)
    with pytest.raises(ValueError) as je:
        jv.commit_verification_items("chain-é", jbid, 10, jc)
    assert str(te.value) == str(je.value)


def _set_ops(vsm, keys):
    """Copies, lookups and ABCI updates of one package's set; returns what
    they give, with each refusal's message."""
    pubs = [keys.PrivKey(s).pubkey.ed25519 for s in SEEDS]
    vs = vsm.ValidatorSet([vsm.Validator(p, 3 + i)
                           for i, p in enumerate(pubs[:4])])
    vs.increment_accum(2)
    cp = vs.copy()
    cp.validators[0].accum += 100          # the copy owns its validators
    out = [cp.hash() == vs.hash(), vs.validators[0].accum,
           [v.address for v in cp.validators] == [v.address
                                                  for v in vs.validators],
           vs.get_by_index(1).address, vs.get_by_index(4),
           vs.get_by_index(-1), vs.has_address(vs.validators[3].address),
           vs.has_address(b"\x00" * 20)]
    # add one, change one's power, remove one: accums carry over
    new = vs.update_with_changes([vsm.Validator(pubs[4], 9),
                                  vsm.Validator(pubs[0], 30),
                                  vsm.Validator(pubs[1], 0)])
    out += [new.hash(), [(v.address, v.voting_power, v.accum)
                         for v in new.validators], len(vs)]
    for changes in ([vsm.Validator(pubs[5], 0)],
                    [vsm.Validator(pubs[0], -1)],
                    [vsm.Validator(p, 0) for p in pubs[:4]]):
        try:
            vs.update_with_changes(changes)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_valset_copy_lookup_and_updates_match_jax():
    got = _set_ops(tvs, tkeys)
    assert got == _set_ops(jvs, jkeys)
    assert got[0] and got[2] and got[4] is None and got[5] is None
    assert got[6] and not got[7]
    assert got[-3:] == ["removing unknown validator", "negative voting power",
                        "validator set would be empty"]
