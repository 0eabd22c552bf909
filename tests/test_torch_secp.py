"""secp256k1 in the port (types/keys.py, utils/secp256k1_ref.py) and the
mixed-key routing of its BatchVerifier, against the JAX package on the
same seeded inputs (tolerance 0: bytes, verdicts, messages):

- keys, addresses, to_obj and signatures equal to the JAX package's. The
  JAX package signs with a random nonce when OpenSSL is present, so its
  RFC 6979 route (`utils/secp256k1_ref.sign`) is the one held here; the
  port signs RFC 6979 on both of its routes;
- verdicts on DER edge cases: the port's OpenSSL route and its route
  without OpenSSL (`cryptography` hidden) both equal the JAX package's
  OpenSSL route. The JAX package's pure route accepts the non-minimal and
  the negative DER integer; that divergence is pinned here too;
- mixed batches at 64 and 300 items through every backend of the port
  and the JAX package's host backends ("auto" at 300 splits the batch);
- a mixed-key ValidatorSet.verify_commit, good and tampered.
"""

import sys

import numpy as np
import pytest
import torch

from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.utils import secp256k1_ref as jsecp
from tendermint_tpu_torch.models.verifier import BatchVerifier as TVerifier
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.utils import secp256k1_ref as tsecp

torch.set_num_threads(1)

N = tsecp.N
SEEDS = [np.random.RandomState(s).bytes(32) for s in range(4)] + \
    [b"\x00" * 32, b"\xff" * 32]


@pytest.fixture
def no_openssl(monkeypatch):
    """Hide `cryptography`'s EC bindings from the port's key types."""
    monkeypatch.setitem(sys.modules,
                        "cryptography.hazmat.primitives.asymmetric", None)
    assert tkeys._ec() is None


def test_secp256k1_ref_is_a_copy():
    for name in ("P", "N", "G"):
        assert getattr(tsecp, name) == getattr(jsecp, name)
    for seed in SEEDS[:2]:
        d = jkeys.Secp256k1PrivKey.generate(seed).seed
        assert tsecp.pubkey_of(d) == jsecp.pubkey_of(d)
        assert tsecp.sign(d, b"m") == jsecp.sign(d, b"m")


@pytest.mark.parametrize("seed", SEEDS, ids=range(len(SEEDS)))
def test_keys_and_signatures_equal_jax(seed, monkeypatch):
    jk = jkeys.Secp256k1PrivKey.generate(seed)
    tk = tkeys.Secp256k1PrivKey.generate(seed)
    assert tk.seed == jk.seed
    assert tk.pubkey.secp256k1 == jk.pubkey.secp256k1
    assert tk.pubkey.address == jk.pubkey.address
    assert tk.to_obj() == jk.to_obj()
    assert tk.pubkey.to_obj() == jk.pubkey.to_obj()
    assert tkeys.privkey_from_obj(jk.to_obj()) == tk
    assert tkeys.pubkey_from_obj(jk.pubkey.to_obj()) == tk.pubkey
    msgs = [b"", b"secp message", bytes(range(256)) * 4]
    want = [jsecp.sign(jk.seed, m) for m in msgs]
    assert [tk.sign(m) for m in msgs] == want           # OpenSSL route
    # the JAX package's OpenSSL signatures (random nonce) verify here
    for m in msgs:
        assert tk.pubkey.verify(m, jk.sign(m))
    monkeypatch.setitem(sys.modules,
                        "cryptography.hazmat.primitives.asymmetric", None)
    fresh = tkeys.Secp256k1PrivKey.generate(seed)
    assert fresh.pubkey == tk.pubkey                    # pure route
    assert [fresh.sign(m) for m in msgs] == want
    assert all(fresh.pubkey.verify(m, s) for m, s in zip(msgs, want))


def _der_int_raw(b: bytes) -> bytes:
    return b"\x02" + bytes([len(b)]) + b


def _seq(body: bytes) -> bytes:
    return b"\x30" + bytes([len(body)]) + body


def _minimal(v: int) -> bytes:
    return v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")


def _der_cases():
    """{name: (pubkey, msg, sig)}: the DER edge cases around one key."""
    k = jkeys.Secp256k1PrivKey.generate(b"\x42" * 32)
    pub = k.pubkey.secp256k1
    i = 0
    while True:   # a message whose r has its top bit set
        msg = b"der-%d" % i
        sig = jsecp.sign(k.seed, msg)
        r, s = jsecp._der_decode(sig)
        if r >> 255:
            break
        i += 1
    x = 5
    while pow(x ** 3 + 7, (jsecp.P - 1) // 2, jsecp.P) == 1:
        x += 1    # no y: off the curve
    off_curve = b"\x02" + x.to_bytes(32, "big")
    return {
        "canonical": (pub, msg, sig),
        "high_s": (pub, msg, jsecp._der_encode(r, N - s)),
        "nonminimal_int": (pub, msg, _seq(
            _der_int_raw(b"\x00" + jsecp._der_int(r)[2:])
            + jsecp._der_int(s))),
        "negative_int": (pub, msg, _seq(
            _der_int_raw(_minimal(r)) + jsecp._der_int(s))),
        "r_zero": (pub, msg, jsecp._der_encode(0, s)),
        "s_n": (pub, msg, jsecp._der_encode(r, N)),
        "truncated": (pub, msg, sig[:-1]),
        "trailing_byte": (pub, msg, sig + b"\x00"),
        "off_curve_key": (off_curve, msg, sig),
        "other_message": (pub, msg + b"!", sig),
    }


DER = _der_cases()
OPENSSL_ACCEPTS = {"canonical", "high_s"}
JAX_PURE_ALSO_ACCEPTS = {"nonminimal_int", "negative_int"}


@pytest.mark.parametrize("case", sorted(DER))
def test_der_verdicts_equal_openssl_on_both_routes(case, monkeypatch):
    pub, msg, sig = DER[case]
    want = jkeys.Secp256k1PubKey(pub).verify(msg, sig)   # OpenSSL
    assert want == (case in OPENSSL_ACCEPTS)
    assert tkeys.Secp256k1PubKey(pub).verify(msg, sig) == want
    assert tkeys.verify_any(pub, msg, sig) == want
    # the reference's pure route: lenient on two cases (a hazard of the
    # reference, recorded, not a fault of the port)
    assert jsecp.verify(pub, msg, sig) == (
        want or case in JAX_PURE_ALSO_ACCEPTS)
    monkeypatch.setitem(sys.modules,
                        "cryptography.hazmat.primitives.asymmetric", None)
    assert tkeys._ec() is None
    assert tkeys.Secp256k1PubKey(pub).verify(msg, sig) == want
    assert tkeys.verify_many([(pub, msg, sig)] * 2) == [want, want]


def _ed_keys(n, seed):
    rng = np.random.RandomState(seed)
    return [jkeys.PrivKey.generate(rng.bytes(32)) for _ in range(n)]


def _secp_keys(n, seed):
    rng = np.random.RandomState(seed)
    return [jkeys.Secp256k1PrivKey.generate(rng.bytes(32)) for _ in range(n)]


def _mixed_items(n, n_ed, seed):
    """n items, n_ed of them Ed25519, at seeded positions; every fifth
    one of each kind tampered (a flipped message byte), one secp
    signature re-encoded with a non-minimal DER integer."""
    rng = np.random.RandomState(seed)
    ed, secp = _ed_keys(8, seed), _secp_keys(8, seed + 1)
    ed_pos = set(rng.choice(n, n_ed, replace=False).tolist())
    items = []
    for i in range(n):
        k = ed[i % 8] if i in ed_pos else secp[i % 8]
        pub = k.pubkey.ed25519 if i in ed_pos else k.pubkey.secp256k1
        msg = b"mixed %d" % i
        sig = k.sign(msg) if i in ed_pos else jsecp.sign(k.seed, msg)
        if i % 5 == 0:
            msg = msg + b"!"
        items.append((pub, msg, sig))
    j = next(i for i in range(1, n) if i not in ed_pos and i % 5)
    r, s = jsecp._der_decode(items[j][2])
    items[j] = (items[j][0], items[j][1], _seq(
        _der_int_raw(b"\x00" + jsecp._der_int(r)[2:]) + jsecp._der_int(s)))
    return items, ed_pos


@pytest.mark.parametrize("n", [64, 300])
def test_mixed_batches_match_jax(n):
    items, ed_pos = _mixed_items(n, 56, seed=n)
    want = JVerifier("python", coalesce="off").verify(items)
    jauto = JVerifier("auto", coalesce="off")
    np.testing.assert_array_equal(jauto.verify(items), want)
    assert want.sum() == n - len(range(0, n, 5)) - 1
    for backend in ("cuda", "auto", "python"):
        v = TVerifier(backend, device="cpu")
        np.testing.assert_array_equal(v.verify(items), want)
        # one call, n signatures: the split is not counted twice
        assert v.stats["calls"] == jauto.stats["calls"] == 1
        assert v.stats["sigs"] == jauto.stats["sigs"] == n
        on_device = backend == "cuda" or (backend == "auto"
                                          and n > v.auto_threshold
                                          and len(ed_pos) > v.auto_threshold)
        assert v.stats["cuda_sigs"] == (len(ed_pos) if on_device else 0)


CHAIN = "torch-secp-test"


def _mixed_commit(pkg, ed, secp, tamper=None):
    vsm, blk, vt = pkg
    keys = ed + secp
    pubs = [k.pubkey.ed25519 for k in ed] + [k.pubkey.secp256k1
                                              for k in secp]
    vs = vsm.ValidatorSet([vsm.Validator(p, 10) for p in pubs])
    by_pub = dict(zip(pubs, keys))
    bid = blk.BlockID(b"\x33" * 32, blk.PartSetHeader(1, b"\x44" * 32))
    votes = []
    for idx, val in enumerate(vs.validators):
        v = vt.Vote(val.address, idx, 9, 0, 2000 + idx, vt.VoteType.PRECOMMIT,
                    bid)
        k = by_pub[val.pubkey]
        sb = v.sign_bytes(CHAIN)
        v.signature = k.sign(sb) if len(val.pubkey) == 32 else \
            jsecp.sign(k.seed, sb)
        if tamper is not None and (len(val.pubkey) == 33) == \
                (tamper == "secp"):
            v.signature = v.signature[:-1] + bytes([v.signature[-1] ^ 1])
            tamper = None
        votes.append(v)
    return vs, bid, blk.Commit(bid, votes)


@pytest.mark.parametrize("tamper", [None, "secp", "ed"])
def test_mixed_key_verify_commit_matches_jax(tamper):
    ed, secp = _ed_keys(6, 30), _secp_keys(3, 31)
    outcomes = []
    runs = [((jvs, jblock, jvote), JVerifier(b, coalesce="off"))
            for b in ("python", "auto")] + \
        [((tvs, tblock, tvote), TVerifier(b, device="cpu"))
         for b in ("cuda", "auto", "python")]
    for pkg, verifier in runs:
        vs, bid, commit = _mixed_commit(pkg, ed, secp, tamper)
        try:
            vs.verify_commit(CHAIN, bid, 9, commit, verifier=verifier)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    want = None if tamper is None else "invalid signature in commit"
    assert outcomes == [want] * len(runs)
