"""The port's light client (tendermint_tpu_torch.lite) against the JAX
package's, scenario by scenario (those of tests/test_lite.py), on the
CPU: both packages build the same headers, sets and commits from the
same seeds, each with its own types, and must give the same outcome, the
same exception class and the same message at every step. Also the
Header hash. The predecompression cache's route deltas of a certify_chain
are held against the JAX package's in tests/test_torch_verifier.py, whose
process has the JAX kernels compiled at that shape already.

The port verifies on BatchVerifier("cuda", device="cpu"), the plain
versions of the verify kernels; the JAX package on its own verifier
("auto", which keeps these small commits on the host). Tolerance 0:
outcomes, messages and hashes.
"""

from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu import lite as jlite
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch import lite as tlite
from tendermint_tpu_torch.models.verifier import BatchVerifier as TVerifier
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types import vote as tvote

# small tensors: one intra-op thread is faster here and leaves the
# cores to the other test workers
torch.set_num_threads(1)

CHAIN = "lite-test"


def _pkg(lite, keys, block, vs, vote, verifier):
    return SimpleNamespace(lite=lite, PrivKey=keys.PrivKey, block=block,
                           Validator=vs.Validator,
                           ValidatorSet=vs.ValidatorSet, Vote=vote.Vote,
                           VoteType=vote.VoteType, verifier=verifier)


@pytest.fixture(scope="module")
def pkgs():
    return (_pkg(jlite, jkeys, jblock, jvs, jvote,
                 JVerifier("auto", mesh="off", coalesce="off")),
            _pkg(tlite, tkeys, tblock, tvs, tvote,
                 TVerifier("cuda", device="cpu")))


class Keys:
    """Ordered keys and the set they form, in one package's types."""

    def __init__(self, pkg, seeds, powers=None):
        self.pkg = pkg
        self.keys = [pkg.PrivKey.generate(s) for s in seeds]
        powers = powers or [10] * len(seeds)
        self.valset = pkg.ValidatorSet(
            [pkg.Validator(k.pubkey.ed25519, p)
             for k, p in zip(self.keys, powers)])

    def derive(self, keys, powers=None):
        out = Keys.__new__(Keys)
        out.pkg = self.pkg
        out.keys = keys
        powers = powers or [10] * len(keys)
        out.valset = self.pkg.ValidatorSet(
            [self.pkg.Validator(k.pubkey.ed25519, p)
             for k, p in zip(keys, powers)])
        return out

    def sign_header(self, height, app_hash=b"\x01" * 32, first=0,
                    last=None):
        """FullCommit of a header signed by keys[first:last]."""
        p = self.pkg
        header = p.block.Header(chain_id=CHAIN, height=height,
                                time_ns=height,
                                validators_hash=self.valset.hash(),
                                app_hash=app_hash)
        bid = p.block.BlockID(header.hash(),
                              p.block.PartSetHeader(1, b"\x22" * 32))
        precommits = [None] * len(self.keys)
        by_addr = {v.address: i for i, v in
                   enumerate(self.valset.validators)}
        for k in self.keys[first:last]:
            idx = by_addr[k.pubkey.address]
            v = p.Vote(k.pubkey.address, idx, height, 0, height,
                       p.VoteType.PRECOMMIT, bid)
            v.signature = k.sign(v.sign_bytes(CHAIN))
            precommits[idx] = v
        return p.lite.FullCommit(
            p.lite.SignedHeader(header, p.block.Commit(bid, precommits),
                                bid), self.valset)


def _seeds(base, n):
    return [bytes([base + i]) * 32 for i in range(n)]


def _try(fn, *args):
    try:
        fn(*args)
        return None
    except Exception as e:
        return (type(e).__name__, str(e))


def _scenario_static(p):
    vk = Keys(p, _seeds(1, 4))
    cert = p.lite.StaticCertifier(CHAIN, vk.valset, verifier=p.verifier)
    tampered = vk.sign_header(8)
    tampered.signed_header.header.app_hash = b"\x99" * 32
    return [_try(cert.certify, vk.sign_header(5)),
            _try(cert.certify, vk.sign_header(6, last=2)),
            _try(cert.certify, Keys(p, _seeds(50, 4)).sign_header(7)),
            _try(cert.certify, tampered)]


def _scenario_dynamic(p):
    vk = Keys(p, _seeds(1, 4))
    cert = p.lite.DynamicCertifier(CHAIN, vk.valset, height=1,
                                   verifier=p.verifier)
    vk2 = vk.derive(vk.keys[:3] + [p.PrivKey.generate(b"\x63" * 32)])
    out = [_try(cert.certify, vk.sign_header(2)),
           _try(cert.update, vk2.sign_header(10)), cert.last_height,
           _try(cert.certify, vk2.sign_header(11)),
           _try(cert.certify, vk.sign_header(12)),
           _try(cert.update, vk2.sign_header(10))]
    # zero overlap with the trusted set
    fresh = p.lite.DynamicCertifier(CHAIN, vk.valset, height=1,
                                    verifier=p.verifier)
    out.append(_try(fresh.update, Keys(p, _seeds(80, 4)).sign_header(10)))
    return out


def _scenario_inquiring(p):
    vk1 = Keys(p, _seeds(1, 4))
    vk2 = vk1.derive(vk1.keys[:3] + [p.PrivKey.generate(b"\x70" * 32)])
    vk3 = vk2.derive(vk2.keys[:2] + [vk2.keys[3],
                                     p.PrivKey.generate(b"\x71" * 32)])
    provider = p.lite.MemProvider()
    provider.store_commit(vk2.sign_header(10))
    provider.store_commit(vk3.sign_header(20))
    cert = p.lite.InquiringCertifier(CHAIN, vk1.sign_header(1), provider,
                                     verifier=p.verifier)
    out = [_try(cert.certify, vk3.sign_header(25)), cert.last_height,
           sorted(provider._by_height)]
    # no bridge in the provider: the bisection gives up with a message
    lone = p.lite.InquiringCertifier(
        CHAIN, vk1.sign_header(1), p.lite.CacheProvider(
            p.lite.MemProvider()), verifier=p.verifier)
    out.append(_try(lone.certify, vk3.sign_header(25)))
    return out


def _scenario_continuous_deltas(p):
    vk1 = Keys(p, _seeds(1, 4))
    vk2 = vk1.derive(vk1.keys + [p.PrivKey.generate(b"\x41" * 32)])
    vk3 = vk2.derive(vk2.keys, [20, 10, 10, 10, 10])
    vk4 = vk3.derive(vk2.keys[1:])
    cert = p.lite.ContinuousCertifier(CHAIN, vk1.valset,
                                      verifier=p.verifier)
    out = [_try(cert.advance, vk.sign_header(h))
           for h, vk in [(1, vk1), (2, vk1), (3, vk2), (4, vk3), (5, vk4),
                         (6, vk4)]]
    out += [cert.certified_height, cert.updates, cert.static_certified,
            cert.validators.hash() == vk4.valset.hash(),
            sorted(cert.app_hashes.items()),
            _try(cert.advance, vk4.sign_header(6)),
            _try(cert.advance, vk4.sign_header(9))]
    return out


def _scenario_continuous_sparse(p):
    vk1 = Keys(p, _seeds(1, 4))
    vk2 = vk1.derive(vk1.keys + [p.PrivKey.generate(b"\x42" * 32)])
    cert = p.lite.ContinuousCertifier(CHAIN, vk1.valset,
                                      verifier=p.verifier)
    return [_try(cert.advance, vk1.sign_header(1)),
            _try(cert.advance, vk2.sign_header(2, last=4)),
            cert.updates, cert.certified_height]


def _scenario_continuous_large_move(p):
    vk1 = Keys(p, _seeds(1, 4))
    swap = vk1.derive(vk1.keys[:1] + [p.PrivKey.generate(bytes([0x50 + i])
                                                         * 32)
                                      for i in range(3)])
    cert = p.lite.ContinuousCertifier(CHAIN, vk1.valset,
                                      verifier=p.verifier)
    out = [_try(cert.advance, vk1.sign_header(1)),
           _try(cert.advance, swap.sign_header(2)),
           cert.certified_height, cert.validators.hash() == vk1.valset.hash()]
    jump = vk1.derive(vk1.keys[:2] + [p.PrivKey.generate(bytes([0x60 + i])
                                                         * 32)
                                      for i in range(2)])
    dyn = p.lite.DynamicCertifier(CHAIN, vk1.valset, height=1,
                                  verifier=p.verifier)
    out.append(_try(dyn.update, jump.sign_header(10)))
    return out


def _scenario_certify_chain(p):
    vk = Keys(p, _seeds(1, 4))

    def run(fcs, **kw):
        return _try(lambda: p.lite.certify_chain(CHAIN, fcs,
                                                 verifier=p.verifier, **kw))

    chain = [vk.sign_header(h) for h in range(1, 9)]
    bad = [vk.sign_header(h) for h in range(1, 9)]
    bad[4].signed_header.commit.precommits[1].signature = b"\x00" * 64
    other = Keys(p, _seeds(40, 4))
    moved = [vk.sign_header(h) for h in range(1, 9)]
    moved[6].signed_header.header.app_hash = b"\x77" * 32
    return [run(chain), run(chain, window=3), run(bad), run(bad, window=2),
            run(chain[:3] + [other.sign_header(4)]),
            run(chain, trusted=other.valset), run(moved), run([])]


def _scenario_providers(p):
    vk = Keys(p, _seeds(1, 3))
    mem, back = p.lite.MemProvider(), p.lite.MemProvider()
    cache = p.lite.CacheProvider(p.lite.MemProvider(), back)
    out = [mem.latest_commit(), cache.latest_commit()]
    for prov in (mem, back):
        prov.store_commit(vk.sign_header(5))
        prov.store_commit(vk.sign_header(9))
    for prov in (mem, cache):
        out += [prov.get_by_height(9).height, prov.get_by_height(7).height,
                prov.get_by_height(4), prov.latest_commit().height]
    # a read through the cache stored what it found in every layer
    out.append(sorted(cache.providers[0]._by_height))
    cache.store_commit(vk.sign_header(12))
    out += [back.latest_commit().height, cache.get_by_height(20).height]
    return out


SCENARIOS = {
    "providers": _scenario_providers,
    "static": _scenario_static,
    "dynamic": _scenario_dynamic,
    "inquiring": _scenario_inquiring,
    "continuous_deltas": _scenario_continuous_deltas,
    "continuous_sparse": _scenario_continuous_sparse,
    "continuous_large_move": _scenario_continuous_large_move,
    "certify_chain": _scenario_certify_chain,
}

# what each scenario must show besides the two packages agreeing (the
# outcomes tests/test_lite.py pins)
CE, VC = "CertificationError", "ValidatorsChangedError"
EXPECT = {
    "static": lambda o: o[0] is None and o[1][0] == CE
    and o[2][0] == VC and o[3] == (CE, "commit is not for this header"),
    "providers": lambda o: o == [None, None, 9, 5, None, 9, 9, 5, None, 9,
                                 [5, 9], 12, 12],
    "dynamic": lambda o: o[:4] == [None, None, 10, None]
    and o[4][0] == VC and o[5][0] == CE and o[6][0] == CE,
    "inquiring": lambda o: o[0] is None and o[1] >= 20
    and o[3][0] == CE,
    "continuous_deltas": lambda o: o[:10] == [None] * 6 + [6, 3, 3, True]
    and [h for h, _ in o[10]] == list(range(1, 7))
    and "expects height" in o[11][1] and "expects height" in o[12][1],
    "continuous_sparse": lambda o: o == [None, None, 1, 2],
    "continuous_large_move": lambda o: o[0] is None
    and "insufficient trusted-set endorsement" in o[1][1]
    and o[2:4] == [1, True] and o[4][0] == CE,
    "certify_chain": lambda o: o[:2] == [None, None]
    and o[2] == (CE, "height 5: invalid signature in commit")
    and o[3] == o[2] and o[4][0] == VC and o[5][0] == VC
    and o[6] == (CE, "commit is not for this header") and o[7] is None,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(pkgs, name):
    jax_out, port_out = (SCENARIOS[name](p) for p in pkgs)
    assert port_out == jax_out
    assert EXPECT[name](port_out), port_out


def _header_fields():
    return dict(chain_id="h-test", height=7, time_ns=123456789, num_txs=3,
                total_txs=40, last_commit_hash=b"\x01" * 32,
                data_hash=b"\x02" * 32, validators_hash=b"\x03" * 32,
                consensus_hash=b"\x04" * 32, app_hash=b"\x05" * 32,
                last_results_hash=b"\x06" * 32, evidence_hash=b"\x07" * 32)


def test_header_hash_matches_jax():
    hs = []
    for blk in (jblock, tblock):
        h = blk.Header(last_block_id=blk.BlockID(
            b"\x08" * 32, blk.PartSetHeader(3, b"\x09" * 32)),
            **_header_fields())
        first = h.hash()
        h.app_hash = b"\x55" * 32            # drops the cached hash
        second = h.hash()
        empty = blk.Header(chain_id="h-test", height=7)
        back = blk.Header.from_obj(h.to_obj())
        hs.append((first, second, empty.hash(), back.hash(), h.to_obj()))
    assert hs[0] == hs[1]
    first, second, empty, back, _ = hs[1]
    assert first != second and len(first) == 32
    assert empty == b"" and back == second
