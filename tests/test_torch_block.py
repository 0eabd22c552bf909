"""The port's block plane against the JAX package's, byte for byte.

The same numpy-seeded block (txs, a last commit with an absent
precommit, duplicate-vote evidence) built in both packages must give the
same canonical bytes, header / data / evidence / commit hashes, block id
and part sets (roots and every proof) at 256 and 1024-byte parts; the
port's part set refuses a tampered part and a proof under another total
with the JAX package's messages; a header changed after hashing misses
every cache. Then evidence verdicts and messages, the priv-validator
double-sign guard and its file, params and genesis round trips, proposals
and heartbeats, validator-set and light-client objects, and the
convert.py crossings. Tolerance 0 (bytes, booleans, strings).
"""

import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tendermint_tpu.lite import types as jlite
from tendermint_tpu.models import verifier as jverifier
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import params as jparams
from tendermint_tpu.types import part_set as jps
from tendermint_tpu.types import priv_validator as jpv
from tendermint_tpu.types import proposal as jprop
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.lite import types as tlite
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.types import evidence as tev
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import params as tparams
from tendermint_tpu_torch.types import part_set as tps
from tendermint_tpu_torch.types import priv_validator as tpv
from tendermint_tpu_torch.types import proposal as tprop
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types import vote as tvote

torch.set_num_threads(1)

CHAIN = "block-chain"
PRE, PC = jvote.VoteType.PREVOTE, jvote.VoteType.PRECOMMIT


def _ns(blk, vs, vt, keys, ev, ps, enc):
    return SimpleNamespace(blk=blk, vs=vs, vt=vt, keys=keys, ev=ev, ps=ps,
                           enc=enc)


JAX = _ns(jblock, jvs, jvote, jkeys, jev, jps, jenc)
PORT = _ns(tblock, tvs, tvote, tkeys, tev, tps, tenc)


def _seeds(n, seed=77):
    rng = np.random.RandomState(seed)
    return [rng.bytes(32) for _ in range(n)]


def _valset(P, n):
    privs = [P.keys.PrivKey.generate(s) for s in _seeds(n)]
    vs = P.vs.ValidatorSet([P.vs.Validator(p.pubkey.ed25519, 10 + i)
                            for i, p in enumerate(privs)])
    by_addr = {p.pubkey.address: p for p in privs}
    return vs, [by_addr[v.address] for v in vs.validators]


def _vote(P, priv, idx, h, type_, bid, ts):
    v = P.vt.Vote(priv.pubkey.address, idx, h, 0, ts, type_, bid)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


def build_block(P, n_vals=8, n_txs=50, height=5):
    """A filled block at `height`: n_txs txs, the last height's commit
    (validator 1 absent) and one duplicate-vote evidence."""
    vs, privs = _valset(P, n_vals)
    last_bid = P.blk.BlockID(b"\x11" * 32, P.blk.PartSetHeader(3, b"\x22" * 32))
    precommits = [None if i == 1 else
                  _vote(P, p, i, height - 1, PC, last_bid, 10_000 + i)
                  for i, p in enumerate(privs)]
    commit = P.blk.Commit(last_bid, precommits)
    ev = P.ev.DuplicateVoteEvidence(
        privs[2].pubkey.ed25519,
        _vote(P, privs[2], 2, height - 1, PRE, last_bid, 7),
        _vote(P, privs[2], 2, height - 1, PRE,
              P.blk.BlockID(b"\x33" * 32, P.blk.PartSetHeader(3, b"\x44" * 32)),
              8))
    header = P.blk.Header(
        chain_id=CHAIN, height=height, time_ns=1_700_000_000_123,
        num_txs=n_txs, total_txs=1000 + n_txs, last_block_id=last_bid,
        validators_hash=vs.hash(), consensus_hash=b"c" * 32,
        app_hash=b"a" * 32, last_results_hash=b"r" * 32)
    block = P.blk.Block(header,
                        P.blk.Data([b"k%d.%d=v" % (height, i)
                                    for i in range(n_txs)]),
                        P.blk.EvidenceData([ev]), commit)
    block.fill_header()
    return block, vs, privs


def _hashes(block):
    return {"block": block.hash(), "header": block.header.hash(),
            "data": block.data.hash(), "evidence": block.evidence.hash(),
            "last_commit": block.last_commit.hash(),
            "evidence_item": block.evidence.evidence[0].hash(),
            "commit_bytes": block.last_commit.to_bytes()}


@pytest.mark.parametrize("n_vals,n_txs", [(4, 10), (8, 50), (64, 200)])
def test_block_bytes_and_hashes_match_jax(n_vals, n_txs):
    tb, _, _ = build_block(PORT, n_vals, n_txs)
    jb, _, _ = build_block(JAX, n_vals, n_txs)
    assert tb.to_bytes() == jb.to_bytes()
    assert _hashes(tb) == _hashes(jb)
    tb.validate_basic()
    for part_size in (256, 1024):
        assert tb.block_id(part_size).to_obj() == jb.block_id(part_size).to_obj()
    back = tblock.Block.from_bytes(jb.to_bytes())
    assert back.hash() == jb.hash() and back.to_bytes() == jb.to_bytes()
    assert tblock.Block.from_obj(tenc.cloads(jb.to_bytes())).to_bytes() == \
        jb.to_bytes()


@pytest.mark.parametrize("part_size", [256, 1024])
def test_part_set_matches_jax(part_size):
    tb, _, _ = build_block(PORT)
    jb, _, _ = build_block(JAX)
    tps_, jps_ = tb.make_part_set(part_size), jb.make_part_set(part_size)
    assert tps_.total == jps_.total > 1
    assert tps_.header().to_obj() == jps_.header().to_obj()
    for i in range(tps_.total):
        assert tps_.get_part(i).to_obj() == jps_.get_part(i).to_obj()
    assert tps_.bit_array() == jps_.bit_array()
    data = tb.to_bytes()
    streamed, parts = tps.PartSet.from_data_streaming(data, part_size)
    assert streamed.header() == tps_.header() and not streamed.is_complete()
    assert [p.to_obj() for p in parts] == \
        [tps_.get_part(i).to_obj() for i in range(tps_.total)]
    assert streamed.is_complete() and streamed.get_data() == data
    for empty in (b"", b"x"):
        assert tps.PartSet.from_data(empty, part_size).header().to_obj() == \
            jps.PartSet.from_data(empty, part_size).header().to_obj()


def _add_part_outcome(ps, part):
    try:
        return ("ok", ps.add_part(part))
    except ValueError as e:
        return ("raise", str(e))


def test_gossip_receiver_matches_jax_and_refuses_bad_parts():
    """A receiver adds every part through its proof and rebuilds the
    block; a part with one flipped payload byte, a part under another
    total and an out-of-range index are refused as the JAX package
    refuses them."""
    outcomes = {}
    for name, P in (("port", PORT), ("jax", JAX)):
        block, _, _ = build_block(P)
        ps = block.make_part_set(256)
        got = []
        rx = P.ps.PartSet.from_header(ps.header())
        assert rx.has_header(ps.header()) and not rx.is_complete()
        bad = copy.deepcopy(ps.get_part(2))
        bad.payload = bad.payload[:5] + bytes([bad.payload[5] ^ 1]) + \
            bad.payload[6:]
        got.append(_add_part_outcome(rx, bad))
        for i in range(ps.total):
            got.append(_add_part_outcome(rx, ps.get_part(i)))
        got.append(_add_part_outcome(rx, ps.get_part(0)))      # duplicate
        got.append(_add_part_outcome(rx, P.ps.Part(ps.total, b"", [])))
        wrong_total = P.ps.PartSet.from_header(
            P.blk.PartSetHeader(ps.total + 1, ps.root))
        got.append(_add_part_outcome(wrong_total, ps.get_part(0)))
        assert rx.is_complete() and rx.bit_array() == [True] * ps.total
        back = P.blk.Block.from_bytes(rx.get_data())
        got.append((back.hash().hex(), back.block_id(256).to_obj()))
        assert back.block_id(256) == block.block_id(256)
        outcomes[name] = got
    assert outcomes["port"] == outcomes["jax"]
    got = outcomes["port"]
    assert got[0] == ("raise", "invalid part proof")
    assert got[-4:-1] == [("ok", False), ("raise", "part index out of range"),
                          ("raise", "invalid part proof")]


def test_header_change_misses_every_cache():
    block, _, _ = build_block(PORT)
    h0, b0 = block.hash(), block.to_bytes()
    ps0 = block.make_part_set(256)
    assert block.make_part_set(256) is ps0
    block.header.app_hash = b"z" * 32
    assert block.hash() != h0
    assert block.to_bytes() != b0
    ps1 = block.make_part_set(256)
    assert ps1 is not ps0 and ps1.root != ps0.root
    jblk, _, _ = build_block(JAX)
    jblk.header.app_hash = b"z" * 32
    assert block.to_bytes() == jblk.to_bytes()
    # a precommit changed in place misses the commit's caches
    c = block.last_commit
    before = c.hash()
    c.precommits[0].signature = bytes(64)
    assert c.hash() != before
    assert c.to_obj()["precommits"][0]["signature"] == "00" * 64
    # num_txs off by one is caught
    block.header.num_txs += 1
    with pytest.raises(ValueError, match="num_txs mismatch"):
        block.validate_basic()


def test_decoded_commit_shares_one_block_id_an_id():
    """A commit decoded from its object holds one BlockID object for the
    block and one for nil, shared by the precommits that name each; it
    encodes and hashes as the JAX package's, and a vote's id replaced
    moves that vote alone."""
    jb, _, privs = build_block(JAX)
    jc = jb.last_commit
    jc.precommits[3] = _vote(JAX, privs[3], 3, 4, PC, jblock.BlockID(),
                             10_003)
    c = tblock.Commit.from_obj(jc.to_obj())
    votes = [v for v in c.precommits if v is not None]
    assert len({id(v.block_id) for v in votes}) == 2
    assert all(v.block_id is c.block_id for v in votes if v is not votes[2])
    assert votes[2].block_id.is_zero()
    assert c.hash() == jc.hash() and c.to_bytes() == jc.to_bytes()
    c.precommits[0].block_id = tblock.BlockID(
        b"\x55" * 32, tblock.PartSetHeader(3, b"\x22" * 32))
    assert c.precommits[2].block_id == c.block_id != c.precommits[0].block_id
    assert c.block_id.to_obj() == jc.block_id.to_obj()


def _evidence_cases(P):
    vs, privs = _valset(P, 4)
    p = privs[0]
    a = P.blk.BlockID(b"a" * 32, P.blk.PartSetHeader(1, b"p" * 32))
    b = P.blk.BlockID(b"b" * 32, P.blk.PartSetHeader(1, b"p" * 32))
    va = _vote(P, p, 0, 1, PRE, a, 1)
    vb = _vote(P, p, 0, 1, PRE, b, 2)
    forged = _vote(P, p, 0, 1, PRE, b, 3)
    forged.signature = forged.signature[:7] + \
        bytes([forged.signature[7] ^ 1]) + forged.signature[8:]
    other_round = _vote(P, p, 0, 1, PRE, b, 2)
    other_round.round = 1
    other_val = _vote(P, privs[1], 1, 1, PRE, b, 2)
    pk = p.pubkey.ed25519
    D = P.ev.DuplicateVoteEvidence
    return {"valid": (D(pk, va, vb), pk), "same block": (D(pk, va, va), pk),
            "forged": (D(pk, va, forged), pk),
            "pubkey mismatch": (D(pk, va, vb), privs[1].pubkey.ed25519),
            "different HRS": (D(pk, va, other_round), pk),
            "address mismatch": (D(pk, va, other_val), pk)}


def _evidence_outcome(ev, pk, verifier):
    try:
        ev.verify(CHAIN, pk, verifier=verifier)
        return "accepted"
    except ValueError as e:
        return str(e)


@pytest.fixture(scope="module")
def cuda_on_cpu():
    return tverifier.BatchVerifier("cuda", device="cpu")


def test_evidence_verdicts_and_messages_match_jax(cuda_on_cpu):
    t_cases, j_cases = _evidence_cases(PORT), _evidence_cases(JAX)
    jv, tv = jverifier.BatchVerifier("python"), tverifier.BatchVerifier(
        "python")
    got = {k: _evidence_outcome(*t_cases[k], tv) for k in t_cases}
    want = {k: _evidence_outcome(*j_cases[k], jv) for k in j_cases}
    assert got == want
    assert got["valid"] == "accepted"
    assert got["forged"] == "invalid signature in evidence"
    # both signatures in one batch call on the batch path
    sigs = cuda_on_cpu.stats["cuda_sigs"]
    for k in ("valid", "forged"):
        assert _evidence_outcome(*t_cases[k], cuda_on_cpu) == got[k]
    assert cuda_on_cpu.stats["cuda_sigs"] - sigs == 4
    for k, (ev, _) in t_cases.items():
        o = j_cases[k][0].to_obj()
        assert ev.to_obj() == o and ev.hash() == j_cases[k][0].hash()
        assert tev.evidence_from_obj(o) == ev
    with pytest.raises(ValueError, match="unknown evidence type x"):
        tev.evidence_from_obj({"type": "x"})


def _guard_run(pv_mod, vt, blk, path):
    """tests/test_types.py's double-sign scenario; returns each step's
    outcome and the file's bytes after it."""
    pv = pv_mod.PrivValidatorFile.generate(path, b"\x11" * 32)
    a = blk.BlockID(b"a".ljust(32, b"\0"), blk.PartSetHeader(1, b"p" * 32))
    b = blk.BlockID(b"b".ljust(32, b"\0"), blk.PartSetHeader(1, b"p" * 32))
    out = []

    def step(vote):
        try:
            pv.sign_vote(CHAIN, vote)
            res = ("signed", vote.signature.hex(), vote.timestamp_ns)
        except pv_mod.DoubleSignError as e:
            res = ("refused", str(e))
        with open(path, "rb") as f:
            out.append((res, f.read()))

    V = vt.Vote
    step(V(pv.address, 0, 5, 0, 111, PRE, a))
    step(V(pv.address, 0, 5, 0, 999, PRE, a))   # only the time differs
    step(V(pv.address, 0, 5, 0, 111, PRE, b))   # another block: refused
    step(V(pv.address, 0, 5, 0, 111, PC, b))    # next step
    step(V(pv.address, 0, 6, 0, 111, PRE, b))
    step(V(pv.address, 0, 4, 0, 1, PRE, a))     # height regression
    step(V(pv.address, 0, 6, 0, 1, PRE, b))     # same HRS, new time
    pv2 = pv_mod.PrivValidatorFile.load(path)
    out.append((pv2.last_height, pv2.last_round, pv2.last_step))
    return out


def test_priv_validator_guard_and_file_match_jax(tmp_path):
    got = _guard_run(tpv, tvote, tblock, str(tmp_path / "t.json"))
    want = _guard_run(jpv, jvote, jblock, str(tmp_path / "j.json"))
    assert got == want
    assert [r[0][0] for r in got[:-1]] == [
        "signed", "signed", "refused", "signed", "signed", "refused",
        "signed"]
    assert got[1][0][1] == got[0][0][1] and got[1][0][2] == 111
    assert got[-1] == (6, 0, 2)
    # each package loads the other's file and refuses the same vote
    for mod, vt, blk, path in ((tpv, tvote, tblock, tmp_path / "j.json"),
                               (jpv, jvote, jblock, tmp_path / "t.json")):
        pv = mod.PrivValidatorFile.load(str(path))
        a = blk.BlockID(b"a".ljust(32, b"\0"), blk.PartSetHeader(1, b"p" * 32))
        with pytest.raises(mod.DoubleSignError, match="height regression"):
            pv.sign_vote(CHAIN, vt.Vote(pv.address, 0, 5, 0, 1, PRE, a))


def test_proposal_and_heartbeat_match_jax():
    priv_t = tpv.PrivValidator(tpv.LocalSigner(tkeys.PrivKey(b"\x05" * 32)))
    priv_j = jpv.PrivValidator(jpv.LocalSigner(jkeys.PrivKey(b"\x05" * 32)))
    objs = []
    for prop, blk, priv in ((tprop, tblock, priv_t), (jprop, jblock, priv_j)):
        psh = blk.PartSetHeader(7, b"\x09" * 32)
        p = prop.Proposal(4, 1, psh, 0, blk.BlockID(b"\x01" * 32, psh), 55)
        priv.sign_proposal(CHAIN, p)
        hb = prop.Heartbeat(priv.address, 3, 4, 1, 9)
        priv.sign_heartbeat(CHAIN, hb)
        objs.append((p.sign_bytes(CHAIN), p.to_obj(), str(p),
                      hb.sign_bytes(CHAIN), hb.to_obj(),
                      prop.Proposal.from_obj(p.to_obj()) == p,
                      prop.Heartbeat.from_obj(hb.to_obj()) == hb))
    assert objs[0] == objs[1]
    assert objs[0][-2:] == (True, True)


def test_params_and_genesis_round_trip_match_jax(tmp_path):
    out = []
    for params, gen, keys in ((tparams, tgen, tkeys), (jparams, jgen, jkeys)):
        p = params.ConsensusParams()
        p.validate()
        assert p.block_gossip.block_part_size_bytes == 65536
        upd = p.update({"block_size": {"max_txs": 5}})
        assert upd.block_size.max_txs == 5 and p.block_size.max_txs == 100000
        bad = p.update(None)
        bad.block_gossip.block_part_size_bytes = 0
        with pytest.raises(ValueError) as e:
            bad.validate()
        doc = gen.GenesisDoc(
            chain_id=CHAIN, genesis_time_ns=123, validators=[
                gen.GenesisValidator(keys.PrivKey(s).pubkey.ed25519, 10 + i,
                                     f"v{i}")
                for i, s in enumerate(_seeds(3, 9))],
            app_hash=b"\x07" * 4, app_state={"k": [1, "v"]})
        doc.validate_and_complete()
        path = tmp_path / f"{gen.__name__}.json"
        doc.save(str(path))
        doc2 = gen.GenesisDoc.load(str(path))
        assert doc2.bytes() == doc.bytes()
        assert doc2.validator_hash() == doc.validator_hash()
        with pytest.raises(ValueError) as e2:
            gen.GenesisDoc(chain_id=CHAIN).validate_and_complete()
        out.append((p.hash(), upd.to_obj(), str(e.value), doc.bytes(),
                    doc.validator_hash(), path.read_bytes(), str(e2.value)))
    assert out[0] == out[1]


def test_valset_and_lite_objects_match_jax():
    tb, tvs_, _ = build_block(PORT, 6)
    jb, jvs_, _ = build_block(JAX, 6)
    for _ in range(3):
        tvs_.increment_accum(1)
        jvs_.increment_accum(1)
        o = jvs_.to_obj()
        assert tvs_.to_obj() == o and "proposer" in o
        back = tvs.ValidatorSet.from_obj(o)
        assert back.proposer().address == jvs_.proposer().address
        jback = jvs.ValidatorSet.from_obj(o)
        back.increment_accum(1)
        jback.increment_accum(1)
        assert back.proposer().address == jback.proposer().address
    with pytest.raises(ValueError, match="not in validator set"):
        tvs.ValidatorSet.from_obj(dict(o, proposer="00" * 20))
    bid = tb.block_id(1024)
    tfc = tlite.FullCommit(tlite.SignedHeader(tb.header, tb.last_commit, bid),
                           tvs_)
    jfc = jlite.FullCommit(jlite.SignedHeader(
        jb.header, jb.last_commit, jb.block_id(1024)), jvs_)
    assert tenc.cdumps(tfc.to_obj()) == jenc.cdumps(jfc.to_obj())
    back = tlite.FullCommit.from_obj(jfc.to_obj())
    assert tenc.cdumps(back.to_obj()) == jenc.cdumps(jfc.to_obj())
    assert back.signed_header.header.hash() == jb.header.hash()


def test_vote_methods_match_jax():
    _, tprivs = _valset(PORT, 3)
    _, jprivs = _valset(JAX, 3)
    bids = [(tblock.BlockID(), jblock.BlockID()),
            (tblock.BlockID(b"\x0f" * 32, tblock.PartSetHeader(2, b"\x01" * 32)),
             jblock.BlockID(b"\x0f" * 32, jblock.PartSetHeader(2, b"\x01" * 32)))]
    for tb_, jb_ in bids:
        tv = _vote(PORT, tprivs[1], 1, 3, PC, tb_, 42)
        jv = _vote(JAX, jprivs[1], 1, 3, PC, jb_, 42)
        assert str(tv) == str(jv) and tv.to_obj() == jv.to_obj()
        assert tvote.Vote.from_obj(jv.to_obj()) == tv
        pk = tprivs[1].pubkey.ed25519
        other = tprivs[0].pubkey.ed25519
        assert (tv.verify(CHAIN, pk), tv.verify(CHAIN, other),
                tv.verify("other", pk)) == \
            (jv.verify(CHAIN, pk), jv.verify(CHAIN, other),
             jv.verify("other", pk)) == (True, False, False)
    for field, value in (("type", 3), ("height", 0), ("round", -1),
                         ("validator_address", b"\x01" * 19),
                         ("validator_index", -1)):
        msgs = []
        for v in (copy.copy(tv), copy.copy(jv)):
            setattr(v, field, value)
            with pytest.raises(ValueError) as e:
                v.validate_basic()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_encoding_helpers_match_jax():
    obj = {"b": [1, None, "x"], "a": {"z": "é"}}
    data = tenc.cdumps(obj)
    assert data == jenc.cdumps(obj)
    assert tenc.cloads(data) == jenc.cloads(data) == obj
    assert tenc.chash(obj) == jenc.chash(obj)
    assert tenc.hex_to_bytes(None) is None
    assert tenc.hex_to_bytes("0aff") == jenc.hex_to_bytes("0aff") == b"\n\xff"


def test_convert_carries_block_votes_valset_and_genesis():
    jb, jvs_, jprivs = build_block(JAX, 6, 20)
    block = convert.block_from_jax(jb.to_obj())
    assert block.to_bytes() == jb.to_bytes() and block.hash() == jb.hash()
    votes = convert.votes_from_jax([v.to_obj() if v else None
                                    for v in jb.last_commit.precommits])
    assert votes[1] is None
    assert tenc.cdumps([v.to_obj() if v else None for v in votes]) == \
        jenc.cdumps(jb.last_commit.to_obj()["precommits"])
    jvs_.increment_accum(2)
    vs = convert.valset_from_jax(jvs_.to_obj())
    assert vs.hash() == jvs_.hash()
    assert vs.proposer().address == jvs_.proposer().address
    doc = jgen.GenesisDoc(CHAIN, 5, validators=[
        jgen.GenesisValidator(p.pubkey.ed25519, 3) for p in jprivs])
    assert convert.genesis_from_jax(doc.to_obj()).bytes() == doc.bytes()
    obj = jb.to_obj()
    obj = json.loads(json.dumps(obj))
    obj["header"]["extra"] = 1
    with pytest.raises(ValueError, match="block does not round-trip"):
        convert.block_from_jax(obj)
