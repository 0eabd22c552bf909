"""The port's stores, chain state, block validation and block execution
(tendermint_tpu_torch.storage / .state) against the JAX package's.

The same chain is built in both packages from the same seeds (signing is
deterministic) and every stored value, state and hash is compared byte
for byte; every validation and apply error with its class and message.
Tolerance 0. The JAX app is the kvstore on its pure route, whose
persisted ABCI responses are per-tx dicts like the port's.
"""

from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu.abci import proxy as jproxy
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state import state as jstate
from tendermint_tpu.state import validation as jval
from tendermint_tpu.storage import block_store as jbs
from tendermint_tpu.storage import db as jdb
from tendermint_tpu.storage import state_store as jss
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import part_set as jps
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.abci import proxy as tproxy
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.apps import kvstore as tkv
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.state import execution as texec
from tendermint_tpu_torch.state import state as tstate
from tendermint_tpu_torch.state import validation as tval
from tendermint_tpu_torch.storage import block_store as tbs
from tendermint_tpu_torch.storage import db as tdb
from tendermint_tpu_torch.storage import state_store as tss
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.types import evidence as tev
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import part_set as tps
from tendermint_tpu_torch.types import vote as tvote

torch.set_num_threads(1)

CHAIN = "state-chain"
PC = jvote.VoteType.PRECOMMIT


def _ns(**kw):
    return SimpleNamespace(**kw)


JAX = _ns(name="jax", proxy=jproxy, abci=jabci, kv=jkv, exe=jexec, st=jstate,
          val=jval, bs=jbs, db=jdb, ss=jss, blk=jblock, enc=jenc, ev=jev,
          gen=jgen, keys=jkeys, ps=jps, vote=jvote,
          app=jkv.KVStoreApp)
PORT = _ns(name="port", proxy=tproxy, abci=tabci, kv=tkv, exe=texec,
           st=tstate, val=tval, bs=tbs, db=tdb, ss=tss, blk=tblock, enc=tenc,
           ev=tev, gen=tgen, keys=tkeys, ps=tps, vote=tvote,
           app=tkv.KVStoreApp)


def val_tx(pubkey: bytes, power: int) -> bytes:
    return b"val:" + pubkey.hex().encode() + b"/%d" % power


class Chain:
    """A chain of applied blocks built in package P: every validator of
    the current set precommits each block (those in `absent` do not)."""

    def __init__(self, P, n_vals, app=None, chain_id=CHAIN, seed=40):
        self.P = P
        privs = [P.keys.PrivKey.generate(bytes([seed + i]) * 32)
                 for i in range(n_vals)]
        self.privs = privs
        # a key that joins through a val: tx
        self.joiner = P.keys.PrivKey.generate(bytes([seed + 100]) * 32)
        self.by_addr = {k.pubkey.address: k for k in privs + [self.joiner]}
        self.gen = P.gen.GenesisDoc(
            chain_id=chain_id, genesis_time_ns=1,
            validators=[P.gen.GenesisValidator(k.pubkey.ed25519, 10)
                        for k in privs])
        self.state = P.st.make_genesis_state(self.gen)
        self.app = app or P.app()
        self.conns = P.proxy.AppConns(P.proxy.local_client_creator(self.app))
        self.conns.consensus.init_chain(
            [P.abci.ValidatorUpdate(v.pubkey, v.voting_power)
             for v in self.state.validators.validators], chain_id)
        self.last_commit = P.blk.Commit()
        self.blocks, self.states, self.responses = [], [self.state], []

    def commit_for(self, block, bid, absent=()):
        P, h = self.P, block.header.height
        pcs = []
        for i, v in enumerate(self.state.validators.validators):
            if i in absent:
                pcs.append(None)
                continue
            vote = P.vote.Vote(v.address, i, h, 0, h * 10 ** 9 + 1, PC, bid)
            vote.signature = self.by_addr[v.address].sign(
                vote.sign_bytes(self.gen.chain_id))
            pcs.append(vote)
        return P.blk.Commit(bid, pcs)

    def next(self, txs, absent=()):
        P, state = self.P, self.state
        h = state.last_block_height + 1
        block = state.make_block(h, txs, self.last_commit,
                                 time_ns=h * 10 ** 9)
        psz = state.consensus_params.block_gossip.block_part_size_bytes
        bid = P.blk.BlockID(block.hash(), block.make_part_set(psz).header())
        self.last_commit = self.commit_for(block, bid, absent)
        resp = P.exe.exec_block_on_app(self.conns.consensus, block,
                                       state.validators)
        new = P.exe.update_state(state.copy(), bid, block, resp)
        new.app_hash = self.conns.consensus.commit()
        self.blocks.append(block)
        self.responses.append(resp)
        self.states.append(new)
        self.state = new
        return block


def both_chains(n_vals, n_blocks, txs_of, absent_of=lambda h: ()):
    out = []
    for P in (JAX, PORT):
        c = Chain(P, n_vals)
        for h in range(1, n_blocks + 1):
            c.next(txs_of(c, h), absent_of(h))
        out.append(c)
    return out


def _txs(c, h):
    return [b"k%d.%d=v%d" % (h % 3, i, h) for i in range(5)]


def _dump(db) -> dict:
    return dict(db.iterate())


def _raised(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


# -- db backends -------------------------------------------------------------

@pytest.mark.parametrize("prefix", [b"", b"a", b"a\xff", b"\xff", b"\xff\xff",
                                    b"ab\xffc", b"\x00"])
def test_prefix_upper_bound_matches_jax(prefix):
    assert tdb._prefix_upper_bound(prefix) == jdb._prefix_upper_bound(prefix)


def _drive_db(db):
    db.set(b"a:1", b"v1")
    db.set(b"a:2", b"v2")
    db.set(b"b:1", b"v3")
    db.set_batch([(b"\xff\x01", b"x"), (b"\xff\xff", b"y"), (b"a:0", b"v0"),
                  (bytearray(b"a:3"), bytearray(b"v3"))])
    db.set(b"a:2", b"v2b")
    seen = [db.get(b"a:1"), db.get(b"missing"),
            list(db.iterate(b"a:")), list(db.iterate(b"\xff")),
            list(db.iterate(b"\xff\xff")), list(db.iterate())]
    db.delete(b"a:1")
    db.delete(b"never")
    db.delete_batch([b"a:0", b"b:1", b"nope"])
    db.compact()
    seen += [db.get(b"a:1"), list(db.iterate())]
    db.close()
    return seen


@pytest.mark.parametrize("backend", ["mem", "sqlite"])
def test_kv_backends_match_jax(tmp_path, backend):
    def mk(mod, name):
        return mod.MemDB() if backend == "mem" else \
            mod.SQLiteDB(str(tmp_path / name))
    assert _drive_db(mk(tdb, "t.db")) == _drive_db(mk(jdb, "j.db"))


def test_sqlite_persists_across_reopen_and_open_db(tmp_path):
    path = str(tmp_path / "kv.db")
    db = tdb.SQLiteDB(path)
    db.set(b"k", b"v")
    db.close()
    db2 = tdb.SQLiteDB(path)
    assert db2.get(b"k") == b"v"
    db2.close()
    assert isinstance(tdb.open_db(None), tdb.MemDB)
    assert isinstance(tdb.open_db(":memory:"), tdb.MemDB)
    db3 = tdb.open_db(str(tmp_path / "x.db"))
    assert isinstance(db3, tdb.SQLiteDB)
    db3.close()


# -- block store -------------------------------------------------------------

def _store_chain(c, part_size):
    bs = c.P.bs.BlockStore(c.P.db.MemDB())
    assert bs.height() == 0 and bs.base() == 1
    for i, block in enumerate(c.blocks):
        seen = c.blocks[i + 1].last_commit if i + 1 < len(c.blocks) \
            else c.last_commit
        bs.save_block(block, block.make_part_set(part_size), seen)
    return bs


@pytest.mark.parametrize("part_size", [64, 65536])
def test_block_store_bytes_match_jax(part_size):
    jc, tc = both_chains(4, 4, _txs, absent_of=lambda h: (1,) if h == 2 else ())
    jbs_, tbs_ = _store_chain(jc, part_size), _store_chain(tc, part_size)
    assert _dump(tbs_.db) == _dump(jbs_.db)
    assert tbs_.height() == jbs_.height() == 4 and tbs_.base() == 1
    for h in range(1, 5):
        assert tbs_.load_block(h).to_bytes() == jbs_.load_block(h).to_bytes()
        assert tbs_.load_block(h).hash() == tc.blocks[h - 1].hash()
        assert tenc.cdumps(tbs_.load_block_meta(h).to_obj()) == \
            jenc.cdumps(jbs_.load_block_meta(h).to_obj())
        assert tbs_.load_seen_commit(h).to_bytes() == \
            jbs_.load_seen_commit(h).to_bytes()
        part = tbs_.load_block_part(h, 0)
        jpart = jbs_.load_block_part(h, 0)
        assert (part.index, part.payload, part.proof) == \
            (jpart.index, jpart.payload, jpart.proof)
    for h in range(1, 4):
        assert tbs_.load_block_commit(h).to_bytes() == \
            jbs_.load_block_commit(h).to_bytes()
    for bs in (tbs_, jbs_):
        assert bs.load_block(5) is None and bs.load_block_meta(99) is None
        assert bs.load_block_commit(4) is None
        assert bs.load_seen_commit(5) is None


def test_block_store_part_rows_match_jax():
    part = tps.Part(3, b"payload" * 9, [b"\x01" * 32, b"\x02" * 32])
    jpart = jps.Part(3, b"payload" * 9, [b"\x01" * 32, b"\x02" * 32])
    raw = tbs._pack_part(part)
    assert raw == jbs._pack_part(jpart)
    got = tbs._unpack_part(raw)
    assert (got.index, got.payload, got.proof) == (3, part.payload, part.proof)
    legacy = jenc.cdumps(jpart.to_obj())
    got = tbs._unpack_part(legacy)
    assert (got.index, got.payload, got.proof) == (3, part.payload, part.proof)
    bad = b"\x07" + raw[1:]
    assert _raised(lambda: tbs._unpack_part(bad)) == \
        _raised(lambda: jbs._unpack_part(bad))


def test_block_store_refusals_match_jax():
    out = []
    for P in (JAX, PORT):
        c = Chain(P, 2)
        b1, b2 = c.next([b"a=1"]), c.next([])
        bs = P.bs.BlockStore(P.db.MemDB())
        out.append(_raised(lambda: bs.save_block(
            b2, b2.make_part_set(64), P.blk.Commit())))
        incomplete = P.ps.PartSet.from_header(b1.make_part_set(64).header())
        out.append(_raised(lambda: bs.save_block(b1, incomplete,
                                                 P.blk.Commit())))
        assert bs.height() == 0
    assert out[:2] == out[2:]
    assert out[0] == ("ValueError", "save_block: expected height 1, got 2")
    assert out[1] == ("ValueError", "save_block: part set is not complete")


# -- state store -------------------------------------------------------------

def _drive_state_store(P):
    c = Chain(P, 4)
    ss = P.ss.StateStore(P.db.MemDB())
    out = [ss.load(), _raised(lambda: ss.load_or_genesis(None))]
    state = ss.load_or_genesis(c.gen)
    out.append(ss.load_or_genesis(c.gen).equals(state))
    other = P.gen.GenesisDoc(chain_id="other-chain", genesis_time_ns=1,
                             validators=c.gen.validators)
    out.append(_raised(lambda: ss.load_or_genesis(other)))
    for h in range(1, 4):
        state = state.copy()
        state.last_block_height = h
        ss.save(state)
    newkeys = [P.keys.PrivKey.generate(bytes([90 + i]) * 32) for i in range(5)]
    state = state.copy()
    state.last_block_height = 4
    state.validators = type(state.validators)(
        [type(state.validators.validators[0])(k.pubkey.ed25519, 7)
         for k in newkeys])
    state.last_height_validators_changed = 5
    ss.save(state)
    out += [ss.load_validators(h).to_obj() for h in range(1, 6)]
    out += [_raised(lambda: ss.load_validators(99)),
            ss.load_consensus_params(2).to_obj(),
            _raised(lambda: ss.load_consensus_params(99))]
    bad = P.ss._validators_key(7)
    ss.db.set(bad, P.enc.cdumps({"last_changed": 6, "valset": None}))
    out.append(_raised(lambda: ss.load_validators(7)))
    out.append(_raised(lambda: ss._validators_info_pair(3, 4,
                                                        state.validators)))
    ss.save_abci_responses(3, {"deliver_txs": [{"code": 0}], "end_block": {}})
    out += [ss.load_abci_responses(3), ss.load_abci_responses(4),
            P.enc.cdumps(ss.load().to_obj())]
    return out, _dump(ss.db)


def test_state_store_matches_jax():
    (jout, jdump), (tout, tdump) = map(_drive_state_store, (JAX, PORT))
    assert tdump == jdump
    assert tout == jout
    assert tout[1] == ("ValueError",
                       "no stored state and no genesis doc provided")
    assert tout[3][0] == "ValueError" and "chain_id" in tout[3][1]


def test_state_bytes_and_round_trip_match_jax():
    jc, tc = both_chains(4, 3, _txs)
    for js, ts in zip(jc.states, tc.states):
        obj = js.to_obj()
        assert tenc.cdumps(ts.to_obj()) == jenc.cdumps(obj)
        carried = convert.chain_state_from_jax(obj)
        assert carried.equals(ts) and not carried.is_empty()
        cp = carried.copy()
        cp.last_block_height += 1
        assert not cp.equals(carried)
    for jb, tb in zip(jc.blocks, tc.blocks):
        assert tb.to_bytes() == jb.to_bytes()
    assert tstate.State().is_empty()
    with pytest.raises(ValueError,
                       match="^chain state does not round-trip through "
                             "to_obj$"):
        convert.chain_state_from_jax(dict(jc.state.to_obj(), extra=1))
    assert tenc.cdumps(tstate.make_genesis_state(tc.gen).to_obj()) == \
        jenc.cdumps(jstate.make_genesis_state(jc.gen).to_obj())


# -- validate_block ------------------------------------------------------------

def _setattr(path, value):
    def mutate(P, state, block):
        obj = {"state": state, "header": block.header, "block": block}[path[0]]
        setattr(obj, path[1], value(P, state, block) if callable(value)
                else value)
    return mutate


def _relink_commit(fn):
    """Mutate the last commit, then refresh last_commit_hash so the block
    stays well formed."""
    def mutate(P, state, block):
        fn(P, state, block)
        block.header.last_commit_hash = block.last_commit.hash()
    return mutate


def _flip_sig(P, state, block):
    pcs = list(block.last_commit.precommits)
    v = P.vote.Vote.from_obj(pcs[2].to_obj())
    v.signature = v.signature[:9] + bytes([v.signature[9] ^ 1]) + \
        v.signature[10:]
    pcs[2] = v
    block.last_commit = P.blk.Commit(block.last_commit.block_id, pcs)


def _drop_votes(P, state, block):
    pcs = list(block.last_commit.precommits)
    pcs[0] = pcs[3] = None
    block.last_commit = P.blk.Commit(block.last_commit.block_id, pcs)


def _short_commit(P, state, block):
    block.last_commit = P.blk.Commit(block.last_commit.block_id,
                                     block.last_commit.precommits[:3])


VALIDATE_CASES = {
    "num_txs": _setattr(("header", "num_txs"), 9),
    "data_hash": _setattr(("header", "data_hash"), b"\x05" * 32),
    "chain_id": _setattr(("header", "chain_id"), "other-chain"),
    "height": _setattr(("state", "last_block_height"), 5),
    "last_block_id": _setattr(
        ("state", "last_block_id"),
        lambda P, s, b: P.blk.BlockID(b"\x01" * 32, s.last_block_id.parts)),
    "total_txs": _setattr(("state", "last_block_total_tx"), 1),
    "app_hash": _setattr(("state", "app_hash"), b"\x02" * 32),
    "last_results_hash": _setattr(("state", "last_results_hash"),
                                  b"\x03" * 32),
    "validators_hash": _setattr(("header", "validators_hash"), b"\x04" * 32),
    "consensus_hash": _setattr(("header", "consensus_hash"), b"\x06" * 32),
    "last_commit_size": _relink_commit(_short_commit),
    "last_commit_signature": _relink_commit(_flip_sig),
    "last_commit_power": _relink_commit(_drop_votes),
    "commit_structure": _relink_commit(
        lambda P, s, b: setattr(b.last_commit.precommits[1], "round", 1)),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_block_errors_match_jax(case):
    jc, tc = both_chains(4, 3, _txs)
    out = []
    for c, verifier in ((jc, None), (tc, tverifier.BatchVerifier("python"))):
        P = c.P
        state = c.states[2].copy()
        block = P.blk.Block.from_bytes(c.blocks[2].to_bytes())
        P.val.validate_block(state, block, verifier=verifier)  # valid as is
        VALIDATE_CASES[case](P, state, block)
        out.append(_raised(lambda: P.val.validate_block(
            state, block, verifier=verifier)))
    assert out[0] is not None and out[0][0] == "BlockValidationError"
    assert out[1] == out[0]


def test_validate_block_one_and_trusted_commit_match_jax():
    jc, tc = both_chains(4, 3, _txs)
    out = []
    for c, verifier in ((jc, None), (tc, tverifier.BatchVerifier("python"))):
        P = c.P
        b1 = P.blk.Block.from_bytes(c.blocks[0].to_bytes())
        b1.last_commit = c.blocks[1].last_commit
        b1.header.last_commit_hash = b1.last_commit.hash()
        out.append(_raised(lambda: P.val.validate_block(c.states[0], b1,
                                                        verifier=verifier)))
        # a forged signature passes only when the commit is trusted
        b3 = P.blk.Block.from_bytes(c.blocks[2].to_bytes())
        _relink_commit(_flip_sig)(P, c.states[2], b3)
        P.val.validate_block(c.states[2], b3, verifier=verifier,
                             trust_last_commit=True)
        out.append(_raised(lambda: P.val.validate_block(
            c.states[2], b3, verifier=verifier)))
    assert out[:2] == out[2:]
    assert out[0] == ("BlockValidationError",
                      "block 1 cannot have a last_commit")
    assert out[1] == ("BlockValidationError",
                      "invalid last_commit: invalid signature in commit")


def _evidence(c, h, priv, flip=False):
    P = c.P
    bid_a = P.blk.BlockID(b"\x11" * 32, P.blk.PartSetHeader(1, b"\x22" * 32))
    bid_b = P.blk.BlockID(b"\x33" * 32, P.blk.PartSetHeader(1, b"\x22" * 32))
    idx, _ = c.state.validators.get_by_address(priv.pubkey.address)
    votes = []
    for bid in (bid_a, bid_b):
        v = P.vote.Vote(priv.pubkey.address, max(idx, 0), h, 0, 5,
                        jvote.VoteType.PREVOTE, bid)
        v.signature = priv.sign(v.sign_bytes(c.gen.chain_id))
        votes.append(v)
    if flip:
        s = votes[1].signature
        votes[1].signature = s[:3] + bytes([s[3] ^ 1]) + s[4:]
    return P.ev.DuplicateVoteEvidence(priv.pubkey.ed25519, *votes)


EVIDENCE_CASES = {
    "valid": dict(ev_h=2),
    "too_old": dict(ev_h=2, last_height=2 + 100000),
    "future": dict(ev_h=9),
    "height_zero": dict(ev_h=0),
    "no_stored_valset": dict(ev_h=2, store=True),
    "not_a_validator": dict(ev_h=2, stranger=True),
    "bad_signature": dict(ev_h=2, flip=True),
}


@pytest.mark.parametrize("case", sorted(EVIDENCE_CASES))
def test_verify_evidence_matches_jax(case):
    kw = EVIDENCE_CASES[case]
    jc, tc = both_chains(4, 3, _txs)
    out = []
    for c, verifier in ((jc, None), (tc, tverifier.BatchVerifier("python"))):
        P = c.P
        priv = P.keys.PrivKey.generate(b"\x77" * 32) if kw.get("stranger") \
            else c.privs[1]
        ev = _evidence(c, kw["ev_h"], priv, kw.get("flip", False))
        state = c.state.copy()
        if "last_height" in kw:
            state.last_block_height = kw["last_height"]
        store = P.ss.StateStore(P.db.MemDB()) if kw.get("store") else None
        got = []
        out.append(_raised(lambda: got.append(P.val.verify_evidence(
            state, ev, store, verifier=verifier))))
        out.append([v.to_obj() for v in got])
    assert out[2:] == out[:2]
    if case == "valid":
        assert out[0] is None and len(out[1]) == 1
    else:
        assert out[0][0] == ("EvidenceTooOldError" if case in
                             ("too_old", "height_zero")
                             else "BlockValidationError")


def test_validate_block_with_evidence_matches_jax():
    out = []
    for P, verifier in ((JAX, None), (PORT, tverifier.BatchVerifier("python"))):
        c = Chain(P, 4)
        c.next([b"a=1"])
        c.next([b"b=2"])
        ss = P.ss.StateStore(P.db.MemDB())
        for s in c.states:
            ss.save(s)
        block = c.state.make_block(3, [], c.last_commit, time_ns=3 * 10 ** 9,
                                   evidence=[_evidence(c, 2, c.privs[2])])
        P.val.validate_block(c.state, block, state_store=ss,
                             verifier=verifier)
        bad = c.state.make_block(3, [], c.last_commit, time_ns=3 * 10 ** 9,
                                 evidence=[_evidence(c, 2, c.privs[2], True)])
        out.append(_raised(lambda: P.val.validate_block(
            c.state, bad, state_store=ss, verifier=verifier)))
        out.append(block.to_bytes())
    assert out[2:] == out[:2]
    assert out[0] == ("BlockValidationError",
                      "invalid evidence: invalid signature in evidence")


# -- apply_block and update_state --------------------------------------------

def _val_chain_txs(c, h):
    txs = _txs(c, h)
    if h == 3:   # a power change and an accepted add in one block
        txs += [val_tx(c.privs[0].pubkey.ed25519, 25),
                val_tx(c.joiner.pubkey.ed25519, 4)]
    if h == 4:   # a refused removal: the guard answers code 2
        txs.append(val_tx(b"\x08" * 32, 0))
    return txs


def _apply_all(c, verifier):
    """A fresh node applies c's blocks through BlockExecutor.apply_block;
    returns its state store and the states it reached."""
    P = c.P
    node = Chain(P, len(c.privs))
    ss = P.ss.StateStore(P.db.MemDB())
    state = ss.load_or_genesis(node.gen)
    exe = P.exe.BlockExecutor(ss, node.conns.consensus, verifier=verifier)
    states = []
    for block in c.blocks:
        bid = block.block_id(
            state.consensus_params.block_gossip.block_part_size_bytes)
        state = exe.apply_block(state, bid, block)
        states.append(state)
    return ss, states, node


def test_apply_block_matches_jax():
    jc, tc = both_chains(4, 5, _val_chain_txs)
    v = tverifier.BatchVerifier("python")
    jss_, jstates, jnode = _apply_all(jc, None)
    tss_, tstates, tnode = _apply_all(tc, v)
    assert _dump(tss_.db) == _dump(jss_.db)
    for js, ts, built in zip(jstates, tstates, tc.states[1:]):
        assert tenc.cdumps(ts.to_obj()) == jenc.cdumps(js.to_obj())
        assert ts.equals(built)
    assert len(tstates[-1].validators) == 5
    assert tstates[-1].last_height_validators_changed == 4
    resp = tss_.load_abci_responses(4)
    assert resp == jss_.load_abci_responses(4)
    assert resp["deliver_txs"][-1]["code"] == 2
    assert tnode.app.app_hash == jnode.app.app_hash == tc.state.app_hash
    assert v.stats["sigs"] == 4 * 3 + 5


def test_exec_commit_block_and_results_hash_match_jax():
    jc, tc = both_chains(4, 3, _val_chain_txs)
    hashes = []
    for c in (jc, tc):
        node = Chain(c.P, 4)
        verifier = tverifier.BatchVerifier("python") if c.P is PORT \
            else None
        exe = c.P.exe.BlockExecutor(None, node.conns.consensus,
                                    verifier=verifier)
        hashes.append([exe.exec_commit_block(b) for b in c.blocks])
        hashes.append([r.results_hash() for r in c.responses])
        hashes.append([c.P.enc.cdumps(r.to_obj()) for r in c.responses])
    assert hashes[3:] == hashes[:3]
    assert hashes[0] == [s.app_hash for s in tc.states[1:]]


def _bad_updates(P, pk_known):
    return {
        "unknown removal": [{"pubkey": (b"\x0a" * 32).hex(), "power": 0}],
        "negative power": [{"pubkey": pk_known.hex(), "power": -1}],
        "empty set": [{"pubkey": pk_known.hex(), "power": 0}],
    }


@pytest.mark.parametrize("case", ["unknown removal", "negative power",
                                  "empty set"])
def test_update_state_refuses_invalid_updates_like_jax(case):
    out = []
    for P in (JAX, PORT):
        c = Chain(P, 1)
        block = c.next([b"x=1"])
        ups = _bad_updates(P, c.privs[0].pubkey.ed25519)[case]
        resp = P.exe.ABCIResponses([], {"validator_updates": ups})
        out.append(_raised(lambda: P.exe.update_state(
            c.states[0], block.block_id(65536), block, resp)))
    assert out[1] == out[0]
    assert out[0][0] == "ApplyBlockError" and \
        out[0][1].startswith("validator update failed at height 1: ")


def test_apply_block_raises_apply_block_error_like_jax():
    """An app that lets an invalid update through EndBlock halts the
    executor with ApplyBlockError, before anything is saved."""
    out = []
    for P, verifier in ((JAX, None), (PORT, tverifier.BatchVerifier("python"))):
        class BadApp(P.kv.KVStoreApp):
            def end_block(self, height):
                return P.abci.ResultEndBlock(
                    [P.abci.ValidatorUpdate(b"\x0b" * 32, 0)])
        built = Chain(P, 2)
        block = built.next([b"x=1"])
        node = Chain(P, 2, app=BadApp(**({"use_native": False}
                                         if P is JAX else {})))
        ss = P.ss.StateStore(P.db.MemDB())
        state = ss.load_or_genesis(node.gen)
        exe = P.exe.BlockExecutor(ss, node.conns.consensus, verifier=verifier)
        out.append(_raised(lambda: exe.apply_block(
            state, block.block_id(65536), block)))
        out.append(ss.load().last_block_height)
    assert out[2:] == out[:2]
    assert out[0][0] == "ApplyBlockError" and out[1] == 0


def test_block_executor_without_verifier_takes_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    saved = tverifier._default
    tverifier.set_default_verifier(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texec.BlockExecutor(None, None)
        v = tverifier.BatchVerifier("python")
        tverifier.set_default_verifier(v)
        assert texec.BlockExecutor(None, None).verifier is v
    finally:
        tverifier.set_default_verifier(saved)


def test_mocks_and_abci_responses_round_trip():
    mp, ep = texec.MockMempool(), texec.MockEvidencePool()
    mp.lock(), mp.unlock(), mp.update(1, []), mp.flush()
    assert mp.size() == 0 and mp.reap(5) == [] and mp.check_tx(b"") is None
    assert ep.pending_evidence() == [] and ep.add_evidence(None) is None
    jc, tc = both_chains(2, 2, _val_chain_txs)
    for jr, tr in zip(jc.responses, tc.responses):
        back = texec.ABCIResponses.from_obj(jr.to_obj())
        assert tenc.cdumps(back.to_obj()) == jenc.cdumps(jr.to_obj())
        assert back.results_hash() == tr.results_hash() == jr.results_hash()
