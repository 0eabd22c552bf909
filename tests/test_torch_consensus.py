"""The port's consensus engine (tendermint_tpu_torch.consensus) against the
JAX package's, on the CPU.

Every scenario of tests/test_consensus.py and tests/test_pol_safety.py
runs through both packages on the same keys and inputs, with both
packages' clocks on the same deterministic source that advances at every
read (so both must read it at the same points); each keeps the reference
test's own assertions, and the two runs must give the same per-height
block bytes, State bytes and app hashes, and the same final (height,
round, step) on every node. Tolerance 0.

Both packages' ConsensusStates run with their pipeline off
(TM_TPU_PIPELINE=off, and the port's pipeline "off"), on the serial
path; the 4-node net below is also held to the JAX net with its pipeline
at its default. Both run their kvstore app at its default, the native
core. Port nodes verify on
BatchVerifier("python"), JAX nodes on their default verifier (the host
loop at these sizes); two cases take the port's batch path on the CPU,
BatchVerifier("cuda", device="cpu"): one vote_agg group and one
proposal check.
"""

import os
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu import consensus as jcons
from tendermint_tpu.abci import proxy as jproxy
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.consensus import replay as jreplay
from tendermint_tpu.evidence import pool as jevpool
from tendermint_tpu.evidence import store as jevstore
from tendermint_tpu.mempool import mempool as jmempool
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.storage import block_store as jbs
from tendermint_tpu.storage import db as jdb
from tendermint_tpu.storage import state_store as jss
from tendermint_tpu.storage import wal as jwal
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu.types import events as jevents
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import priv_validator as jpv
from tendermint_tpu.types import proposal as jprop
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.utils import clock as jclock
from tendermint_tpu import config as jconfig
from tendermint_tpu_torch import config as tconfig
from tendermint_tpu_torch import pipeline as tpipeline
from tendermint_tpu_torch import consensus as tcons
from tendermint_tpu_torch.abci import proxy as tproxy
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.apps import kvstore as tkv
from tendermint_tpu_torch.consensus import replay as treplay
from tendermint_tpu_torch.consensus import testnet as ttestnet
from tendermint_tpu_torch.evidence import pool as tevpool
from tendermint_tpu_torch.evidence import store as tevstore
from tendermint_tpu_torch.mempool import mempool as tmempool
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.state import execution as texec
from tendermint_tpu_torch.storage import block_store as tbs
from tendermint_tpu_torch.storage import db as tdb
from tendermint_tpu_torch.storage import state_store as tss
from tendermint_tpu_torch.storage import wal as twal
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.types import events as tevents
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import priv_validator as tpv
from tendermint_tpu_torch.types import proposal as tprop
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.utils import clock as tclock

torch.set_num_threads(1)

_PY = tverifier.BatchVerifier("python")

JAX = SimpleNamespace(
    name="jax", cons=jcons, proxy=jproxy, abci=jabci, replay=jreplay,
    evpool=jevpool, evstore=jevstore, mempool=jmempool, exe=jexec,
    bs=jbs, db=jdb, ss=jss, wal=jwal, blk=jblock, enc=jenc, events=jevents,
    gen=jgen, keys=jkeys, pv=jpv, prop=jprop, vote=jvote, clock=jclock,
    config=jconfig, app=jkv.KVStoreApp,
    verifier=lambda: None)
PORT = SimpleNamespace(
    name="port", cons=tcons, proxy=tproxy, abci=tabci, replay=treplay,
    evpool=tevpool, evstore=tevstore, mempool=tmempool, exe=texec,
    bs=tbs, db=tdb, ss=tss, wal=twal, blk=tblock, enc=tenc, events=tevents,
    gen=tgen, keys=tkeys, pv=tpv, prop=tprop, vote=tvote, clock=tclock,
    config=tconfig, app=tkv.KVStoreApp, verifier=lambda: _PY)
PKGS = (JAX, PORT)
T0 = 1_700_000_000 * 10 ** 9


@pytest.fixture(autouse=True)
def serial_pipeline(monkeypatch):
    """Both packages' ConsensusStates on their serial path: the clocks
    tick at every read, and the precompute worker of the pipelined path
    reads them from its own thread."""
    monkeypatch.setenv("TM_TPU_PIPELINE", "off")
    monkeypatch.setattr(tpipeline, "_configured", "off")


def ticking_clocks():
    """Both packages' clocks on their own counter from T0, one
    microsecond a read."""
    for P in PKGS:
        ticks = iter(range(T0, T0 + 10 ** 15, 1000))
        P.clock.set_source(lambda ticks=ticks: next(ticks))


@pytest.fixture
def clocks():
    ticking_clocks()
    yield
    for P in PKGS:
        P.clock.set_source(None)


# ------------------------------------------------------------ the harness

def genesis(P, keys, chain_id, power=10):
    return P.gen.GenesisDoc(
        chain_id=chain_id, genesis_time_ns=1,
        validators=[P.gen.GenesisValidator(k.pubkey.ed25519, power)
                    for k in keys])


def make_node(P, gen_doc, key=None, app=None, record=None):
    """tests/test_consensus.py's make_node in package P; `record` (a
    list) collects (block bytes, State bytes, app hash) per commit."""
    app = app or P.app()
    conns = P.proxy.AppConns(P.proxy.local_client_creator(app))
    state_store = P.ss.StateStore(P.db.MemDB())
    block_store = P.bs.BlockStore(P.db.MemDB())
    state = state_store.load_or_genesis(gen_doc)
    conns.consensus.init_chain(
        [P.abci.ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen_doc.chain_id)
    exe = P.exe.BlockExecutor(state_store, conns.consensus,
                              verifier=P.verifier())
    cs = P.cons.ConsensusState(
        P.config.test_config().consensus, state, exe, block_store,
        priv_validator=(P.pv.PrivValidator(P.pv.LocalSigner(key))
                        if key else None),
        ticker_factory=P.cons.MockTicker)
    cs.app = app
    cs.record = record if record is not None else []
    _record_commits(P, cs)
    return cs


def _record_commits(P, cs):
    apply = cs.block_exec.apply_block

    def recording_apply(state, block_id, block, *a, **kw):
        new = apply(state, block_id, block, *a, **kw)
        cs.record.append((block.to_bytes(), P.enc.cdumps(new.to_obj()),
                          new.app_hash))
        return new
    cs.block_exec.apply_block = recording_apply


class ListMempool:
    """Minimal reap/update mempool for proposer-side tx injection."""

    def __init__(self):
        self.txs = []

    def lock(self): pass

    def unlock(self): pass

    def size(self): return len(self.txs)

    def reap(self, mx): return self.txs[:mx]

    def update(self, height, txs):
        self.txs = [t for t in self.txs if t not in txs]

    def flush(self): pass


def wire_full_mesh(nodes):
    for i, src in enumerate(nodes):
        def relay(msg, i=i):
            for j, dst in enumerate(nodes):
                if j != i and msg["type"] in ("proposal", "block_part",
                                              "vote"):
                    dst.submit(dict(msg), peer_id=f"node{i}")
        src.broadcast_hooks.append(relay)


def make_keys(P, n):
    return [P.keys.PrivKey.generate(bytes([i + 1]) * 32) for i in range(n)]


def make_net(P, n, chain_id="cs-test"):
    keys = make_keys(P, n)
    gen = genesis(P, keys, chain_id)
    nodes = [make_node(P, gen, k) for k in keys]
    wire_full_mesh(nodes)
    return nodes, keys


def fire_all(nodes):
    n = 0
    for node in nodes:
        if node.ticker.fire_next() is not None:
            n += 1
    return n


def run_until_height(nodes, height, max_ticks=200):
    for _ in range(max_ticks):
        if all(n.state.last_block_height >= height for n in nodes):
            return
        if fire_all(nodes) == 0 and \
                all(n.state.last_block_height >= height for n in nodes):
            return
    raise AssertionError(
        f"net did not reach height {height}; at "
        f"{[n.state.last_block_height for n in nodes]}")


def outcome(nodes):
    return [(n.record, n.state.last_block_height,
             (n.rs.height, n.rs.round, int(n.rs.step))) for n in nodes]


# -------------------------------------------- tests/test_consensus.py's twelve

def sc_single_validator_commits_blocks(P):
    nodes, _ = make_net(P, 1)
    cs = nodes[0]
    committed = []
    cs.decided_hook = committed.append
    cs.start()
    run_until_height(nodes, 3)
    assert [b.header.height for b in committed][:3] == [1, 2, 3]
    assert committed[1].header.app_hash != b""
    return outcome(nodes)


def sc_four_validators_commit_and_agree(P):
    nodes, _ = make_net(P, 4)
    for n in nodes:
        n.start()
    run_until_height(nodes, 3)
    hashes = {n.state.last_block_id.key() for n in nodes
              if n.state.last_block_height == nodes[0].state.last_block_height}
    assert len(hashes) == 1
    return outcome(nodes)


def _mempool_net(P, keys, chain_id, wire_exec=False):
    gen = genesis(P, keys, chain_id)
    nodes, mempools = [], []
    for k in keys:
        node = make_node(P, gen, k)
        mp = ListMempool()
        node.mempool = mp
        if wire_exec:
            node.block_exec.mempool = mp
        mempools.append(mp)
        nodes.append(node)
    wire_full_mesh(nodes)
    return nodes, mempools


def sc_net_with_txs_delivers_to_all_apps(P):
    nodes, mempools = _mempool_net(P, make_keys(P, 4), "tx-test")
    for mp in mempools:
        mp.txs = [b"alpha=1", b"beta=2"]
    for n in nodes:
        n.start()
    run_until_height(nodes, 2)
    for n in nodes:
        assert n.app.store.get(b"alpha") == b"1"
        assert n.app.store.get(b"beta") == b"2"
    assert len({n.app.app_hash for n in nodes}) == 1
    return outcome(nodes)


def sc_validator_absent_still_commits(P):
    nodes, _ = make_net(P, 4)
    live = nodes[:3]
    nodes[3].submit = lambda *a, **k: None
    for n in live:
        n.start()
    run_until_height(live, 2, max_ticks=400)
    return outcome(live)


def sc_round_advances_without_proposer(P):
    nodes, _ = make_net(P, 4)
    proposer_addr = nodes[0].rs.validators.proposer().address
    dead = [n for n in nodes
            if n.priv_validator.address == proposer_addr][0]
    live = [n for n in nodes if n is not dead]
    dead.submit = lambda *a, **k: None
    for n in live:
        n.start()
    run_until_height(live, 1, max_ticks=600)
    return outcome(live)


def _val_tx(key, power):
    return b"val:" + key.pubkey.ed25519.hex().encode() + b"/%d" % power


def sc_validator_set_changes_through_end_block(P):
    keys = make_keys(P, 4)
    nodes, mempools = _mempool_net(P, keys, "valchange-test",
                                   wire_exec=True)
    target = keys[0].pubkey
    for mp in mempools:
        mp.txs = [_val_tx(keys[0], 30)]
    for n in nodes:
        n.start()
    run_until_height(nodes, 3)
    for n in nodes:
        _, val = n.state.validators.get_by_address(target.address)
        assert val is not None and val.voting_power == 30
    gone = keys[3].pubkey
    for mp in mempools:
        mp.txs = [_val_tx(keys[3], 0)]
    h = nodes[0].state.last_block_height
    run_until_height(nodes, h + 2)
    for n in nodes:
        assert len(n.state.validators) == 3
        assert not n.state.validators.has_address(gone.address)
    h = nodes[0].state.last_block_height
    run_until_height(nodes, h + 1)
    return outcome(nodes)


def sc_invalid_app_validator_update_fails_loudly(P):
    key = P.keys.PrivKey.generate(b"\x01" * 32)
    gen = genesis(P, [key], "loud-fail")
    app = P.app()
    cs = make_node(P, gen, key, app=app)
    ghost = P.keys.PrivKey.generate(b"\x77" * 32).pubkey
    app._val_updates.append(P.abci.ValidatorUpdate(ghost.ed25519, 0))
    cs.start()
    with pytest.raises(P.exe.ApplyBlockError) as err:
        run_until_height([cs], 1, max_ticks=30)
    assert cs.fatal_error is err.value
    return outcome([cs]) + [(type(err.value).__name__, str(err.value))]


def sc_heartbeat_sent_while_waiting_for_txs(P):
    key = P.keys.PrivKey.generate(b"\x05" * 32)
    gen = genesis(P, [key], "hb-test")
    cs = make_node(P, gen, key)
    cs.config.create_empty_blocks = False
    mp = ListMempool()
    cs.mempool = mp
    cs.block_exec.mempool = mp
    sent = []
    cs.broadcast_hooks.append(
        lambda m: sent.append(m) if m.get("type") == "heartbeat" else None)
    cs.start()
    run_until_height([cs], 2)
    for _ in range(5):
        cs.ticker.fire_next()
    assert cs.state.last_block_height == 2, "must WAIT with no txs"
    assert sent, "no heartbeat broadcast while waiting for txs"
    hb = P.prop.Heartbeat.from_obj(sent[-1]["heartbeat"])
    assert hb.height == 3
    assert key.pubkey.verify(hb.sign_bytes("hb-test"), hb.signature)
    mp.txs = [b"wake=up"]
    cs.submit({"type": "txs_available"})
    run_until_height([cs], 3)
    return outcome([cs]) + [P.enc.cdumps(sent)]


def sc_bad_proposal_rejected_and_prevotes_nil(P):
    nodes, keys = make_net(P, 2, chain_id="badprop-test")
    for n in nodes:
        n.broadcast_hooks.clear()
    prop_addr = nodes[0].rs.validators.proposer().address
    prop_idx = next(i for i, k in enumerate(keys)
                    if k.pubkey.address == prop_addr)
    victim = nodes[1 - prop_idx]
    prop_key = keys[prop_idx]
    victim.start()
    bad_block = victim.state.make_block(
        1, [b"tx=1"], P.blk.Commit(), time_ns=10 ** 9)
    bad_block.header.app_hash = b"\xde\xad" * 16
    parts = bad_block.make_part_set(
        victim.state.consensus_params.block_gossip.block_part_size_bytes)
    forged = P.prop.Proposal(1, 0, parts.header(), timestamp_ns=5)
    forged.signature = keys[1 - prop_idx].sign(
        forged.sign_bytes("badprop-test"))
    victim.submit({"type": "proposal", "proposal": forged.to_obj()},
                  peer_id="peerX")
    assert victim.rs.proposal is None, "forged proposal accepted"
    prevotes = []
    victim.broadcast_hooks.append(
        lambda m: prevotes.append(m) if m.get("type") == "vote" and
        m["vote"]["type"] == 1 else None)
    good = P.prop.Proposal(1, 0, parts.header(), timestamp_ns=5)
    good.signature = prop_key.sign(good.sign_bytes("badprop-test"))
    victim.submit({"type": "proposal", "proposal": good.to_obj()},
                  peer_id="peerX")
    assert victim.rs.proposal is not None
    for i in range(parts.total):
        victim.submit({"type": "block_part", "height": 1, "round": 0,
                       "part": parts.get_part(i).to_obj()},
                      peer_id="peerX")
    for _ in range(20):
        if prevotes:
            break
        victim.ticker.fire_next()
    assert prevotes and prevotes[0]["vote"]["block_id"]["hash"] == ""
    return outcome([victim]) + [P.enc.cdumps(prevotes)]


def sc_conflicting_precommit_for_claimed_maj23_block_commits(P):
    VT = P.vote.VoteType
    nodes, keys = make_net(P, 4, chain_id="maj23-test")
    for n in nodes:
        n.broadcast_hooks.clear()
    prop_addr = nodes[0].rs.validators.proposer().address
    prop_idx = next(i for i, k in enumerate(keys)
                    if k.pubkey.address == prop_addr)
    victim_idx = next(i for i in range(4) if i != prop_idx)
    victim = nodes[victim_idx]
    sent = []
    victim.broadcast_hooks.append(
        lambda m: sent.append(m) if m.get("type") == "vote" else None)
    victim.start()
    block = victim.state.make_block(1, [b"tx=1"], P.blk.Commit(),
                                    time_ns=10 ** 9)
    parts = block.make_part_set(
        victim.state.consensus_params.block_gossip.block_part_size_bytes)
    prop = P.prop.Proposal(1, 0, parts.header(), timestamp_ns=5)
    prop.signature = keys[prop_idx].sign(prop.sign_bytes("maj23-test"))
    victim.submit({"type": "proposal", "proposal": prop.to_obj()},
                  peer_id="peerX")
    for i in range(parts.total):
        victim.submit({"type": "block_part", "height": 1, "round": 0,
                       "part": parts.get_part(i).to_obj()}, peer_id="peerX")
    for _ in range(20):
        if any(m["vote"]["type"] == VT.PREVOTE for m in sent):
            break
        victim.ticker.fire_next()
    my_prevote = next(m for m in sent if m["vote"]["type"] == VT.PREVOTE)
    bid = P.blk.BlockID.from_obj(my_prevote["vote"]["block_id"])
    assert bid.hash == block.hash()

    def vote_from(key, type_, vbid, ts):
        i, _ = victim.rs.validators.get_by_address(key.pubkey.address)
        v = P.vote.Vote(key.pubkey.address, i, 1, 0, ts, type_, vbid)
        v.signature = key.sign(v.sign_bytes("maj23-test"))
        return {"type": "vote", "vote": v.to_obj()}

    others = [k for i, k in enumerate(keys) if i != victim_idx]
    honest1, honest2, equivocator = others
    nil_bid = P.blk.BlockID(b"", P.blk.PartSetHeader(0, b""))
    victim.submit(vote_from(honest1, VT.PREVOTE, bid, 11), "p1")
    victim.submit(vote_from(honest2, VT.PREVOTE, bid, 12), "p2")
    for _ in range(20):
        if any(m["vote"]["type"] == VT.PRECOMMIT for m in sent):
            break
        victim.ticker.fire_next()
    victim.submit(vote_from(honest1, VT.PRECOMMIT, bid, 21), "p1")
    victim.submit(vote_from(equivocator, VT.PRECOMMIT, nil_bid, 22), "p3")
    assert victim.state.last_block_height == 0
    filed = []

    class RecordingPool:
        def add_evidence(self, ev):
            filed.append(ev)

        def pending_evidence(self):
            return []

        def update(self, block, state=None):
            pass
    victim.evidence_pool = RecordingPool()
    victim.rs.votes.set_peer_maj23(0, VT.PRECOMMIT, "peerZ", bid)
    victim.submit(vote_from(equivocator, VT.PRECOMMIT, bid, 23), "p4")
    for _ in range(20):
        if victim.state.last_block_height >= 1:
            break
        victim.ticker.fire_next()
    assert victim.state.last_block_height >= 1
    assert filed and filed[0].vote_a.block_id != filed[0].vote_b.block_id
    return outcome([victim]) + [[P.enc.cdumps(e.to_obj()) for e in filed],
                                P.enc.cdumps(sent)]


def sc_proposer_rotates_across_heights(P):
    nodes, _ = make_net(P, 4, chain_id="rot-test")
    for n in nodes:
        n.start()
    run_until_height(nodes, 3)
    for n in nodes:
        vs = n.rs.validators
        assert vs.proposer().address == \
            vs.validators[(n.rs.height - 1) % 4].address
    return outcome(nodes)


def sc_proposer_rotates_per_round_on_nil_votes(P):
    VT = P.vote.VoteType
    nodes, keys = make_net(P, 4, chain_id="rot2-test")
    for n in nodes:
        n.broadcast_hooks.clear()
    victim = nodes[0]
    victim.start()
    nil_bid = P.blk.BlockID(b"", P.blk.PartSetHeader(0, b""))
    my_addr = victim.priv_validator.address
    proposers = []
    for r in range(4):
        assert victim.rs.round == r
        vs = victim.rs.validators
        assert vs.proposer().address == vs.validators[r % 4].address
        proposers.append(vs.proposer().address)
        for k in keys:
            if k.pubkey.address == my_addr:
                continue
            i, _ = vs.get_by_address(k.pubkey.address)
            for t, ts in ((VT.PREVOTE, 100 + r), (VT.PRECOMMIT, 200 + r)):
                v = P.vote.Vote(k.pubkey.address, i, 1, r, ts, t, nil_bid)
                v.signature = k.sign(v.sign_bytes("rot2-test"))
                victim.submit({"type": "vote", "vote": v.to_obj()},
                              peer_id="px")
        for _ in range(30):
            if victim.rs.round > r:
                break
            victim.ticker.fire_next()
        assert victim.rs.round == r + 1
    return outcome([victim]) + [proposers]


CONSENSUS_SCENARIOS = [
    sc_single_validator_commits_blocks,
    sc_four_validators_commit_and_agree,
    sc_net_with_txs_delivers_to_all_apps,
    sc_validator_absent_still_commits,
    sc_round_advances_without_proposer,
    sc_validator_set_changes_through_end_block,
    sc_invalid_app_validator_update_fails_loudly,
    sc_heartbeat_sent_while_waiting_for_txs,
    sc_bad_proposal_rejected_and_prevotes_nil,
    sc_conflicting_precommit_for_claimed_maj23_block_commits,
    sc_proposer_rotates_across_heights,
    sc_proposer_rotates_per_round_on_nil_votes,
]


@pytest.mark.parametrize("scenario", CONSENSUS_SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_consensus_scenario_matches_jax(scenario):
    out = {}
    for P in PKGS:
        ticking_clocks()
        try:
            out[P.name] = scenario(P)
        finally:
            P.clock.set_source(None)
    assert out["port"] == out["jax"]


# ----------------------------------------- tests/test_pol_safety.py's five

POL_CHAIN = "pol-test"


class Script:
    """One scripted node: the height-1 round-0 proposer of a 4-validator
    set, the other three scripted keys whose votes the test forges."""

    def __init__(self, P):
        self.P = P
        keys = make_keys(P, 4)
        gen = genesis(P, keys, POL_CHAIN)
        cs = make_node(P, gen, keys[0])
        cs.start()
        cs.ticker.fire_next()
        prop = cs.rs.validators.proposer().address
        key = next(k for k in keys if k.pubkey.address == prop)
        cs = make_node(P, gen, key)
        self.cs = cs
        self.others = [k for k in keys
                       if k.pubkey.address != key.pubkey.address]
        self.own_votes = []
        cs.broadcast_hooks.append(
            lambda m: self.own_votes.append(m["vote"])
            if m.get("type") == "vote" else None)
        cs.start()
        cs.ticker.fire_next()

    def inject_vote(self, key, type_, round_, block_id=None):
        P, rs = self.P, self.cs.rs
        idx, _ = rs.validators.get_by_address(key.pubkey.address)
        bid = block_id if block_id is not None else P.blk.BlockID()
        v = P.vote.Vote(key.pubkey.address, idx, rs.height, round_,
                        1000 + round_, type_, bid)
        v.signature = key.sign(v.sign_bytes(POL_CHAIN))
        self.cs.submit({"type": "vote", "vote": v.to_obj()},
                       peer_id="scripted")

    def own_last(self, type_, round_):
        for v in reversed(self.own_votes):
            if v["type"] == type_ and v["round"] == round_:
                return v
        return None

    def proposal_block_id(self):
        rs = self.cs.rs
        return self.P.blk.BlockID(rs.proposal_block.hash(),
                                  rs.proposal_block_parts.header())

    def outcome(self):
        rs = self.cs.rs
        return outcome([self.cs]) + [
            self.P.enc.cdumps(self.own_votes), rs.locked_round,
            rs.locked_block.hash() if rs.locked_block else None]


def _lock_in_round0(s):
    VT = s.P.vote.VoteType
    cs = s.cs
    bid = s.proposal_block_id()
    for k in s.others[:2]:
        s.inject_vote(k, VT.PREVOTE, 0, bid)
    assert cs.rs.locked_block.hash() == bid.hash and cs.rs.locked_round == 0
    for k in s.others[:2]:
        s.inject_vote(k, VT.PRECOMMIT, 0)
    assert cs.ticker.fire_next() is not None
    assert cs.rs.round == 1
    return bid


def pol_lock_no_pol_prevote_locked_block(s):
    VT = s.P.vote.VoteType
    bid = _lock_in_round0(s)
    if s.own_last(VT.PREVOTE, 1) is None:
        s.cs.ticker.fire_next()
    assert bytes.fromhex(s.own_last(VT.PREVOTE, 1)["block_id"]["hash"]) \
        == bid.hash
    for k in s.others[:2]:
        s.inject_vote(k, VT.PREVOTE, 1)
    s.cs.ticker.fire_next()
    assert s.own_last(VT.PRECOMMIT, 1)["block_id"]["hash"] == ""
    assert s.cs.rs.locked_block.hash() == bid.hash


def pol_relock_on_newer_polka_same_block(s):
    VT = s.P.vote.VoteType
    bid = _lock_in_round0(s)
    if s.own_last(VT.PREVOTE, 1) is None:
        s.cs.ticker.fire_next()
    for k in s.others[:2]:
        s.inject_vote(k, VT.PREVOTE, 1, bid)
    assert bytes.fromhex(s.own_last(VT.PRECOMMIT, 1)["block_id"]["hash"]) \
        == bid.hash
    assert s.cs.rs.locked_round == 1


def pol_unlock_on_nil_polka(s):
    VT = s.P.vote.VoteType
    _lock_in_round0(s)
    for k in s.others:
        s.inject_vote(k, VT.PREVOTE, 1)
    assert s.cs.rs.locked_block is None
    assert s.own_last(VT.PRECOMMIT, 1)["block_id"]["hash"] == ""


def pol_no_unlock_on_older_round_votes(s):
    VT = s.P.vote.VoteType
    bid = _lock_in_round0(s)
    s.inject_vote(s.others[2], VT.PREVOTE, 0)
    assert s.cs.rs.locked_block.hash() == bid.hash


def pol_halt_commits_from_older_round_on_late_precommit(s):
    VT = s.P.vote.VoteType
    cs = s.cs
    bid = s.proposal_block_id()
    for k in s.others[:2]:
        s.inject_vote(k, VT.PREVOTE, 0, bid)
    s.inject_vote(s.others[0], VT.PRECOMMIT, 0, bid)
    s.inject_vote(s.others[1], VT.PRECOMMIT, 0)
    cs.ticker.fire_next()
    assert cs.rs.round == 1 and cs.state.last_block_height == 0
    if s.own_last(VT.PREVOTE, 1) is None:
        cs.ticker.fire_next()
    s.inject_vote(s.others[2], VT.PRECOMMIT, 0, bid)
    cs.ticker.fire_next()
    assert cs.state.last_block_height == 1
    assert cs.state.last_block_id.hash == bid.hash


POL_SCENARIOS = [
    pol_lock_no_pol_prevote_locked_block,
    pol_relock_on_newer_polka_same_block,
    pol_unlock_on_nil_polka,
    pol_no_unlock_on_older_round_votes,
    pol_halt_commits_from_older_round_on_late_precommit,
]


@pytest.mark.parametrize("scenario", POL_SCENARIOS,
                         ids=lambda f: f.__name__[4:])
def test_pol_scenario_matches_jax(scenario):
    out = {}
    for P in PKGS:
        ticking_clocks()
        try:
            s = Script(P)
            scenario(s)
            out[P.name] = s.outcome()
        finally:
            P.clock.set_source(None)
    assert out["port"] == out["jax"]


# ------------------------------------------------------------- vote_agg

def _agg_setup(P, verifier):
    """A 4-validator node that is NOT the round-0 proposer, holding the
    proposer's block: returns (node, keys, block id)."""
    keys = make_keys(P, 4)
    gen = genesis(P, keys, "agg-test")
    probe = make_node(P, gen, keys[0])
    prop_addr = probe.rs.validators.proposer().address
    me = next(k for k in keys if k.pubkey.address != prop_addr)
    cs = make_node(P, gen, me)
    if verifier is not None:
        cs.block_exec.verifier = verifier
        cs.rs.votes = P.cons.HeightVoteSet(
            cs.state.chain_id, 1, cs.state.validators, verifier=verifier)
    cs.start()
    cs.ticker.fire_next()
    block = cs.state.make_block(1, [b"agg=1"], P.blk.Commit(),
                                time_ns=10 ** 9)
    parts = block.make_part_set(
        cs.state.consensus_params.block_gossip.block_part_size_bytes)
    prop = P.prop.Proposal(1, 0, parts.header(), timestamp_ns=5)
    prop_key = next(k for k in keys if k.pubkey.address == prop_addr)
    prop.signature = prop_key.sign(prop.sign_bytes("agg-test"))
    cs.submit({"type": "proposal", "proposal": prop.to_obj()}, "px")
    for i in range(parts.total):
        cs.submit({"type": "block_part", "height": 1, "round": 0,
                   "part": parts.get_part(i).to_obj()}, "px")
    return cs, keys, P.blk.BlockID(block.hash(), parts.header())


def _agg_votes(P, cs, keys, bid, type_, forged=()):
    """The other validators' signed votes for `bid`; those at the
    positions in `forged` carry a flipped signature byte."""
    others = [k for k in keys
              if k.pubkey.address != cs.priv_validator.address]
    out = []
    for j, k in enumerate(others):
        i, _ = cs.rs.validators.get_by_address(k.pubkey.address)
        v = P.vote.Vote(k.pubkey.address, i, 1, 0, 50 + j, type_, bid)
        v.signature = k.sign(v.sign_bytes("agg-test"))
        if j in forged:
            v.signature = v.signature[:5] + bytes([v.signature[5] ^ 1]) + \
                v.signature[6:]
        out.append(v.to_obj())
    return out


def _agg_run(P, verifier, forged):
    VT = P.vote.VoteType
    cs, keys, bid = _agg_setup(P, verifier)
    steps = []
    cs.broadcast_hooks.append(
        lambda m: steps.append((m["type"], m.get("height"), m.get("round"),
                                m.get("step"))) if m["type"] in
        ("new_round_step", "has_vote") else None)
    cs.submit({"type": "vote_agg",
               "votes": _agg_votes(P, cs, keys, bid, VT.PREVOTE, forged)},
              "px")
    pv = cs.rs.votes.prevotes(0)
    sets = [[None if v is None else P.enc.cdumps(v.to_obj())
             for v in pv.votes]]
    cs.submit({"type": "vote_agg",
               "votes": _agg_votes(P, cs, keys, bid, VT.PRECOMMIT)}, "px")
    return outcome([cs]) + [sets, steps]


@pytest.mark.parametrize("forged", [(), (2,)], ids=["clean", "forged"])
def test_vote_agg_matches_jax(clocks, forged):
    """A grouped prevote message (one signature forged in the second
    case), then a grouped precommit message, into both packages'
    ConsensusStates: the same vote sets, step transitions and commit."""
    out = {}
    for P in PKGS:
        ticking_clocks()
        out[P.name] = _agg_run(P, None, forged)
    assert out["port"] == out["jax"]
    assert out["port"][0][1] == 1  # committed height 1


def test_vote_agg_group_on_the_batch_path(clocks):
    """One vote_agg group through HeightVoteSet.add_votes on the port's
    batch path (BatchVerifier("cuda", device="cpu"): host prep and the
    plain kernels) gives what the host loop gives, and one verifier
    call for the group."""
    VT = PORT.vote.VoteType
    batch = tverifier.BatchVerifier("cuda", device="cpu")
    ticking_clocks()
    cs, keys, bid = _agg_setup(PORT, batch)
    calls = batch.stats["calls"]
    results, errors = cs.rs.votes.add_votes(
        0, VT.PREVOTE,
        [PORT.vote.Vote.from_obj(o)
         for o in _agg_votes(PORT, cs, keys, bid, VT.PREVOTE, (1,))], "px")
    assert batch.stats["calls"] == calls + 1
    ticking_clocks()
    cs2, keys2, bid2 = _agg_setup(PORT, None)
    results2, errors2 = cs2.rs.votes.add_votes(
        0, VT.PREVOTE,
        [PORT.vote.Vote.from_obj(o)
         for o in _agg_votes(PORT, cs2, keys2, bid2, VT.PREVOTE, (1,))],
        "px")
    assert results == results2 == [True, False, True]
    assert [(p, str(e)) for p, e in errors] == \
        [(p, str(e)) for p, e in errors2]


def test_proposal_check_on_the_batch_path(clocks):
    """A proposal's signature through the port's batch path on the CPU:
    a good one is taken, a forged one refused with the JAX package's
    outcome."""
    batch = tverifier.BatchVerifier("cuda", device="cpu")
    keys = make_keys(PORT, 2)
    gen = genesis(PORT, keys, "prop-batch")
    prop_addr = make_node(PORT, gen).rs.validators.proposer().address
    prop_key = next(k for k in keys if k.pubkey.address == prop_addr)
    other = next(k for k in keys if k is not prop_key)
    node = make_node(PORT, gen, other)
    node.block_exec.verifier = batch
    node.start()
    node.ticker.fire_next()
    block = node.state.make_block(1, [], PORT.blk.Commit(), time_ns=1)
    parts = block.make_part_set(4096)
    calls = batch.stats["cuda_sigs"]
    for signer, accepted in ((other, False), (prop_key, True)):
        p = PORT.prop.Proposal(1, 0, parts.header(), timestamp_ns=5)
        p.signature = signer.sign(p.sign_bytes("prop-batch"))
        node.submit({"type": "proposal", "proposal": p.to_obj()}, "px")
        assert (node.rs.proposal is not None) is accepted
    assert batch.stats["cuda_sigs"] == calls + 2


# ------------------------------------------- the 4-node net, stepped clock

class JaxTestnet:
    """The port's consensus.testnet.Testnet, built of the JAX package:
    the same keys, stores, mempools, evidence pools, event buses, WALs
    and relay, driven the same way."""

    def __init__(self, home):
        P = JAX
        self.keys = make_keys(P, ttestnet.N_VALS)
        self.gen = genesis(P, self.keys, ttestnet.CHAIN_ID)
        self.home, self.file_nodes = home, {ttestnet.FILE_NODE}
        self.live = [True] * ttestnet.N_VALS
        self.nodes = [self._build(i) for i in range(ttestnet.N_VALS)]
        for i, node in enumerate(self.nodes):
            node.cs.broadcast_hooks.append(self._relay_from(i))

    def _build(self, i):
        P, on_file = JAX, i in self.file_nodes
        node = SimpleNamespace(index=i, key=self.keys[i])

        def db(name):
            if not on_file:
                return P.db.MemDB()
            d = os.path.join(self.home, f"node{i}", "data")
            os.makedirs(d, exist_ok=True)
            return P.db.SQLiteDB(os.path.join(d, name + ".db"))
        node.block_store = P.bs.BlockStore(db("blockstore"))
        node.state_store = P.ss.StateStore(db("state"))
        node.app = P.app()
        node.conns = P.proxy.AppConns(P.proxy.local_client_creator(node.app))
        state = P.replay.Handshaker(node.state_store, node.block_store,
                                    self.gen).handshake(node.conns)
        node.mempool = P.mempool.Mempool(
            node.conns.mempool, height=state.last_block_height,
            wal_dir=os.path.join(self.home, f"node{i}", "data",
                                 "mempool.wal") if on_file else None)
        node.evidence_pool = P.evpool.EvidencePool(
            P.evstore.EvidenceStore(db("evidence")), state,
            state_store=node.state_store)
        node.event_bus = P.events.EventBus()
        node.block_exec = P.exe.BlockExecutor(
            node.state_store, node.conns.consensus, mempool=node.mempool,
            evidence_pool=node.evidence_pool, event_bus=node.event_bus)
        node.wal = (P.wal.WAL(os.path.join(self.home, f"node{i}", "data",
                                           "cs.wal", "wal"))
                    if on_file else P.wal.NilWAL())
        config = P.config.test_config().consensus
        config.max_block_size_txs = ttestnet.MAX_BLOCK_TXS
        node.cs = P.cons.ConsensusState(
            config, state, node.block_exec, node.block_store,
            mempool=node.mempool, evidence_pool=node.evidence_pool,
            priv_validator=P.pv.PrivValidator(P.pv.LocalSigner(node.key)),
            wal=node.wal, event_bus=node.event_bus,
            ticker_factory=P.cons.MockTicker)
        return node

    def _relay_from(self, i):
        def relay(msg):
            if msg["type"] not in ("proposal", "block_part", "vote"):
                return
            for j, dst in enumerate(self.nodes):
                if j != i and self.live[j]:
                    dst.cs.submit(dict(msg), peer_id=f"node{i}")
        return relay

    def start(self):
        for node in self.nodes:
            node.cs.start()

    def heights(self):
        return [n.cs.state.last_block_height for i, n in
                enumerate(self.nodes) if self.live[i]]

    def run_until(self, height):
        for _ in range(ttestnet.MAX_TICKS):
            for i, node in enumerate(self.nodes):
                if min(self.heights()) >= height:
                    return
                if self.live[i]:
                    node.cs.ticker.fire_next()
        raise AssertionError(f"net did not reach {height}: {self.heights()}")

    def feed(self, txs):
        for i, node in enumerate(self.nodes):
            if self.live[i]:
                assert all(r.ok for r in node.mempool.check_tx_batch(txs))

    def stop_node(self, i):
        node = self.nodes[i]
        self.live[i] = False
        node.cs.stop()
        node.wal.close()
        node.mempool.close()

    def restart_node(self, i):
        node = self._build(i)
        self.nodes[i] = node
        n = JAX.replay.catchup_replay(node.cs, node.wal)
        node.cs.broadcast_hooks.append(self._relay_from(i))
        self.live[i] = True
        node.cs.start()
        return n

    def close(self):
        for i, node in enumerate(self.nodes):
            if self.live[i]:
                self.stop_node(i)


# chip_smoke.py's consensus schedule, cut to 10 heights of 50 txs
NET = ttestnet.Schedule(heights=10, txs=50, join_at=3, leave_at=6,
                        equivocate_at=5, forge_at=7, restart_after=8)


def drive_net(P, net, standby):
    """ttestnet.run_schedule, as chip_smoke.py's consensus phase runs it,
    through NET: the standby key joins at 3 and leaves at 6, validator 1
    equivocates at 5 (to nodes 0, 2 and 3), a forged prevote reaches
    node 0 at 7, node 3 crashes and restarts after 8; then the net
    drains the mempools. Returns what the comparison reads."""
    T = [T0]
    P.clock.set_source(lambda: T[0])
    subs = {name: net.nodes[0].event_bus.subscribe(
        "probe", f"tm.event = '{name}'", capacity=100000)
        for name in ("NewBlock", "Tx", "Vote")}
    net.start()
    fed = []
    replayed = forged_refused = None
    for h, refused in ttestnet.run_schedule(net, NET, standby, T, fed):
        if refused is not None:
            forged_refused = refused
        if h == NET.restart_after:
            net.stop_node(ttestnet.FILE_NODE)
            replayed = net.restart_node(ttestnet.FILE_NODE)
    P.clock.set_source(None)
    assert not any(n.mempool.size() for n in net.nodes)
    node0 = net.nodes[0]
    blocks = [node0.block_store.load_block(h)
              for h in range(1, node0.block_store.height() + 1)]
    committed = [tx for b in blocks for tx in b.data.txs]
    assert sorted(committed) == sorted(fed)
    evidence = [P.enc.cdumps(ev.to_obj()) for b in blocks
                for ev in b.evidence.evidence]
    assert len(evidence) == 1
    events = []
    for name, sub in subs.items():
        while not sub.empty():
            it = sub.get_nowait()
            d = it.data
            if name == "NewBlock":
                payload = (d["block"].to_bytes(), d["block_id"].to_obj())
            elif name == "Tx":
                payload = (d["height"], d["index"], d["tx"],
                           d["result"].to_obj())
            else:
                payload = d["vote"].to_obj()
            events.append((name, P.enc.cdumps(it.tags), payload))
    assert net.nodes[0].event_bus.dropped_total == 0
    node3 = net.nodes[3]
    rows = {name: list(db.iterate()) for name, db in
            (("block", node3.block_store.db), ("state", node3.state_store.db))}
    with open(os.path.join(net.home, "node3", "data", "cs.wal", "wal"),
              "rb") as f:
        wal = f.read()
    out = {"blocks": [b.to_bytes() for b in blocks],
           "states": [P.enc.cdumps(n.cs.state.to_obj()) for n in net.nodes],
           "app_hashes": [n.app.app_hash for n in net.nodes],
           "steps": [(n.cs.rs.height, n.cs.rs.round, int(n.cs.rs.step))
                     for n in net.nodes],
           "evidence": evidence, "events": events, "rows": rows,
           "wal": wal, "replayed": replayed, "forged_refused": forged_refused,
           "validators": [len(n.cs.state.validators) for n in net.nodes]}
    net.close()
    return out


@pytest.fixture(scope="module")
def port_net(tmp_path_factory):
    home = str(tmp_path_factory.mktemp("port_net"))
    # the serial path, as the JAX net of the comparisons below runs it
    # (tests/test_torch_pipeline.py holds the pipelined net)
    tpipeline.configure("off")
    try:
        net = ttestnet.Testnet(verifier_of=lambda i: _PY, home=home,
                               file_nodes=(ttestnet.FILE_NODE,))
        return drive_net(PORT, net, ttestnet.standby_key())
    finally:
        tpipeline.configure("auto")


def _jax_net(tmp_path_factory, name):
    home = str(tmp_path_factory.mktemp(name))
    standby = JAX.keys.PrivKey.generate(bytes([200, 1]) * 16)
    return drive_net(JAX, JaxTestnet(home), standby)


def test_net_matches_jax_block_for_block(port_net, tmp_path_factory):
    """Blocks, every node's State, app hashes, final steps, the committed
    evidence, node 3's store rows and its WAL file, byte for byte."""
    jax_net = _jax_net(tmp_path_factory, "jax_net")
    for key in ("blocks", "states", "app_hashes", "steps", "evidence",
                "rows", "validators", "replayed", "forged_refused"):
        assert port_net[key] == jax_net[key], key
    assert port_net["wal"] == jax_net["wal"]
    assert len(port_net["blocks"]) >= NET.heights
    assert port_net["forged_refused"] is True


def test_net_events_match_jax(port_net, tmp_path_factory):
    """NewBlock, Tx and Vote events of node 0: tags and payloads."""
    jax_net = _jax_net(tmp_path_factory, "jax_events")
    names = [e[0] for e in port_net["events"]]
    assert names.count("Tx") == sum(
        len(tblock.Block.from_bytes(b).data.txs) for b in port_net["blocks"])
    assert port_net["events"] == jax_net["events"]


def test_net_matches_jax_with_its_pipeline_on(port_net, tmp_path_factory,
                                              monkeypatch):
    """The JAX package's default (pipelined finalize, precompute,
    streaming part sets) gives the same chain bytes."""
    monkeypatch.delenv("TM_TPU_PIPELINE", raising=False)
    jax_net = _jax_net(tmp_path_factory, "jax_pipelined")
    for key in ("blocks", "states", "app_hashes", "evidence"):
        assert port_net[key] == jax_net[key], key
