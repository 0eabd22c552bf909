"""The port's reactors (consensus, mempool, evidence, blockchain) and its
socket nets against the JAX package's, on the CPU, tolerance 0.

- Message parity: both packages' ConsensusReactor on the same RoundState
  (4 validators at height 3 built through each package's ConsensusState
  on the same genesis, keys, txs and clock, with an in-process relay)
  and a capturing fake peer: the STATE, DATA and VOTE messages of the
  data and votes gossip passes are the same bytes for a peer at the tip,
  one height behind and two behind, with compact and vote_agg on and
  with both off. A sequence of every message type through `receive`
  submits the same inputs to the state machine, answers the same bytes
  and leaves the same PeerRoundState. The mempool reactor's broadcast
  walk and the evidence reactor send the same bytes for the same
  contents, and refuse bad messages with the same errors.
- ConsensusState.logger: switch_to_consensus over a WAL without the
  synced height's marker logs that the replay was skipped.
- Nets over encrypted TCP, each waiting at most 30 s a step:
  1. four port nodes over make_connected_switches commit 5 heights with
     txs and agree on block hashes and State bytes (app hash included);
  2. two JAX nodes and two port nodes on one mesh reach height 3 and
     agree on every block and app hash (the end-to-end wire parity);
  3. a port node with fast_sync=True syncs from a JAX peer by 4-block
     windows, switches to consensus, and its State bytes equal the
     source's;
  4. a validator whose links are dropped rejoins by persistent redial and
     catches up by gossip.
  The nets run config 1's socket timeouts (socknet.bench_config, propose
  400 ms + 100 a round): test_config's 100 ms propose with 1 ms a round
  lets a GIL-bound in-process socket net fall into rounds that its
  message latency never catches up with.

Both packages run with their pipeline off (TM_TPU_PIPELINE=off, and the
port's pipeline "off"): the serial path. Port nodes verify on BatchVerifier("auto",
device="cpu"): the host loop at these batch sizes.
"""

import logging
import threading
import time
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.abci.proxy import AppConns as JAppConns
from tendermint_tpu.abci.proxy import local_client_creator as jlcc
from tendermint_tpu.blockchain.reactor import BlockchainReactor as JBcReactor
from tendermint_tpu.config import test_config as jtest_config
from tendermint_tpu.consensus import reactor as jreactor
from tendermint_tpu.consensus.replay import Handshaker as JHandshaker
from tendermint_tpu.consensus.state import ConsensusState as JCS
from tendermint_tpu.consensus.ticker import MockTicker as JMockTicker
from tendermint_tpu.evidence.pool import EvidencePool as JEvPool
from tendermint_tpu.evidence.reactor import EvidenceReactor as JEvReactor
from tendermint_tpu.evidence.store import EvidenceStore as JEvStore
from tendermint_tpu.mempool.mempool import Mempool as JMempool
from tendermint_tpu.mempool.reactor import MempoolReactor as JMpReactor
from tendermint_tpu.p2p import NodeInfo as JNodeInfo
from tendermint_tpu.p2p import NodeKey as JNodeKey
from tendermint_tpu.p2p import Switch as JSwitch
from tendermint_tpu.state.execution import BlockExecutor as JBlockExecutor
from tendermint_tpu.storage import BlockStore as JBlockStore
from tendermint_tpu.storage import MemDB as JMemDB
from tendermint_tpu.storage import StateStore as JStateStore
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu.types.block import BlockID as JBlockID
from tendermint_tpu.types.evidence import DuplicateVoteEvidence as JDVE
from tendermint_tpu.types.events import EventBus as JEventBus
from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc
from tendermint_tpu.types.genesis import GenesisValidator as JGenVal
from tendermint_tpu.types.keys import PrivKey as JPrivKey
from tendermint_tpu.types.priv_validator import LocalSigner as JLocalSigner
from tendermint_tpu.types.priv_validator import PrivValidator as JPrivVal
from tendermint_tpu.types.proposal import Heartbeat as JHeartbeat
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu.utils import clock as jclock
from tendermint_tpu_torch import pipeline as tpipeline
from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.config import test_config as ttest_config
from tendermint_tpu_torch.consensus import reactor as treactor
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import MockTicker
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
from tendermint_tpu_torch.evidence.store import EvidenceStore
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.models.verifier import BatchVerifier
from tendermint_tpu_torch.p2p import socknet
from tendermint_tpu_torch.p2p.test_util import make_connected_switches
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage import BlockStore, MemDB, StateStore
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.types.block import BlockID
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.priv_validator import (LocalSigner,
                                                       PrivValidator)
from tendermint_tpu_torch.types.proposal import Heartbeat
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.utils import clock as tclock

torch.set_num_threads(1)

WAIT_S = 30.0
T0 = 1_700_000_000 * 10 ** 9
CHAIN = "reactor-parity"
TXS_A_HEIGHT = 40
CPU = BatchVerifier("auto", device="cpu")

JAX = SimpleNamespace(
    name="jax", PrivKey=JPrivKey, GenesisDoc=JGenesisDoc, GenVal=JGenVal,
    app=jkv.KVStoreApp, AppConns=JAppConns,
    lcc=jlcc, MemDB=JMemDB, StateStore=JStateStore, BlockStore=JBlockStore,
    Handshaker=JHandshaker, Mempool=JMempool, EvPool=JEvPool,
    EvStore=JEvStore, EventBus=JEventBus, BlockExecutor=JBlockExecutor,
    CS=JCS, MockTicker=JMockTicker, PrivVal=JPrivVal, Signer=JLocalSigner,
    config=jtest_config, reactor=jreactor, Vote=JVote, BlockID=JBlockID,
    DVE=JDVE, Heartbeat=JHeartbeat, MpReactor=JMpReactor,
    EvReactor=JEvReactor, enc=jenc, clock=jclock, vkw={})
PORT = SimpleNamespace(
    name="port", PrivKey=PrivKey, GenesisDoc=GenesisDoc,
    GenVal=GenesisValidator, app=KVStoreApp, AppConns=AppConns,
    lcc=local_client_creator, MemDB=MemDB, StateStore=StateStore,
    BlockStore=BlockStore, Handshaker=Handshaker, Mempool=Mempool,
    EvPool=EvidencePool, EvStore=EvidenceStore, EventBus=EventBus,
    BlockExecutor=BlockExecutor, CS=ConsensusState, MockTicker=MockTicker,
    PrivVal=PrivValidator, Signer=LocalSigner, config=ttest_config,
    reactor=treactor, Vote=Vote, BlockID=BlockID, DVE=DuplicateVoteEvidence,
    Heartbeat=Heartbeat, MpReactor=MempoolReactor, EvReactor=EvidenceReactor,
    enc=tenc, clock=tclock, vkw={"verifier": CPU})
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def serial_pipeline(monkeypatch):
    """Both packages' ConsensusStates on their serial path."""
    monkeypatch.setenv("TM_TPU_PIPELINE", "off")
    monkeypatch.setattr(tpipeline, "_configured", "off")


def wait_for(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _txs(h):
    return [b"r%d/k%d=v%d" % (h, i, i * h) for i in range(TXS_A_HEIGHT)]


# --------------------------------------------------- a relay net, per package

class RelayNet:
    """4 validators of package P on MockTickers, relayed in process
    (proposals, parts and votes to every live node), each with a kvstore
    app, a mempool, an evidence pool and an event bus; the JAX package's
    consensus tests' wiring, the port's consensus.testnet's."""

    def __init__(self, P, compact=True, vote_agg=True):
        self.P = P
        self.keys = [P.PrivKey.generate(bytes([i + 1]) * 32)
                     for i in range(4)]
        self.gen = P.GenesisDoc(chain_id=CHAIN, genesis_time_ns=1,
                                validators=[P.GenVal(k.pubkey.ed25519, 10)
                                            for k in self.keys])
        self.live = [True] * 4
        self.nodes = [self._build(k, compact, vote_agg) for k in self.keys]
        for i, n in enumerate(self.nodes):
            n.cs.broadcast_hooks.append(self._relay(i))

    def _build(self, key, compact, vote_agg):
        P = self.P
        n = SimpleNamespace(key=key, app=P.app())
        conns = P.AppConns(P.lcc(n.app))
        n.state_store = P.StateStore(P.MemDB())
        n.block_store = P.BlockStore(P.MemDB())
        state = P.Handshaker(n.state_store, n.block_store, self.gen,
                             **P.vkw).handshake(conns)
        n.mempool = P.Mempool(conns.mempool, height=state.last_block_height)
        n.evidence_pool = P.EvPool(P.EvStore(P.MemDB()), state,
                                   state_store=n.state_store, **P.vkw)
        n.event_bus = P.EventBus()
        exe = P.BlockExecutor(n.state_store, conns.consensus,
                              mempool=n.mempool,
                              evidence_pool=n.evidence_pool,
                              event_bus=n.event_bus, **P.vkw)
        cfg = P.config().consensus
        if P is PORT:
            cfg.compact, cfg.vote_agg = compact, vote_agg
        n.cs = P.CS(cfg, state, exe, n.block_store, mempool=n.mempool,
                    evidence_pool=n.evidence_pool,
                    priv_validator=P.PrivVal(P.Signer(key)),
                    event_bus=n.event_bus, ticker_factory=P.MockTicker)
        return n

    def _relay(self, i):
        def relay(msg):
            if msg["type"] not in ("proposal", "block_part", "vote"):
                return
            for j, dst in enumerate(self.nodes):
                if j != i and self.live[j]:
                    dst.cs.submit(dict(msg), peer_id=f"node{i}")
        return relay

    def run_until(self, h):
        """Fire one node at a time until every node has committed h: no
        node enters h + 1 before the caller feeds it."""
        for _ in range(400):
            for i, n in enumerate(self.nodes):
                if all(x.cs.state.last_block_height >= h
                       for x in self.nodes):
                    return
                if self.live[i]:
                    n.cs.ticker.fire_next()
        raise AssertionError(f"relay net stuck below {h}")

    def feed(self, txs):
        for n in self.nodes:
            assert all(r.ok for r in n.mempool.check_tx_batch(txs))

    def proposer(self):
        addr = self.nodes[0].cs.rs.validators.proposer().address
        return next(i for i, k in enumerate(self.keys)
                    if k.pubkey.address == addr)

    def close(self):
        for n in self.nodes:
            n.cs.stop()


def tip_state(P, monkeypatch, compact, vote_agg):
    """The net of package P after heights 1-2 with txs, in height 3: the
    proposer and node `me` have entered round 0 with the proposal (so
    `me` holds the proposal, its block and two prevotes), and `lagger`
    (no proposer) has seen nothing of height 3."""
    on = lambda b: "on" if b else "off"  # noqa: E731
    monkeypatch.setenv("TM_TPU_COMPACT", on(compact))
    monkeypatch.setenv("TM_TPU_VOTE_AGG", on(vote_agg))
    T = [T0]
    P.clock.set_source(lambda: T[0])
    net = RelayNet(P, compact, vote_agg)
    for n in net.nodes:
        n.cs.start()
    for h in (1, 2):
        T[0] += 10 ** 9
        net.feed(_txs(h))
        net.run_until(h)
    T[0] += 10 ** 9
    net.feed(_txs(3))
    prop = net.proposer()
    me = next(i for i in range(4) if i != prop)
    lagger = next(i for i in range(4) if i not in (prop, me))
    net.live[lagger] = False
    net.nodes[prop].cs.ticker.fire_next()
    net.nodes[me].cs.ticker.fire_next()
    rs = net.nodes[me].cs.rs
    assert rs.height == 3 and rs.proposal is not None
    assert rs.proposal_block is not None
    assert net.nodes[lagger].cs.rs.proposal is None
    return net, me, lagger, T


@pytest.fixture
def clocks():
    yield
    for P in PKGS:
        P.clock.set_source(None)


class FakePeer:
    """A peer that records what reactors send it."""

    def __init__(self, pid, caps=(), running=True):
        self.id = pid
        self.node_info = SimpleNamespace(other=list(caps))
        self.running = running
        self.sent = []
        self._data = {}

    def send(self, ch, msg):
        self.sent.append((ch, bytes(msg)))
        return True

    try_send = send

    def send_obj(self, ch, obj):
        return self.send(ch, tenc.cdumps(obj))

    try_send_obj = send_obj

    def get(self, k):
        return self._data.get(k)

    def set(self, k, v):
        self._data[k] = v


class FakeSwitch:
    def __init__(self):
        self.stopped, self.broadcasts = [], []
        self.peers = SimpleNamespace(get=lambda pid: None)

    def stop_peer_for_error(self, peer, err):
        self.stopped.append((peer.id, type(err).__name__, str(err)))

    def broadcast_obj(self, ch, obj):
        self.broadcasts.append((ch, tenc.cdumps(obj)))


def _reactor(P, node):
    r = P.reactor.ConsensusReactor(node.cs, gossip_sleep_s=0.005)
    r.switch = FakeSwitch()
    return r


def _attach(P, r, peer, height, round_, step):
    """Register `peer` with reactor r as add_peer would, without its
    gossip threads, at the given round step."""
    ps = P.reactor.PeerRoundState()
    ps.caps = (("compact/1" in peer.node_info.other),
               ("voteagg/1" in peer.node_info.other))
    r.peer_states[peer.id] = ps
    peer.set("consensus_peer_state", ps)
    ps.apply_new_round_step({"type": "new_round_step", "height": height,
                             "round": round_, "step": step,
                             "last_commit_round": 0})
    return ps


def _passes(r, peer, ps):
    """Data passes until one sends nothing, then votes passes likewise;
    -> the bytes sent."""
    for _ in range(500):
        if not r._gossip_data_pass(peer, ps):
            break
    st = {"idle": 0}
    for _ in range(500):
        if not r._gossip_votes_pass(peer, ps, st):
            break
    return list(peer.sent)


CAPS = ("compact/1", "voteagg/1")


@pytest.mark.parametrize("planes", [(True, True), (False, False)],
                         ids=["compact+voteagg", "legacy"])
@pytest.mark.parametrize("behind", [0, 1, 2])
def test_gossip_passes_send_the_jax_bytes(monkeypatch, clocks, planes,
                                          behind):
    sent = {}
    for P in PKGS:
        net, me, _, _ = tip_state(P, monkeypatch, *planes)
        try:
            r = _reactor(P, net.nodes[me])
            peer = FakePeer("ff" * 20, caps=CAPS if planes[0] else ())
            ps = _attach(P, r, peer, 3 - behind, 0, 3)
            sent[P.name] = _passes(r, peer, ps)
        finally:
            net.close()
    assert sent["port"] == sent["jax"]
    assert sent["port"], "the passes sent nothing"
    kinds = [tenc.cloads(m)["type"] for _, m in sent["port"]]
    if behind == 0:
        assert kinds[0] == "proposal"
        assert ("compact_block" in kinds) == planes[0]
        assert ("vote_agg" in kinds) == planes[1]
    else:
        assert "block_part" in kinds and "proposal" not in kinds


def _receive_script(P, net, me, lagger):
    """(reactor node, channel, message) in order: what a peer holding
    height 3's proposal sends the lagger, then what a reconstructing
    peer sends `me`."""
    rs = net.nodes[me].cs.rs
    lag_rs = net.nodes[lagger].cs.rs
    votes = [v.to_obj() for v in rs.votes.prevotes(0).votes if v]
    parts = rs.proposal_block_parts
    r_me = _reactor(P, net.nodes[me])
    with net.nodes[me].cs._lock:
        compact = r_me._build_compact_locked(rs)
    k = net.keys[lagger]
    idx, _ = lag_rs.validators.get_by_address(k.pubkey.address)
    hb = P.Heartbeat(k.pubkey.address, idx, 3, 0, 1)
    hb.signature = k.sign(hb.sign_bytes(CHAIN))
    maj_bid = votes[0]["block_id"]
    L, M = "lagger", "me"
    return r_me, [
        (L, 0x20, {"type": "new_round_step", "height": 3, "round": 0,
                   "step": 3, "last_commit_round": 0}),
        (L, 0x20, {"type": "has_vote", "height": 3, "round": 0,
                   "vote_type": 1, "index": 2}),
        (L, 0x23, {"type": "vote_set_bits", "height": 3, "round": 0,
                   "vote_type": 1, "block_id": maj_bid, "indices": [0, 1]}),
        (L, 0x21, {"type": "proposal", "proposal": rs.proposal.to_obj()}),
        (L, 0x21, compact),
        (L, 0x21, {"type": "block_part", "height": 3, "round": 0,
                   "part": parts.get_part(0).to_obj()}),
        (L, 0x22, {"type": "vote", "vote": votes[0]}),
        (L, 0x22, {"type": "vote_agg", "votes": votes}),
        (L, 0x22, {"type": "vote_agg", "votes": []}),
        (L, 0x20, {"type": "vote_set_maj23", "height": 3, "round": 0,
                   "vote_type": 1, "block_id": maj_bid}),
        (L, 0x20, {"type": "vote_set_maj23", "height": 3, "round": 0,
                   "vote_type": 9, "block_id": maj_bid}),
        (L, 0x20, {"type": "heartbeat", "heartbeat": hb.to_obj()}),
        (L, 0x20, {"type": "heartbeat", "heartbeat": hb.to_obj()}),
        (L, 0x20, {"type": "commit_step", "height": 3, "parts_total":
                   parts.total}),
        (L, 0x21, {"type": "tx_fetch_reply", "height": 3, "round": 0,
                   "txs": [[0, "00"]]}),
        (M, 0x21, {"type": "tx_fetch", "height": 3, "round": 0,
                   "indices": [0, 5, 39, 400]}),
        (M, 0x21, {"type": "tx_fetch", "height": 3, "round": 0,
                   "indices": []}),
        (M, 0x21, {"type": "compact_ack", "height": 3, "round": 0,
                   "ok": False, "reason": "failed"}),
        (M, 0x21, {"type": "compact_ack", "height": 3, "round": 0,
                   "ok": True, "reason": ""}),
    ]


def _trace_receive(P, monkeypatch):
    net, me, lagger, _ = tip_state(P, monkeypatch, True, True)
    try:
        r_me, script = _receive_script(P, net, me, lagger)
        r_lag = _reactor(P, net.nodes[lagger])
        reactors = {"lagger": (r_lag, net.nodes[lagger]),
                    "me": (r_me, net.nodes[me])}
        submitted = []
        for name, (r, node) in reactors.items():
            inner = node.cs.submit

            def submit(msg, peer_id="", inner=inner, name=name):
                submitted.append((name, P.enc.cdumps(msg), peer_id))
                return inner(msg, peer_id)
            node.cs.submit = submit
        peer = FakePeer("ee" * 20, caps=CAPS)
        pss = {}
        for name, (r, node) in reactors.items():
            rs = node.cs.rs
            pss[name] = _attach(P, r, peer, rs.height, rs.round, 3)
        # `me` has offered the peer its compact proposal (the ack's key)
        r_me._gossip_data_pass(peer, pss["me"])
        r_me._gossip_data_pass(peer, pss["me"])
        trace = []
        for name, ch, msg in script:
            r = reactors[name][0]
            peer.sent.clear()
            submitted.clear()
            r.receive(ch, peer, tenc.cdumps(msg))
            trace.append((name, msg["type"], list(submitted),
                          list(peer.sent), pss[name].snapshot(),
                          sorted(pss[name].votes_known.items()),
                          list(r.switch.stopped)))
        lag = net.nodes[lagger].cs.rs
        trace.append(("end", lag.proposal_block.hash()
                      if lag.proposal_block else None,
                      r_lag.compact_stats.snapshot() if P is PORT else None))
        return trace
    finally:
        net.close()


def test_receive_submits_and_answers_as_jax(monkeypatch, clocks):
    """Every message type through receive, in one order, on both
    packages: the same state-machine inputs, replies, peer state and
    refusals; the lagger rebuilds height 3's block from the compact
    offer and its mempool."""
    port = _trace_receive(PORT, monkeypatch)
    jax = _trace_receive(JAX, monkeypatch)
    assert port[:-1] == jax[:-1]
    assert port[-1][1] == jax[-1][1] is not None
    assert port[-1][2]["reconstruct"] == {"hit": 1}
    kinds = {t[1] for t in port[:-1] if t[2]}
    assert {"proposal", "block_part", "vote", "vote_agg",
            "compact_block"} <= kinds
    replies = {tenc.cloads(m)["type"] for t in port[:-1] for _, m in t[3]}
    assert {"compact_ack", "vote_set_bits", "tx_fetch_reply"} <= replies


def _mempool_walk(P, txs):
    n = RelayNet(P).nodes[0]
    try:
        for tx in txs:
            n.mempool.check_tx(tx)
        r = P.MpReactor(n.mempool)
        peer = FakePeer("dd" * 20)
        t = threading.Thread(target=r._broadcast_tx_routine, args=(peer,),
                             daemon=True)
        t.start()
        want = len(txs)
        got = lambda: sum(  # noqa: E731
            len(tenc.cloads(m).get("txs", [0])) for _, m in peer.sent)
        assert wait_for(lambda: got() >= want)
        time.sleep(0.1)          # nothing more may come
        peer.running = False
        r._stopped = True
        t.join(5)
        assert not t.is_alive()
        # receive: a batch, a single tx, and two bad messages
        sw = FakeSwitch()
        r.switch = sw
        for m in ({"type": "txs", "txs": [b"in/a=1".hex(), txs[0].hex()]},
                  {"type": "tx", "tx": b"in/b=2".hex()},
                  {"type": "txs", "txs": "nope"}, {"type": "what"}):
            r.receive(0x30, peer, tenc.cdumps(m))
        return peer.sent, sw.stopped, n.mempool.size()
    finally:
        n.cs.stop()


def test_a_committed_tx_the_mempool_never_held_is_refused_after():
    """A block from a peer commits a tx this node never admitted; gossip
    of that tx arriving after the commit must not re-admit it (the port
    caches every committed tx; the JAX package caches only the txs it
    admitted, so it admits this one again and a later proposal of that
    node would commit it twice)."""
    tx = b"late/k=v"
    got = {}
    for P in PKGS:
        n = RelayNet(P).nodes[0]
        try:
            n.mempool.update(1, [tx])
            got[P.name] = n.mempool.check_tx_batch([tx])[0].ok
        finally:
            n.cs.stop()
    assert got == {"port": False, "jax": True}


def test_a_tx_pushed_out_of_the_cache_is_admitted_again_as_in_jax():
    """The cache is a FIFO of cache_size txs (100,000 by default): a
    committed tx that cache_size later txs pushed out is admitted again by
    both packages (ROADMAP Queue 3: a lagging node's gossip can then
    commit it twice)."""
    tx = b"old/k=v"
    later = [b"new/k%d=v" % i for i in range(3)]
    got = {}
    for P in PKGS:
        n = RelayNet(P).nodes[0]
        try:
            mp = n.mempool
            mp.cache = type(mp.cache)(len(later))
            assert mp.check_tx_batch([tx])[0].ok
            mp.update(1, [tx])
            refused = not mp.check_tx_batch([tx])[0].ok
            assert all(r.ok for r in mp.check_tx_batch(later))
            got[P.name] = (refused, mp.check_tx_batch([tx])[0].ok)
        finally:
            n.cs.stop()
    assert got == {"port": (True, True), "jax": (True, True)}


def test_mempool_broadcast_walk_and_receive_match_jax():
    txs = [b"m/k%d=%d" % (i, i) for i in range(150)]
    assert _mempool_walk(PORT, txs) == _mempool_walk(JAX, txs)


def _evidence_run(P, monkeypatch, clocks_):
    net, me, lagger, _ = tip_state(P, monkeypatch, True, True)
    try:
        n = net.nodes[me]
        k = net.keys[lagger]
        vs = n.cs.state.validators
        idx, _ = vs.get_by_address(k.pubkey.address)
        bids = [P.BlockID.from_obj(v.block_id.to_obj()) for v in
                n.cs.rs.votes.prevotes(0).votes if v][:1]
        fake = P.BlockID.from_obj({"hash": "11" * 32, "parts": {
            "total": 1, "hash": "22" * 32}})
        votes = []
        for b in (bids[0], fake):
            v = P.Vote(k.pubkey.address, idx, 2, 0, T0 + 7, 1, b)
            v.signature = k.sign(v.sign_bytes(CHAIN))
            votes.append(v)
        ev = P.DVE(k.pubkey.ed25519, votes[0], votes[1])
        r = P.EvReactor(n.evidence_pool)
        sw = FakeSwitch()
        r.switch = sw
        peer = FakePeer("cc" * 20)
        r.receive(0x38, peer, tenc.cdumps({
            "type": "evidence_list", "evidence": [ev.to_obj()]}))
        pending = [P.enc.cdumps(e.to_obj())
                   for e in n.evidence_pool.pending_evidence()]
        r.add_peer(peer)
        drained = n.evidence_pool.drain(timeout=1.0)
        for m in ({"type": "nope"},
                  {"type": "evidence_list", "evidence": [{"x": 1}]}):
            r.receive(0x38, peer, tenc.cdumps(m))
        return (pending, peer.sent, sw.stopped,
                P.enc.cdumps(drained.to_obj()))
    finally:
        net.close()


def test_evidence_reactor_matches_jax(monkeypatch, clocks):
    port = _evidence_run(PORT, monkeypatch, clocks)
    jax = _evidence_run(JAX, monkeypatch, clocks)
    assert port == jax
    assert len(port[0]) == 1 and port[1]


# ----------------------------------------------------- ConsensusState.logger

def test_switch_to_consensus_logs_a_skipped_wal_replay(monkeypatch, clocks,
                                                       caplog):
    """Fast sync past the WAL's last marker: switch_to_consensus logs
    through the port's ConsensusState.logger (the JAX reactor's call)
    and starts the machine."""
    net, me, _, _ = tip_state(PORT, monkeypatch, True, True)
    try:
        node = net.nodes[me]
        r = treactor.ConsensusReactor(node.cs, fast_sync=True)
        with caplog.at_level(logging.INFO):
            r.switch_to_consensus(node.cs.state)
        assert not r.fast_sync
        assert any("WAL catchup replay skipped err=WAL has no #ENDHEIGHT "
                   "for 2" in rec.getMessage() for rec in caplog.records)
        assert node.cs.rs.height == 3
    finally:
        net.close()


# ------------------------------------------------------------------- nets

def _bench():
    return socknet.bench_config()


def test_four_port_nodes_over_connected_switches_commit_and_agree():
    cfg = _bench()
    keys = socknet.validator_keys()
    gen = socknet.genesis(keys)
    nodes = [socknet.build_node(i, k, gen, cfg, CPU)
             for i, k in enumerate(keys)]
    switches = make_connected_switches(
        4, lambda i: nodes[i].reactors(), network=gen.chain_id,
        encrypt=True, config=cfg.p2p, other=["compact/1", "voteagg/1"])
    for n, sw in zip(nodes, switches):
        n.switch = sw
    try:
        fed = [b"n1/k%d=v" % i for i in range(600)]
        assert sum(r.ok for r in nodes[0].mempool.check_tx_batch(fed)) == 600
        # a node saves its State just after the block: wait for, and
        # compare, the heights whose State every node has saved
        assert wait_for(lambda: all(max(n.states) >= 5 for n in nodes))
        assert wait_for(lambda: all(n.mempool.size() == 0 for n in nodes))
        top = min(max(n.states) for n in nodes)
        for h in range(1, top + 1):
            assert len({n.block_store.load_block_meta(h).block_id.hash
                        for n in nodes}) == 1
            assert len({n.states[h] for n in nodes}) == 1
        # the State holds the app hash: equal States, equal apps
        n0 = nodes[0].block_store
        committed = [tx for h in range(1, n0.height() + 1)
                     for tx in n0.load_block(h).data.txs]
        assert sorted(committed) == sorted(fed)
    finally:
        for n in nodes:
            n.close()


class JaxSockNode:
    """A JAX package node for the socket nets: kvstore app, MemDB stores,
    mempool, evidence pool, event bus, a real ticker and the four
    reactors on an encrypted Switch listening on 127.0.0.1:0."""

    def __init__(self, i, key, gen, fast_sync=False):
        from tendermint_tpu.consensus import compact as jcompact
        from tendermint_tpu.p2p.trust import TrustMetricStore
        cfg = jtest_config()
        cfg.consensus = replace(
            cfg.consensus, timeout_propose=400, timeout_propose_delta=100,
            timeout_prevote=200, timeout_prevote_delta=100,
            timeout_precommit=200, timeout_precommit_delta=100,
            timeout_commit=100, skip_timeout_commit=False,
            peer_gossip_sleep_ms=100, max_block_size_txs=1000)
        self.index, self.states = i, {}
        self.app = jkv.KVStoreApp()
        self.conns = JAppConns(jlcc(self.app))
        self.state_store = JStateStore(JMemDB())
        self.block_store = JBlockStore(JMemDB())
        inner = self.state_store.save

        def save(state):
            inner(state)
            self.states[state.last_block_height] = jenc.cdumps(
                state.to_obj())
        self.state_store.save = save
        state = JHandshaker(self.state_store, self.block_store,
                            gen).handshake(self.conns)
        self.mempool = JMempool(self.conns.mempool,
                                height=state.last_block_height)
        evp = JEvPool(JEvStore(JMemDB()), state, state_store=self.state_store)
        exe = JBlockExecutor(self.state_store, self.conns.consensus,
                             mempool=self.mempool, evidence_pool=evp,
                             event_bus=JEventBus())
        from tendermint_tpu.consensus.ticker import TimeoutTicker
        self.cs = JCS(cfg.consensus, state, exe, self.block_store,
                      mempool=self.mempool, evidence_pool=evp,
                      priv_validator=(JPrivVal(JLocalSigner(key))
                                      if key is not None else None),
                      ticker_factory=TimeoutTicker)
        nk = JNodeKey(JPrivKey.generate(bytes([101 + i]) * 32))
        info = JNodeInfo(pubkey=nk.pubkey, moniker=f"jax{i}",
                         network=gen.chain_id,
                         other=jcompact.wire_capabilities())
        self.switch = JSwitch(cfg.p2p, nk, info, encrypt=True)
        self.switch.trust_store = TrustMetricStore(JMemDB())
        cr = jreactor.ConsensusReactor(self.cs, fast_sync=fast_sync,
                                       gossip_sleep_s=0.1)
        for name, r in (("mempool", JMpReactor(self.mempool)),
                        ("blockchain", JBcReactor(
                            state, exe, self.block_store,
                            fast_sync=fast_sync, consensus_reactor=cr)),
                        ("consensus", cr), ("evidence", JEvReactor(evp))):
            self.switch.add_reactor(name, r)
        self.switch.listen("127.0.0.1", 0)
        self.switch.start()

    def close(self):
        self.switch.stop()
        self.mempool.close()


def _jax_genesis(keys):
    return JGenesisDoc(chain_id=socknet.CHAIN_ID, genesis_time_ns=1,
                       validators=[JGenVal(k.pubkey.ed25519, 10)
                                   for k in keys])


def test_mixed_jax_and_port_net_agrees_on_every_block():
    """Validators 0 and 1 are port nodes, 2 and 3 JAX nodes, on one
    encrypted mesh: every node stores the same block and app hashes."""
    net = socknet.SockNet(_bench(), verifier_of=lambda i: CPU)
    jkeys = [JPrivKey.generate(bytes([i + 1]) * 32) for i in range(4)]
    jax_nodes = []
    try:
        net.start(validators=[0, 1])
        for i in (2, 3):
            jax_nodes.append(JaxSockNode(i, jkeys[i], _jax_genesis(jkeys)))
            net.add_node(jax_nodes[-1])
        net.feed(0, [b"mx/k%d=v" % i for i in range(200)])
        net.wait_height(3, WAIT_S)
        assert net.disagreements() == []
        everyone = net.nodes + jax_nodes
        top = min(n.block_store.height() for n in everyone)
        for h in range(1, top + 1):
            assert len({n.block_store.load_block_meta(h).block_id.hash
                        for n in everyone}) == 1
            # the app hash after h is in block h + 1's header
            assert len({n.block_store.load_block(h).header.app_hash
                        for n in everyone}) == 1
    finally:
        for n in jax_nodes:
            n.close()
        net.close()


def test_port_joiner_fast_syncs_from_a_jax_peer():
    """A single JAX validator makes a chain; a port node with
    fast_sync=True syncs it over the switch in 4-block windows, switches
    to consensus and follows; its State bytes equal the source's."""
    jkey = JPrivKey.generate(b"\x01" * 32)
    src = JaxSockNode(0, jkey, _jax_genesis([jkey]))
    net = socknet.SockNet(_bench(), verifier_of=lambda i: CPU, n_vals=1)
    try:
        src.mempool.check_tx_batch([b"fs/k%d=v" % i for i in range(300)])
        assert wait_for(lambda: src.block_store.height() >= 10)
        net.others.append(src)          # the joiner dials it
        joiner = net.add_joiner(verify_window=4)
        assert wait_for(lambda: joiner.blockchain_reactor.synced)
        assert joiner.blockchain_reactor.sync_error is None
        h = src.block_store.height() + 2
        assert wait_for(lambda: h in joiner.states and h in src.states)
        for x in range(1, h + 1):
            assert joiner.states[x] == src.states[x]
            assert joiner.block_store.load_block_meta(x).block_id.hash == \
                src.block_store.load_block_meta(x).block_id.hash
        assert not joiner.consensus_reactor.fast_sync
    finally:
        net.close()
        src.close()


def test_dropped_validator_redials_and_catches_up():
    net = socknet.SockNet(_bench(), verifier_of=lambda i: CPU)
    try:
        net.start()
        net.feed(0, [b"dr/k%d=v" % i for i in range(300)])
        net.wait_height(2, WAIT_S)
        net.drop_links(3)
        assert net.nodes[3].switch.peers.size() == 0
        h = max(net.heights()) + 2
        net.wait_height(h, WAIT_S, nodes=net.nodes[:3])
        assert net.nodes[3].block_store.height() < h
        net.restore_links(3)
        net.wait_for(lambda: net.nodes[3].switch.peers.size() == 3, WAIT_S,
                     "redial")
        net.wait_height(h + 1, WAIT_S)
        assert net.disagreements() == []
    finally:
        net.close()
