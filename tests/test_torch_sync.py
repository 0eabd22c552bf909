"""Fast sync in the port (tendermint_tpu_torch.blockchain) against the JAX
package's: the block pool's scheduling, the reactor's message handlers
and pool routine, the window engine syncing a chain, a bad peer, and the
port's chain builder.

The synced chain is built by the JAX package (4 validators, 40 blocks of
20 txs, one validator's power changed at height 36) and carried across
with `convert.block_from_jax`; both reactors sync it with verify_window
8, the port on BatchVerifier("cuda", device="cpu") (the batch path and
the plain versions of the kernels). The power change makes the batched
verdicts of the rest of its window stale, so those blocks re-verify one
by one against the new set. Per-height state bytes, every stored row of both stores and the
verifier's calls are compared. Tolerance 0.
"""

import copy
from types import SimpleNamespace

import pytest
import torch

import bench_fastsync
from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.blockchain import pool as jpool
from tendermint_tpu.blockchain import reactor as jreactor
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu.utils import clock as jclock
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.abci.apps import kvstore as tkv
from tendermint_tpu_torch.blockchain import builder as tbuilder
from tendermint_tpu_torch.blockchain import pool as tpool
from tendermint_tpu_torch.blockchain import reactor as treactor
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.utils import clock as tclock
from tests.test_torch_state import JAX, PORT, Chain, _dump, val_tx

torch.set_num_threads(1)

PKG = {"jax": SimpleNamespace(pool=jpool, reactor=jreactor, clock=jclock,
                              base=JAX),
       "port": SimpleNamespace(pool=tpool, reactor=treactor, clock=tclock,
                               base=PORT)}


# --------------------------------------------------------------- BlockPool

class FakeBlock:
    def __init__(self, h):
        self.header = SimpleNamespace(height=h)


def _heights(blocks):
    return [b.header.height for b in blocks]


def _requests_and_ordering(M):
    sent = []
    pool = M.pool.BlockPool(
        start_height=1, send_request=lambda p, h: sent.append((p, h)) or True,
        on_peer_error=lambda p, r: None)
    pool.set_peer_height("peerA", 10)
    pool.set_peer_height("peerB", 5)
    pool.set_peer_height("peerB", 3)       # heights only rise
    pool.make_next_requests()
    out = [sorted(sent), pool.max_peer_height(), pool.num_peers()]
    for h in (3, 1, 2, 5):
        peer = next(p for p, hh in sent if hh == h)
        out.append(pool.add_block(peer, FakeBlock(h), 100))
    out.append(pool.add_block("peerA", FakeBlock(1), 100))  # filled already
    out += [_heights(pool.peek_window(10)), _heights(pool.peek_window(1)),
            _heights(pool.peek_window(10, skip=1)),
            _heights(pool.peek_window(10, skip=3))]
    first, second = pool.peek_two_blocks()
    out.append((first.header.height, second.header.height))
    pool.pop_request()
    out += [pool.height, _heights(pool.peek_window(10))]
    return out


def _unsolicited(M):
    pool = M.pool.BlockPool(1, lambda p, h: True, lambda p, r: None)
    pool.set_peer_height("peerA", 3)
    pool.make_next_requests()
    return [pool.add_block("stranger", FakeBlock(1), 100),
            pool.add_block("peerA", FakeBlock(99), 100),
            pool.add_block("peerA", FakeBlock(2), 100)]


def _removal_reassigns(M):
    sent = []
    pool = M.pool.BlockPool(1, lambda p, h: sent.append((p, h)) or True,
                            lambda p, r: None)
    pool.set_peer_height("peerA", 4)
    pool.make_next_requests()
    pool.remove_peer("peerA")
    pool.set_peer_height("peerB", 4)
    pool.retry_stale_requests()
    return sent


def _send_failure_and_cap(M):
    """A request the peer cannot take is orphaned and its pending count
    drained; a per-peer cap bounds the window."""
    sent = []
    pool = M.pool.BlockPool(1, lambda p, h: sent.append((p, h)) or h != 2,
                            lambda p, r: None, max_pending_per_peer=3)
    pool.set_peer_height("peerA", 10)
    pool.make_next_requests()
    out = [list(sent), pool.peers["peerA"].num_pending,
           pool.requests[2].peer_id]
    pool.make_next_requests()      # the orphan goes out again
    out += [list(sent), sorted(pool.requests)]
    return out


def _strikes_backoff_reroute(M):
    t = [1000.0]
    M.clock.set_source(lambda: int(t[0] * 1e9))
    try:
        sent, dropped = [], []
        pool = M.pool.BlockPool(1, lambda p, h: sent.append((p, h)) or True,
                                lambda p, r: dropped.append((p, r)))
        pool.set_peer_height("peerA", 10)
        pool.make_next_requests()
        pool.set_peer_height("peerB", 10)
        t[0] += M.pool.REQUEST_TIMEOUT_S + 1
        pool.retry_stale_requests()
        a = pool.peers["peerA"]
        out = [list(sent), a.strikes, a.in_backoff(M.clock.now_s()),
               a.backoff_until, list(dropped),
               [M.pool._jitter("peerA", n) for n in range(1, 5)]]
        for _ in range(M.pool.MAX_STRIKES - 1):
            for req in pool.requests.values():
                req.peer_id = "peerA"
                req.sent_at = t[0]
            t[0] += M.pool.REQUEST_TIMEOUT_S + M.pool.BACKOFF_CAP_S + 1
            pool.retry_stale_requests()
        out += [list(dropped), sorted(pool.peers)]
        return out
    finally:
        M.clock.set_source(None)


def _never_evicts_last_peer(M):
    t = [1000.0]
    M.clock.set_source(lambda: int(t[0] * 1e9))
    try:
        dropped = []
        pool = M.pool.BlockPool(1, lambda p, h: True,
                                lambda p, r: dropped.append(p))
        pool.set_peer_height("only", 5)
        pool.make_next_requests()
        strikes = []
        for _ in range(M.pool.MAX_STRIKES + 2):
            for req in pool.requests.values():
                req.peer_id = "only"
                req.sent_at = t[0]
            t[0] += M.pool.REQUEST_TIMEOUT_S + M.pool.BACKOFF_CAP_S + 1
            pool.retry_stale_requests()
            strikes.append(pool.peers["only"].strikes)
        return [dropped, pool.num_peers(), strikes]
    finally:
        M.clock.set_source(None)


def _caught_up_reset_redo(M):
    pool = M.pool.BlockPool(5, lambda p, h: True, lambda p, r: None)
    out = []
    pool.set_peer_height("peerA", 4)
    out.append(pool.is_caught_up())
    pool.set_peer_height("peerB", 9)
    out.append(pool.is_caught_up())
    pool.make_next_requests()
    for h in (5, 6, 7):
        pool.add_block(pool.requests[h].peer_id, FakeBlock(h), 10)
    out.append(pool.redo_request(6))
    out += [sorted(pool.peers), pool.requests[6].peer_id,
            pool.requests[6].block, _heights(pool.peek_window(5))]
    pool.reset_height(7)
    out += [pool.height, sorted(pool.requests), _heights(pool.peek_window(5))]
    pool.reset_height(3)           # never moves back
    out.append(pool.height)
    return out


def _peer_rate_discipline(M):
    """A peer's burst rate resets per burst; a block clears its strikes."""
    p = M.pool.BpPeer("p", 9)
    out = [p.is_slow()]
    p.on_request()
    p.on_request()
    p.strike(100.0)
    out += [p.num_pending, p.strikes, p.in_backoff(100.5), p.is_slow()]
    p.on_block(5000)
    p.on_request_failed()
    p.on_request_failed()
    out += [p.num_pending, p.strikes, p.backoff_until, p.blocks_received,
            p.recv_monitor.total]
    return out


POOL_SCENARIOS = {f.__name__.strip("_"): f for f in (
    _requests_and_ordering, _unsolicited, _removal_reassigns,
    _send_failure_and_cap, _strikes_backoff_reroute, _never_evicts_last_peer,
    _caught_up_reset_redo, _peer_rate_discipline)}


@pytest.mark.parametrize("scenario", sorted(POOL_SCENARIOS))
def test_pool_scheduling_matches_jax(scenario):
    fn = POOL_SCENARIOS[scenario]
    assert fn(PKG["port"]) == fn(PKG["jax"])


def test_pool_scenarios_pin_the_reference_behaviour():
    got = {k: f(PKG["port"]) for k, f in POOL_SCENARIOS.items()}
    assert sorted(h for _, h in got["requests_and_ordering"][0]) == \
        list(range(1, 11))
    assert got["requests_and_ordering"][8:10] == [[1, 2, 3], [1, 2]]
    assert got["unsolicited"] == [False, False, True]
    assert ("peerB", 1) in got["removal_reassigns"]
    strikes = got["strikes_backoff_reroute"]
    assert strikes[1] == 1 and strikes[2] and strikes[4] == []
    assert [p for p, _ in strikes[6]] == ["peerA"]
    assert got["never_evicts_last_peer"][:2] == [[], 1]


# ------------------------------------------------------------- the reactor

class Peer:
    """An in-process peer: serves `blocks` (height h at h - 1), through
    the reactor's own receive(), as a block_response message."""

    def __init__(self, pid, reactor, blocks, enc, forge=None):
        self.id, self.reactor, self.blocks, self.enc = pid, reactor, blocks, enc
        self.forge = forge or {}
        self.sent = []

    def try_send_obj(self, ch, obj):
        self.sent.append(obj)
        if obj["type"] != "block_request":
            return True
        h = obj["height"]
        if h > len(self.blocks):
            msg = {"type": "no_block_response", "height": h}
        else:
            bobj = self.blocks[h - 1].to_obj()
            if h in self.forge:
                bobj = self.forge[h](bobj)
            msg = {"type": "block_response", "block": bobj}
        self.reactor.receive(ch, self, self.enc.cdumps(msg))
        return True


class Switch:
    """The three members of the p2p switch the reactor uses."""

    def __init__(self, reactor):
        self.reactor = reactor
        self.peers = {}
        self.stopped, self.broadcasts = [], []

    def add(self, peer, height):
        self.peers[peer.id] = peer
        self.reactor.pool.set_peer_height(peer.id, height)

    def broadcast_obj(self, ch, obj):
        self.broadcasts.append((ch, obj))

    def stop_peer_for_error(self, peer, err):
        self.stopped.append((peer.id, str(err)))
        self.peers.pop(peer.id, None)
        self.reactor.remove_peer(peer, err)


def _node(M, gen, verifier, window, **kw):
    P = M.base
    ss = P.ss.StateStore(P.db.MemDB())
    bs = P.bs.BlockStore(P.db.MemDB())
    state = ss.load_or_genesis(gen)
    app = P.app()
    conns = P.proxy.AppConns(P.proxy.local_client_creator(app))
    conns.consensus.init_chain(
        [P.abci.ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen.chain_id)
    exe = P.exe.BlockExecutor(ss, conns.consensus, verifier=verifier)
    seen = {}   # height -> the canonical bytes of the state it applied to
    apply_block = exe.apply_block

    def apply_and_keep(*args, **kw):
        new = apply_block(*args, **kw)
        seen[new.last_block_height] = P.enc.cdumps(new.to_obj())
        return new

    exe.apply_block = apply_and_keep
    reactor = M.reactor.BlockchainReactor(
        state, exe, bs, fast_sync=True, verify_window=window, **kw)
    return SimpleNamespace(reactor=reactor, ss=ss, bs=bs, app=app, seen=seen)


def _sync(node, blocks, n_sync, peer="peer"):
    """bench_fastsync.sync_chain's instant peer: a request is answered
    at once from `blocks`."""
    r = node.reactor

    def send_request(peer_id, height):
        r.pool.add_block(peer_id, blocks[height - 1], 1)
        return True

    r.pool.send_request = send_request
    r.pool.max_pending_per_peer = 1 << 20
    r.pool.set_peer_height(peer, len(blocks))
    r.pool.make_next_requests()
    try:
        while r.state.last_block_height < n_sync:
            if not r._sync_window():
                r.pool.make_next_requests()
    finally:
        r.stop()
    assert r._resolver is None


N_VALS, N_BLOCKS, N_TXS, CHANGE_AT, WINDOW = 4, 40, 20, 36, 8


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX package's chain and its sentinel block (which carries the
    commit of the last synced block)."""
    def txs(c, h):
        out = [b"k%d.%d=v%d" % (h % 7, i, h) for i in range(N_TXS)]
        if h == CHANGE_AT:
            out.append(val_tx(c.privs[0].pubkey.ed25519, 20))
        return out

    c = Chain(JAX, N_VALS, chain_id="sync-chain")
    for h in range(1, N_BLOCKS + 2):
        c.next(txs(c, h) if h <= N_BLOCKS else [])
    assert c.states[CHANGE_AT].validators.hash() != \
        c.states[CHANGE_AT - 1].validators.hash()
    return c


def test_sync_through_both_reactors_matches_jax(jax_chain):
    c = jax_chain
    verifier = tverifier.BatchVerifier("cuda", device="cpu")
    jnode = _node(PKG["jax"], c.gen, None, WINDOW)
    tnode = _node(PKG["port"], convert.genesis_from_jax(c.gen.to_obj()),
                  verifier, WINDOW)
    _sync(jnode, c.blocks, N_BLOCKS)
    _sync(tnode, [convert.block_from_jax(b.to_obj()) for b in c.blocks],
          N_BLOCKS)
    assert sorted(tnode.seen) == list(range(1, N_BLOCKS + 1))
    assert tnode.seen == jnode.seen
    for h in range(1, N_BLOCKS + 1):
        assert tnode.seen[h] == tenc.cdumps(c.states[h].to_obj())
    assert _dump(tnode.bs.db) == _dump(jnode.bs.db)
    assert _dump(tnode.ss.db) == _dump(jnode.ss.db)
    for h in range(1, N_BLOCKS + 1):
        meta = tnode.bs.load_block_meta(h)
        assert meta.block_id.hash == c.blocks[h - 1].hash()
        assert tnode.bs.load_seen_commit(h).to_bytes() == \
            c.blocks[h].last_commit.to_bytes()
        assert tnode.ss.load_abci_responses(h) == \
            jnode.ss.load_abci_responses(h)
    assert tnode.app.app_hash == jnode.app.app_hash == c.states[-2].app_hash
    # five windows of 8 in one batch each, and the blocks after the power
    # change in its window re-verified one by one
    stale = N_BLOCKS - CHANGE_AT
    assert verifier.stats["calls"] == N_BLOCKS // WINDOW + stale
    assert verifier.stats["cuda_sigs"] == \
        verifier.stats["sigs"] == (N_BLOCKS + stale) * N_VALS


def _flip_last_commit_sig(bobj):
    # a copy: to_obj hands out the commit's cached object
    bobj = copy.deepcopy(bobj)
    pc = bobj["last_commit"]["precommits"][1]
    sig = bytearray.fromhex(pc["signature"])
    sig[7] ^= 1
    pc["signature"] = sig.hex()
    return bobj


def _bad_peer(M, chain, verifier):
    """A forger serves block 7 with a flipped precommit signature in its
    last commit, so block 6 cannot be verified: the window is cut after
    5 blocks, heights 6 and 7 are re-requested, the forger is stopped and
    the window in flight is dropped; an honest peer then serves the rest."""
    node = _node(M, chain.gen, verifier, 4)
    r = node.reactor
    sw = r.switch = Switch(r)
    blocks = chain.blocks
    forger = Peer("forger", r, blocks, M.base.enc,
                  forge={7: _flip_last_commit_sig})
    sw.add(forger, len(blocks))
    cut = []
    apply_window, redo = r._apply_window, r.pool.redo_request

    def apply_and_log(per_block, *a):
        n = apply_window(per_block, *a)
        cut.append((per_block[0][0].header.height, len(per_block), n))
        return n

    redone = []
    r._apply_window = apply_and_log
    r.pool.redo_request = lambda h: redone.append(h) or redo(h)
    r.pool.make_next_requests()
    out = []
    try:
        while r.state.last_block_height < 11:
            progress = r._sync_window()
            if redone and not out:
                out += [r.state.last_block_height, r._pending_window,
                        list(sw.stopped), sorted(r.pool.peers)]
                honest = Peer("honest", r, blocks, M.base.enc)
                sw.add(honest, len(blocks))
            if not progress:
                r.pool.make_next_requests()
    finally:
        r.stop()
    out += [cut, redone, node.seen[11], node.bs.height(),
            [node.bs.load_block(h).to_bytes() for h in (6, 7)]]
    return out


def test_bad_peer_is_stopped_and_the_sync_recovers_like_jax():
    c = Chain(JAX, N_VALS, chain_id="bad-peer-chain")
    for h in range(1, 13):
        c.next([b"k%d=v" % h])
    port_chain = SimpleNamespace(
        gen=convert.genesis_from_jax(c.gen.to_obj()),
        blocks=[convert.block_from_jax(b.to_obj()) for b in c.blocks])
    got = _bad_peer(PKG["port"], port_chain,
                    tverifier.BatchVerifier("python"))
    want = _bad_peer(PKG["jax"], c, None)
    assert got == want
    assert got[:4] == [5, None,
                       [("forger", "bad block/commit at height 6")],
                       []]
    # windows: 1-4 whole, 5-8 cut after 5, the successor 9-11 dropped
    assert got[4][:2] == [(1, 4, 4), (5, 4, 1)]
    assert got[5] == [6]
    assert got[6] == tenc.cdumps(c.states[11].to_obj())
    assert got[8] == [c.blocks[5].to_bytes(), c.blocks[6].to_bytes()]


def _handlers(M, chain, verifier):
    node = _node(M, chain.gen, verifier, 4)
    r = node.reactor
    for i, b in enumerate(chain.blocks[:3]):
        node.bs.save_block(b, b.make_part_set(65536),
                           chain.blocks[i + 1].last_commit)
    sw = r.switch = Switch(r)
    enc = M.base.enc
    p = Peer("p1", r, [], enc)
    sw.peers["p1"] = p
    out = [r.min_peer_height() > 1 << 60]
    r.add_peer(p)
    r.receive(0x40, p, enc.cdumps({"type": "status_response", "height": 7}))
    r.receive(0x40, p, enc.cdumps({"type": "status_response", "height": 5}))
    r.receive(0x40, p, enc.cdumps({"type": "status_request"}))
    r.receive(0x40, p, enc.cdumps({"type": "block_request", "height": 2}))
    r.receive(0x40, p, enc.cdumps({"type": "block_request", "height": 9}))
    r.receive(0x40, p, enc.cdumps({"type": "no_block_response",
                                   "height": 9}))
    out += [r.min_peer_height(), r.pool.max_peer_height(),
            [enc.cdumps(m) for m in p.sent]]
    r.broadcast_status_request()
    out.append(list(sw.broadcasts))
    out.append(r._send_block_request("p1", 4))
    out.append(r._send_block_request("nobody", 4))
    r.receive(0x40, p, enc.cdumps({"type": "bogus"}))
    out.append(list(sw.stopped))
    r.adopt_restored(chain.states[3])
    out.append(r.pool.height)
    r.switch = None
    out += [r._send_block_request("p1", 4), r._stop_peer("p1", "x")]
    r.remove_peer(p, "bye")
    out.append(r.min_peer_height() > 1 << 60)
    return out


def test_message_handlers_match_jax():
    c = Chain(JAX, 2, chain_id="handler-chain")
    for h in range(1, 5):
        c.next([b"h=%d" % h])
    port = SimpleNamespace(
        gen=convert.genesis_from_jax(c.gen.to_obj()),
        blocks=[convert.block_from_jax(b.to_obj()) for b in c.blocks],
        states=[convert.chain_state_from_jax(s.to_obj()) for s in c.states])
    got = _handlers(PKG["port"], port, tverifier.BatchVerifier("python"))
    assert got == _handlers(PKG["jax"], c, None)
    assert got[1:3] == [7, 7] and got[-1]


def _routine(M, chain, verifier):
    """The pool routine on its own thread: status broadcast, the sync
    loop, and the handoff to consensus once caught up."""
    node = _node(M, chain.gen, verifier, 4)
    r = node.reactor
    handed = []
    r.consensus_reactor = SimpleNamespace(
        switch_to_consensus=lambda s: handed.append(s.last_block_height))
    sw = r.switch = Switch(r)
    sw.add(Peer("p1", r, chain.blocks, M.base.enc), len(chain.blocks))
    r.start()
    try:
        r._thread.join(timeout=30)
    finally:
        r.stop()
    return [handed, r.synced, r.fast_sync, r.sync_error, sw.broadcasts,
            node.bs.height()]


def test_pool_routine_switches_to_consensus_like_jax():
    c = Chain(JAX, 2, chain_id="routine-chain")
    for h in range(1, 8):
        c.next([b"r=%d" % h])
    port = SimpleNamespace(
        gen=convert.genesis_from_jax(c.gen.to_obj()),
        blocks=[convert.block_from_jax(b.to_obj()) for b in c.blocks])
    got = _routine(PKG["port"], port, tverifier.BatchVerifier("python"))
    assert got == _routine(PKG["jax"], c, None)
    assert got[:3] == [[6], True, False] and got[5] == 6


def _may_switch(M, gen, verifier):
    redials = []
    node = _node(M, gen, verifier, 4, expect_peers=True,
                 redial=lambda: redials.append(1))
    r = node.reactor
    g, s = M.reactor.NO_PEER_GRACE_S, M.reactor.REDIAL_INTERVAL_S
    out = [r._may_switch(100.0), r._may_switch(100.0 + s + 1),
           r._may_switch(100.0 + 2 * s + 2), r._may_switch(100.0 + g),
           len(redials)]
    r.pool.set_peer_height("p", 3)
    out += [r._may_switch(100.0 + g), r._redials]
    r.expect_peers = False
    r.pool.remove_peer("p")
    out.append(r._may_switch(0.0))
    r._switch_to_consensus()
    out += [r.synced, r.fast_sync]
    return out


def test_may_switch_waits_out_the_no_peer_grace_like_jax(jax_chain):
    got = _may_switch(PKG["port"],
                      convert.genesis_from_jax(jax_chain.gen.to_obj()),
                      tverifier.BatchVerifier("python"))
    assert got == _may_switch(PKG["jax"], jax_chain.gen, None)
    assert got[:5] == [False, False, False, True, 3]


# ---------------------------------------------------------- the builder

def test_builder_matches_the_jax_builder_for_3_heights():
    jb = bench_fastsync.ChainBuilder(4, 30, key_space=2)
    tb = tbuilder.ChainBuilder(4, 30, key_space=2, device="cpu")
    times = {}
    got, want = tb.build(3, times), jb.build(3)
    assert [b.to_bytes() for b in got] == [b.to_bytes() for b in want]
    assert tb.last_commit.to_bytes() == jb.last_commit.to_bytes()
    assert tenc.cdumps(tb.state.to_obj()) == jenc.cdumps(jb.state.to_obj())
    assert set(times) == set(tbuilder.STAGES)
