"""The port's crash recovery (tendermint_tpu_torch.consensus.replay and
wal_generator) against the JAX package's, on the CPU.

tests/test_replay.py drives the JAX Node; here a node is the assembly
the Node makes for consensus (SQLite stores, the kvstore app, the ABCI
handshake, a file WAL, ConsensusState with a MockTicker, catchup replay
at start), built the same way in both packages. Each case runs in both
on the same keys with both clocks on the same ticking source: chains,
app hashes, states, WAL files, replay counts and errors must be equal.
The handshake's case matrix runs over stores and apps cut to every
relevant height pair, and a port node continues a JAX node's chain from
its files (convert.node_files_from_jax).
"""

import os
import shutil

import pytest

from tendermint_tpu.consensus import wal_generator as jwalgen
from tendermint_tpu.storage import db as jdb
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.consensus import wal_generator as twalgen
from tendermint_tpu_torch.storage import db as tdb
from tendermint_tpu_torch import pipeline as tpipeline
from tests.test_torch_consensus import JAX, PORT, PKGS, genesis, ticking_clocks

JAX.sqlite, PORT.sqlite = jdb.SQLiteDB, tdb.SQLiteDB
JAX.walgen, PORT.walgen = jwalgen, twalgen


@pytest.fixture(autouse=True)
def serial_pipeline(monkeypatch):
    monkeypatch.setenv("TM_TPU_PIPELINE", "off")
    monkeypatch.setattr(tpipeline, "_configured", "off")


@pytest.fixture(autouse=True)
def clocks():
    ticking_clocks()
    yield
    for P in PKGS:
        P.clock.set_source(None)


def _gen(P, chain_id="replay-chain"):
    key = P.keys.PrivKey.generate(b"\x09" * 32)
    return genesis(P, [key], chain_id), key


class MiniNode:
    """The consensus half of the JAX Node in package P, on files under
    `home`: handshake at construction, catchup replay at start."""

    def __init__(self, P, home, gen, key, app=None, files=None):
        self.P = P
        if files is None:
            d = os.path.join(home, "data")
            os.makedirs(d, exist_ok=True)
            self.block_store = P.bs.BlockStore(
                P.sqlite(os.path.join(d, "blockstore.db")))
            self.state_store = P.ss.StateStore(
                P.sqlite(os.path.join(d, "state.db")))
            self.wal = P.wal.WAL(os.path.join(d, "cs.wal", "wal"))
        else:
            self.block_store, self.state_store, self.wal = files
        self.app = app or P.app()
        self.conns = P.proxy.AppConns(P.proxy.local_client_creator(self.app))
        hs = P.replay.Handshaker(self.state_store, self.block_store, gen,
                                 verifier=P.verifier())
        state = hs.handshake(self.conns)
        self.handshake_blocks = hs.n_blocks
        exe = P.exe.BlockExecutor(self.state_store, self.conns.consensus,
                                  verifier=P.verifier())
        self.cs = P.cons.ConsensusState(
            P.config.test_config().consensus, state, exe, self.block_store,
            priv_validator=P.pv.PrivValidator(P.pv.LocalSigner(key)),
            wal=self.wal, ticker_factory=P.cons.MockTicker)
        self.replayed = None

    @property
    def height(self):
        return self.cs.state.last_block_height

    def start(self):
        try:
            self.replayed = self.P.replay.catchup_replay(self.cs, self.wal)
        except ValueError as e:
            self.replayed = str(e)
        self.cs.start()

    def run_to(self, heights, ticks=40):
        for _ in range(ticks * heights):
            if self.height >= heights:
                break
            self.cs.ticker.fire_next()
        assert self.height >= heights, f"stuck at {self.height}"

    def blocks(self, lo=1):
        return [self.block_store.load_block(h).to_bytes()
                for h in range(lo, self.block_store.height() + 1)]

    def stop(self):
        self.cs.stop()
        self.wal.close()


def _run_node(P, home, gen, key, heights):
    node = MiniNode(P, home, gen, key)
    node.start()
    node.run_to(heights)
    return node


def _per_pkg(case, tmp_path):
    out = {}
    for P in PKGS:
        ticking_clocks()
        d = tmp_path / P.name
        d.mkdir()
        out[P.name] = case(P, str(d))
    assert out["port"] == out["jax"]
    return out["port"]


def case_node_restarts_and_continues(P, home):
    gen, key = _gen(P)
    node = _run_node(P, home, gen, key, 3)
    h1 = node.height
    node.stop()
    node2 = _run_node(P, home, gen, key, h1 + 2)
    assert node2.height > h1 and node2.app.height >= h1
    out = (node2.blocks(), node2.cs.state.app_hash, node2.handshake_blocks,
           node2.replayed)
    node2.stop()
    return out


def case_handshake_replays_all_blocks_into_fresh_app(P, home):
    gen, key = _gen(P)
    node = _run_node(P, home, gen, key, 3)
    stored_hash = node.cs.state.app_hash
    node.stop()
    fresh = P.app()
    conns = P.proxy.AppConns(P.proxy.local_client_creator(fresh))
    hs = P.replay.Handshaker(node.state_store, node.block_store, gen,
                             verifier=P.verifier())
    state = hs.handshake(conns)
    assert hs.n_blocks >= 3 and fresh.height == node.block_store.height()
    assert state.app_hash == stored_hash
    return hs.n_blocks, P.enc.cdumps(state.to_obj())


def case_handshake_rejects_app_ahead_of_store(P, home):
    gen, _ = _gen(P)
    app = P.app()
    app.height = 42
    conns = P.proxy.AppConns(P.proxy.local_client_creator(app))
    hs = P.replay.Handshaker(P.ss.StateStore(P.db.MemDB()),
                             P.bs.BlockStore(P.db.MemDB()), gen)
    with pytest.raises(P.replay.HandshakeError, match="ahead of store") as e:
        hs.handshake(conns)
    return str(e.value)


def case_wal_catchup_replay_is_idempotent(P, home):
    gen, key = _gen(P)
    _run_node(P, home, gen, key, 2).stop()
    node2 = MiniNode(P, home, gen, key)
    h_before = node2.height
    node2.start()
    assert node2.height >= h_before
    node2.run_to(h_before + 1)
    out = (node2.replayed, node2.blocks())
    node2.stop()
    return out


def case_wal_generator_produces_replayable_wal(P, home):
    path = os.path.join(home, "gen.wal")
    gen, state, block_store = P.walgen.wal_with_n_blocks(
        3, path, **({"verifier": P.verifier()} if P is PORT else {}))
    assert state.last_block_height >= 3 and block_store.height() >= 3
    wal = P.wal.WAL(path)
    msgs = wal.messages_after_end_height(2)
    types = {m.msg.get("type") for m in msgs}
    assert "vote" in types and "proposal" in types
    wal.close()
    with open(path, "rb") as f:
        return f.read(), P.enc.cdumps(state.to_obj())


def case_wal_tail_for_legacy_genesis_log(P, home):
    W = P.wal
    legacy = os.path.join(home, "legacy.wal")
    with open(legacy, "wb") as f:
        f.write(W.encode_frame(W.WALMessage(0, {"type": "proposal", "h": 1})))
        f.write(W.encode_frame(W.WALMessage(0, {"type": "vote", "h": 1})))
    tail = P.replay.wal_tail_for(W.WAL(legacy), 0)
    assert [m.msg["type"] for m in tail] == ["proposal", "vote"]
    multi = os.path.join(home, "multi.wal")
    with open(multi, "wb") as f:
        f.write(W.encode_frame(W.WALMessage(0, {"type": "vote", "h": 1})))
        f.write(W.encode_frame(W.WALMessage(
            0, {"type": "endheight", "height": 1})))
        f.write(W.encode_frame(W.WALMessage(0, {"type": "vote", "h": 2})))
    errs = []
    with pytest.raises(ValueError, match="state store wiped") as e:
        P.replay.wal_tail_for(W.WAL(multi), 0)
    errs.append(str(e.value))
    # a marker for a committed height that the log lacks, and a tail
    # that spans a later committed height
    for h in (5, 0):
        try:
            P.replay.wal_tail_for(W.WAL(multi), h)
        except ValueError as e2:
            errs.append(str(e2))
    return [m.to_obj() for m in tail], errs


class _WALCrash(BaseException):
    """Simulated process death at a programmed WAL write."""


def case_crashing_wal_sweep(P, home):
    """Kill the node at the k-th WAL write over the first two heights'
    messages; the restart recovers from what reached disk and commits."""
    outcomes = []
    for k in (*range(1, 13), 14, 17, 20, 24, 28):
        d = os.path.join(home, f"k{k}")
        gen, key = _gen(P, f"crashwal-{k}")
        node = MiniNode(P, d, gen, key)
        wal = node.wal
        orig_save = wal.save
        writes = [0]

        def crashing_save(msg, time_ns=0, _orig=orig_save, _k=k):
            if writes[0] >= _k:
                raise _WALCrash(f"write {writes[0]}")
            writes[0] += 1
            _orig(msg, time_ns)
        wal.save = crashing_save
        crashed = False
        try:
            node.start()
            for _ in range(80):
                if node.height >= 2:
                    break
                node.cs.ticker.fire_next()
        except _WALCrash:
            crashed = True
        h_before = node.height
        wal.save = lambda msg, time_ns=0: None
        node.stop()
        if not crashed:
            outcomes.append((k, h_before))
            continue
        node2 = MiniNode(P, d, gen, key)
        node2.start()
        node2.run_to(max(h_before + 1, 2))
        outcomes.append((k, h_before, node2.replayed, node2.blocks()))
        node2.stop()
    assert any(len(o) > 2 for o in outcomes), "sweep never crashed"
    return outcomes


REPLAY_CASES = [
    case_node_restarts_and_continues,
    case_handshake_replays_all_blocks_into_fresh_app,
    case_handshake_rejects_app_ahead_of_store,
    case_wal_catchup_replay_is_idempotent,
    case_wal_generator_produces_replayable_wal,
    case_wal_tail_for_legacy_genesis_log,
    case_crashing_wal_sweep,
]


@pytest.mark.parametrize("case", REPLAY_CASES, ids=lambda f: f.__name__[5:])
def test_replay_case_matches_jax(case, tmp_path):
    _per_pkg(case, tmp_path)


# ------------------------------------------------------ the handshake matrix

class RecordedChain:
    """A single-validator chain of 4 heights in package P, each height's
    block, seen commit, state and ABCI responses recorded, so stores and
    apps can be rebuilt at any heights."""

    def __init__(self, P):
        self.P = P
        self.gen, key = _gen(P, "matrix-chain")
        ss = P.ss.StateStore(P.db.MemDB())
        bs = P.bs.BlockStore(P.db.MemDB())
        app = P.app()
        conns = P.proxy.AppConns(P.proxy.local_client_creator(app))
        state = P.replay.Handshaker(ss, bs, self.gen).handshake(conns)
        exe = P.exe.BlockExecutor(ss, conns.consensus, verifier=P.verifier())
        cs = P.cons.ConsensusState(
            P.config.test_config().consensus, state, exe, bs,
            priv_validator=P.pv.PrivValidator(P.pv.LocalSigner(key)),
            ticker_factory=P.cons.MockTicker)
        self.states = [state]
        apply = exe.apply_block

        def recording_apply(st, bid, block, *a, **kw):
            new = apply(st, bid, block, *a, **kw)
            self.states.append(new.copy())
            return new
        exe.apply_block = recording_apply
        cs.start()
        for _ in range(200):
            if cs.state.last_block_height >= 4:
                break
            cs.ticker.fire_next()
        self.src_bs, self.src_ss = bs, ss

    def stores(self, store_h, state_h):
        P = self.P
        bs = P.bs.BlockStore(P.db.MemDB())
        ss = P.ss.StateStore(P.db.MemDB())
        ss.save(self.states[0])
        for h in range(1, store_h + 1):
            block = self.src_bs.load_block(h)
            psz = self.states[0].consensus_params.block_gossip \
                .block_part_size_bytes
            bs.save_block(block, block.make_part_set(psz),
                          self.src_bs.load_seen_commit(h))
            ss.save_abci_responses(h, self.src_ss.load_abci_responses(h))
        for h in range(1, state_h + 1):
            ss.save(self.states[h])
        return bs, ss

    def app(self, app_h):
        P = self.P
        app = P.app()
        conns = P.proxy.AppConns(P.proxy.local_client_creator(app))
        if app_h:
            conns.consensus.init_chain(
                [P.abci.ValidatorUpdate(v.pubkey, v.voting_power)
                 for v in self.states[0].validators.validators],
                self.gen.chain_id)
        for h in range(1, app_h + 1):
            P.exe.exec_block_on_app(conns.consensus,
                                    self.src_bs.load_block(h))
            conns.consensus.commit()
        return app, conns


# (store height, state height, app height)
MATRIX = [(0, 0, 0), (3, 3, 0), (3, 3, 2), (3, 3, 3), (3, 2, 3), (3, 2, 2),
          (3, 2, 0), (3, 3, 4), (3, 1, 1), (2, 3, 2), (4, 4, 1)]


@pytest.fixture(scope="module")
def chains():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_TPU_PIPELINE", "off")
        mp.setattr(tpipeline, "_configured", "off")
        out = {}
        for P in PKGS:
            ticking_clocks()
            out[P.name] = RecordedChain(P)
            P.clock.set_source(None)
        return out


@pytest.mark.parametrize("hs", MATRIX, ids=lambda t: "store%d-state%d-app%d" % t)
def test_handshake_matrix_matches_jax(chains, hs):
    store_h, state_h, app_h = hs
    out = {}
    for P in PKGS:
        c = chains[P.name]
        bs, ss = c.stores(store_h, state_h)
        app, conns = c.app(app_h)
        h = P.replay.Handshaker(ss, bs, c.gen, verifier=P.verifier())
        try:
            state = h.handshake(conns)
            out[P.name] = ("ok", P.enc.cdumps(state.to_obj()), app.app_hash,
                           app.height, h.n_blocks,
                           P.enc.cdumps(ss.load().to_obj()))
        except P.replay.HandshakeError as e:
            out[P.name] = ("error", str(e))
    assert out["port"] == out["jax"]
    if out["port"][0] == "ok" and store_h:
        assert out["port"][2] == chains["port"].states[store_h].app_hash


# --------------------------------------- a port node on a JAX node's files

@pytest.mark.parametrize("app_from", ["handshake", "carried"])
def test_port_node_continues_a_jax_nodes_chain(tmp_path, app_from):
    """A JAX node commits 3 heights on SQLite stores and a file WAL and
    stops. A copy of its files restarts as a JAX node and another as a
    port node (through convert.node_files_from_jax; the app rebuilt by
    the handshake's replay, or carried by convert.app_from_jax): both
    commit the same next 3 blocks, byte for byte."""
    gen, key = _gen(JAX, "carry-chain")
    jhome = str(tmp_path / "jax")
    ticking_clocks()
    jnode = _run_node(JAX, jhome, gen, key, 3)
    jnode.stop()
    h0 = jnode.height
    items, vals = jnode.app.snapshot_items(), [
        (v.pubkey, v.voting_power)
        for v in jnode.cs.state.validators.validators]
    homes = {n: str(tmp_path / n) for n in ("jax2", "port")}
    for h in homes.values():
        shutil.copytree(jhome, h)
    out = {}
    for P in PKGS:
        ticking_clocks()
        home = homes["jax2" if P is JAX else "port"]
        d = os.path.join(home, "data")
        if P is PORT:
            files = convert.node_files_from_jax(
                os.path.join(d, "blockstore.db"), os.path.join(d, "state.db"),
                os.path.join(d, "cs.wal", "wal"))
            pgen = convert.genesis_from_jax(gen.to_obj())
            pkey = P.keys.PrivKey.generate(b"\x09" * 32)
            app = convert.app_from_jax(items, h0, vals) \
                if app_from == "carried" else None
            node = MiniNode(P, home, pgen, pkey, app=app, files=files)
        else:
            app = None
            if app_from == "carried":
                app = JAX.app()
                app.restore_items(items, h0, vals)
            node = MiniNode(P, home, gen, key, app=app)
        assert node.height == h0
        node.start()
        node.run_to(h0 + 3)
        out[P.name] = (node.blocks(h0 + 1)[:3], node.app.app_hash,
                       node.handshake_blocks, node.replayed)
        node.stop()
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 3
