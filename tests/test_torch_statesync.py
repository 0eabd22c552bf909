"""The port's state sync (tendermint_tpu_torch.statesync) against the JAX
package's (tests/test_statesync.py), on the CPU, at tolerance 0.

The serving side of every net is the same four-validator chain in both
packages (tests/test_torch_state.Chain) stored with a SnapshotManager,
so that both serve byte-identical snapshot libraries; a fresh node
restores over in-process switches (socketpairs) and fast-syncs the tail.

- A fresh node joins by the newest snapshot and fast-syncs the tail, for
  every pairing of serving and restoring package (port from a JAX switch,
  JAX from a port switch): the restored State bytes, the bootstrapped
  store rows, the pin and the final store rows and app hash are equal.
- Channel 0x60: every message the server and client sides send for the
  same requests is byte-equal to the JAX reactor's.
- A peer serving corrupted chunks is banned with the JAX reactor's
  reason and the restore completes from the honest peer; a forged
  manifest bans its peer and falls back; a snapshot whose commit fails
  light verification is poisoned and the node falls back to block sync
  from genesis; the refusals' messages equal the JAX package's.
- A crash at statesync.before_apply and at statesync.after_restore is
  repaired by resume_pending_restore to the JAX package's rows; a
  restore dir holding some chunks and a torn one fetches only the rest.
- A verifier that fails on its device raises VerifierError out of
  apply_restore with the stores untouched, and a reactor's restore then
  ends with restore_error set, the gate held and nothing poisoned.
"""

import os
import shutil
import threading
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu import statesync as jss
from tendermint_tpu.blockchain import BlockchainReactor as JBlockchainReactor
from tendermint_tpu.config import test_config as jtest_config
from tendermint_tpu.consensus import ConsensusState as JConsensusState
from tendermint_tpu.consensus import MockTicker as JMockTicker
from tendermint_tpu.consensus.reactor import ConsensusReactor as JConsReactor
from tendermint_tpu.p2p import test_util as jtu
from tendermint_tpu.statesync import reactor as jssr
from tendermint_tpu_torch import statesync as tss
from tendermint_tpu_torch.blockchain import BlockchainReactor as TBlockchainReactor
from tendermint_tpu_torch.config import test_config as ttest_config
from tendermint_tpu_torch.consensus import ConsensusState as TConsensusState
from tendermint_tpu_torch.consensus import MockTicker as TMockTicker
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor as TConsReactor
from tendermint_tpu_torch.models.verifier import BatchVerifier, VerifierError
from tendermint_tpu_torch.p2p import test_util as ttu
from tendermint_tpu_torch.statesync import reactor as tssr
from tests.test_torch_snapshot import (BOTH, JAX, PORT, _Crash, _crash,
                                       _reset, _Stored, _tree)
from tests.test_torch_state import Chain, _dump, _raised

for _P, _ext in ((JAX, dict(ss=jss, ssr=jssr, bcr=JBlockchainReactor,
                            cs=JConsensusState, tick=JMockTicker,
                            cr=JConsReactor, tu=jtu,
                            test_config=jtest_config)),
                 (PORT, dict(ss=tss, ssr=tssr, bcr=TBlockchainReactor,
                             cs=TConsensusState, tick=TMockTicker,
                             cr=TConsReactor, tu=ttu,
                             test_config=ttest_config))):
    for _k, _v in _ext.items():
        setattr(_P, "sync_" + _k, _v)

N_BLOCKS = 13
GIVE_UP_S = 5.0       # the reference test gives 6 s; offers come in well under 1 s

_reset = _reset   # the fail hooks of both packages, reset after each test


def _txs(c, h):
    return [b"ss/k%d.%d=v%d" % (h % 5, i, h) for i in range(8)]


@pytest.fixture(scope="module")
def chains():
    out = {}
    for P in BOTH:
        c = Chain(P, 4)
        for h in range(1, N_BLOCKS + 1):
            c.next(_txs(c, h))
        out[P.name] = c
    return out


def _source(P, c, root, chunk_size=256, interval=4):
    return _Stored(P, c, root, mgr_kw=dict(interval=interval, keep=2,
                                           chunk_size=chunk_size))


def _serving_switch(P, src, seed, reactor_cls=None, snap_store=None):
    cls = reactor_cls or P.sync_ssr.StateSyncReactor
    ss = cls(snap_store or src.snaps, src.c.gen.chain_id)
    bc = P.sync_bcr(src.c.state, None, src.bs, fast_sync=False)
    sw = P.sync_tu.make_switch(network=src.c.gen.chain_id, seed=seed)
    sw.add_reactor("blockchain", bc)
    sw.add_reactor("statesync", ss)
    sw.start()
    return sw


def _fresh_side(P, gen, root, give_up_s=8.0, verifier=None):
    """A restoring node's assembly (tests/test_statesync.py _fresh_side)
    in package P; the ban reasons its reactor gives are recorded."""
    app = P.app()
    conns = P.proxy.AppConns(P.proxy.local_client_creator(app))
    state_store = P.ss.StateStore(P.db.MemDB())
    block_store = P.bs.BlockStore(P.db.MemDB())
    state = state_store.load_or_genesis(gen)
    conns.consensus.init_chain(
        [P.abci.ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen.chain_id)
    verifier = verifier or P.verifier
    exec_ = P.exe.BlockExecutor(state_store, conns.consensus,
                                verifier=verifier)
    gate = threading.Event()
    cs = P.sync_cs(P.sync_test_config().consensus, state, exec_,
                   block_store, priv_validator=None,
                   ticker_factory=P.sync_tick)
    cons = P.sync_cr(cs, fast_sync=True)
    bc = P.sync_bcr(state, exec_, block_store, fast_sync=True,
                    consensus_reactor=cons, verify_window=5, gate=gate)
    local_snaps = P.snap.SnapshotStore(os.path.join(root, "snapshots"))
    statesync_dir = os.path.join(root, "statesync")

    def on_done(restored):
        if restored is not None:
            cs.state = restored
            bc.adopt_restored(restored)
        gate.set()

    ss = P.sync_ssr.StateSyncReactor(
        local_snaps, gen.chain_id, restore=True,
        statesync_dir=statesync_dir, block_store=block_store,
        state_store=state_store, app=app, verifier=verifier,
        on_restored=on_done, give_up_s=give_up_s)
    bans = []
    ban = ss._ban

    def recorded_ban(peer, reason):
        bans.append((peer.id, reason))
        ban(peer, reason)

    ss._ban = recorded_ban
    sw = P.sync_tu.make_switch(network=gen.chain_id, seed=b"\x7f" * 32)
    sw.add_reactor("consensus", cons)
    sw.add_reactor("blockchain", bc)
    sw.add_reactor("statesync", ss)
    return SimpleNamespace(app=app, block_store=block_store,
                           state_store=state_store, bc=bc, ss=ss, sw=sw,
                           gate=gate, statesync_dir=statesync_dir,
                           local_snaps=local_snaps, bans=bans)


def _wait(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(what)


def _connect(serving, fresh_sw):
    """The serving switch dials the fresh one over a socketpair (either
    package's connect_switches drives both; the port's is used)."""
    ttu.connect_switches(serving, fresh_sw)


# ------------------------------------------------------ join and tail --

def _join(S, F, chains, tmp_path):
    src = _source(S, chains[S.name], str(tmp_path / f"src-{S.name}"))
    sw_src = _serving_switch(S, src, b"\x01" * 32)
    new = _fresh_side(F, chains[F.name].gen, str(tmp_path / f"new-{F.name}"))
    new.sw.start()
    _connect(sw_src, new.sw)
    try:
        _wait(lambda: new.bc.synced, 40, "never synced")
        restored = new.ss.restored_state
        assert restored is not None
        snap_h = restored.last_block_height
        return {"snap_heights": src.snaps.list_heights(),
                "restored": F.enc.cdumps(restored.to_obj()),
                "base": new.block_store.base(),
                "height": new.block_store.height(),
                "app": (new.app.height, new.app.app_hash),
                "bc_app_hash": new.bc.state.app_hash,
                "pin": new.state_store.load_snapshot_pin(snap_h),
                "local": _tree(new.local_snaps.root_dir),
                "statesync_left": _tree(new.statesync_dir),
                "rows": (_dump(new.block_store.db),
                         _dump(new.state_store.db)),
                "bans": new.bans,
                "status": {k: v for k, v in new.ss.status().items()
                           if k in ("restoring", "finished", "restored",
                                    "chunks_total", "chunks_pending")}}
    finally:
        sw_src.stop()
        new.sw.stop()


@pytest.fixture(scope="module")
def jax_join(chains, tmp_path_factory):
    """The JAX package's own join: a JAX fresh node from a JAX switch."""
    return _join(JAX, JAX, chains, tmp_path_factory.mktemp("jax_join"))


@pytest.mark.parametrize("pair", ["port_from_port", "port_from_jax",
                                  "jax_from_port"])
def test_fresh_node_joins_by_snapshot_and_syncs_the_tail(tmp_path, chains,
                                                         jax_join, pair):
    fresh, serving = pair.split("_from_")
    pk = {"jax": JAX, "port": PORT}
    got = _join(pk[serving], pk[fresh], chains, tmp_path)
    assert got == jax_join
    c = chains["port"]
    snap_h = max(got["snap_heights"])
    assert snap_h == 12
    assert got["base"] == snap_h + 1
    assert got["height"] == N_BLOCKS - 1
    assert got["app"] == (N_BLOCKS - 1, c.states[N_BLOCKS - 1].app_hash)
    assert got["bc_app_hash"] == c.states[N_BLOCKS - 1].app_hash
    assert got["statesync_left"] == {}
    assert got["bans"] == []


# ---------------------------------------------------- channel 0x60 -----

class _Peer:
    def __init__(self, pid):
        self.id = pid
        self.sent = []

    def try_send_obj(self, ch, obj):
        self.sent.append((ch, obj))
        return True


def _wire(P, c, root):
    """Every message the server and client sides of package P send for
    the same requests, as canonical bytes."""
    src = _source(P, c, os.path.join(root, "src"), chunk_size=512)
    server = P.sync_ssr.StateSyncReactor(src.snaps, c.gen.chain_id)
    h = max(src.snaps.list_heights())
    m = src.snaps.load_manifest(h)
    peer = _Peer("aa" * 20)
    reqs = [{"type": "snapshots_request"},
            {"type": "manifest_request", "height": h, "root": m["root"]},
            {"type": "manifest_request", "height": h, "root": "00"},
            {"type": "manifest_request", "height": 3, "root": m["root"]},
            {"type": "chunk_request", "height": h, "root": m["root"],
             "index": 0},
            {"type": "chunk_request", "height": h, "root": m["root"],
             "index": len(m["chunks"]) - 1},
            {"type": "chunk_request", "height": h, "root": m["root"],
             "index": len(m["chunks"])},
            {"type": "chunk_request", "height": h, "root": "ff",
             "index": 0}]
    for r in reqs:
        server.receive(P.sync_ss.STATESYNC_CHANNEL, peer, P.enc.cdumps(r))
    out = [(ch, P.enc.cdumps(o)) for ch, o in peer.sent]
    client = P.sync_ssr.StateSyncReactor(
        P.snap.SnapshotStore(os.path.join(root, "local")), c.gen.chain_id,
        restore=True, statesync_dir=os.path.join(root, "ss"))
    cpeer = _Peer("bb" * 20)
    client.add_peer(cpeer)
    out += [(ch, P.enc.cdumps(o)) for ch, o in cpeer.sent]
    out.append([(d.id, d.priority, d.send_queue_capacity,
                 d.recv_message_capacity) for d in server.get_channels()])
    return out, [r["type"] for r in reqs]


def test_channel_0x60_messages_match_jax(tmp_path, chains):
    out = {P.name: _wire(P, chains[P.name], str(tmp_path / P.name))
           for P in BOTH}
    assert out["port"] == out["jax"]
    msgs = out["port"][0]
    assert msgs[0][0] == 0x60
    kinds = [tss.reactor.encoding.cloads(b)["type"] for _, b in msgs[:-1]]
    assert kinds == ["snapshots_response", "manifest_response",
                     "no_manifest", "no_manifest", "chunk_response",
                     "chunk_response", "no_chunk", "no_chunk",
                     "snapshots_request"]


# --------------------------------------------------- hostile peers -----

def _evil_chunks_cls(P):
    class EvilChunks(P.sync_ssr.StateSyncReactor):
        served = 0

        def _serve_chunk(self, peer, msg):
            m = self.snapshot_store.load_manifest(int(msg.get("height", 0)))
            if m is None:
                return super()._serve_chunk(peer, msg)
            EvilChunks.served += 1
            peer.try_send_obj(P.sync_ss.STATESYNC_CHANNEL, {
                "type": "chunk_response", "height": m["height"],
                "index": int(msg.get("index", 0)),
                "root": msg.get("root", ""),
                "data": (b"\xde\xad" * 40).hex()})
    return EvilChunks


def _evil_manifest_cls(P):
    class EvilManifest(P.sync_ssr.StateSyncReactor):
        def _serve_manifest(self, peer, msg):
            m = self.snapshot_store.load_manifest(int(msg.get("height", 0)))
            if m is None:
                return super()._serve_manifest(peer, msg)
            m = dict(m)
            m["chunks"] = ["00" * 32] * len(m["chunks"])
            peer.try_send_obj(P.sync_ss.STATESYNC_CHANNEL, {
                "type": "manifest_response", "height": m["height"],
                "manifest": m})
    return EvilManifest


def _bad_chunks(P, c, root):
    src = _source(P, c, os.path.join(root, "src"), chunk_size=64)
    evil_cls = _evil_chunks_cls(P)
    sw_honest = _serving_switch(P, src, b"\x01" * 32)
    sw_evil = _serving_switch(P, src, b"\x02" * 32, reactor_cls=evil_cls)
    new = _fresh_side(P, c.gen, os.path.join(root, "new"))
    new.sw.start()
    _connect(sw_evil, new.sw)
    _connect(sw_honest, new.sw)
    try:
        _wait(lambda: new.ss.finished.is_set(), 40, "never concluded")
        _wait(lambda: new.bc.synced, 30, "tail never synced")
        assert evil_cls.served >= 1
        return [new.ss.restored_state.last_block_height,
                sorted(new.ss._banned), sorted(set(new.bans)),
                sw_evil.node_info.id in new.ss._banned,
                new.bc.state.app_hash, new.ss.status()["chunks_bad"] >= 1
                if P is PORT else True]
    finally:
        sw_honest.stop()
        sw_evil.stop()
        new.sw.stop()


def _forged_manifest(P, c, root):
    src = _source(P, c, os.path.join(root, "src"))
    sw_evil = _serving_switch(P, src, b"\x02" * 32,
                              reactor_cls=_evil_manifest_cls(P))
    new = _fresh_side(P, c.gen, os.path.join(root, "new"),
                      give_up_s=GIVE_UP_S)
    new.sw.start()
    _connect(sw_evil, new.sw)
    try:
        _wait(lambda: new.ss.finished.is_set(), 40, "never concluded")
        return [new.ss.restored_state, sorted(new.ss._banned), new.bans,
                new.gate.is_set(), new.block_store.height()]
    finally:
        sw_evil.stop()
        new.sw.stop()


def _poisoned(P, c, root):
    src = _source(P, c, os.path.join(root, "src"))
    h = max(src.snaps.list_heights())
    payload = src.snaps.assemble_payload(h)
    for p in payload["commit"]["precommits"]:
        if p is not None:
            p["signature"] = "00" * 64
    evil = P.snap.SnapshotStore(os.path.join(root, "evil"))
    manifest = evil.take(h, payload, chunk_size=256)
    # the refusal's message, from the apply itself
    refusal = _raised(lambda: P.sync_ss.apply_restore(
        evil, manifest, P.bs.BlockStore(P.db.MemDB()),
        P.ss.StateStore(P.db.MemDB()),
        P.snap.SnapshotStore(os.path.join(root, "x")), P.app(),
        c.gen.chain_id, verifier=P.verifier))
    sw_evil = _serving_switch(P, src, b"\x02" * 32, snap_store=evil)
    new = _fresh_side(P, c.gen, os.path.join(root, "new"),
                      give_up_s=GIVE_UP_S)
    new.sw.start()
    _connect(sw_evil, new.sw)
    try:
        _wait(lambda: new.ss.finished.is_set(), 40, "never concluded")
        out = [refusal, new.ss.restored_state, sorted(new.ss._poisoned),
               new.bans]
        _wait(lambda: new.bc.synced, 40, "fallback sync never ran")
        return out + [new.block_store.base(), new.block_store.height(),
                      new.bc.state.app_hash, _tree(evil.root_dir) != {}]
    finally:
        sw_evil.stop()
        new.sw.stop()


HOSTILE = {"bad_chunks": _bad_chunks, "forged_manifest": _forged_manifest,
           "poisoned_snapshot": _poisoned}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_hostile_peers_are_refused_like_jax(tmp_path, chains, case,
                                            monkeypatch):
    # a banned manifest server is waited out for MANIFEST_TIMEOUT_S in
    # both packages; a shorter wait keeps the test short
    for mod in (jssr, tssr):
        monkeypatch.setattr(mod, "MANIFEST_TIMEOUT_S", 1.0)
    out = {P.name: HOSTILE[case](P, chains[P.name], str(tmp_path / P.name))
           for P in BOTH}
    assert out["port"] == out["jax"]
    got = out["port"]
    if case == "bad_chunks":
        assert got[0] == 12 and got[3]
        assert [r for _, r in got[2]][0].startswith("chunk ")
    elif case == "forged_manifest":
        assert got[0] is None and got[2] and got[3]
        assert got[2][0][1] == "manifest root mismatch"
    else:
        assert got[0][0] == "ValueError"
        assert got[1] is None and got[2][0][0] == 12
        assert got[4:6] == [1, N_BLOCKS - 1]


# --------------------------------------------------- crash and resume --

def _crash_resume(P, c, root):
    src = _source(P, c, os.path.join(root, "src"))
    h = max(src.snaps.list_heights())
    manifest = src.snaps.load_manifest(h)
    out = []
    for point in ("statesync.before_apply", "statesync.after_restore"):
        base = os.path.join(root, point)
        restore_store = P.snap.SnapshotStore(os.path.join(base, "ss"))
        os.makedirs(restore_store.dir_for(h))
        for name in os.listdir(src.snaps.dir_for(h)):
            shutil.copy(os.path.join(src.snaps.dir_for(h), name),
                        os.path.join(restore_store.dir_for(h), name))
        state_store = P.ss.StateStore(P.db.MemDB())
        block_store = P.bs.BlockStore(P.db.MemDB())
        state_store.load_or_genesis(c.gen)
        local = P.snap.SnapshotStore(os.path.join(base, "snapshots"))
        P.fail.arm(point, _crash)
        try:
            P.sync_ss.apply_restore(restore_store, manifest, block_store,
                                    state_store, local, P.app(),
                                    c.gen.chain_id, verifier=P.verifier)
            out.append("no crash")
        except _Crash as e:
            out.append(str(e))
        P.fail.disarm_all()
        out += [restore_store.load_manifest(h) is not None,
                _dump(block_store.db), _dump(state_store.db)]
        app2 = P.app()
        state = P.sync_ss.resume_pending_restore(
            os.path.join(base, "ss"), block_store, state_store, local, app2,
            c.gen.chain_id, verifier=P.verifier)
        out += [P.enc.cdumps(state.to_obj()), block_store.height(),
                block_store.base(), state_store.latest_snapshot_height(),
                (app2.height, app2.app_hash), restore_store.list_heights(),
                local.list_heights(), _tree(local.root_dir),
                _dump(block_store.db), _dump(state_store.db),
                P.sync_ss.resume_pending_restore(
                    os.path.join(base, "ss"), block_store, state_store,
                    local, P.app(), c.gen.chain_id, verifier=P.verifier)]
    return out


def test_crash_mid_restore_resumes_to_the_jax_rows(tmp_path, chains):
    out = {P.name: _crash_resume(P, chains[P.name], str(tmp_path / P.name))
           for P in BOTH}
    assert out["port"] == out["jax"]
    got = out["port"]
    assert got[0] == "statesync.before_apply"
    assert got[5] == 12 and got[6] == 13 and got[7] == 12
    assert got[-1] is None


def test_restore_resumes_a_partial_chunk_dir(tmp_path, chains):
    """Half the chunks and one torn file on disk: only the remainder is
    fetched, and the restore lands at the snapshot height."""
    c = chains["port"]
    src = _source(PORT, c, str(tmp_path / "src"), chunk_size=64)
    h = max(src.snaps.list_heights())
    manifest = src.snaps.load_manifest(h)
    assert len(manifest["chunks"]) >= 3
    new = _fresh_side(PORT, c.gen, str(tmp_path / "new"))
    restore_store = PORT.snap.SnapshotStore(new.statesync_dir)
    os.makedirs(restore_store.dir_for(h))
    src_dir = src.snaps.dir_for(h)
    shutil.copy(os.path.join(src_dir, "manifest.json"),
                os.path.join(restore_store.dir_for(h), "manifest.json"))
    half = manifest["chunks"][:len(manifest["chunks"]) // 2]
    for digest in half:
        name = PORT.snap.chunk_name(digest)
        shutil.copy(os.path.join(src_dir, name),
                    os.path.join(restore_store.dir_for(h), name))
    torn = manifest["chunks"][-1]
    with open(os.path.join(restore_store.dir_for(h),
                           PORT.snap.chunk_name(torn)), "wb") as f:
        f.write(b"torn")
    sw_src = _serving_switch(PORT, src, b"\x01" * 32)
    new.sw.start()
    _connect(sw_src, new.sw)
    try:
        _wait(lambda: new.ss.finished.is_set(), 40, "never concluded")
        assert new.ss.restored_state.last_block_height == h
        status = new.ss.status()
        assert status["chunks_ok"] == len(manifest["chunks"]) - len(half)
        assert status["restore_height"] == h and status["error"] is None
        assert set(status["timings"]) >= {"discovery_s", "fetch_s",
                                          "verify_s", "app_s"}
    finally:
        sw_src.stop()
        new.sw.stop()


# ------------------------------------------ a device that fails to verify --

class _FailingVerifier(BatchVerifier):
    def __init__(self):
        super().__init__("python")

    def verify_async(self, items):
        raise VerifierError("launch failed (simulated)")


def test_verifier_failure_raises_and_never_falls_back(tmp_path, chains):
    c = chains["port"]
    src = _source(PORT, c, str(tmp_path / "src"))
    h = max(src.snaps.list_heights())
    bs = PORT.bs.BlockStore(PORT.db.MemDB())
    ss = PORT.ss.StateStore(PORT.db.MemDB())
    with pytest.raises(VerifierError):
        PORT.sync_ss.apply_restore(
            src.snaps, src.snaps.load_manifest(h), bs, ss,
            PORT.snap.SnapshotStore(str(tmp_path / "x")), PORT.app(),
            c.gen.chain_id, verifier=_FailingVerifier())
    assert _dump(bs.db) == {} and _dump(ss.db) == {}

    sw_src = _serving_switch(PORT, src, b"\x01" * 32)
    new = _fresh_side(PORT, c.gen, str(tmp_path / "new"),
                      verifier=_FailingVerifier())
    new.sw.start()
    _connect(sw_src, new.sw)
    try:
        _wait(lambda: new.ss.finished.is_set(), 40, "never concluded")
        assert isinstance(new.ss.restore_error, VerifierError)
        assert not new.gate.is_set()
        assert new.ss.restored_state is None
        assert new.ss._poisoned == set()
        assert new.block_store.height() == 0
        assert new.ss.status()["fallback"] == 0
        time.sleep(0.3)
        assert not new.bc.synced
    finally:
        sw_src.stop()
        new.sw.stop()


# ------------------------------------- a restore torn inside a node's start --

def _node_restore(P, root, point, monkeypatch):
    """A source node (snapshots every 2 heights, 2 kept) commits two waves
    to 6; a fresh home holds its snapshot at 6 in the statesync dir, as
    a finished download leaves it. A node started there is crashed at
    `point` inside its start (resume_pending_restore), started again, and
    then commits a third wave: its rows, app hashes and blocks."""
    from tests.test_torch_snapshot import (WAVE_A, WAVE_B, _commit_to,
                                           _drain, _gen, _inject,
                                           _make_node)
    recovery = dict(snapshot_interval=2, snapshot_keep=2)
    monkeypatch.setenv("TM_TPU_SNAPSHOT_INTERVAL", "2")
    monkeypatch.setenv("TM_TPU_SNAPSHOT_KEEP", "2")
    gen, key = _gen(P, "restore-crash")
    src = _make_node(P, os.path.join(root, "src"), gen, key, recovery)
    src.start()
    _inject(src, WAVE_A)
    _commit_to(src, 3)
    _inject(src, WAVE_B)
    _commit_to(src, 6)
    _drain(src)
    assert src.height == 6 and 6 in src.snapshot_store.list_heights()
    snap_dir = src.snapshot_store.dir_for(6)
    wave_c = [b"sn/c%d=u%d" % (i, i) for i in range(1, 4)]
    _inject(src, wave_c)
    _commit_to(src, 7)
    src_top, src_hash = src.height, src.consensus.state.app_hash
    src.stop()
    home = os.path.join(root, "new")
    shutil.copytree(snap_dir, os.path.join(home, "data", "statesync", "6"))
    P.fail.arm(point, _crash)
    with pytest.raises(_Crash):
        _make_node(P, home, gen, key, recovery)
    P.fail.disarm_all()
    node = _make_node(P, home, gen, key, recovery)
    out = [node.height, node.consensus.state.app_hash, node.app.height,
           node.block_store.base(), node.block_store.height(),
           _dump(node.block_store.db), _dump(node.state_store.db),
           _tree(node.snapshot_store.root_dir),
           os.listdir(os.path.join(home, "data", "statesync"))]
    node.start()
    _inject(node, wave_c)
    _commit_to(node, src_top)
    out += [node.height == src_top,
            node.consensus.state.app_hash == src_hash]
    if P is PORT:
        out.append(node.recovery_counts()["resumed_restore"])
    node.stop()
    return out


@pytest.mark.parametrize("point", ["statesync.before_apply",
                                   "statesync.after_restore"])
def test_restore_torn_inside_a_node_start_resumes_like_jax(
        tmp_path, monkeypatch, point):
    """The crash sweep's restore points at node level, on a pinned clock
    in both packages: the next start completes the restore to the same
    rows, the handshake rebuilds nothing, and the node commits on to the
    source's app hash."""
    from tendermint_tpu.utils import clock as jclock
    from tendermint_tpu_torch.utils import clock as tclock
    for clk in (jclock, tclock):
        clk.set_source(lambda: 10 ** 18)
    try:
        out = {P.name: _node_restore(P, str(tmp_path / P.name), point,
                                     monkeypatch)
               for P in BOTH}
    finally:
        for clk in (jclock, tclock):
            clk.set_source(None)
    resumed = out["port"].pop()
    assert out["port"] == out["jax"]
    assert out["port"][:5] == [6, out["port"][1], 6, 7, 6]
    assert out["port"][8] == [] and out["port"][-2:] == [True, True]
    assert resumed == 6


def test_the_port_nodes_peer_floor_reads_consensus_heights():
    """The pruner's peer frontier: the blockchain reactor's reported
    heights (the JAX node's only source, stale once a peer leaves fast
    sync) and each peer's consensus height, a peer's need one above the
    larger; no peer, no bound."""
    from tendermint_tpu_torch import node as tnode

    class _PS:
        def __init__(self, height):
            self.lock = threading.Lock()
            self.height = height

    def floor(reported, states):
        stub = SimpleNamespace(
            blockchain_reactor=SimpleNamespace(
                _ph_lock=threading.Lock(), _peer_heights=reported),
            consensus_reactor=SimpleNamespace(peer_states={
                k: _PS(h) for k, h in states.items()}))
        return tnode.Node._peer_floor(stub)

    assert floor({}, {}) == (1 << 62) + 1
    assert floor({"a": 2, "b": 2}, {}) == 3          # the JAX reading
    assert floor({"a": 2, "b": 2}, {"a": 41, "b": 38}) == 38
    assert floor({"a": 2}, {"a": 41, "c": 0}) == 1   # c is fast-syncing
    assert floor({"a": 30}, {"a": 12}) == 31
