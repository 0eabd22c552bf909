"""The port's snapshot plane (tendermint_tpu_torch.storage.snapshot, the
block and state stores' bootstrap, pins and prune, the handshake's
local-snapshot seam) against the JAX package's, on the CPU, at
tolerance 0: the scenarios of tests/test_snapshot.py through both
packages side by side.

- The snapshot store: take / assemble / idempotence, content-addressed
  chunks and bit rot, a tampered manifest root, a crash at each
  publication fail point, retention: every file the library holds and
  every refusal's class and message equal the JAX store's.
- A four-validator chain (tests/test_torch_state.Chain, the same blocks
  in both packages) stored height by height with a SnapshotManager on
  it: the snapshot trees (payload chunks, manifests, roots), the block
  store's and state store's rows after the manager's snapshots and
  pruning, and the manager's floors, byte for byte; the floor policy
  (no snapshot, a pinned snapshot, a peer frontier, the evidence
  horizon) on the same chain.
- Store mechanics: block store prune with the prune.mid_range crash and
  the self-healing base, the state store's prune with its indirection
  targets, bootstrap and the snapshot pins: equal rows.
- light_verify_payload: a genuine payload passes, a forged commit and a
  wrong chain id fail with the JAX package's messages.
- The handshake's seam: a fresh app behind a pruned store is rebuilt
  from the newest pinned snapshot to the JAX handshake's State and app
  hash; with no snapshot store both raise the same HandshakeError.
- Nodes: the crash sweep at snapshot.after_chunk,
  snapshot.before_publish and prune.mid_range (a port node crashed at
  the point, rebuilt from its files, reaches an uncrashed JAX node's app
  hash, no half snapshot visible), and a pruned port node's restart
  rebuilding its app from a snapshot to the JAX node's app hash.

The port verifies on BatchVerifier("python") here (the card's kernels
run in chip_smoke.py's recovery phase).
"""

import os

import pytest

from tendermint_tpu import config as jconfig
from tendermint_tpu import node as jnode
from tendermint_tpu.consensus import MockTicker as JMockTicker
from tendermint_tpu.consensus import replay as jreplay
from tendermint_tpu.storage import snapshot as jsnap
from tendermint_tpu.types import priv_validator as jpv
from tendermint_tpu.utils import fail as jfail
from tendermint_tpu_torch import config as tconfig
from tendermint_tpu_torch import node as tnode
from tendermint_tpu_torch import pipeline as tpipeline
from tendermint_tpu_torch.consensus import MockTicker as TMockTicker
from tendermint_tpu_torch.consensus import replay as treplay
from tendermint_tpu_torch.models.verifier import BatchVerifier
from tendermint_tpu_torch.storage import snapshot as tsnap
from tendermint_tpu_torch.types import priv_validator as tpv
from tendermint_tpu_torch.utils import fail as tfail
from tests.test_torch_state import JAX, PORT, Chain, _dump, _raised

for _P, _ext in ((JAX, dict(snap=jsnap, fail=jfail, replay=jreplay,
                            config=jconfig, node=jnode, pv=jpv,
                            ticker=JMockTicker, verifier=None)),
                 (PORT, dict(snap=tsnap, fail=tfail, replay=treplay,
                             config=tconfig, node=tnode, pv=tpv,
                             ticker=TMockTicker,
                             verifier=BatchVerifier("python")))):
    for _k, _v in _ext.items():
        setattr(_P, _k, _v)
BOTH = (JAX, PORT)


class _Crash(BaseException):
    """A simulated process death: nothing between the fail point and the
    test may swallow it."""


def _crash(name):
    raise _Crash(name)


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setattr(tpipeline, "_configured", "auto")
    yield
    for f in (jfail, tfail):
        f.clear_callback()
        f.set_target(None)
        f.disarm_all()
        f.reset()


def _tree(root) -> dict:
    """Every file under root: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _payload(n_app=5):
    return {"state": {"chain_id": "t", "app_hash": "ab" * 32},
            "commit": {}, "app": [["%02x" % i, "aa"] for i in range(n_app)]}


# ------------------------------------------------------- snapshot store --

def _roundtrip(P, root):
    store = P.snap.SnapshotStore(root)
    m = store.take(8, _payload(), chunk_size=16)
    return [P.enc.cdumps(m), len(m["chunks"]),
            m["root"] == P.snap.manifest_root(m["chunks"]),
            store.list_heights(), store.assemble_payload(8, m["root"]),
            store.take(8, _payload(99), chunk_size=16) == m]


def _bit_rot(P, root):
    store = P.snap.SnapshotStore(root)
    m = store.take(4, _payload(), chunk_size=16)
    data = store.read_chunk(4, 1)
    path = os.path.join(store.dir_for(4), P.snap.chunk_name(m["chunks"][1]))
    with open(path, "wb") as f:
        f.write(b"\x00" * len(data))
    return [data, store.read_chunk(4, 1), store.read_chunk(4, 99),
            store.read_chunk(5, 0),
            _raised(lambda: store.assemble_payload(4)),
            _raised(lambda: store.assemble_payload(6))]


def _tampered_root(P, root):
    store = P.snap.SnapshotStore(root)
    m = store.take(4, _payload(), chunk_size=64)
    out = [_raised(lambda: store.assemble_payload(4, "cd" * 32))]
    m["root"] = "00" * 32
    with open(os.path.join(store.dir_for(4), P.snap.MANIFEST_NAME),
              "wb") as f:
        f.write(P.enc.cdumps(m))
    return out + [_raised(lambda: store.assemble_payload(4))]


def _crash_mid_write(P, root):
    out = []
    for point in ("snapshot.after_chunk", "snapshot.before_publish"):
        store = P.snap.SnapshotStore(os.path.join(root, point))
        P.fail.arm(point, _crash)
        try:
            store.take(8, _payload(), chunk_size=16)
            out.append("no crash")
        except _Crash as e:
            out.append(str(e))
        P.fail.disarm_all()
        out += [store.list_heights(), store.load_manifest(8),
                sorted(_tree(store.root_dir))]
        m = store.take(8, _payload(), chunk_size=16)
        out += [store.assemble_payload(8, m["root"]) == _payload(),
                sorted(_tree(store.root_dir))]
    return out


def _retention(P, root):
    store = P.snap.SnapshotStore(root)
    for h in (2, 4, 6, 8):
        store.take(h, _payload(), chunk_size=64)
    return [store.retain(2), store.list_heights(), store.retain(0),
            store.retain(5)]


STORE_SCENARIOS = {"roundtrip": _roundtrip, "bit_rot": _bit_rot,
                   "tampered_root": _tampered_root,
                   "crash_mid_write": _crash_mid_write,
                   "retention": _retention}


@pytest.mark.parametrize("scenario", sorted(STORE_SCENARIOS))
def test_snapshot_store_matches_jax(tmp_path, scenario):
    fn = STORE_SCENARIOS[scenario]
    out = {}
    for P in BOTH:
        root = str(tmp_path / P.name)
        out[P.name] = (fn(P, root), _tree(root))
    assert out["port"] == out["jax"]


# --------------------------------------------- a chain with its snapshots --

def _txs(c, h):
    return [b"sn%d/k%d=v%d" % (h % 4, i, h) for i in range(6)]


def _chain(P, n_blocks, max_age=None):
    c = Chain(P, 4)
    if max_age is not None:
        c.state.consensus_params.evidence.max_age = max_age
    for h in range(1, n_blocks + 1):
        c.next(_txs(c, h))
    return c


class _Stored:
    """Package P's chain `c` saved height by height into MemDB stores,
    each height offered to a SnapshotManager (as the node's commit path
    does) when `mgr_kw` is given."""

    def __init__(self, P, c, root, upto=None, mgr_kw=None, every=True):
        self.P, self.c = P, c
        self.bs = P.bs.BlockStore(P.db.MemDB())
        self.ss = P.ss.StateStore(P.db.MemDB())
        self.snaps = P.snap.SnapshotStore(root)
        # the app the manager snapshots sits at exactly the height offered
        self.app = P.app()
        conns = P.proxy.AppConns(P.proxy.local_client_creator(self.app))
        conns.consensus.init_chain(
            [P.abci.ValidatorUpdate(v.pubkey, v.voting_power)
             for v in c.states[0].validators.validators], c.gen.chain_id)
        self.mgr = None
        if mgr_kw is not None:
            self.mgr = P.snap.SnapshotManager(
                self.snaps, self.ss, self.bs, self.app, **mgr_kw)
        self.ss.save(c.states[0])
        n = len(c.blocks) if upto is None else upto
        for i in range(n):
            block = c.blocks[i]
            seen = c.blocks[i + 1].last_commit if i + 1 < len(c.blocks) \
                else c.last_commit
            psz = c.states[i].consensus_params.block_gossip \
                .block_part_size_bytes
            self.bs.save_block(block, block.make_part_set(psz), seen)
            P.exe.exec_block_on_app(conns.consensus, block,
                                    c.states[i].validators)
            assert conns.consensus.commit() == c.states[i + 1].app_hash
            self.ss.save_abci_responses(i + 1, c.responses[i].to_obj())
            self.ss.save(c.states[i + 1])
            if self.mgr is not None and (every or i + 1 == n):
                self.mgr.maybe_snapshot(c.states[i + 1])

    def rows(self):
        return _dump(self.bs.db), _dump(self.ss.db)


@pytest.fixture(scope="module")
def chains():
    """12 heights of the same four-validator chain in both packages, and
    the same with evidence max_age 3."""
    return {(P.name, age): _chain(P, 12, max_age=age)
            for P in BOTH for age in (None, 3)}


MGR_CASES = {
    "interval4_keep2_retain3": dict(interval=4, keep=2, chunk_size=256,
                                    retain_heights=3),
    "interval5_keep1_no_prune": dict(interval=5, keep=1, chunk_size=512),
    "interval3_retain2_one_chunk": dict(interval=3, keep=3,
                                        chunk_size=1 << 20,
                                        retain_heights=2),
}


@pytest.mark.parametrize("case", sorted(MGR_CASES))
@pytest.mark.parametrize("age", [None, 3], ids=["age_default", "age3"])
def test_chain_snapshots_and_pruning_match_jax(tmp_path, chains, case, age):
    """The same chain in both packages, the same manager: the payloads,
    chunks, manifests and roots on disk, the pins, and every row of both
    stores after the manager's pruning are equal byte for byte."""
    out = {}
    for P in BOTH:
        s = _Stored(P, chains[(P.name, age)], str(tmp_path / P.name),
                    mgr_kw=MGR_CASES[case])
        out[P.name] = (_tree(s.snaps.root_dir), s.rows(), s.bs.base(),
                       s.ss.latest_snapshot_height(),
                       s.snaps.list_heights())
        if P is PORT:
            counts = s.mgr.counts
    assert out["port"] == out["jax"]
    heights = out["port"][4]
    assert heights and counts["latest"] == heights[-1]
    assert counts["published"] >= len(heights)
    if MGR_CASES[case].get("retain_heights"):
        assert out["port"][2] > 1 and counts["pruned_blocks"] > 0


def test_payload_bytes_and_light_verify_match_jax(tmp_path, chains):
    """build_payload at height 9 of the same chain: equal canonical bytes
    in both packages; light_verify_payload accepts it and refuses a forged
    commit, a wrong chain id, a commit of another height and one sealing
    another block with the JAX package's messages."""
    out = {}
    for P in BOTH:
        s = _Stored(P, chains[(P.name, None)], str(tmp_path / P.name),
                    upto=9)
        st = s.c.states[9]
        commit = s.bs.load_seen_commit(9)
        payload = P.snap.build_payload(st, commit, s.app.snapshot_items())
        got_state, got_commit = P.snap.light_verify_payload(
            P.enc.cloads(P.enc.cdumps(payload)), s.c.gen.chain_id,
            verifier=P.verifier)
        forged = P.enc.cloads(P.enc.cdumps(payload))
        for p in forged["commit"]["precommits"]:
            if p is not None:
                p["signature"] = "00" * 64
        other_h = P.enc.cloads(P.enc.cdumps(payload))
        other_h["commit"] = s.bs.load_seen_commit(8).to_obj()
        other_b = P.enc.cloads(P.enc.cdumps(payload))
        other_b["state"]["last_block_id"] = s.c.states[8].last_block_id \
            .to_obj()
        out[P.name] = [
            P.enc.cdumps(payload), P.enc.cdumps(got_state.to_obj()),
            got_commit.to_bytes(),
            P.snap.payload_app_items(payload),
            _raised(lambda: P.snap.light_verify_payload(
                forged, s.c.gen.chain_id, verifier=P.verifier)),
            _raised(lambda: P.snap.light_verify_payload(
                payload, "other-chain", verifier=P.verifier)),
            _raised(lambda: P.snap.light_verify_payload(
                other_h, s.c.gen.chain_id, verifier=P.verifier)),
            _raised(lambda: P.snap.light_verify_payload(
                other_b, s.c.gen.chain_id, verifier=P.verifier))]
    assert out["port"] == out["jax"]
    assert out["port"][4][0] == "ValueError"
    assert "chain_id" in out["port"][5][1]


# ---------------------------------------------------- floor policy --------

def _floors(P, c, root):
    """tests/test_snapshot.py's three floor scenarios on package P's
    stored chain: bases and rows after each."""
    out = []
    # no snapshot: pruning refuses; then a pinned snapshot at 6 caps it
    s = _Stored(P, c, root + "/a", mgr_kw=dict(interval=0,
                                                retain_heights=1))
    out.append(s.bs.base())
    m = s.snaps.take(6, _payload())
    s.ss.pin_snapshot(6, m)
    s.mgr.maybe_snapshot(c.state)
    out += [s.bs.base(), s.bs.load_block(6) is not None, s.rows()]
    # a peer's catch-up frontier caps it
    s = _Stored(P, c, root + "/b", mgr_kw=dict(
        interval=2, retain_heights=1, peer_floor=lambda: 4), every=False)
    out += [s.bs.base(), s.rows(), s.ss.latest_snapshot_height()]
    return out


def test_prune_floor_policy_matches_jax(tmp_path, chains):
    out = {P.name: _floors(P, chains[(P.name, None)], str(tmp_path / P.name))
           for P in BOTH}
    assert out["port"] == out["jax"]
    assert out["port"][:3] == [1, 6, True]
    assert out["port"][4] == 4


def test_evidence_horizon_keeps_state_rows_like_jax(tmp_path, chains):
    out = {}
    for P in BOTH:
        s = _Stored(P, chains[(P.name, 3)], str(tmp_path / P.name),
                    mgr_kw=dict(interval=2, retain_heights=1), every=False)
        out[P.name] = [s.bs.base(), s.ss.load_validators(10) is not None,
                       s.ss.load_abci_responses(10),
                       s.ss.load_abci_responses(9), s.rows()]
    assert out["port"] == out["jax"]
    # blocks to the snapshot floor (12), state rows kept from 12 - 3 + 1
    assert out["port"][:2] == [12, True] and out["port"][2] is not None
    assert out["port"][3] is None
    assert PORT.ss.StateStore(PORT.db.MemDB()).prune_floor() == 1


# ------------------------------------------------------- store mechanics --

def _block_prune(P, c):
    s = _Stored(P, c, "")
    bs = s.bs
    out = [bs.base(), bs.prune(5, window=2), bs.base(), bs.load_block(4),
           bs.load_block_meta(4), bs.load_block(5) is not None,
           bs.load_seen_commit(4), bs.load_block_commit(4)]
    out += [bs.prune(100), bs.base(), bs.prune(3), _dump(bs.db)]
    return out


def _block_prune_crash(P, c):
    bs = _Stored(P, c, "").bs
    hits = []

    def crash(name):
        hits.append(name)
        if len(hits) == 1:   # die after the first window's deletes
            raise _Crash(name)

    P.fail.arm("prune.mid_range", crash)
    try:
        bs.prune(7, window=2)
    except _Crash:
        pass
    P.fail.disarm_all()
    out = [hits, bs.db.get(b"BS:base"), bs.base(), bs.db.get(b"BS:base")]
    out += [bs.prune(7, window=2), bs.base(), bs.load_block(7) is not None,
            _dump(bs.db)]
    return out


def _bootstrap(P, c):
    bs = P.bs.BlockStore(P.db.MemDB())
    ss = P.ss.StateStore(P.db.MemDB())
    ss.load_or_genesis(c.gen)
    st = c.states[7]
    commit = c.blocks[7].last_commit
    bs.bootstrap(7, commit)
    bs.bootstrap(7, commit)              # idempotent
    ss.bootstrap(st)
    ss.pin_snapshot(7, {"root": "ab" * 32, "height": 7})
    out = [bs.height(), bs.base(), bs.load_seen_commit(7).to_bytes(),
           bs.load_block_commit(7).to_bytes(), bs.load_block(7),
           P.enc.cdumps(ss.load().to_obj()),
           ss.load_validators(7).hash(), ss.load_validators(8).hash(),
           ss.latest_snapshot_height(), ss.load_snapshot_pin(7),
           _raised(lambda: bs.bootstrap(3, commit))]
    ss.pin_snapshot(9, {"root": "cd" * 32})
    ss.unpin_snapshot(7)
    out += [ss.load_snapshot_pin(7), ss.latest_snapshot_height(),
            _dump(bs.db), _dump(ss.db)]
    # a store ahead of the bootstrap height refuses it
    full = _Stored(P, c, "").bs
    out.append(_raised(lambda: full.bootstrap(5, commit)))
    return out


def _state_prune(P, c):
    ss = _Stored(P, c, "").ss
    out = [ss.prune(1), ss.prune(7, window=2), ss.load_abci_responses(3),
           ss.load_abci_responses(7) is not None,
           ss.load_validators(8).hash(),
           P.enc.cdumps(ss.load_consensus_params(9).to_obj()),
           ss.prune(9), _dump(ss.db)]
    return out


MECHANICS = {"block_prune": _block_prune,
             "block_prune_crash": _block_prune_crash,
             "bootstrap_and_pins": _bootstrap, "state_prune": _state_prune}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_store_mechanics_match_jax(chains, case):
    out = {P.name: MECHANICS[case](P, chains[(P.name, None)]) for P in BOTH}
    assert out["port"] == out["jax"]


def test_block_store_prune_crash_self_heals():
    """The port's own reading of the crash case: the base row still says
    1 after the first window's deletes, base() heals it to 3."""
    c = Chain(PORT, 1)
    for h in range(1, 9):
        c.next([b"k%d=v" % h])
    out = _block_prune_crash(PORT, c)
    assert out[:4] == [["prune.mid_range"], None, 3, b"3"]
    assert out[4:7] == [4, 7, True]


# ----------------------------------------------- the handshake's seam ---

def _handshake(P, c, root, with_snapshots):
    s = _Stored(P, c, root, mgr_kw=dict(interval=3, keep=2, chunk_size=512,
                                        retain_heights=2))
    app = P.app()
    conns = P.proxy.AppConns(P.proxy.local_client_creator(app))
    hs = P.replay.Handshaker(
        s.ss, s.bs, c.gen, verifier=P.verifier,
        snapshot_store=s.snaps if with_snapshots else None, app=app)
    try:
        state = hs.handshake(conns)
    except P.replay.HandshakeError as e:
        return ["HandshakeError", str(e)]
    return [P.enc.cdumps(state.to_obj()), app.app_hash, app.height,
            hs.n_blocks, s.bs.base(), s.rows()]


@pytest.mark.parametrize("with_snapshots", [True, False],
                         ids=["snapshot_store", "no_snapshot_store"])
def test_handshake_local_snapshot_seam_matches_jax(tmp_path, chains,
                                                   with_snapshots):
    out = {P.name: _handshake(P, chains[(P.name, None)],
                              str(tmp_path / P.name), with_snapshots)
           for P in BOTH}
    assert out["port"] == out["jax"]
    if with_snapshots:
        c = chains[("port", None)]
        assert out["port"][1] == c.state.app_hash
        assert out["port"][2] == 12
    else:
        assert out["port"][0] == "HandshakeError"
        assert "no usable local snapshot" in out["port"][1]


# ------------------------------------------------------------- nodes ----

WAVE_A = [b"sn/a%d=v%d" % (i, i) for i in range(1, 4)]
WAVE_B = [b"sn/b%d=w%d" % (i, i) for i in range(1, 4)]
RECOVERY_SWEEP_POINTS = ("snapshot.after_chunk", "snapshot.before_publish",
                         "prune.mid_range")


def _gen(P, chain_id):
    key = P.keys.PrivKey.generate(b"\x0b" * 32)
    gen = P.gen.GenesisDoc(
        chain_id=chain_id, genesis_time_ns=1,
        validators=[P.gen.GenesisValidator(key.pubkey.ed25519, 10)])
    gen.consensus_params.evidence.max_age = 4
    return gen, key


def _make_node(P, home, gen, key, recovery=None):
    pv_path = os.path.join(home, "priv_validator.json")
    if os.path.exists(pv_path):
        pv = P.pv.PrivValidatorFile.load(pv_path)
    else:
        pv = P.pv.PrivValidatorFile(pv_path, key)
        pv._persist()
    cfg = P.config.test_config(home)
    if P is PORT:
        cfg.base.verifier_backend = "python"
        for k, v in (recovery or {}).items():
            setattr(cfg.base, k, v)
    node = P.node.Node(cfg, gen, priv_validator=pv, app=P.app())
    node.consensus.ticker.stop()
    node.consensus.ticker = P.ticker(node.consensus._on_timeout_fire)
    return node


def _inject(node, txs):
    for tx in txs:
        try:
            node.mempool.check_tx(tx)
        except Exception:
            pass


def _commit_to(node, target_height, max_ticks=400):
    for _ in range(max_ticks):
        if node.height >= target_height:
            return
        node.consensus.ticker.fire_next()
    raise AssertionError(f"stuck at height {node.height}")


def _drain(node, max_ticks=200):
    for _ in range(max_ticks):
        if node.mempool.size() == 0:
            return
        node.consensus.ticker.fire_next()
    raise AssertionError("mempool never drained")


@pytest.fixture(scope="module")
def jax_control(tmp_path_factory):
    """An uncrashed JAX node with the recovery plane off: its app hash at
    height 6 after both waves."""
    gen, key = _gen(JAX, "snap-sweep")
    node = _make_node(JAX, str(tmp_path_factory.mktemp("control")), gen, key)
    node.start()
    _inject(node, WAVE_A)
    _commit_to(node, 3)
    _inject(node, WAVE_B)
    _commit_to(node, 6)
    _drain(node)
    h = node.consensus.state.app_hash
    node.stop()
    return h


@pytest.mark.parametrize("point", RECOVERY_SWEEP_POINTS)
def test_crash_at_recovery_point_recovers_jax_control_apphash(
        tmp_path, jax_control, point):
    """A snapshotting and pruning port node crashed at `point`, rebuilt
    from its home, reaches the uncrashed JAX node's app hash with no
    committed height lost and no half snapshot visible."""
    recovery = dict(snapshot_interval=2, snapshot_keep=2, retain_heights=2)
    gen, key = _gen(PORT, "snap-sweep")
    home = str(tmp_path)
    node = _make_node(PORT, home, gen, key, recovery)
    node.start()
    _inject(node, WAVE_A)
    _commit_to(node, 3)
    tfail.arm(point, _crash)
    with pytest.raises(_Crash):
        _inject(node, WAVE_B)
        _commit_to(node, 6)
        raise AssertionError(f"{point} never fired")
    tfail.disarm_all()
    crashed_at = node.height
    node.consensus._stopped = True
    try:
        node.stop()
    except Exception:
        pass
    node2 = _make_node(PORT, home, gen, key, recovery)
    node2.start()
    try:
        assert node2.height >= crashed_at
        _inject(node2, WAVE_B)
        _commit_to(node2, 6)
        _drain(node2)
        assert node2.consensus.state.app_hash == jax_control
        for h in node2.snapshot_store.list_heights():
            node2.snapshot_store.assemble_payload(h)
        assert not [n for n in os.listdir(node2.snapshot_store.root_dir)
                    if n.startswith(".tmp-")]
        counts = node2.recovery_counts()
        assert counts["snapshots"]["published"] >= 1
        assert counts["block_base"] == node2.block_store.base()
    finally:
        node2.stop()


def test_pruned_restart_recovers_app_from_snapshot_like_jax(tmp_path,
                                                            monkeypatch):
    """Eight heights on a node with snapshots every 3 and 2 heights
    retained, in both packages; after the restart each handshake rebuilds
    its app from a snapshot and the tail: equal heights, app hashes and
    bases, and the port node keeps committing."""
    monkeypatch.setenv("TM_TPU_SNAPSHOT_INTERVAL", "3")
    monkeypatch.setenv("TM_TPU_RETAIN_HEIGHTS", "2")
    recovery = dict(snapshot_interval=3, retain_heights=2)
    out = {}
    for P in BOTH:
        gen, key = _gen(P, "snap-restart")
        home = str(tmp_path / P.name)
        node = _make_node(P, home, gen, key, recovery)
        node.start()
        for w in range(8):
            _inject(node, [b"pr/k%d=v%d" % (w, w)])
            _commit_to(node, w + 1)
        _drain(node)
        before = (node.height, node.consensus.state.app_hash,
                  node.block_store.base(),
                  node.snapshot_store.list_heights())
        node.stop()
        node2 = _make_node(P, home, gen, key, recovery)
        after = (node2.consensus.state.last_block_height,
                 node2.consensus.state.app_hash, node2.app.height,
                 node2.app.app_hash)
        if P is PORT:
            node2.start()
            _inject(node2, [b"pr/after=1"])
            _commit_to(node2, before[0] + 1)
            node2.stop()
        out[P.name] = (before, after)
    assert out["port"] == out["jax"]
    (h, app_hash, base, heights), after = out["port"]
    assert base > 1 and heights
    assert after == (h, app_hash, h, app_hash)
