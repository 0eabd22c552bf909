"""The port's pipelined block hot path (tendermint_tpu_torch.pipeline,
the native part-set build, streaming proposal gossip, StagedDB and
group commit, the precomputed next proposal) against the JAX package's
(tests/test_pipeline.py:32-270), on the CPU, tolerance 0.

- the native part-set skeleton equals the Python split's and the JAX
  package's, at the boundaries; PartSet.from_data is the same with the
  pipeline on and off; streaming equals the batch build;
- a single-validator node on a pinned clock puts the same proposal,
  part and vote messages on the wire with the pipeline on and off, and
  the same as a JAX node; off, the proposal goes first and every part in
  index order;
- StagedDB reads its own writes and shadows deletions, as the JAX one;
  GroupCommit flushes in registration order, then runs after_flush;
- with a mempool that does not change, the precomputed proposal is used;
- config 1's in-process net (consensus/testnet.py, four validators,
  MockTickers, a join, a leave, an equivocation, a forged vote and node
  3's crash and restart) on a pinned clock: the same blocks, States, app
  hashes and node 3's store rows with the port's pipeline on and off
  and the JAX package's on.
"""

import os
import time

import pytest

from tendermint_tpu import native as jnative
from tendermint_tpu import pipeline as jpipeline
from tendermint_tpu.storage import db as jdb
from tendermint_tpu.types import part_set as jpart_set
from tendermint_tpu_torch import native, pipeline
from tendermint_tpu_torch.consensus import testnet as ttestnet
from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.storage import db as tdb
from tendermint_tpu_torch.types import part_set

import tests.test_torch_consensus as tc

T_PINNED = tc.T0 + 5 * 10 ** 9


@pytest.fixture(autouse=True)
def _pipeline_default(monkeypatch):
    """Each test starts from the default mode and leaves it so."""
    monkeypatch.setattr(pipeline, "_configured", "auto")
    monkeypatch.delenv("TM_TPU_PIPELINE", raising=False)
    yield
    for P in tc.PKGS:
        P.clock.set_source(None)


def _data(n: int) -> bytes:
    return bytes((i * 131 + 7) % 256 for i in range(n))


@pytest.mark.parametrize("size,part_size", [
    (0, 64), (1, 64), (63, 64), (64, 64), (65, 64), (1000, 64), (4096, 64),
    (12345, 777), (5000, 4999), (5000, 5001)])
def test_partset_build_native_matches_python(size, part_size):
    data = _data(size)
    chunks = [data[i:i + part_size]
              for i in range(0, len(data), part_size)] or [b""]
    want = merkle.tree_proofs_plain(chunks)
    assert native.partset_build(data, part_size) == want
    assert jnative.partset_build(data, part_size) == want


def _snap(ps):
    return (ps.total, ps.root,
            [(p.index, p.payload, p.proof) for p in ps.parts])


@pytest.mark.parametrize("size,part_size", [(0, 64), (65, 64), (5000, 512)])
def test_from_data_same_bytes_on_and_off(size, part_size):
    data = _data(size)
    before = part_set.build_stats()
    on = _snap(part_set.PartSet.from_data(data, part_size))
    pipeline.configure("off")
    off = _snap(part_set.PartSet.from_data(data, part_size))
    after = part_set.build_stats()
    assert on == off == _snap(jpart_set.PartSet.from_data(data, part_size))
    assert {k: after[k] - before[k] for k in after} == \
        {"native": 1, "python": 1}
    total, root, parts = on
    for i, payload, proof in parts:
        assert merkle.verify_proof_host(root, total, i, payload, proof)


def test_from_data_streaming_equals_batch():
    data = _data(5000)
    batch = part_set.PartSet.from_data(data, 512)
    ps, it = part_set.PartSet.from_data_streaming(data, 512)
    assert ps.header() == batch.header()   # usable before any part
    assert not ps.is_complete()
    yielded = list(it)
    assert ps.is_complete() and ps.get_data() == data
    assert [(p.index, p.payload, p.proof) for p in yielded] == \
        _snap(batch)[2]
    jps, jit = jpart_set.PartSet.from_data_streaming(data, 512)
    assert [(p.index, p.payload, p.proof) for p in jit] == _snap(batch)[2]


def _drive_one_height(P, mode: str, monkeypatch):
    """A single-validator node commits height 1 on a pinned clock; every
    message it broadcasts, encoded canonically."""
    if P is tc.PORT:
        pipeline.configure(mode)
    else:
        monkeypatch.setenv("TM_TPU_PIPELINE", mode)
    P.clock.set_source(lambda: T_PINNED)
    nodes, _ = tc.make_net(P, 1, chain_id="pipe-wire")
    cs = nodes[0]
    assert cs._pipeline is (mode == "on")
    mp = tc.ListMempool()
    mp.txs = [b"wire/k%d=v%d" % (i, i) for i in range(50)]
    cs.mempool = mp
    wire = []
    cs.broadcast_hooks.append(lambda msg: wire.append(P.enc.cdumps(msg)))
    cs.start()
    for _ in range(100):
        if cs.state.last_block_height >= 1:
            break
        cs.ticker.fire_next()
    assert cs.state.last_block_height >= 1
    cs.stop()
    return [raw for raw in wire if P.enc.cloads(raw).get("type") in
            ("proposal", "block_part", "vote")]


def test_streaming_gossip_wire_equals_serial_and_jax(monkeypatch):
    on = _drive_one_height(tc.PORT, "on", monkeypatch)
    off = _drive_one_height(tc.PORT, "off", monkeypatch)
    jax_on = _drive_one_height(tc.JAX, "on", monkeypatch)
    assert on == off == jax_on
    assert len(on) >= 4


def test_pipeline_off_serial_broadcast_shape(monkeypatch):
    off = [tc.PORT.enc.cloads(raw) for raw in
           _drive_one_height(tc.PORT, "off", monkeypatch)]
    msgs = [m for m in off if m["type"] in ("proposal", "block_part")]
    assert msgs[0]["type"] == "proposal"
    total = msgs[0]["proposal"]["block_parts_header"]["total"]
    parts = [m for m in msgs if m["type"] == "block_part"]
    assert [p["part"]["index"] for p in parts[:total]] == list(range(total))


def _staged_run(mod):
    inner = mod.MemDB()
    for k, v in ((b"a", b"1"), (b"b", b"2"), (b"d", b"4")):
        inner.set(k, v)
    s = mod.StagedDB(inner)
    s.set(b"b", b"2x")
    s.set_batch([(b"c", b"3"), (b"e", b"5")])
    s.delete(b"a")
    s.delete_batch([b"e", b"zz"])
    reads = [s.get(k) for k in (b"a", b"b", b"c", b"d", b"e")]
    inner_before = list(inner.iterate())
    listing = list(s.iterate(b"")), list(s.iterate(b"c"))
    s.flush_into_inner()
    return reads, inner_before, listing, list(inner.iterate()), s.staged


def test_staged_db_matches_jax():
    got = _staged_run(tdb)
    assert got == _staged_run(jdb)
    reads, inner_before, listing, inner_after, staged = got
    assert reads == [None, b"2x", b"3", b"4", None]
    assert inner_before == [(b"a", b"1"), (b"b", b"2"), (b"d", b"4")]
    assert listing[0] == [(b"b", b"2x"), (b"c", b"3"), (b"d", b"4")]
    assert inner_after == listing[0] and staged == {}


def test_group_commit_flush_order_and_after_flush():
    for mod, gc in ((tdb, pipeline.GroupCommit),
                    (jdb, jpipeline.GroupCommit)):
        order = []

        class Spy(mod.MemDB):
            def __init__(self, name):
                super().__init__()
                self.name = name

            def set_batch(self, pairs):
                order.append(self.name)
                super().set_batch(pairs)

        a, b = Spy("block"), Spy("state")
        g = gc()
        g.staged(a).set(b"k", b"v")     # registration order = flush order
        g.staged(b).set(b"k", b"v")
        assert g.staged(a) is g.staged(a)
        fired = []
        g.after_flush(lambda: fired.append(order[:]))
        flushes = pipeline.stats()["group_flushes"]
        g.flush()
        assert order == ["block", "state"]
        assert fired == [["block", "state"]]   # events after the writes
        if gc is pipeline.GroupCommit:
            assert pipeline.stats()["group_flushes"] == flushes + 1


def test_precompute_used_on_stable_mempool():
    used = pipeline.stats()["precompute"]["used"]
    tc.PORT.clock.set_source(lambda: T_PINNED)
    nodes, _ = tc.make_net(tc.PORT, 1, chain_id="pipe-pre")
    cs = nodes[0]
    mp = tc.ListMempool()
    mp.txs = [b"pre/k%d=v" % i for i in range(20)]
    cs.mempool = mp
    cs.start()
    for _ in range(200):
        if cs.state.last_block_height >= 2:
            break
        cs.ticker.fire_next()
    assert cs.state.last_block_height >= 2
    # the height-3 worker lands its handoff before the propose step runs
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        with cs._pre_lock:
            pre = cs._precomputed
        if pre is not None and pre["height"] == 3:
            break
        time.sleep(0.005)
    assert pre is not None and pre["height"] == 3
    for _ in range(200):
        if cs.state.last_block_height >= 3:
            break
        cs.ticker.fire_next()
    assert cs.state.last_block_height >= 3
    cs.stop()
    st = pipeline.stats()
    assert st["precompute"]["used"] > used
    assert st["precompute"]["failed"] == 0
    assert 0.0 < st["overlap_ratio"] <= 1.0


def _net(P, mode: str, home: str, monkeypatch):
    """config 1's in-process net through tc.NET on a pinned clock."""
    if P is tc.PORT:
        pipeline.configure(mode)
        net = ttestnet.Testnet(verifier_of=lambda i: tc._PY, home=home,
                               file_nodes=(ttestnet.FILE_NODE,))
    else:
        monkeypatch.setenv("TM_TPU_PIPELINE", mode)
        net = tc.JaxTestnet(home)
    assert all(n.cs._pipeline is (mode == "on") for n in net.nodes)
    P.clock.set_source(lambda: T_PINNED)
    net.start()
    fed = []
    for h, _ in ttestnet.run_schedule(net, tc.NET, ttestnet.standby_key()
                                      if P is tc.PORT else
                                      tc.JAX.keys.PrivKey.generate(
                                          bytes([200, 1]) * 16),
                                      [tc.T0], fed):
        if h == tc.NET.restart_after:
            net.stop_node(ttestnet.FILE_NODE)
            net.restart_node(ttestnet.FILE_NODE)
    node0, node3 = net.nodes[0], net.nodes[3]
    out = {"blocks": [node0.block_store.load_block(h).to_bytes()
                      for h in range(1, node0.block_store.height() + 1)],
           "states": [P.enc.cdumps(n.cs.state.to_obj()) for n in net.nodes],
           "app_hashes": [n.app.app_hash for n in net.nodes],
           "rows": {name: list(db.iterate()) for name, db in
                    (("block", node3.block_store.db),
                     ("state", node3.state_store.db))}}
    net.close()
    return out


def test_net_on_equals_off_equals_jax_on(tmp_path, monkeypatch):
    flushes = pipeline.stats()["group_flushes"]
    natives = part_set.build_stats()["native"]
    on = _net(tc.PORT, "on", str(tmp_path / "on"), monkeypatch)
    assert pipeline.stats()["group_flushes"] > flushes
    assert part_set.build_stats()["native"] > natives
    off = _net(tc.PORT, "off", str(tmp_path / "off"), monkeypatch)
    jax_on = _net(tc.JAX, "on", str(tmp_path / "jax"), monkeypatch)
    assert len(on["blocks"]) >= tc.NET.heights
    for key in ("blocks", "states", "app_hashes", "rows"):
        assert on[key] == off[key], key
        assert on[key] == jax_on[key], key
