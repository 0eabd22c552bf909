"""The port's edge serving plane (tendermint_tpu_torch/serving/) against the
JAX package's (tendermint_tpu/serving/, tests/test_serving.py), on the
CPU, tolerance 0.

- Load generator: the same seed gives the two OpenLoopFleet copies an
  equal op schedule (kinds, methods, params and arrival offsets, on a
  pinned clock) and an equal report; `find_knee`, `_ws_frame`, the op
  builders and `default_mix` agree.
- Topology: `materialize` gives the JAX tree's file shape, process specs
  and genesis powers; only the CLI module differs (and `--device` where
  the topology names one).
- The JAX tests' scenarios on the port with device="cpu": a certifier
  follower reaches the frontier with zero lag; one held behind reports
  its lag honestly and flips /healthz; a forged commit in the stores
  freezes trust; a replica read carries a proof that verifies from the
  genesis valset under both packages' certifiers; a tampered value is
  refused by the replica and by the client; the async front door's
  admission envelope from TM_CUDA_RPC_MAX_CONNS=20 and TM_CUDA_RPC_RATE=40
  (the TM_TPU_* pair changes nothing) sheds connections and rate-limits
  calls under the open-loop fleet.
"""

import copy
import os
import random
import time
import types

import numpy as np
import pytest

from tendermint_tpu.lite.certifier import ContinuousCertifier as JCert
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu.serving import loadgen as jload
from tendermint_tpu.serving import topology as jtopo
from tendermint_tpu.shard import reads as jreads
from tendermint_tpu.types import GenesisDoc as JGenesisDoc
from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.lite.certifier import ContinuousCertifier
from tendermint_tpu_torch.serving import loadgen as tload
from tendermint_tpu_torch.serving import topology as ttopo
from tendermint_tpu_torch.serving.edge import (CertifierFollower,
                                               ReplicaCore,
                                               make_replica_server)
from tendermint_tpu_torch.shard import ShardSet
from tendermint_tpu_torch.shard.reads import CertifiedReader, ReadProofError


def wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


# -------------------------------------------------------- load generator --

def _schedule(mod, seed: int, rate: float, duration: float, mix_of):
    """Run `mod`'s fleet on a pinned clock (0.5 ms a read) with its sends
    recorded and its socket pump a no-op: (sends, report)."""
    tick = [0.0]

    def perf_counter():
        tick[0] += 0.0005
        return tick[0]

    saved = mod.time
    mod.time = types.SimpleNamespace(perf_counter=perf_counter,
                                     sleep=lambda s: None)
    fleet = mod.OpenLoopFleet("127.0.0.1", 9, seed=seed)
    sends = []
    try:
        for _ in range(3):
            conn = mod._VirtConn(None)
            fleet.conns.append(conn)
        fleet._send = lambda conn, method, params, kind, offered_t: \
            sends.append((fleet.conns.index(conn), kind, method, params,
                          round(offered_t, 9)))
        fleet._pump = lambda out, timeout: None
        report = fleet.run(duration, rate, mix_of(mod), drain_s=0.01)
    finally:
        mod.time = saved
        fleet.sel.close()
    return sends, report


def _mixes():
    return {
        "default": lambda m: m.default_mix(keyspace=50),
        "replica": lambda m: [("replica_read", 1.0,
                               m.op_replica_read(keyspace=7, prefix="vk"))],
        "all": lambda m: [("write", 0.2, m.op_write(9, "w")),
                          ("query_prove", 0.3, m.op_query_prove(9, "w")),
                          ("tx_search", 0.1, m.op_tx_search(9, "w")),
                          ("replica_read", 0.4, m.op_replica_read(9, "w"))],
    }


@pytest.mark.parametrize("seed,rate,mix", [(0, 300.0, "default"),
                                           (7, 80.0, "replica"),
                                           (42, 1200.0, "all")])
def test_fleet_schedule_and_report_equal_jax(seed, rate, mix):
    mix_of = _mixes()[mix]
    tsends, trep = _schedule(tload, seed, rate, 1.5, mix_of)
    jsends, jrep = _schedule(jload, seed, rate, 1.5, mix_of)
    assert len(tsends) > rate      # arrivals over the 1.5 s window
    assert tsends == jsends
    assert trep == jrep
    assert trep["offered"] == len(tsends)


def test_find_knee_equals_jax():
    rng = np.random.default_rng(11)
    for _ in range(300):
        points = []
        for rate in (150, 300, 600, 1200, 2400, 4800):
            g = rng.choice([None, float(rng.random())])
            p99 = rng.choice([None, float(rng.exponential(1500))])
            points.append({"offered_rate": rate, "goodput_ratio": g,
                           "p99_ms": p99})
        for floor, slo in ((0.85, None), (0.85, 1500.0), (0.5, 300.0)):
            assert tload.find_knee(points, floor, slo) == \
                jload.find_knee(points, floor, slo)
    assert tload.find_knee([]) is None


def test_ws_frame_and_builders_equal_jax():
    for n in (0, 1, 125, 126, 127, 65535, 65536, 70001):
        data = bytes(random.Random(n).randrange(256) for _ in range(n))
        assert tload._ws_frame(data) == jload._ws_frame(data)
    for name in ("op_write", "op_query_prove", "op_tx_search",
                 "op_replica_read"):
        tb, jb = getattr(tload, name)(33, "p"), getattr(jload, name)(33, "p")
        tr, jr = random.Random(5), random.Random(5)
        assert [tb(tr, i) for i in range(50)] == \
            [jb(jr, i) for i in range(50)]
    tm, jm = tload.default_mix(17), jload.default_mix(17)
    assert [(k, w) for k, w, _ in tm] == [(k, w) for k, w, _ in jm]
    assert tload._pct([], 0.5) is None
    xs = sorted(random.Random(3).random() * 100 for _ in range(999))
    for p in (0.5, 0.95, 0.99):
        assert tload._pct(xs, p) == jload._pct(xs, p)


# -------------------------------------------------------------- topology --

def _tree(root: str) -> list:
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def _spec_shape(spec, root: str, cli: str) -> tuple:
    argv = [os.path.relpath(a, root) if a.startswith(root) else a
            for a in spec.argv[1:]]
    argv = ["<cli>" if a == cli else a for a in argv]
    return (spec.name, spec.kind, os.path.relpath(spec.home, root),
            tuple(argv), spec.p2p_port, spec.rpc_port, spec.rpc_address)


@pytest.mark.parametrize("kind", ["validators", "shardset"])
def test_materialize_equals_jax(tmp_path, kind):
    kw = dict(kind=kind, n_validators=2, n_replicas=2, n_shards=3,
              chain_id="topo", base_port=23000, max_seconds=60)
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    tspecs = ttopo.materialize(ttopo.Topology(**kw), troot)
    jspecs = jtopo.materialize(jtopo.Topology(**kw), jroot)
    assert _tree(troot) == _tree(jroot)
    assert [_spec_shape(s, troot, "tendermint_tpu_torch.cli")
            for s in tspecs] == \
        [_spec_shape(s, jroot, "tendermint_tpu.cli") for s in jspecs]
    assert ttopo.FAST_TIMEOUTS == jtopo.FAST_TIMEOUTS
    for s in tspecs:
        pv = os.path.join(s.home, "config", "priv_validator.json")
        assert os.path.exists(pv) == (s.kind == "validator"), s.name
        gpath = os.path.join(s.home, "config", "genesis.json")
        if kind == "validators":
            from tendermint_tpu_torch.types.genesis import GenesisDoc
            gen = GenesisDoc.load(gpath)
            jgen = JGenesisDoc.load(gpath.replace(troot, jroot))
            assert [v.power for v in gen.validators] == \
                [v.power for v in jgen.validators] == [10, 10]
            assert gen.chain_id == jgen.chain_id == "topo"
    # --device reaches every child's argv, and only there
    dev = ttopo.materialize(ttopo.Topology(**kw, device="cpu"),
                            str(tmp_path / "dev"))
    for s in dev:
        assert s.argv[-2:] == ["--device", "cpu"]


# ------------------------------------------------------ the JAX scenarios --

@pytest.fixture
def serving1(monkeypatch):
    """One tree-backed in-process chain: the stores a replica's follower
    certifies from."""
    monkeypatch.setenv("TM_CUDA_STATE_TREE", "on")
    s = ShardSet(1, chain_prefix="tserve", device="cpu")
    s.start()
    try:
        assert wait_for(lambda: s.frontier() >= 3), s.heights()
        yield s
    finally:
        s.stop()


def _put_and_settle(node, key, value):
    node.mempool.check_tx(key + b"=" + value)

    def provable():
        h = node.block_store.height()
        if h < 2:
            return False
        res = node.app_conns.query.query("", key, height=h - 1,
                                         prove=True)
        return res.code == 0 and res.value == value
    assert wait_for(provable), node.height
    return node


def test_follower_certifies_to_frontier_with_zero_lag(serving1):
    node = serving1.nodes[0]
    f = CertifierFollower(node, max_lag=5)
    assert f.catch_up() > 0
    assert f.certified_height == node.block_store.height() - f.lag
    assert f.lag <= 1
    st = f.status()
    assert st["role"] == "replica" and st["failed"] is None
    assert st["trust_anchor"] == 0 and st["max_lag"] == 5
    assert telemetry.value("edge_certified_height") == f.certified_height


def test_follower_behind_reports_honest_lag_and_flips_healthz(serving1):
    from tendermint_tpu_torch.rpc.core import RPCCore, RPCEnv
    node = serving1.nodes[0]
    assert wait_for(lambda: node.block_store.height() >= 5)
    f = CertifierFollower(node, max_lag=2)
    h = node.block_store.height()
    f.catch_up(up_to=h - 4)
    assert f.certified_height == h - 4
    assert f.lag >= 4 and not f.ok
    core = ReplicaCore.__new__(ReplicaCore)
    core._core = RPCCore(RPCEnv.from_node(node))
    core.node, core.follower = node, f
    doc = core.status()
    assert doc["edge"]["certified_height"] == h - 4
    assert doc["edge"]["lag"] >= 4
    hz = core.healthz()
    assert hz["ok"] is False and hz["edge"]["ok"] is False
    f.catch_up()
    assert f.ok and core.healthz()["edge"]["ok"] is True


def test_forged_commit_in_stores_freezes_trust(serving1, monkeypatch):
    from tendermint_tpu_torch.shard import reads as _reads
    node = serving1.nodes[0]
    orig = _reads.full_commit_at

    def forged(store, state_store, height):
        fc = orig(store, state_store, height)
        if fc is not None and height >= 2:
            fc = copy.deepcopy(fc)
            for v in fc.signed_header.commit.precommits:
                if v is not None:
                    sig = bytearray(v.signature)
                    sig[0] ^= 0xFF
                    v.signature = bytes(sig)
        return fc

    monkeypatch.setattr(_reads, "full_commit_at", forged)
    before = telemetry.value("edge_cert_failures_total") or 0
    f = CertifierFollower(node, max_lag=100)
    f.catch_up()
    assert f.failed is not None and "height 2" in f.failed
    assert f.certified_height == 1
    assert not f.ok
    assert telemetry.value("edge_cert_failures_total") == before + 1
    f.catch_up()
    assert f.certified_height == 1


def test_replica_read_verifies_from_genesis_in_both_packages(serving1):
    node = serving1.nodes[0]
    for i in range(6):
        node.mempool.check_tx(b"edge/pad%d=p" % i)
    _put_and_settle(node, b"edge/k1", b"v1")
    f = CertifierFollower(node, max_lag=50)
    f.catch_up()
    _server, core = make_replica_server(node, f)
    before = telemetry.value("edge_reads_total", {"result": "verified"}) \
        or 0
    doc = core.replica_read(b"edge/k1")
    assert doc["edge"]["certified_height"] >= doc["height"]
    assert doc["value_proof"] is not None
    assert bytes.fromhex(doc["value"]) == b"v1"
    assert telemetry.value("edge_reads_total",
                           {"result": "verified"}) == before + 1
    gen = node.gen_doc.to_obj()
    cert = ContinuousCertifier(node.gen_doc.chain_id,
                               node.state_store.load_validators(1),
                               verifier=serving1.verifier)
    CertifiedReader.verify(copy.deepcopy(doc), cert)
    jgen = JGenesisDoc.from_obj(gen)
    jcert = JCert(jgen.chain_id, jreads._genesis_valset(jgen),
                  verifier=JVerifier("auto", mesh="off", coalesce="off"))
    jreads.CertifiedReader.verify(copy.deepcopy(doc), jcert)
    assert cert.certified_height == jcert.certified_height >= doc["height"]


def test_replica_refuses_a_tampered_value(serving1, monkeypatch):
    from tendermint_tpu_torch.rpc.server import RPCError
    from tendermint_tpu_torch.shard import reads as _reads
    node = serving1.nodes[0]
    _put_and_settle(node, b"edge/forged", b"honest")
    f = CertifierFollower(node, max_lag=50)
    f.catch_up()
    _server, core = make_replica_server(node, f)
    orig = _reads.serve_read

    def tampered(n, key, since_height=0, **kw):
        d = orig(n, key, since_height=since_height, **kw)
        d["value"] = b"forged!".hex()
        return d

    monkeypatch.setattr(_reads, "serve_read", tampered)
    before = telemetry.value("edge_reads_total",
                             {"result": "rejected"}) or 0
    with pytest.raises(RPCError, match="self-verification failed"):
        core.replica_read(b"edge/forged")
    assert telemetry.value("edge_reads_total",
                           {"result": "rejected"}) == before + 1
    monkeypatch.setattr(_reads, "serve_read", orig)
    doc = core.replica_read(b"edge/forged")
    doc["value"] = b"forged!".hex()
    cert = ContinuousCertifier(node.gen_doc.chain_id,
                               node.state_store.load_validators(1),
                               verifier=serving1.verifier)
    with pytest.raises(ReadProofError):
        CertifiedReader.verify(doc, cert)


def test_edge_admission_sheds_conns_and_rate_limits(serving1, monkeypatch):
    monkeypatch.setenv("TM_CUDA_RPC_MAX_CONNS", "20")
    monkeypatch.setenv("TM_CUDA_RPC_RATE", "40")
    # the JAX package's names reach nothing in the port
    monkeypatch.setenv("TM_TPU_RPC_MAX_CONNS", "4096")
    monkeypatch.setenv("TM_TPU_RPC_RATE", "0")
    node = serving1.nodes[0]
    _put_and_settle(node, b"edge/adm", b"v")
    f = CertifierFollower(node, max_lag=50)
    f.catch_up()
    loop = serving1.ensure_loop()
    server, _core = make_replica_server(node, f, loop=loop)
    assert (server.max_conns, server.rate_per_ip) == (20, 40.0)
    host, port = server.serve("127.0.0.1", 0)
    fleet = tload.OpenLoopFleet(host, port, seed=7)
    try:
        admitted = fleet.connect(30)
        assert admitted <= 20
        assert fleet.shed_conns >= 10
        point = fleet.run(
            2.0, rate=200.0,
            mix=[("query_prove", 1.0, tload.op_query_prove(
                keyspace=1, prefix="edge/adm"))],
            drain_s=3.0)
        assert point["errors"]["rate_limited"] > 0
        assert point["completed_ok"] > 0
        assert point["per_kind"]["query_prove"]["offered"] >= 300
        assert server.stats["rejected_conn_cap"] >= 10
    finally:
        fleet.close()
        server.stop()
