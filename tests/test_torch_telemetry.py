"""The port's metric registry and its families (tendermint_tpu_torch/
telemetry/) against the JAX package's, on the CPU, tolerance 0.

- Registry parity: fresh registries of both packages fed the same
  numpy-seeded observations (counters, gauges, labelled histograms on
  each bucket set, summaries) expose byte-equal Prometheus text under
  the namespace `tm`; the port's default namespace is `tmcuda`.
- Family catalog parity: after importing the modules both packages
  have, every JAX family has a port family of the same name, type,
  help, label names and buckets (summary quantiles and cap), and the
  port has no other. There is no exception: the mesh_* families of
  parallel/mesh.py have theirs too (UNPORTED is empty).
- QuantileSketch: equal quantiles, counts, sums and items on the same
  seeded streams, through compactions.
- RPC: the six observability routes and the five raw GET paths of a
  single-node port chain answer with the JAX routes' keys; LEFT_OUT is
  empty.
- Off switch: with the registry off, a run that feeds every instrumented
  layer leaves every family at its value.
- Stand-ins: after a small run, each plain count equals its family's
  movement (the verifier's and coalescer's stats, the predecompression
  cache, the pipeline's stage and precompute counts, part-set builds,
  the tx batcher, the event loop, the front door and a snapshot
  manager).
"""

import hashlib
import json
import math
import re
import time
import urllib.request

import numpy as np
import pytest

from tendermint_tpu.telemetry import registry as jreg
from tendermint_tpu_torch import telemetry as ttel
from tendermint_tpu_torch.telemetry import registry as treg

# The modules whose families the parity covers: every module of the JAX
# package that registers families and has a port counterpart.
PAIRED_MODULES = (
    "models.verifier", "models.coalescer", "ops.merkle", "types.part_set",
    "types.events", "pipeline", "mempool.mempool", "consensus.compact",
    "consensus.state", "consensus.reactor", "blockchain.pool",
    "p2p.switch", "p2p.conn.mconn", "p2p.conn.secret", "p2p.conn.loop",
    "rpc.core", "rpc.aserver", "storage.snapshot", "statesync.reactor",
    "analysis.divergence", "telemetry.causal", "telemetry.profile",
    "telemetry.queues", "telemetry.slo", "telemetry.merge",
    "state.execution", "node", "statetree.store", "statetree.codec",
    "chaos", "chaos.wire", "shard.router", "serving.edge",
    "serving.loadgen", "serving.deploy", "parallel.mesh",
)
#: families of JAX modules the port does not have: none, every JAX
#: family has its counterpart
UNPORTED = set()


@pytest.fixture
def both_on():
    """Both registries on and at their namespaces, restored after."""
    saved = [(m._state.enabled, m._state.namespace) for m in (jreg, treg)]
    jreg.set_enabled(True)
    treg.set_enabled(True)
    yield
    for m, (on, ns) in zip((jreg, treg), saved):
        m._state.enabled, m._state.namespace = on, ns


def _feed(mod, rng_seed: int) -> str:
    rng = np.random.default_rng(rng_seed)
    r = mod.Registry()
    c = r.counter("demo_events_total", "Events, by kind", ("kind",))
    g = r.gauge("demo_depth", "Queue depth")
    h = r.histogram("demo_batch", "Batch sizes",
                    buckets=mod.POW2_BUCKETS)
    hl = r.histogram("demo_seconds", "Latency\\n with \"quotes\"",
                     ("route", "chain"))
    hr = r.histogram("demo_fill", "Fill", buckets=mod.RATIO_BUCKETS)
    s = r.summary("demo_leg_seconds", "Legs", ("stage",), cap=64)
    r.counter("demo_unused_total", "Never touched", ("x",))
    for i in range(400):
        kind = ["a", "b", 'q"uote', "new\nline"][int(rng.integers(4))]
        c.labels(kind).inc(float(rng.integers(1, 5)))
        g.set(float(rng.normal()))
        h.observe(float(rng.integers(1, 20000)))
        hl.labels(["x", "y"][i % 2], "").observe(float(rng.exponential()))
        hr.observe(float(rng.random()))
        s.labels(["admit", "commit"][i % 2]).observe(
            float(rng.exponential(0.05)))
    return r.expose(namespace="tm")


def test_registry_exposition_byte_equal_under_tm(both_on):
    for seed in (1, 2, 3):
        assert _feed(treg, seed) == _feed(jreg, seed)
    assert treg.DEFAULT_NAMESPACE == "tmcuda"
    assert treg._TelemetryState().namespace in ("tmcuda",)


def test_registry_value_and_conflicts_as_jax(both_on):
    for mod in (jreg, treg):
        r = mod.Registry()
        r.histogram("x_seconds", "h", ("a",))
        with pytest.raises(ValueError):
            r.histogram("x_seconds", "h", ("a",), buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            r.counter("Bad-Name", "h")
    jr, tr = jreg.Registry(), treg.Registry()
    for r in (jr, tr):
        f = r.histogram("v_seconds", "v", ("a",))
        for x in (0.001, 0.2, 3.0, 30.0):
            f.labels("k").observe(x)
    assert tr.value("v_seconds", {"a": "k"}) == \
        jr.value("v_seconds", {"a": "k"})


_CATALOG_SCRIPT = r"""
import importlib, json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
mods = sys.argv[1:]
for m in mods:
    importlib.import_module("tendermint_tpu." + m)
    importlib.import_module("tendermint_tpu_torch." + m)
# the JAX rpc core registers its tx-batcher families lazily, at the
# first TxBatcher
from tendermint_tpu.rpc import core as jcore


class _Mp:
    def check_tx_batch(self, txs):
        return []


jcore.TxBatcher(_Mp()).close()
from tendermint_tpu import telemetry as jtel
from tendermint_tpu_torch import telemetry as ttel


def spec(fam):
    out = {"kind": fam.kind, "help": fam.help,
           "labelnames": list(fam.labelnames)}
    if fam.kind == "histogram":
        out["buckets"] = list(fam.buckets)
    if fam.kind == "summary":
        out["quantiles"] = list(fam.quantiles)
        out["cap"] = fam.cap
    return out


print(json.dumps({
    "jax": {n: spec(jtel.REGISTRY.get(n)) for n in jtel.REGISTRY.names()},
    "port": {n: spec(ttel.REGISTRY.get(n))
             for n in ttel.REGISTRY.names()}}))
"""


def test_family_catalog_matches_the_jax_package():
    """In a fresh interpreter (the registries are process-global, and a
    worker's earlier tests import JAX modules the port does not have)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.run(
        [sys.executable, "-c", _CATALOG_SCRIPT, *PAIRED_MODULES],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    jnames, tnames = set(got["jax"]), set(got["port"])
    assert UNPORTED <= jnames
    assert tnames == jnames - UNPORTED, sorted(tnames ^ (jnames - UNPORTED))
    assert len(tnames) >= 100
    for name in sorted(tnames):
        assert got["port"][name] == got["jax"][name], name


@pytest.mark.parametrize("cap", [16, 64, 512])
def test_quantile_sketch_matches_jax(cap):
    rng = np.random.default_rng(cap)
    vals = rng.lognormal(size=3000).tolist()
    js, ts = jreg.QuantileSketch(cap), treg.QuantileSketch(cap)
    for v in vals:
        js.observe(v)
        ts.observe(v)
    qs = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)
    assert ts.quantiles(qs) == js.quantiles(qs)
    assert (ts.count, ts.sum) == (js.count, js.sum)
    assert list(ts.items()) == list(js.items())
    assert treg.quantile_of_items(ts.items(), 0.5) == \
        jreg.quantile_of_items(js.items(), 0.5)


# ------------------------------------------------------------- over RPC

@pytest.fixture(scope="module")
def chains():
    """A single-validator node of each package (test_torch_node's
    harness), with its JSON-RPC served on the threaded server."""
    from test_torch_node import JAX, PORT, single_node
    from tendermint_tpu.rpc import core as jcore
    from tendermint_tpu_torch.rpc import core as tcore
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_TPU_PIPELINE", "off")
        out = {}
        for P, cmod in ((JAX, jcore), (PORT, tcore)):
            node = single_node(P)
            node.config.rpc.unsafe = True
            srv, core = cmod.make_server(cmod.RPCEnv.from_node(node))
            host, port = srv.serve("127.0.0.1", 0)
            out[P.name] = (node, srv, core, port)
        try:
            yield out
        finally:
            for node, srv, _, _ in out.values():
                srv.stop()
                node.stop()
            for P in (JAX, PORT):
                P.clock.set_source(None)


def _keys(x, depth=2):
    if not isinstance(x, dict) or depth == 0:
        return type(x).__name__
    return {k: _keys(v, depth - 1) for k, v in x.items()}


@pytest.fixture
def profilers_unset():
    """Neither package's process profiler exists for the test, restored
    after: a JAX test that ran earlier on the worker (tests/test_profile.py)
    leaves its stopped sampler behind, and debug_profile then answers with
    the sampler's table."""
    from tendermint_tpu.telemetry import profile as jprof
    from tendermint_tpu_torch.telemetry import profile as tprof
    saved = []
    for m in (jprof, tprof):
        with m._prof_lock:
            saved.append(m._prof)
            m._prof = None
    yield
    for m, p in zip((jprof, tprof), saved):
        with m._prof_lock:
            m._prof = p


def test_observability_routes_answer_with_the_jax_keys(chains, tmp_path,
                                                       profilers_unset):
    from tendermint_tpu_torch.rpc import core as tcore
    assert tcore.LEFT_OUT == ()
    calls = [("metrics", {}), ("dump_height_timeline", {}),
             ("debug_profile", {}), ("debug_profile", {"action": "dump"}),
             ("healthz", {}), ("slo", {}), ("slo", {"sketches": True})]
    got = {}
    for name in ("jax", "port"):
        core = chains[name][2]
        routes = core.routes()
        got[name] = [_keys(routes[r](**p)) for r, p in calls]
        got[name].append(_keys(routes["unsafe_dump_trace"](
            filename=str(tmp_path / f"{name}.json"))))
    assert got["port"] == got["jax"]
    # the healthz verdict of a resting chain: ok, not stalled
    h = chains["port"][2].healthz()
    assert h["ok"] and not h["stall"]["stalled"]
    assert h["height"] == chains["port"][0].height


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.headers.get("Content-Type"), r.read()


def test_raw_get_paths_answer_as_jax(chains):
    for path in ("/metrics", "/debug/timeline", "/healthz", "/slo",
                 "/debug/pprof"):
        out = {}
        for name in ("jax", "port"):
            ctype, body = _get(chains[name][3], path)
            out[name] = (ctype, body)
        assert out["port"][0] == out["jax"][0], path
        if path in ("/metrics", "/debug/pprof"):
            continue
        assert _keys(json.loads(out["port"][1])) == \
            _keys(json.loads(out["jax"][1])), path
    text = _get(chains["port"][3], "/metrics")[1].decode()
    ns = ttel.namespace()
    helps = re.findall(r"^# HELP (\S+) ", text, re.M)
    types = re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M)
    assert helps and len(helps) == len(types)
    assert all(n.startswith(ns + "_") for n in helps)
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, val = ln.rsplit(" ", 1)
            float(val)
            assert name.startswith(ns + "_")
    assert f"{ns}_consensus_height " in text


# --------------------------------------------------- off switch, stand-ins

def _keys_and_sigs(n, seed):
    from tendermint_tpu_torch.types.keys import PrivKey
    out = []
    for i in range(n):
        k = PrivKey.generate(hashlib.sha256(b"%d/%d" % (seed, i)).digest())
        msg = b"vote %d" % i
        out.append((k.pubkey.ed25519, msg, k.sign(msg)))
    return out


def _small_run(slow=True):
    """One pass over the instrumented layers; returns their plain
    counts' movements keyed by the family each stands in for."""
    from tendermint_tpu_torch import pipeline
    from tendermint_tpu_torch.models.verifier import BatchVerifier
    from tendermint_tpu_torch.ops import ed25519, merkle
    from tendermint_tpu_torch.p2p.conn.loop import ReactorLoop
    from tendermint_tpu_torch.rpc.core import TxBatcher
    from tendermint_tpu_torch.types import part_set

    moved = {}
    items = _keys_and_sigs(4, 1)
    v = BatchVerifier("python", coalesce="off")
    for k in (1, 2, 3):
        v.verify(items[:k])
    vc = BatchVerifier("python")
    try:
        for k in (1, 2, 3, 4):
            vc.verify(items[:k])
        cs = vc.coalescer_stats()
    finally:
        vc.close()
    # the coalescer's merged dispatches run the host loop too
    moved["python_calls"] = v.stats["calls"] + vc.stats["calls"]
    moved["python_sigs"] = v.stats["sigs"] + vc.stats["sigs"]
    moved["coalesce_calls"] = cs["submissions"]
    moved["coalesce_dispatches"] = cs["dispatches"]
    if slow:
        pre0 = ed25519.predecomp_stats()
        vb = BatchVerifier("cuda", device="cpu", coalesce="off")
        many = _keys_and_sigs(64, 2)
        assert vb.verify(many).all()
        pre1 = ed25519.predecomp_stats()
        moved["cuda_calls"] = vb.stats["calls"]
        moved["cuda_sigs"] = vb.stats["cuda_sigs"]
        for o in ("hit", "fill", "full"):
            moved["predecomp_" + o] = pre1[o] - pre0[o]
    st0 = pipeline.stats()
    pipeline.observe_stage("apply", 0.004)
    pipeline.observe_stage("persist", 0.002)
    pipeline.note_precompute("used")
    pipeline.note_precompute("discarded")
    st1 = pipeline.stats()
    for s in ("apply", "persist"):
        moved["stage_" + s] = st1["stage_n"][s] - st0["stage_n"][s]
    for o in ("used", "discarded"):
        moved["precompute_" + o] = \
            st1["precompute"][o] - st0["precompute"][o]
    b0 = part_set.build_stats()
    for mode in ("auto", "off"):
        pipeline.configure(mode)
        part_set.PartSet.from_data(bytes(range(256)) * 40, 1024)
    pipeline.configure("auto")
    b1 = part_set.build_stats()
    for impl in ("native", "python"):
        moved["partset_" + impl] = b1[impl] - b0[impl]
    merkle.root_host([b"a", b"b", b"c"])
    merkle.proof_host([b"a", b"b", b"c"], 1)

    class _Mp:
        def check_tx_batch(self, txs):
            from tendermint_tpu_torch.abci.types import ResultCheckTx
            return [ResultCheckTx() for _ in txs]
    tb = TxBatcher(_Mp(), wait_s=0.0)
    try:
        for i in range(5):
            tb.submit(b"tx%d" % i)
        moved["tx_batched"] = tb.stats["txs"]
        moved["tx_flushes"] = tb.stats["flushes"]
    finally:
        tb.close()
    loop = ReactorLoop()
    loop.start()
    try:
        done = []
        for _ in range(6):
            loop.call_soon(lambda: done.append(1), owner="test")
        deadline = time.monotonic() + 10
        while len(done) < 6 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        loop.stop()
    moved["loop_soon"] = loop.stats["soon"]
    return moved


def _family_moves(before, after):
    """The same keys as _small_run's, read off the families."""
    def d(name, labels=None, field=None):
        a = after(name, labels)
        b = before(name, labels)
        if field is not None:
            a = a[field] if a else 0
            b = b[field] if b else 0
        return (a or 0) - (b or 0)
    return {
        "python_calls": d("verifier_calls_total", {"backend": "python"}),
        "python_sigs": d("verifier_sigs_total", {"backend": "python"}),
        "coalesce_calls": d("verifier_coalesce_calls_total"),
        "coalesce_dispatches": d("verifier_coalesce_dispatches_total"),
        "cuda_calls": d("verifier_calls_total", {"backend": "cuda"}),
        "cuda_sigs": d("verifier_sigs_total", {"backend": "cuda"}),
        "predecomp_hit": d("verifier_predecomp_batches_total",
                           {"outcome": "hit"}),
        "predecomp_fill": d("verifier_predecomp_batches_total",
                            {"outcome": "fill"}),
        "predecomp_full": d("verifier_predecomp_batches_total",
                            {"outcome": "full"}),
        "stage_apply": d("pipeline_stage_seconds", {"stage": "apply"},
                         "count"),
        "stage_persist": d("pipeline_stage_seconds", {"stage": "persist"},
                           "count"),
        "precompute_used": d("pipeline_precompute_total",
                             {"outcome": "used"}),
        "precompute_discarded": d("pipeline_precompute_total",
                                  {"outcome": "discarded"}),
        "partset_native": d("partset_build_seconds", {"impl": "native"},
                            "count"),
        "partset_python": d("partset_build_seconds", {"impl": "python"},
                            "count"),
        "tx_batched": d("rpc_tx_batched_total"),
        "tx_flushes": d("rpc_tx_batch_flushes_total"),
        "loop_soon": d("loop_dispatch_total", {"kind": "soon"}),
    }


class _Frozen:
    """Every family's values at one moment, readable like REGISTRY.value."""

    def __init__(self):
        reg = ttel.REGISTRY
        self._v = {}
        for name in reg.names():
            fam = reg.get(name)
            for key, _ in fam.children():
                self._v[(name, key)] = reg.value(
                    name, dict(zip(fam.labelnames, key)) if key else None)

    def __call__(self, name, labels=None):
        fam = ttel.REGISTRY.get(name)
        key = tuple(str(labels[n]) for n in fam.labelnames) if labels \
            else ()
        return self._v.get((name, key))


def test_stand_ins_equal_their_families(both_on):
    before = _Frozen()
    moved = _small_run()
    after = _Frozen()
    fam = _family_moves(before, after)
    assert moved == fam
    assert moved["predecomp_full"] == 1 and moved["cuda_sigs"] == 64
    assert moved["partset_native"] == moved["partset_python"] == 1
    assert moved["loop_soon"] >= 6
    # the dispatch-seconds histogram counts one observation a call
    assert fam["cuda_calls"] == (
        after("verifier_dispatch_seconds", {"backend": "cuda"})["count"]
        - ((before("verifier_dispatch_seconds", {"backend": "cuda"})
            or {"count": 0})["count"]))


def test_snapshot_manager_counts_equal_their_families(both_on, tmp_path):
    from tests.test_torch_snapshot import PORT, _chain, _Stored
    chain = _chain(PORT, 12)
    before = _Frozen()
    stored = _Stored(PORT, chain, str(tmp_path / "snaps"),
                     mgr_kw=dict(interval=4, keep=2, chunk_size=256,
                                 retain_heights=3))
    after = _Frozen()
    c = stored.mgr.counts
    assert c["published"] >= 1
    taken = (after("snapshot_taken_total") or 0) - \
        (before("snapshot_taken_total") or 0)
    assert taken == c["published"]
    assert after("snapshot_height") == c["latest"]
    pruned = sum(((after("prune_heights_total", {"store": s}) or 0) -
                  (before("prune_heights_total", {"store": s}) or 0))
                 for s in ("block", "state"))
    assert pruned == c["pruned_blocks"] + c["pruned_state"] > 0


def _exposition_values():
    return [ln for ln in ttel.expose().splitlines()
            if ln and not ln.startswith("#")]


def test_off_switch_leaves_every_family_at_its_value(both_on):
    _small_run(slow=False)          # every child exists before the check
    treg.set_enabled(False)
    before = _exposition_values()
    moved = _small_run(slow=False)
    assert moved["python_calls"] >= 4 and moved["tx_batched"] == 5
    assert _exposition_values() == before
    treg.set_enabled(True)
    _small_run(slow=False)
    assert _exposition_values() != before
    assert math.isfinite(len(before))
