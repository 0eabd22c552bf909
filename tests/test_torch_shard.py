"""The port's shard plane (tendermint_tpu_torch/shard/) against the JAX
package's (tendermint_tpu/shard/, tests/test_shard.py), on the CPU,
tolerance 0.

- ShardMap: `shard_of` equal over 10,000 seeded keys for n = 1..64;
  `to_obj` equal after `rebalanced`; `key_prefix` equal on seeded txs;
  the map is the same in a fresh interpreter of the port.
- Front door: the port router's route names and signatures (the
  chain-scoped passthroughs' included) equal the JAX router's.
- Cross-package proofs: a port `serve_read` doc (state tree on) is
  accepted by the JAX `CertifiedReader.verify` under a JAX certifier from
  the same genesis valset, and by the port's; a forged value, proof,
  header or commit is refused by both with the same exception class and
  message.
- AppHash replay: a port shard's stored blocks replayed through the JAX
  kvstore and the port's give the header app hashes at every height,
  with the tree on and off.
- The JAX tests' scenarios on the port with device="cpu": one verifier
  object and one loop shared by the shards (the set owns the verifier,
  no node does); a stop in any order keeps it verifying; a crashed
  shard leaves its siblings committing; certified cross-shard reads
  (in process and over HTTP); forged commit and value proofs refused;
  proven values and absences; a proof-carrying abci_query over HTTP;
  tx_search fanned out; the front door's labels and `shard_*` families;
  SLO chain attribution equal to the JAX plane's.
"""

import copy
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tendermint_tpu import telemetry as jtel
from tendermint_tpu.lite.certifier import ContinuousCertifier as JCert
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu.shard import reads as jreads
from tendermint_tpu.shard import router as jrouter
from tendermint_tpu.types import GenesisDoc as JGenesisDoc
from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.lite.certifier import ContinuousCertifier
from tendermint_tpu_torch.models.verifier import BatchVerifier as TVerifier
from tendermint_tpu_torch.rpc import JSONRPCClient
from tendermint_tpu_torch.shard import (CertifiedReader, ReadProofError,
                                        ShardSet)
from tendermint_tpu_torch.shard import reads as treads
from tendermint_tpu_torch.shard import router as trouter
from tendermint_tpu_torch.shard.router import ShardMap, key_prefix

REPO = Path(__file__).resolve().parent.parent


def wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _seeded_keys(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 24, size=n)
    return [rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes()
            for k in lens]


def _flip_commit_sig(doc: dict) -> None:
    for v in doc["proof_commits"][-1]["signed_header"]["commit"][
            "precommits"]:
        if v:
            sig = bytearray(bytes.fromhex(v["signature"]))
            sig[0] ^= 0xFF
            v["signature"] = bytes(sig).hex()


@pytest.fixture
def shard2():
    s = ShardSet(2, chain_prefix="tshard", device="cpu")
    s.start()
    try:
        assert wait_for(lambda: s.frontier() >= 2), s.heights()
        yield s
    finally:
        s.stop()


@pytest.fixture
def shard2_tree(monkeypatch):
    """Two shards whose kvstore runs the authenticated state tree."""
    monkeypatch.setenv("TM_CUDA_STATE_TREE", "on")
    s = ShardSet(2, chain_prefix="ttree", device="cpu")
    s.start()
    try:
        assert wait_for(lambda: s.frontier() >= 2), s.heights()
        yield s
    finally:
        s.stop()


def _put_and_settle(s, key, value):
    """Write through the owning shard and wait until the value is
    provable at the stable-read version (frontier - 1)."""
    node = s.node_for_key(key)
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


# ------------------------------------------------------------ the map --

@pytest.mark.parametrize("lo", range(1, 65, 8))
def test_shard_of_equals_jax_over_seeded_keys(lo):
    keys = _seeded_keys(10_000, seed=lo)
    for n in range(lo, lo + 8):
        chains = [f"c{i}" for i in range(n)]
        tm, jm = ShardMap(chains), jrouter.ShardMap(chains)
        got = [tm.shard_of(k) for k in keys]
        assert got == [jm.shard_of(k) for k in keys], n
        assert all(0 <= i < n for i in got)
        assert [tm.chain_of(k) for k in keys[:64]] == \
            [jm.chain_of(k) for k in keys[:64]]


@pytest.mark.parametrize("n", [1, 3, 4, 7, 32])
def test_to_obj_after_rebalance_equals_jax(n):
    chains = [f"shard-{i:02d}" for i in range(n)]
    tm, jm = ShardMap(chains), jrouter.ShardMap(chains)
    assert tm.to_obj() == jm.to_obj()
    t2, j2 = tm.rebalanced(chains + ["x"]), jm.rebalanced(chains + ["x"])
    assert t2.version == j2.version == 2
    assert t2.to_obj() == j2.to_obj()
    keys = _seeded_keys(512, seed=n)
    assert [t2.shard_of(k) for k in keys] == [j2.shard_of(k) for k in keys]
    with pytest.raises(ValueError):
        ShardMap([])


def test_key_prefix_equals_jax():
    rng = np.random.default_rng(7)
    txs = [b"balance/7=100", b"no-equals-tx", b"a=b=c", b"=lead", b""]
    for _ in range(2000):
        raw = rng.integers(0, 256, size=int(rng.integers(0, 40)),
                           dtype=np.uint8).tobytes()
        txs.append(raw.replace(b"\x00", b"="))
    for tx in txs:
        assert key_prefix(tx) == jrouter.key_prefix(tx)
    m = ShardMap(["a"] * 16)
    assert m.shard_of(key_prefix(b"balance/7=100")) == \
        m.shard_of(b"balance/7")


def test_shard_map_is_the_same_in_a_fresh_interpreter():
    keys = [b"user/%d" % i for i in range(64)]
    local = [ShardMap(["a"] * 8).shard_of(k) for k in keys]
    code = ("from tendermint_tpu_torch.shard.router import ShardMap\n"
            "m = ShardMap(['a'] * 8)\n"
            "print(','.join(str(m.shard_of(b'user/%d' % i)) "
            "for i in range(64)))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, check=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert [int(x) for x in out.stdout.strip().split(",")] == local


# ----------------------------------------------------------- front door --

def _signatures(routes: dict) -> dict:
    return {name: str(inspect.signature(fn)) for name, fn in routes.items()}


def test_router_routes_and_signatures_equal_jax(shard2):
    from tendermint_tpu.shard import ShardSet as JShardSet
    js = JShardSet(2, chain_prefix="tshard")
    js.start()
    try:
        jr = jrouter.ShardRouter(js)
        tr = trouter.ShardRouter(shard2)
        assert sorted(tr.routes()) == sorted(jr.routes())
        assert _signatures(tr.routes()) == _signatures(jr.routes())
        assert _signatures(tr.ws_routes()) == _signatures(jr.ws_routes())
        assert trouter._PASSTHROUGH == jrouter._PASSTHROUGH
        assert tr.map.to_obj() == jr.map.to_obj()
        # the bounded chain label resolves the same way
        for method, params in (
                ("broadcast_tx_sync", {"tx": b"k1=v".hex()}),
                ("abci_query", {"data": b"k1".hex()}),
                ("shard_read", {"key": b"k2".hex()}),
                ("status", {"chain_id": "tshard-01"}),
                ("status", {"chain_id": "minted"}),
                ("status", []), ("abci_query", {"data": "zz"})):
            assert tr.chain_of_call(method, params) == \
                jr.chain_of_call(method, params), (method, params)
    finally:
        js.stop()


# ---------------------------------------------------- proofs across packages --

@pytest.fixture(scope="module")
def proven_doc():
    """(doc, genesis obj): a port serve_read of a padded key of a
    tree-backed port shard set, JSON round-tripped. The set is stopped
    before the tests run (a module-scoped set would keep committing under
    later tests' fail points)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_CUDA_STATE_TREE", "on")
        s = ShardSet(2, chain_prefix="xproof", device="cpu")
        s.start()
        try:
            assert wait_for(lambda: s.frontier() >= 2), s.heights()
            key = b"forge/value"
            owner = s.node_for_key(key)
            for i in range(8):
                owner.mempool.check_tx(b"forge/pad%d=p" % i)
            node = _put_and_settle(s, key, b"honest")
            doc = json.loads(json.dumps(treads.serve_read(node, key, 0)))
        finally:
            s.stop()
    return doc, node.gen_doc.to_obj()


def _certifiers(gen_obj: dict):
    from tendermint_tpu_torch.types.genesis import GenesisDoc
    tgen, jgen = GenesisDoc.from_obj(gen_obj), JGenesisDoc.from_obj(gen_obj)
    tcert = ContinuousCertifier(tgen.chain_id, treads._genesis_valset(tgen),
                                verifier=TVerifier("python"))
    jcert = JCert(jgen.chain_id, jreads._genesis_valset(jgen),
                  verifier=JVerifier("auto", mesh="off", coalesce="off"))
    return tcert, jcert


def test_port_read_doc_verifies_under_the_jax_certifier(proven_doc):
    doc, gen = proven_doc
    assert doc["value_proof"] is not None and doc["height"] >= 2
    assert doc["value_height"] == doc["height"] - 1
    tcert, jcert = _certifiers(gen)
    jreads.CertifiedReader.verify(copy.deepcopy(doc), jcert)
    CertifiedReader.verify(copy.deepcopy(doc), tcert)
    assert tcert.certified_height == jcert.certified_height == doc["height"]
    assert tcert.app_hashes == jcert.app_hashes


def _forge_value(d):
    d["value"] = b"forged".hex()


def _forge_proof(d):
    steps = d["value_proof"]["steps"]
    assert steps, "proof has no sibling steps to tamper"
    steps[0][1] = "11" * 32


def _forge_header(d):
    hdr = d["proof_commits"][-1]["signed_header"]["header"]
    hdr["app_hash"] = "22" * 32


@pytest.mark.parametrize("forge", [_forge_value, _forge_proof,
                                   _forge_header, _flip_commit_sig],
                         ids=["value", "proof", "header", "commit"])
def test_forgeries_refused_by_both_packages_alike(proven_doc, forge):
    doc, gen = proven_doc
    forged = copy.deepcopy(doc)
    forge(forged)
    tcert, jcert = _certifiers(gen)
    with pytest.raises(jreads.ReadProofError) as je:
        jreads.CertifiedReader.verify(copy.deepcopy(forged), jcert)
    with pytest.raises(ReadProofError) as te:
        CertifiedReader.verify(copy.deepcopy(forged), tcert)
    assert str(te.value) == str(je.value)
    assert tcert.certified_height == jcert.certified_height


# ------------------------------------------------------------ app hashes --

@pytest.mark.parametrize("tree", ["off", "on"])
def test_shard_app_hashes_replay_through_both_kvstores(monkeypatch, tree):
    from tendermint_tpu.abci.apps import KVStoreApp as JKV
    from tendermint_tpu_torch.abci.apps import KVStoreApp as TKV
    monkeypatch.setenv("TM_CUDA_STATE_TREE", tree)
    monkeypatch.setenv("TM_TPU_STATE_TREE", tree)
    s = ShardSet(2, chain_prefix=f"replay-{tree}", device="cpu")
    s.start()
    try:
        assert wait_for(lambda: s.frontier() >= 2), s.heights()
        for i in range(40):
            k = b"r/%d" % (i % 13)
            s.node_for_key(k).mempool.check_tx(k + b"=v%d" % i)
            if i % 10 == 9:
                time.sleep(0.05)
        assert wait_for(lambda: all(
            n.mempool.size() == 0 for n in s.nodes))
        top = s.frontier() + 2
        assert wait_for(lambda: s.frontier() >= top), s.heights()
    finally:
        s.stop()
    txs_total = 0
    for nd in s.nodes:
        tapp, japp = TKV(device="cpu"), JKV()
        ah = b""
        top = nd.block_store.height()
        for h in range(1, top + 1):
            blk = nd.block_store.load_block(h)
            if h > 1:
                assert blk.header.app_hash == ah, (nd.gen_doc.chain_id, h)
            for tx in blk.data.txs:
                tapp.deliver_tx(tx)
                japp.deliver_tx(tx)
            txs_total += len(blk.data.txs)
            ah = tapp.commit()
            assert japp.commit() == ah, (nd.gen_doc.chain_id, h)
    assert txs_total == 40


# --------------------------------------------- the JAX scenarios, ported --

def test_shards_share_one_verifier_and_one_loop(shard2):
    v0, v1 = (n.verifier for n in shard2.nodes)
    assert v0 is v1 is shard2.verifier
    assert str(v0.device) == "cpu" and v0.coalesce == "auto"
    assert shard2._owns_verifier
    assert all(not n._owns_verifier for n in shard2.nodes)
    assert all(n.loop is shard2.loop for n in shard2.nodes)
    assert all(not n._owns_loop for n in shard2.nodes)
    assert len(set(shard2.chains)) == 2
    pks = {n.consensus.priv_validator.pubkey.ed25519 for n in shard2.nodes}
    assert len(pks) == 2
    # the shards' verifies merged in the one coalescer
    assert wait_for(lambda: v0.coalescer_stats()["dispatches"] > 0)
    assert v0.stats["coalesced_calls"] >= \
        v0.coalescer_stats()["dispatches"]


def test_stop_in_any_order_keeps_the_shared_verifier_working():
    from tendermint_tpu_torch.types.keys import PrivKey
    s = ShardSet(3, chain_prefix="tdown", device="cpu")
    shared = s.verifier
    s.start()
    try:
        assert wait_for(lambda: s.frontier() >= 1), s.heights()
        for node in (s.nodes[1], s.nodes[0], s.nodes[2]):
            node.stop()
            k = PrivKey.generate(b"\x07" * 32)
            sig = k.sign(b"still-alive")
            assert bool(shared.verify(
                [(k.pubkey.ed25519, b"still-alive", sig)]).all())
    finally:
        s.nodes = []       # already stopped, in an odd order
        s.stop()           # the loop and the set's verifier only


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crashed_shard_leaves_siblings_committing():
    from tendermint_tpu_torch.chaos.runner import ChaosCrash
    from tendermint_tpu_torch.utils import fail

    s = ShardSet(3, chain_prefix="tcrash", device="cpu")
    s.start()
    try:
        assert wait_for(lambda: s.frontier() >= 2), s.heights()
        fired = []

        def boom(name):
            fired.append(name)
            raise ChaosCrash(f"shard crash at {name}")

        fail.arm("consensus.before_save_block", boom)
        assert wait_for(lambda: bool(fired)), \
            "armed commit point never fired"
        h1 = {n.gen_doc.chain_id: n.height for n in s.nodes}
        assert wait_for(lambda: sum(
            1 for n in s.nodes
            if n.height >= h1[n.gen_doc.chain_id] + 3) == 2), s.heights()
        victims = [n for n in s.nodes
                   if n.height < h1[n.gen_doc.chain_id] + 3]
        assert len(victims) == 1
        dead = victims[0]
        h_dead = dead.height
        time.sleep(0.5)
        assert dead.height == h_dead, "crashed shard kept committing"
    finally:
        fail.disarm_all()
        s.stop()


def test_certified_cross_shard_read_e2e(shard2):
    addr = shard2.serve()
    c = JSONRPCClient(f"http://{addr[0]}:{addr[1]}")
    keys = [b"acct/%d" % i for i in range(8)]
    r = c.call("broadcast_tx_batch",
               txs=[(k + b"=v/" + k).hex() for k in keys])
    assert all(x["code"] == 0 for x in r["results"])
    assert r["mapping_version"] == 1
    placed = {k: shard2.router.map.chain_of(k) for k in keys}
    assert len(set(placed.values())) == 2

    def settled():
        return all(bytes.fromhex(c.call(
            "abci_query", data=k.hex())["response"]["value"] or "")
            == b"v/" + k for k in keys)
    assert wait_for(settled, 30)
    before = telemetry.value("shard_cross_reads_total",
                             {"result": "verified"}) or 0
    reader = shard2.reader()
    for k in keys:
        res = reader.read(k)
        assert res["value"] == b"v/" + k
        assert res["chain_id"] == placed[k]
        assert res["certified_height"] >= res["height"] > 0
    assert reader.verified_reads == len(keys)
    assert set(reader._certifiers) == set(shard2.chains)
    cert = reader._certifiers[placed[keys[0]]]
    h0 = cert.certified_height
    assert reader.read(keys[0])["certified_height"] >= h0
    # over the HTTP front door, the same verification
    http_reader = CertifiedReader(call=lambda m, **p: c.call(m, **p),
                                  verifier=shard2.verifier)
    assert http_reader.read(keys[0])["value"] == b"v/" + keys[0]
    assert telemetry.value("shard_cross_reads_total",
                           {"result": "verified"}) == before + len(keys) + 2
    with pytest.raises(ValueError):
        CertifiedReader()


def test_forged_cross_shard_commit_proof_is_rejected(shard2):
    node = shard2.node_for_key(b"forge-me")
    chain = node.gen_doc.chain_id
    vals = node.state_store.load_validators(1)
    doc = treads.serve_read(node, b"forge-me", 0)
    assert doc["height"] >= 1 and doc["proof_commits"]
    v = shard2.verifier
    forged = copy.deepcopy(doc)
    _flip_commit_sig(forged)
    cert = ContinuousCertifier(chain, vals, verifier=v)
    with pytest.raises(ReadProofError, match="certification failed"):
        CertifiedReader.verify(forged, cert)
    assert cert.certified_height < doc["height"]
    truncated = copy.deepcopy(doc)
    truncated["proof_commits"] = truncated["proof_commits"][:-1]
    with pytest.raises(ReadProofError, match="stops at"):
        CertifiedReader.verify(truncated,
                               ContinuousCertifier(chain, vals, verifier=v))
    wrong = copy.deepcopy(doc)
    wrong["chain_id"] = "not-" + chain
    with pytest.raises(ReadProofError, match="certifier follows"):
        CertifiedReader.verify(wrong,
                               ContinuousCertifier(chain, vals, verifier=v))
    rej = telemetry.value("shard_cross_reads_total",
                          {"result": "rejected"}) or 0
    reader = shard2.reader()
    orig = treads.serve_read

    def forge(node, key, since, **kw):
        d = orig(node, key, since, **kw)
        _flip_commit_sig(d)
        return d

    treads.serve_read = forge
    try:
        with pytest.raises(ReadProofError):
            reader.read(b"forge-me")
    finally:
        treads.serve_read = orig
    assert telemetry.value("shard_cross_reads_total",
                           {"result": "rejected"}) == rej + 1


def test_tree_backend_read_proves_value_and_absence(shard2_tree):
    key = b"proved/key"
    node = _put_and_settle(shard2_tree, key, b"certified!")
    reader = shard2_tree.reader()
    res = reader.read(key)
    assert res["proven"] is True and res["value"] == b"certified!"
    assert res["value_height"] == res["height"] - 1
    cert = reader._certifiers[node.gen_doc.chain_id]
    assert res["value_height"] + 1 in cert.app_hashes
    res2 = reader.read(b"proved/absent-key")
    assert res2["value"] == b"" and res2["proven"] is True
    assert reader.verified_reads == 2


def test_forged_value_proofs_are_rejected(shard2_tree):
    key = b"forge/value"
    owner = shard2_tree.node_for_key(key)
    for i in range(8):
        owner.mempool.check_tx(b"forge/pad%d=p" % i)
    _put_and_settle(shard2_tree, key, b"honest")
    reader = shard2_tree.reader()
    assert reader.read(key)["proven"]
    orig = treads.serve_read

    def tampered(mutate):
        def forge(node, k, since, **kw):
            d = orig(node, k, since, **kw)
            assert d.get("value_proof"), "expected a proven read"
            mutate(d)
            return d
        return forge

    cases = {
        "tampered leaf value": _forge_value,
        "truncated path": lambda d: d["value_proof"].__setitem__(
            "steps", d["value_proof"]["steps"][:-1]),
        "sibling swap": _forge_proof,
        "absence proof for a present key": lambda d: (
            d["value_proof"].update(present=False,
                                    other_key_hash="01" * 32,
                                    other_value_hash="02" * 32),
            d.__setitem__("value", "")),
        "wrong root (n_keys binding)": lambda d: d["value_proof"].update(
            n_keys=d["value_proof"]["n_keys"] + 1),
    }
    for name, mutate in cases.items():
        rej = telemetry.value("shard_cross_reads_total",
                              {"result": "rejected"}) or 0
        verified = reader.verified_reads
        treads.serve_read = tampered(mutate)
        try:
            with pytest.raises(ReadProofError, match="value proof"):
                reader.read(key)
        finally:
            treads.serve_read = orig
        assert telemetry.value("shard_cross_reads_total",
                               {"result": "rejected"}) == rej + 1, name
        assert reader.verified_reads == verified, name
    res = reader.read(key)
    assert res["proven"] and res["value"] == b"honest"


def test_proof_carrying_abci_query_over_http(shard2_tree):
    from tendermint_tpu_torch import statetree
    key = b"http/proved"
    node = _put_and_settle(shard2_tree, key, b"over-the-wire")
    addr = shard2_tree.serve()
    chain = shard2_tree.router.map.chain_of(key)
    c = JSONRPCClient(f"http://{addr[0]}:{addr[1]}")
    r, version = {}, 0
    for _ in range(8):
        version = node.block_store.height() - 1
        r = c.call("abci_query", data=key.hex(), height=version,
                   prove=True)["response"]
        if int(r.get("code") or 0) == 0 and r.get("proof"):
            break
    assert bytes.fromhex(r["value"]) == b"over-the-wire"
    assert int(r["height"]) == version
    pf = statetree.proof_from_bytes(bytes.fromhex(r["proof"]))
    hdr = c.call("commit", height=version + 1, chain_id=chain)["header"]
    anchor = bytes.fromhex(hdr["app_hash"])
    statetree.verify(pf, key, b"over-the-wire", anchor)
    with pytest.raises(statetree.ProofError):
        statetree.verify(pf, key, b"tampered-on-the-wire", anchor)


def test_tx_search_through_the_front_door(shard2):
    import hashlib
    addr = shard2.serve()
    c = JSONRPCClient(f"http://{addr[0]}:{addr[1]}")
    keys = [b"srch/%d" % i for i in range(8)]
    txs = [k + b"=x" for k in keys]
    placed = {k: shard2.router.map.chain_of(k) for k in keys}
    assert len(set(placed.values())) == 2
    r = c.call("broadcast_tx_batch", txs=[t.hex() for t in txs])
    assert all(x["code"] == 0 for x in r["results"])
    h0 = hashlib.sha256(txs[0]).hexdigest()
    assert wait_for(lambda: c.call(
        "tx_search", query=f"tx.hash='{h0}'")["total_count"] == 1)
    doc = c.call("tx_search", query=f"tx.hash='{h0}'")
    rec = doc["txs"][0]
    assert rec["chain_id"] == placed[keys[0]]
    assert bytes.fromhex(rec["tx"]) == txs[0]
    assert doc["mapping_version"] == 1
    assert wait_for(lambda: c.call(
        "tx_search", query="tx.height >= 1",
        per_page=100)["total_count"] >= len(txs))
    doc = c.call("tx_search", query="tx.height >= 1", per_page=100)
    recs = doc["txs"]
    assert {x["chain_id"] for x in recs} == set(shard2.chains)
    order = [(x["height"], x["index"], x["chain_id"]) for x in recs]
    assert order == sorted(order)
    page1 = c.call("tx_search", query="tx.height >= 1", per_page=3)
    assert len(page1["txs"]) == 3
    assert page1["total_count"] == doc["total_count"]
    page2 = c.call("tx_search", query="tx.height >= 1", per_page=3, page=2)
    assert page2["txs"][0] == doc["txs"][3]
    one = c.call("tx_search", query="tx.height >= 1", per_page=100,
                 chain_id=shard2.chains[0])
    assert {x["chain_id"] for x in one["txs"]} == {shard2.chains[0]}


def test_front_door_labels_and_shard_families(shard2):
    addr = shard2.serve()
    c = JSONRPCClient(f"http://{addr[0]}:{addr[1]}")
    key = b"labelled-key"
    chain = shard2.router.map.chain_of(key)
    labels = {"route": "broadcast_tx_sync", "chain": chain}
    before = telemetry.value("rpc_call_seconds", labels)
    assert c.call("broadcast_tx_sync", tx=(key + b"=1").hex())["code"] == 0
    after = telemetry.value("rpc_call_seconds", labels)
    assert after["count"] == (before["count"] if before else 0) + 1
    assert shard2.router.chain_of_call(
        "status", {"chain_id": "client-minted"}) == ""
    assert shard2.router.chain_of_call(
        "status", {"chain_id": chain}) == chain
    doc = c.call("shards")
    for ch in shard2.chains:
        g = telemetry.value("shard_height", {"chain": ch})
        assert g and g >= 1
    assert doc["heights"][chain] >= 1
    assert telemetry.value("shard_mapping_version") == 1
    hits = telemetry.value("shard_router_hits_total", {"chain": chain})
    assert hits and hits >= 1
    st = c.call("status", chain_id=shard2.chains[1])
    assert st["latest_block_height"] >= 1
    with pytest.raises(Exception):
        c.call("status", chain_id="no-such-chain")
    hz = c.call("healthz")
    assert hz["shards"]["n_shards"] == 2
    assert set(hz["shards"]["heights"]) == set(shard2.chains)


def test_slo_chain_attribution_equals_jax(monkeypatch):
    from tendermint_tpu.telemetry import slo as jslo
    from tendermint_tpu_torch.telemetry import slo as tslo

    monkeypatch.setenv("TM_TPU_SLO", "on")
    monkeypatch.setenv("TM_CUDA_SLO", "on")
    got = {}
    try:
        for name, slo, tel in (("jax", jslo, jtel), ("port", tslo,
                                                      telemetry)):
            slo.reset()
            tx = b"slo-shard-tx"
            slo.admit(tx, chain="chain-A")
            slo.mark(tx, "checktx")
            slo.mark(tx, "commit", height=3)
            tx2 = b"slo-plain-tx"
            slo.admit(tx2)
            slo.mark(tx2, "checktx")
            snap = slo.snapshot(windows=False)
            got[name] = {
                "chains": {c: v["sampled"]
                           for c, v in snap["chains"].items()},
                "counts": [(tel.value("slo_stage_seconds",
                                      {"stage": st, "chain": ch}) or
                            {"count": 0})["count"] > 0
                           for st, ch in (("checktx", "chain-A"),
                                          ("e2e_commit", "chain-A"),
                                          ("checktx", ""))]}
    finally:
        monkeypatch.delenv("TM_TPU_SLO")
        monkeypatch.delenv("TM_CUDA_SLO")
        jslo.reset()
        tslo.reset()
    assert got["port"] == got["jax"]
    assert got["port"]["chains"]["chain-A"] == 1
    assert all(got["port"]["counts"])
