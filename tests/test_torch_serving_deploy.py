"""The port's deployment driver (tendermint_tpu_torch/serving/deploy.py)
with real OS processes of `python -m tendermint_tpu_torch.cli ...
--device cpu` over TCP, on the CPU (tests/test_serving_deploy.py's
scenario, and the driver's other shapes).

- Two validators and one keyless replica boot, commit and certify; a
  write through a validator is read PROVEN through the replica and
  verified client-side from the genesis valset under both packages'
  certifiers; /healthz folds the edge verdict; the replica prints its
  `replica kernels` lines; a SIGKILLed replica is restarted by the
  supervisor and certifies again; teardown leaves no process, log or
  tree behind.
- A `cli shardset` process (three chains, the state tree on) serves the
  sharded front door: the map, a batch split across shards, a certified
  cross-shard read over HTTP, and its `shardset kernels` line at stop.
- Validators behind the chaos WireProxy (`Topology.wire`) commit over the
  proxied links, and their configs point their peers at the proxy.
- `cli replica` refuses a home that holds a validator key.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from tendermint_tpu.lite.certifier import ContinuousCertifier as JCert
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu.shard import reads as jreads
from tendermint_tpu.types import GenesisDoc as JGenesisDoc
from tendermint_tpu_torch import cli
from tendermint_tpu_torch.lite.certifier import ContinuousCertifier
from tendermint_tpu_torch.models.verifier import BatchVerifier
from tendermint_tpu_torch.serving import Deployment, Topology
from tendermint_tpu_torch.shard.reads import CertifiedReader, _genesis_valset
from tendermint_tpu_torch.types.genesis import GenesisDoc

REPO = Path(__file__).resolve().parent.parent


def _wait(cond, timeout=90.0, step=0.3):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def _lines(path: str, tag: str) -> list:
    with open(path) as f:
        return [json.loads(m) for m in
                re.findall(rf"^{tag} kernels (\{{.*\}})$", f.read(), re.M)]


def test_deployment_boot_certify_read_crash_restart(tmp_path):
    topo = Topology(kind="validators", n_validators=2, n_replicas=1,
                    chain_id="deploy-smoke", max_seconds=240,
                    env={"TM_CUDA_STATE_TREE": "on"}, device="cpu")
    out = str(tmp_path / "net")
    d = Deployment(topo, out, max_restarts=2)
    for spec in d.specs:
        pv = os.path.join(spec.home, "config", "priv_validator.json")
        assert os.path.exists(pv) == (spec.kind == "validator"), spec.name
        assert spec.argv[-2:] == ["--device", "cpu"]
    d.start()
    try:
        d.wait_height(3, timeout_s=120)
        rep = d.clients(kind="replica")[0]

        def certified(h):
            try:
                return rep.call("status")["edge"]["certified_height"] >= h
            except OSError:
                return False
        assert _wait(lambda: certified(2)), d.log_tail("replica0")
        val = d.clients(kind="validator")[0]
        val.call("broadcast_tx_commit", tx=b"dk=dv".hex())
        assert _wait(lambda: certified(
            val.call("status")["latest_block_height"])), \
            d.log_tail("replica0")
        doc = rep.call("replica_read", key=b"dk".hex())
        assert bytes.fromhex(doc["value"]) == b"dv"
        assert doc["value_proof"] is not None
        assert doc["edge"]["certified_height"] >= doc["height"]
        gpath = os.path.join(d.spec("replica0").home, "config",
                             "genesis.json")
        gen = GenesisDoc.load(gpath)
        cert = ContinuousCertifier(gen.chain_id, _genesis_valset(gen),
                                   verifier=BatchVerifier("python"))
        CertifiedReader.verify(doc, cert)
        assert cert.certified_height >= doc["height"]
        jgen = JGenesisDoc.load(gpath)
        jcert = JCert(jgen.chain_id, jreads._genesis_valset(jgen),
                      verifier=JVerifier("auto", mesh="off",
                                         coalesce="off"))
        jreads.CertifiedReader.verify(doc, jcert)
        assert jcert.certified_height == cert.certified_height
        hz = rep.call("healthz")
        assert hz["edge"]["role"] == "replica"
        assert hz["edge"]["lag"] <= hz["edge"]["max_lag"]
        lines = _lines(os.path.join(d.spec("replica0").home, "node.log"),
                       "replica")
        assert lines and lines[-1]["edge"]["certified_height"] >= 2
        assert lines[-1]["device"] == "cpu"
        d.kill("replica0")
        assert _wait(lambda: d.restarts.get("replica0", 0) >= 1,
                     timeout=30)
        assert _wait(lambda: d.alive("replica0"), timeout=30)
        assert _wait(lambda: certified(2), timeout=90), \
            d.log_tail("replica0")
        assert not d.dead
    finally:
        d.stop()
    assert all(p.poll() is not None for p in d._procs.values())
    assert not d._logs
    assert not os.path.exists(out)


def test_shardset_process_serves_the_front_door(tmp_path):
    from tendermint_tpu_torch.rpc import JSONRPCClient
    topo = Topology(kind="shardset", n_shards=3, max_seconds=120,
                    env={"TM_CUDA_STATE_TREE": "on"}, device="cpu")
    out = str(tmp_path / "ss")
    d = Deployment(topo, out, max_restarts=0)
    d.start()
    try:
        c = JSONRPCClient(d.specs[0].rpc_address)
        assert _wait(lambda: _shards(c) is not None, 60), \
            d.log_tail("shardset")
        doc = _shards(c)
        assert doc["n_shards"] == 3 and doc["version"] == 1
        keys = [b"ss/%d" % i for i in range(12)]
        r = c.call("broadcast_tx_batch",
                   txs=[(k + b"=v").hex() for k in keys])
        assert all(x["code"] == 0 for x in r["results"])
        reader = CertifiedReader(call=lambda m, **p: c.call(m, **p),
                                 verifier=BatchVerifier("python"))

        def read_back():
            res = reader.read(keys[0])
            return res if res["value"] == b"v" else None
        assert _wait(read_back, 30)
        res = read_back()
        assert res["proven"] and res["certified_height"] >= res["height"]
    finally:
        d.stop(cleanup=False)
    lines = _lines(os.path.join(d.specs[0].home, "node.log"), "shardset")
    assert lines and set(lines[-1]["heights"]) == set(doc["chains"])
    assert lines[-1]["coalescer"]["submissions"] > 0
    assert lines[-1]["device"] == "cpu"


def _shards(c):
    try:
        return c.call("shards")
    except OSError:
        return None


def test_validators_commit_through_the_wire_proxy(tmp_path):
    topo = Topology(kind="validators", n_validators=2, n_replicas=0,
                    chain_id="wired", max_seconds=120, device="cpu",
                    wire={"step_ms": 25, "delay": 0.05,
                          "delay_steps": [1, 2]}, wire_seed=3)
    d = Deployment(topo, str(tmp_path / "w"), max_restarts=0)
    d.start()
    try:
        proxy = d._proxy
        assert proxy is not None and len(proxy.ports) == 2
        for i, spec in enumerate(d.specs):
            with open(os.path.join(spec.home, "config",
                                   "config.json")) as f:
                cfg = json.load(f)
            assert cfg["p2p"]["pex"] is False
            port = int(cfg["p2p"]["persistent_peers"].rsplit(":", 1)[1])
            assert port == proxy.ports[(i, 1 - i)]
        d.wait_height(3, timeout_s=90)
    finally:
        d.stop()
    assert d._proxy is None


def test_cli_replica_refuses_a_home_with_a_validator_key(tmp_path):
    """In a process of its own: `cli replica` configures the process's
    logging."""
    home = str(tmp_path / "r")
    assert cli.main(["--home", home, "init", "--chain-id", "keyed"]) == 0
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", home,
         "replica", "--device", "cpu", "--max-seconds", "1"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "REFUSING to start" in proc.stdout
