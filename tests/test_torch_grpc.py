"""The port's gRPC surfaces (rpc/proto, rpc/grpc_util.py,
rpc/grpc_service.py, abci/grpc_app.py) against the JAX package's
(tests/test_grpc.py), on the CPU, tolerance 0.

- The port's tmtpu_pb2 registers the JAX module's serialized descriptor
  byte for byte, so both import in one process and share the message
  classes; the method paths are the JAX package's.
- ABCI over gRPC: the round trip of every method, on the port's server
  and client beside the JAX pair on the same calls, and AppConns over
  grpc_client_creator; both wire crossings (the JAX ABCIGrpcServer with
  the port's GrpcClient, the port's server with the JAX client).
- A single-validator port node whose app sits behind ABCIGrpcServer,
  reached by grpc_client_creator, commits the app hashes of the same txs
  on the local client.
- BroadcastAPI: ping and a tx on a device="cpu" port node, from the
  port's client and the JAX client; the tx is committed.
- A second bind of a gRPC port raises, in both packages.
"""

import hashlib
import time

import pytest

from tendermint_tpu.abci import grpc_app as jgrpc
from tendermint_tpu.abci.apps import KVStoreApp as JKVStoreApp
from tendermint_tpu.abci.types import ValidatorUpdate as JValidatorUpdate
from tendermint_tpu.rpc import grpc_service as jsvc
from tendermint_tpu.rpc.proto import tmtpu_pb2 as jpb
from tendermint_tpu_torch.abci import grpc_app as tgrpc
from tendermint_tpu_torch.abci.apps import KVStoreApp as TKVStoreApp
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.abci.types import ValidatorUpdate
from tendermint_tpu_torch.config import test_config as make_test_config
from tendermint_tpu_torch.consensus import MockTicker
from tendermint_tpu_torch.node import Node
from tendermint_tpu_torch.rpc import grpc_service as tsvc
from tendermint_tpu_torch.rpc.proto import tmtpu_pb2 as tpb
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.priv_validator import (LocalSigner,
                                                       PrivValidator)


def test_descriptor_is_the_jax_one():
    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.DESCRIPTOR.name == "tmtpu.proto"
    assert tpb.DESCRIPTOR.package == "tendermint_tpu"
    assert tpb.BroadcastTxRequest is jpb.BroadcastTxRequest
    assert tsvc._SERVICE == jsvc._SERVICE == "tendermint_tpu.BroadcastAPI"
    assert tgrpc._SERVICE == jgrpc._SERVICE
    assert tgrpc._METHODS == jgrpc._METHODS


def _session(client, vu):
    """Every ABCI method once, in a height's order; the results as plain
    tuples."""
    out = [client.echo("hello"), tuple(vars(client.info()).values())]
    client.init_chain([vu(b"\x01" * 32, 10)], "grpc-chain")
    client.begin_block(b"\xaa" * 32, {"height": 1, "time_ns": 1},
                       absent_validators=[], byzantine_validators=[])
    res = client.deliver_tx(b"k=v")
    out.append((res.code, res.data, res.log, res.tags))
    out.append([(r.code, r.tags) for r in
                client.deliver_tx_batch([b"a=1", b"b=2", b""])])
    eb = client.end_block(1)
    out.append((eb.validator_updates, eb.consensus_param_updates, eb.tags))
    out.append(client.commit())
    q = client.query("/key", b"k")
    out.append((q.code, q.key, q.value, q.proof, q.height, q.log))
    for tx in (b"x=y", b""):
        c = client.check_tx(tx)
        out.append((c.code, c.data, c.log, c.gas_wanted, c.ok))
    out.append(client.set_option("k", "v"))
    out.append(tuple(vars(client.info()).values()))
    return out


def _served(server_mod, app):
    server = server_mod.ABCIGrpcServer(app, "127.0.0.1:0")
    server.start()
    return server


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_abci_grpc_round_trip_matches_jax(server_pkg, client_pkg):
    """The same session over the JAX pair and over the pair under test
    (the port's alone, or a crossing of the wire) gives equal results."""
    want_server = _served(jgrpc, JKVStoreApp())
    server = _served(tgrpc if server_pkg == "port" else jgrpc,
                     TKVStoreApp() if server_pkg == "port"
                     else JKVStoreApp())
    try:
        jc = jgrpc.GrpcClient(f"127.0.0.1:{want_server.port}")
        want = _session(jc, JValidatorUpdate)
        jc.close()
        cmod = tgrpc if client_pkg == "port" else jgrpc
        c = cmod.GrpcClient(f"127.0.0.1:{server.port}")
        got = _session(c, ValidatorUpdate if client_pkg == "port"
                       else JValidatorUpdate)
        c.close()
    finally:
        server.stop()
        want_server.stop()
    assert [repr(x) for x in got] == [repr(x) for x in want]
    assert got[3] == [(0, {"app.key": "a"}), (0, {"app.key": "b"}),
                      (1, {})]


def test_abci_grpc_client_creator_with_appconns():
    """The node-side use: three AppConns over three channels."""
    app = TKVStoreApp()
    server = _served(tgrpc, app)
    try:
        conns = AppConns(tgrpc.grpc_client_creator(
            f"127.0.0.1:{server.port}"))
        assert conns.query.info().last_block_height == 0
        assert conns.mempool.check_tx(b"k=v").ok
        conns.consensus.begin_block(b"\x01" * 32, {"height": 1})
        conns.consensus.deliver_tx(b"k=v")
        conns.consensus.end_block(1)
        h = conns.consensus.commit()
        assert h and h == app.app_hash
        assert conns.query.query("", b"k").value == b"v"
        conns.close()
    finally:
        server.stop()


# ------------------------------------------------- a node on gRPC ABCI --

TXS = [b"g%02d=v%d" % (i, i) for i in range(9)]


def _grpc_app_node(client_creator=None, app=None):
    key = PrivKey.generate(b"\x0b" * 32)
    gen = GenesisDoc(chain_id="grpc-abci", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    cfg = make_test_config("")
    cfg.base.verifier_backend = "python"
    cfg.consensus.max_block_size_txs = 3
    node = Node(cfg, gen, priv_validator=PrivValidator(LocalSigner(key)),
                app=app, client_creator=client_creator, in_memory=True)
    node.consensus.ticker.stop()
    node.consensus.ticker = MockTicker(node.consensus._on_timeout_fire)
    return node


def _app_hashes(node, heights=4):
    node.start()
    try:
        for tx in TXS:
            node.mempool.check_tx(tx)
        for _ in range(400):
            if node.height >= heights:
                break
            node.consensus.ticker.fire_next()
        assert node.height >= heights
        return [node.block_store.load_block_meta(h).header.app_hash
                for h in range(1, heights + 1)]
    finally:
        node.stop()


def test_node_over_grpc_abci_commits_the_local_app_hashes():
    app = TKVStoreApp()
    server = _served(tgrpc, app)
    try:
        over_grpc = _app_hashes(_grpc_app_node(
            client_creator=tgrpc.grpc_client_creator(
                f"127.0.0.1:{server.port}")))
    finally:
        server.stop()
    local_app = TKVStoreApp()
    local = _app_hashes(_grpc_app_node(
        client_creator=local_client_creator(local_app), app=local_app))
    assert over_grpc == local
    assert len(set(local[1:])) == len(local) - 1   # the txs moved it
    assert dict(app.store) == dict(local_app.store)


# ----------------------------------------------------------- BroadcastAPI

@pytest.fixture(scope="module")
def grpc_node():
    key = PrivKey.generate(b"\x0b" * 32)
    gen = GenesisDoc(chain_id="grpc-test", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    cfg = make_test_config("")
    cfg.base.verifier_backend = "python"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
    node = Node(cfg, gen, priv_validator=PrivValidator(LocalSigner(key)),
                in_memory=True, with_rpc=True, device="cpu")
    node.start()
    deadline = time.monotonic() + 30
    while node.height < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert node.height >= 2
    yield node
    node.stop()


@pytest.mark.parametrize("client_mod", [tsvc, jsvc], ids=["port", "jax"])
def test_broadcast_api_ping_and_tx(grpc_node, client_mod):
    c = client_mod.BroadcastAPIClient(
        f"127.0.0.1:{grpc_node.grpc_server.port}")
    try:
        c.ping()  # must not raise
        tx = b"gk-%s=gv" % client_mod.__name__.encode()
        res = c.broadcast_tx(tx)
        assert res.check_tx.code == 0
        assert res.deliver_tx.code == 0
        assert res.height >= 1
        assert res.hash == hashlib.sha256(tx).digest()
        blk = grpc_node.block_store.load_block(res.height)
        assert tx in blk.data.txs
    finally:
        c.close()


def test_grpc_only_node_serves_no_json_rpc():
    key = PrivKey.generate(b"\x0c" * 32)
    gen = GenesisDoc(chain_id="grpc-only", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    cfg = make_test_config("")
    cfg.base.verifier_backend = "python"
    cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
    node = Node(cfg, gen, priv_validator=PrivValidator(LocalSigner(key)),
                in_memory=True)
    node.start()
    try:
        assert node.rpc_address is None and node.grpc_server.port > 0
        c = tsvc.BroadcastAPIClient(f"127.0.0.1:{node.grpc_server.port}")
        c.ping()
        c.close()
    finally:
        node.stop()


@pytest.mark.parametrize("mod,app", [(tgrpc, TKVStoreApp),
                                     (jgrpc, JKVStoreApp)],
                         ids=["port", "jax"])
def test_grpc_bind_conflict_raises(mod, app):
    """SO_REUSEPORT is off: a second bind of the same port fails loudly
    (grpcio raises RuntimeError at add_insecure_port; OSError is the
    guard for the silent 0)."""
    first = mod.ABCIGrpcServer(app(), "127.0.0.1:0")
    try:
        with pytest.raises((OSError, RuntimeError)):
            mod.ABCIGrpcServer(app(), f"127.0.0.1:{first.port}")
        # across the packages too
        other = jgrpc if mod is tgrpc else tgrpc
        with pytest.raises((OSError, RuntimeError)):
            other.ABCIGrpcServer(app(), f"127.0.0.1:{first.port}")
    finally:
        first.stop()
