"""The port's ABCI socket protocol (abci/client.SocketClient,
abci/server.ABCIServer, abci/proxy.socket_client_creator) against the
JAX package's, on the CPU, tolerance 0.

- The frames (4-byte big-endian length + canonical JSON) of every
  request and response shape are the JAX package's bytes.
- The port's SocketClient drives the JAX package's ABCIServer, and the
  JAX SocketClient the port's ABCIServer: every AppConn call gives the
  result a LocalClient gives on the same app, and an app error comes
  back as ABCIClientError with the JAX message.
- Eight seeded blocks of kvstore txs (and a validator update) through a
  socket AppConns of the port (socket_client_creator) give, height for
  height, the app hashes, DeliverTx results and EndBlock updates of the
  local client, with the port's server and with the JAX package's.
"""

import io
import random

import pytest

from tendermint_tpu.abci import client as jclient
from tendermint_tpu.abci import server as jserver
from tendermint_tpu.abci import types as jtypes
from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu_torch.abci import client as tclient
from tendermint_tpu_torch.abci import server as tserver
from tendermint_tpu_torch.abci import types as ttypes
from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.proxy import (AppConns, local_client_creator,
                                             socket_client_creator)
from tendermint_tpu_torch.types.keys import PrivKey

HEADER = {"height": 1, "chain_id": "abci-socket", "time_ns": 7}
VAL = PrivKey.generate(b"\x07" * 32).pubkey.ed25519


def _shapes(P):
    """One request and response of every method, as each package builds
    them (the payloads the clients and server write)."""
    reqs = [P.Request("echo", {"msg": "hi"}), P.Request("info"),
            P.Request("check_tx", {"tx": b"a=1".hex()}),
            P.Request("init_chain", {"validators": [
                {"pubkey": VAL.hex(), "power": 10}], "chain_id": "c",
                "app_state": None}),
            P.Request("begin_block", {"block_hash": "00" * 32,
                                      "header": HEADER,
                                      "absent_validators": [],
                                      "byzantine_validators": []}),
            P.Request("deliver_tx", {"tx": b"k=v".hex()}),
            P.Request("end_block", {"height": 3}), P.Request("commit")]
    resps = [P.Response("echo", {"msg": "hi"}),
             P.Response("check_tx", P.ResultCheckTx(code=0).to_obj()),
             P.Response("deliver_tx", None, "ValueError: bad"),
             P.Response("commit", {"data": "ab" * 32})]
    return [r.to_obj() for r in reqs + resps]


def _frames(frames_mod, P):
    buf = io.BytesIO()
    for obj in _shapes(P):
        frames_mod.write_frame(buf, obj)
    return buf.getvalue()


def test_frame_bytes_match_jax():
    want = _frames(jclient, jtypes)
    assert _frames(tclient, ttypes) == want
    # each package reads the other's frames back to the same objects
    for reader, P in ((tclient, ttypes), (jclient, jtypes)):
        f = io.BytesIO(want)
        got = [reader.read_frame(f) for _ in _shapes(P)]
        assert got == _shapes(P)
        with pytest.raises(EOFError):
            reader.read_frame(f)


def test_oversized_and_torn_frames_raise_as_in_jax():
    big = tclient._LEN.pack(tclient._MAX_MSG + 1)
    for mod in (tclient, jclient):
        with pytest.raises(mod.ABCIClientError, match="exceeds"):
            mod.read_frame(io.BytesIO(big))
        with pytest.raises(EOFError, match="mid-frame"):
            mod.read_frame(io.BytesIO(tclient._LEN.pack(10) + b"abc"))


def _calls(conn):
    """Every AppConn call; results as plain objects."""
    out = [conn.echo("hello"), conn.info().to_obj(),
           conn.set_option("k", "v")]
    conn.init_chain([ttypes.ValidatorUpdate(VAL, 10)], "abci-socket")
    out.append(conn.check_tx(b"a=1").to_obj())
    conn.begin_block(b"\x01" * 32, HEADER)
    out.append(conn.deliver_tx(b"a=1").to_obj())
    out.append([r.to_obj() for r in conn.deliver_tx_batch(
        [b"b=2", b"c=3", b"opaque"])])
    out.append(conn.end_block(1).to_obj())
    out.append(conn.commit().hex())
    out.append(conn.query("", b"b", 0, False).to_obj())
    out.append(conn.info().to_obj())
    return out


SERVERS = {"port": lambda app, addr: tserver.ABCIServer(app, addr),
           "jax": lambda app, addr: jserver.ABCIServer(app, addr)}
APPS = {"port": KVStoreApp, "jax": lambda: jkv.KVStoreApp(use_native=False)}
CLIENTS = {"port": tclient.SocketClient, "jax": jclient.SocketClient}


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port", "port")])
def test_socket_client_and_server_interoperate(server, client):
    want = _calls(LocalClient(KVStoreApp()))
    srv = SERVERS[server](APPS[server](), "127.0.0.1:0")
    srv.start()
    try:
        conn = CLIENTS[client](f"127.0.0.1:{srv.bound_port}")
        try:
            got = _calls(conn)
        finally:
            conn.close()
    finally:
        srv.stop()
    assert _jsonable(got) == _jsonable(want)


def test_server_error_reply_matches_jax():
    """A request the app cannot serve answers the JAX error string."""
    replies = []
    for mk, C in ((SERVERS["port"], tclient), (SERVERS["jax"], jclient)):
        srv = mk(KVStoreApp(), "127.0.0.1:0")
        srv.start()
        conn = C.SocketClient(f"127.0.0.1:{srv.bound_port}")
        try:
            with pytest.raises(C.ABCIClientError) as e:
                conn._call("no_such_method", {})
            replies.append(str(e.value))
            with pytest.raises(C.ABCIClientError) as e:
                conn._call("deliver_tx", {"tx": "zz"})
            replies.append(str(e.value))
        finally:
            conn.close()
            srv.stop()
    assert replies[:2] == replies[2:]
    assert replies[0] == ("no_such_method: ValueError: unknown ABCI method "
                          "'no_such_method'")


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, bytes):
        return x.hex()
    return x


def _blocks(seed: int, n: int = 8):
    rng = random.Random(seed)
    out = []
    for h in range(1, n + 1):
        txs = [b"k%d=v%d" % (rng.randrange(40), rng.randrange(1000))
               for _ in range(rng.randrange(5, 30))]
        if h == 4:
            txs.append(b"val:" + VAL.hex().encode() + b"/5")
        out.append(txs)
    return out


def _run_blocks(conns, blocks):
    conns.consensus.init_chain([ttypes.ValidatorUpdate(VAL, 10)],
                               "abci-socket")
    rows = []
    for h, txs in enumerate(blocks, 1):
        conns.consensus.begin_block(bytes([h]) * 32,
                                    dict(HEADER, height=h))
        res = [r.to_obj() for r in conns.consensus.deliver_tx_batch(txs)]
        end = conns.consensus.end_block(h).to_obj()
        rows.append((conns.consensus.commit(), res, end,
                     conns.query.info().to_obj()))
    return rows


@pytest.mark.parametrize("server", ["port", "jax"])
def test_seeded_blocks_through_the_socket_give_the_local_app_hashes(server):
    blocks = _blocks(11)
    local = AppConns(local_client_creator(KVStoreApp()))
    want = _run_blocks(local, blocks)
    srv = SERVERS[server](APPS[server](), "127.0.0.1:0")
    srv.start()
    try:
        conns = AppConns(socket_client_creator(
            f"127.0.0.1:{srv.bound_port}"))
        try:
            got = _run_blocks(conns, blocks)
        finally:
            conns.close()
    finally:
        srv.stop()
    assert _jsonable(got) == _jsonable(want)
    assert len({h for h, _, _, _ in want}) == len(blocks)
