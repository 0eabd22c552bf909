"""The port's JSON-RPC (rpc/server.py, rpc/core.py, rpc/client.py) against
the JAX package's, on the CPU, tolerance 0.

- Server and clients: one set of handlers registered on a port RPCServer
  and a JAX RPCServer, called through JSON-RPC POST, URI GET and
  WebSocket by the port's clients and the JAX package's, give the same
  results and error codes and messages in every pairing: unknown method,
  missing and bad params, a handler's exception, a handler's RPCError,
  a ws-only route over HTTP, a parse error, the route listing, and the
  HTTP connection cap's 503.
- Route table: RPCCore.routes() / ws_routes() equal the JAX table less
  the routes named in rpc/core.LEFT_OUT, with unsafe on and off.
- Routes over nodes: a port and a JAX in-memory single-validator node
  (test_torch_node.single_node: one genesis, key, txs and height clock)
  answer every ported route with equal JSON, before and after txs
  through broadcast_tx_sync / _commit / _batch / _async, and their
  errors with equal messages; a WebSocket subscriber of each node's
  server receives the same Tx event. LocalClient and MockClient wrap a
  server as the JAX ones do.
- net_info over a switch: two connected switches of each package, on the
  same seeded keys, give equal net_info once the port's `banned` (its
  extension over the JAX route) is taken out; `banned` lists the active
  bans of a planted set with their strikes, and no expired one.
"""

import hashlib
import socket
import time
import tracemalloc

import pytest

from tendermint_tpu.p2p import test_util as jp2p
from tendermint_tpu.rpc import client as jclient
from tendermint_tpu.rpc import core as jcore
from tendermint_tpu.rpc import server as jserver
from tendermint_tpu_torch.p2p import test_util as tp2p
from tendermint_tpu_torch.rpc import client as tclient
from tendermint_tpu_torch.rpc import core as tcore
from tendermint_tpu_torch.rpc import server as tserver
from test_torch_node import JAX, PORT, settle, single_node

SERVERS = {"port": tserver, "jax": jserver}
CLIENTS = {"port": tclient, "jax": jclient}


def _handlers(srv_mod):
    def add(a: int, b: int = 1) -> int:
        return a + b

    def echo(s: str = "", flag: bool = False):
        return {"s": s, "flag": flag}

    def hexlen(data: bytes = b""):
        return {"n": len(data), "hex": data.hex()}

    def boom():
        raise ValueError("kaboom")

    def refuse():
        raise srv_mod.RPCError(-32000, "custom refusal", data="d")

    def whoami(ws=None):
        return {"ws": ws is not None}

    return {"add": add, "echo": echo, "hexlen": hexlen, "boom": boom,
            "refuse": refuse}, {"whoami": whoami}


def _serve(name, **kw):
    mod = SERVERS[name]
    srv = mod.RPCServer(**kw)
    routes, ws_routes = _handlers(mod)
    srv.register_all(routes)
    for k, fn in ws_routes.items():
        srv.register(k, fn, ws_only=True)
    host, port = srv.serve("127.0.0.1", 0)
    return srv, port


CALLS = [("add", {"a": 2, "b": 5}), ("add", {"a": "7"}), ("add", {}),
         ("add", {"a": "x"}), ("echo", {"s": "hi", "flag": "true"}),
         ("echo", {}), ("hexlen", {"data": "0xdeadbeef"}),
         ("hexlen", {"data": "zz"}), ("boom", {}), ("refuse", {}),
         ("nope", {}), ("whoami", {})]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        # the traceback a -32603 error carries names files: not compared
        data = getattr(e, "data", None)
        if isinstance(data, str) and "Traceback" in data:
            data = "<traceback>"
        return ("err", type(e).__name__, getattr(e, "code", None), str(e),
                data)


def _run_clients(cmod, port):
    base = f"http://127.0.0.1:{port}"
    out = {}
    http = cmod.JSONRPCClient(base)
    uri = cmod.URIClient(base)
    ws = cmod.WSClient("127.0.0.1", port)
    try:
        for kind, c in (("post", http), ("uri", uri), ("ws", ws)):
            out[kind] = [_outcome(lambda m=m, p=p: c.call(m, **p))
                         for m, p in CALLS]
    finally:
        ws.close()
    return out


def test_clients_and_servers_answer_as_jax():
    results = {}
    for s in SERVERS:
        srv, port = _serve(s)
        try:
            for c in CLIENTS:
                results[(s, c)] = _run_clients(CLIENTS[c], port)
        finally:
            srv.stop()
    want = results[("jax", "jax")]
    for key, got in results.items():
        assert got == want, key
    post = dict(zip([m for m, _ in CALLS], want["post"]))
    assert want["post"][0] == ("ok", 7)
    assert want["uri"][1] == ("ok", 8)
    assert want["post"][2][2] == -32602          # missing param
    assert want["uri"][3][2] == -32602           # bad value
    assert post["boom"][2] == -32603 and "kaboom" in post["boom"][3]
    assert post["refuse"][2:] == (-32000, "[-32000] custom refusal", "d")
    assert post["nope"][2] == -32601
    assert post["whoami"][2] == -32601           # ws-only over HTTP
    assert want["ws"][-1] == ("ok", {"ws": True})


def _raw(port, data: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(data)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
        head, _, body = buf.partition(b"\r\n\r\n")
        n = int(dict(ln.split(b": ", 1) for ln in head.split(b"\r\n")[1:]
                     if b": " in ln).get(b"Content-Length", b"0"))
        while len(body) < n:
            body += s.recv(4096)
        return head.split(b"\r\n")[0] + b"|" + body


def test_raw_http_edges_and_connection_cap_match_jax():
    out = {}
    for name in SERVERS:
        srv, port = _serve(name, max_http_conns=1)
        hold = socket.create_connection(("127.0.0.1", port))
        try:
            hold.sendall(b"GET / HTTP/1.1\r\n")   # holds the only slot
            time.sleep(0.2)
            capped = _raw(port, b"GET /add?a=1 HTTP/1.1\r\nHost: x\r\n\r\n")
        finally:
            hold.close()
            srv.stop()
        srv, port = _serve(name)
        try:
            listing = _raw(port, b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
            bad = b"{not json"
            parse = _raw(port, b"POST / HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(bad) + bad)
            big = _raw(port, b"POST / HTTP/1.1\r\nHost: x\r\n"
                       b"Content-Length: %d\r\n\r\n" % (2 << 20))
        finally:
            srv.stop()
        out[name] = (capped, listing, parse, big)
    assert out["port"] == out["jax"]
    assert out["port"][0].startswith(b"HTTP/1.1 503")
    assert b'"routes"' in out["port"][1] and b"-32700" in out["port"][2]
    assert out["port"][3].startswith(b"HTTP/1.1 413")


@pytest.mark.parametrize("unsafe", [False, True])
def test_route_table_is_the_jax_table_less_the_telemetry_routes(unsafe):
    t = tcore.RPCCore(tcore.RPCEnv(unsafe=unsafe))
    j = jcore.RPCCore(jcore.RPCEnv(unsafe=unsafe))
    assert set(t.routes()) == set(j.routes()) - set(tcore.LEFT_OUT)
    assert set(j.routes()) & set(tcore.LEFT_OUT) == (
        set(tcore.LEFT_OUT) if unsafe else
        set(tcore.LEFT_OUT) - {"unsafe_dump_trace"})
    assert set(t.ws_routes()) == set(j.ws_routes())


# ----------------------------------------------------------- over nodes

@pytest.fixture(scope="module")
def nodes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_TPU_PIPELINE", "off")
        ns = {"jax": single_node(JAX), "port": single_node(PORT)}
        for n in ns.values():
            n.config.rpc.unsafe = True
        try:
            yield ns
        finally:
            for n in ns.values():
                n.stop()
            for P in (JAX, PORT):
                P.clock.set_source(None)


def _cores(nodes):
    return {"port": tcore.RPCCore(tcore.RPCEnv.from_node(nodes["port"])),
            "jax": jcore.RPCCore(jcore.RPCEnv.from_node(nodes["jax"]))}


def _call(core, name, params):
    fn = core.routes().get(name)
    try:
        return ("ok", tcore.jsonify(fn(**params)))
    except Exception as e:
        return ("err", type(e).__name__, getattr(e, "code", None), str(e))


def _compare(nodes, calls):
    cores = _cores(nodes)
    for name, params in calls:
        got = _call(cores["port"], name, params)
        want = _call(cores["jax"], name, params)
        assert got == want, (name, params)
    return got


def _read_calls(h):
    tx0 = hashlib.sha256(b"k00=v0").digest()
    return [
        ("status", {}), ("net_info", {}), ("genesis", {}),
        ("blockchain", {}), ("blockchain", {"min_height": 2,
                                            "max_height": 3}),
        ("block", {}), ("block", {"height": 2}), ("block", {"height": 99}),
        ("block_results", {"height": 2}), ("block_results", {}),
        ("block_results", {"height": 99}),
        ("commit", {}), ("commit", {"height": 2}), ("commit", {"height": 99}),
        ("validators", {}), ("validators", {"height": 1}),
        ("dump_consensus_state", {}), ("unconfirmed_txs", {}),
        ("num_unconfirmed_txs", {}), ("abci_info", {}),
        ("abci_query", {"data": b"k03"}),
        ("abci_query", {"path": "", "data": b"absent"}),
        ("tx", {"hash": tx0}), ("tx", {"hash": tx0, "prove": True}),
        ("tx", {"hash": b"\x00" * 32}),
        ("tx_search", {"query": "tx.height = 2"}),
        ("tx_search", {"query": f"tx.height >= 1", "page": 2,
                       "per_page": 4}),
        ("tx_search", {"query": "tx.hash = '" + tx0.hex() + "'"}),
        ("blockchain", {"max_height": h}),
    ]


def test_routes_over_nodes_answer_as_jax(nodes):
    h = nodes["port"].height
    assert h == nodes["jax"].height >= 4
    _compare(nodes, _read_calls(h))


def _settle_both(nodes):
    for n in nodes.values():
        settle(n)
    assert nodes["port"].height == nodes["jax"].height


def test_broadcast_routes_answer_as_jax(nodes):
    got = _compare(nodes, [("broadcast_tx_sync", {"tx": b"s1=1"}),
                           ("broadcast_tx_sync", {"tx": b"s1=1"})])
    assert got[2:] == (-32000, "tx already in cache")
    _settle_both(nodes)
    _compare(nodes, [("broadcast_tx_commit", {"tx": b"c1=1"})])
    _settle_both(nodes)
    res = _compare(nodes, [("broadcast_tx_batch", {
        "txs": [b"b1=1".hex(), b"b2=2".hex(), b"b1=1".hex()]}),
        ("broadcast_tx_batch", {"txs": ["zz"]}),
        ("broadcast_tx_batch", {"txs": "notalist"})])
    assert res[2] == -32602
    _settle_both(nodes)
    _compare(nodes, [("broadcast_tx_async", {"tx": b"a1=1"})])
    for n in nodes.values():
        t0 = time.monotonic()
        while not n.tx_indexer.get(hashlib.sha256(b"a1=1").digest()):
            assert time.monotonic() - t0 < 20
            time.sleep(0.02)
    _settle_both(nodes)
    _compare(nodes, _read_calls(nodes["port"].height) +
             [("tx_search", {"query": "tx.height > 4"}),
              ("unsafe_flush_mempool", {}),
              ("dial_peers", {"peers": ""}), ("dial_seeds", {})])


def test_unsafe_profiler_routes_answer_as_jax(nodes, tmp_path):
    cores = _cores(nodes)
    out = {}
    for name, core in cores.items():
        f = str(tmp_path / f"{name}.prof")
        r = core.routes()
        out[name] = [_call(core, "unsafe_stop_cpu_profiler", {}),
                     r["unsafe_start_cpu_profiler"](filename=f),
                     _call(core, "unsafe_start_cpu_profiler", {}),
                     r["unsafe_stop_cpu_profiler"]()["written"] == f]
        was = tracemalloc.is_tracing()
        tracemalloc.stop()
        out[name].append(r["unsafe_write_heap_profile"]())
        if not was:
            tracemalloc.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0][2] == -32000 and out["port"][2][2] == -32000


def test_ws_subscriber_and_local_clients_see_what_jax_does(nodes):
    events = {}
    servers = {"port": tcore.make_server(
        tcore.RPCEnv.from_node(nodes["port"]))[0],
        "jax": jcore.make_server(jcore.RPCEnv.from_node(nodes["jax"]))[0]}
    try:
        subs = {}
        for name, srv in servers.items():
            _, port = srv.serve("127.0.0.1", 0)
            subs[name] = tclient.WSClient("127.0.0.1", port)
            subs[name].subscribe("tm.event = 'Tx'")
        for name, ws in subs.items():
            res = ws.call("broadcast_tx_commit", tx=b"ws1=1", timeout=30)
            events[name] = (res, ws.next_event(timeout=30))
            assert ws.call("unsubscribe_all") == {}
            ws.close()
        _settle_both(nodes)
        # LocalClient and MockClient around the servers
        for name, srv in servers.items():
            lc = tclient.LocalClient(srv)
            mc = tclient.MockClient(inner=lc)
            mc.expect("status", response={"canned": True})
            events[name] += (mc.call("status"), mc.call("abci_info"),
                             _outcome(lambda: mc.call("nope")),
                             [c.method for c in mc.calls])
    finally:
        for srv in servers.values():
            srv.stop()
    assert events["port"] == events["jax"]
    assert events["port"][1]["data"]["tx"] == b"ws1=1".hex()


# ----------------------------------------------------------- over switches

@pytest.fixture
def switch_pairs():
    pairs = {"jax": jp2p.make_connected_switches(2, lambda i: {}),
             "port": tp2p.make_connected_switches(2, lambda i: {})}
    try:
        yield pairs
    finally:
        for sws in pairs.values():
            for sw in sws:
                sw.stop()


def _net_info(core_mod, sw):
    return core_mod.RPCCore(core_mod.RPCEnv(switch=sw)).net_info()


def test_net_info_with_a_switch_answers_as_jax(switch_pairs):
    got = _net_info(tcore, switch_pairs["port"][0])
    want = _net_info(jcore, switch_pairs["jax"][0])
    assert got.pop("banned") == {}
    assert got == want
    assert got["n_peers"] == 1
    assert got["peers"][0]["node_info"]["moniker"] == "node1"


def test_net_info_lists_the_active_bans(switch_pairs):
    sw = switch_pairs["port"][0]
    peer = sw.peers.list()[0].node_info.id
    sw.ban_peer(peer, "planted")
    for _ in range(2):
        sw.ban_peer("aa" * 20, "planted twice")
    sw.ban_peer("bb" * 20, "planted, expired")
    sw.banned["bb" * 20]["until"] = time.monotonic() - 1.0
    assert _net_info(tcore, sw)["banned"] == {
        peer: {"strikes": 1}, "aa" * 20: {"strikes": 2}}
