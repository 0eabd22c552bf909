"""The port's async RPC front door (rpc/aserver.py) and front-door tx
batching (rpc/core.TxBatcher) against the JAX package's, on the CPU,
tolerance 0 (response bytes, results, error codes and messages).

- Handlers: one set of handlers on a port AsyncRPCServer (on a port
  ReactorLoop) and a JAX one (on a JAX ReactorLoop), called through POST,
  URI GET and WebSocket by the port's clients and the JAX package's, give
  the same results and errors in every pairing; the raw HTTP answers to a
  route listing, a parse error and an oversized body are the same bytes.
  An oversized body's 413 repeats in both packages (a fault of the
  reference the port keeps: the answer parses the buffered head again).
- Routes over nodes: a port and a JAX in-memory single-validator node
  (test_torch_node.single_node) behind make_server(env, loop=) answer
  every ported read route with the same JSON bytes over POST, URI GET
  and a WebSocket frame; broadcast_tx_sync through each front door's tx
  batcher admits a tx and refuses its duplicate with the same bytes.
- Admission: the connection cap's 503, the in-flight cap's overload
  error and the per-IP token bucket's -32005 are the same bytes.
- Event fan-out: subscribers of each server see every published event
  with no thread a subscriber; the port's front door writes a loop
  tick's frames in one native call (csrc/hostops.cpp tm_sendmany), whose
  partial writes and errors are checked on socket pairs.
- TxBatcher: the same txs (a duplicate and a full mempool included),
  merged into one check_tx_batch, give the same results and leave the
  same mempool as the JAX batcher; RPCCore's broadcast routes over the
  batcher map a duplicate and a full mempool to the same errors.
"""

import base64
import json
import os
import re
import socket
import struct
import threading
import time
from types import SimpleNamespace
from urllib.parse import quote

import pytest

from tendermint_tpu.p2p.conn import loop as jloop
from tendermint_tpu.rpc import aserver as jaserver
from tendermint_tpu.rpc import core as jcore
from tendermint_tpu.types.events import EventBus as JEventBus
from tendermint_tpu_torch.p2p.conn import loop as tloop
from tendermint_tpu_torch.rpc import aserver as taserver
from tendermint_tpu_torch.rpc import client as tclient
from tendermint_tpu_torch.rpc import core as tcore
from tendermint_tpu_torch.types.events import EventBus as TEventBus
from test_torch_mempool import JAX as MJAX, PORT as MPORT, make_mempool
from test_torch_node import JAX, PORT, single_node
from test_torch_rpc import (CALLS, CLIENTS, _handlers, _outcome, _raw,
                            _read_calls, _run_clients)

PKGS = {"port": (tloop, taserver, tcore), "jax": (jloop, jaserver, jcore)}
WAIT_S = 20.0


class Served:
    """An async server of package `name` on its own loop."""

    def __init__(self, name, register=True, **kw):
        loop_mod, srv_mod, _ = PKGS[name]
        self.loop = loop_mod.ReactorLoop(name=f"tm-reactor-loop-{name}")
        self.loop.start()
        self.srv = srv_mod.AsyncRPCServer(self.loop, **kw)
        if register:
            routes, ws_routes = _handlers(
                __import__("tendermint_tpu_torch.rpc.server" if name == "port"
                           else "tendermint_tpu.rpc.server",
                           fromlist=["RPCError"]))
            self.srv.register_all(routes)
            for k, fn in ws_routes.items():
                self.srv.register(k, fn, ws_only=True)

    def serve(self):
        self.port = self.srv.serve("127.0.0.1", 0)[1]
        return self.port

    def stop(self):
        self.srv.stop()
        self.loop.stop()


def test_clients_and_async_servers_answer_as_jax():
    results = {}
    raws = {}
    for s in PKGS:
        sv = Served(s)
        try:
            port = sv.serve()
            for c in CLIENTS:
                results[(s, c)] = _run_clients(CLIENTS[c], port)
            bad = b"{not json"
            raws[s] = (
                _first(port, b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"),
                _first(port, b"POST / HTTP/1.1\r\nHost: x\r\n"
                       b"Content-Length: %d\r\n\r\n" % len(bad) + bad),
                _first(port, b"POST / HTTP/1.1\r\nHost: x\r\n"
                       b"Content-Length: %d\r\n\r\n" % (2 << 20)))
            if s == "port":
                assert sv.srv.stats["requests_http"] > 0
        finally:
            sv.stop()
    want = results[("jax", "jax")]
    for key, got in results.items():
        assert got == want, key
    post = dict(zip([m for m, _ in CALLS], want["post"]))
    assert want["post"][0] == ("ok", 7) and want["uri"][1] == ("ok", 8)
    assert post["boom"][2] == -32603 and post["nope"][2] == -32601
    assert want["ws"][-1] == ("ok", {"ws": True})
    assert raws["port"] == raws["jax"]
    assert b'"routes"' in raws["port"][0] and b"-32700" in raws["port"][1]
    assert raws["port"][2].startswith(b"HTTP/1.1 413")


def _first(port, data: bytes) -> bytes:
    """The first response to `data`: status line | body."""
    status, _, body = _raw(port, data).partition(b"|")
    head = body.split(b"HTTP/1.1 ", 1)[0]
    return status + b"|" + head


def _answers(port, data: bytes, quiet_s: float = 1.0) -> bytes:
    """Everything the server sends for `data` until it is quiet."""
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
        s.sendall(data)
        s.settimeout(quiet_s)
        buf = b""
        try:
            while True:
                chunk = s.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
        except socket.timeout:
            pass
    return buf


def test_oversized_body_is_refused_repeatedly_as_in_jax():
    """A fault of the reference kept by the port: a POST whose declared
    body exceeds MAX_BODY_BYTES is answered 413, and the answer parses
    the same buffered head again, so the 413 repeats (hundreds of times,
    until the loop callback reaches the interpreter's recursion limit
    and the loop logs it). Both packages do it; each repeat is the same
    bytes, and the server stays up."""
    req = (b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
           % (2 << 20))
    out = {}
    for name in PKGS:
        sv = Served(name)
        try:
            port = sv.serve()
            got = _answers(port, req)
            out[name] = (got.split(b"HTTP/1.1 ")[1], got.count(b" 413 "))
            assert _first(port, b"GET /add?a=4 HTTP/1.1\r\nHost: x\r\n"
                          b"\r\n").endswith(b'"result": 5}')
        finally:
            sv.stop()
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0].startswith(b"413 Payload Too Large")
    assert out["port"][1] > 1 and out["jax"][1] > 1


# ------------------------------------------------------ raw transports

def _jsonable(v):
    if isinstance(v, bytes):
        return v.hex()
    return v


def _uri_value(v):
    if isinstance(v, bytes):
        return "0x" + v.hex()
    if isinstance(v, bool):
        return "true" if v else "false"
    return quote(str(v))


_TRACEBACK = re.compile(rb'"data": "Traceback[^"\\]*(?:\\.[^"\\]*)*"')


def _norm(raw: bytes) -> bytes:
    """A -32603 error's data is the handler's traceback, which names the
    package's files: not compared."""
    return _TRACEBACK.sub(b'"data": "<traceback>"', raw)


def _post_bytes(port, method, params, id_=1):
    body = json.dumps({"jsonrpc": "2.0", "id": id_, "method": method,
                       "params": {k: _jsonable(v)
                                  for k, v in params.items()}}).encode()
    return _norm(_raw(port, b"POST / HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: %d\r\n\r\n" % len(body) + body))


def _uri_bytes(port, method, params):
    q = "&".join(f"{k}={_uri_value(v)}" for k, v in params.items())
    return _norm(_raw(port, f"GET /{method}?{q} HTTP/1.1\r\nHost: x\r\n"
                      f"\r\n".encode()))


class RawWS:
    """A WebSocket client that hands back each reply frame's bytes."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=WAIT_S)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            (f"GET /websocket HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
             f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
             f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            self.buf += self.sock.recv(4096)
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        assert b" 101 " in head.split(b"\r\n")[0]

    def _need(self, n):
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            assert chunk, "ws closed"
            self.buf += chunk

    def call(self, method, params, id_=1) -> bytes:
        data = json.dumps({"jsonrpc": "2.0", "id": id_, "method": method,
                           "params": {k: _jsonable(v)
                                      for k, v in params.items()}}).encode()
        n = len(data)
        hdr = bytes([0x81, 0x80 | 126]) + struct.pack(">H", n) \
            if n >= 126 else bytes([0x81, 0x80 | n])
        self.sock.sendall(hdr + b"\x00" * 4 + data)   # a zero mask
        self._need(2)
        ln = self.buf[1] & 0x7F
        pos = 2
        if ln == 126:
            self._need(4)
            ln, pos = struct.unpack(">H", self.buf[2:4])[0], 4
        elif ln == 127:
            self._need(10)
            ln, pos = struct.unpack(">Q", self.buf[2:10])[0], 10
        self._need(pos + ln)
        frame, self.buf = self.buf[:pos + ln], self.buf[pos + ln:]
        return _norm(frame[pos:])

    def close(self):
        self.sock.close()


@pytest.fixture(scope="module")
def served_nodes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_TPU_PIPELINE", "off")
        nodes = {"jax": single_node(JAX), "port": single_node(PORT)}
        loops, servers = {}, {}
        try:
            for name, node in nodes.items():
                loop_mod, _, core_mod = PKGS[name]
                loops[name] = loop_mod.ReactorLoop(
                    name=f"tm-reactor-loop-{name}")
                loops[name].start()
                servers[name], _ = core_mod.make_server(
                    core_mod.RPCEnv.from_node(node), loop=loops[name])
                servers[name].serve("127.0.0.1", 0)
            yield nodes, servers
        finally:
            for s in servers.values():
                s.stop()
            for lp in loops.values():
                lp.stop()
            for n in nodes.values():
                n.stop()
            for P in (JAX, PORT):
                P.clock.set_source(None)


def _port_of(srv):
    return srv._listener.getsockname()[1]


def test_read_routes_answer_with_the_jax_bytes(served_nodes):
    nodes, servers = served_nodes
    h = nodes["port"].height
    assert h == nodes["jax"].height >= 4
    ports = {k: _port_of(s) for k, s in servers.items()}
    ws = {k: RawWS(p) for k, p in ports.items()}
    try:
        for i, (method, params) in enumerate(_read_calls(h)):
            got = {k: (_post_bytes(p, method, params, id_=i),
                       _uri_bytes(p, method, params),
                       ws[k].call(method, params, id_=i))
                   for k, p in ports.items()}
            assert got["port"] == got["jax"], (method, params)
    finally:
        for w in ws.values():
            w.close()


def test_broadcast_over_the_batcher_answers_with_the_jax_bytes(
        served_nodes):
    nodes, servers = served_nodes
    ports = {k: _port_of(s) for k, s in servers.items()}
    got = {k: [_post_bytes(p, "broadcast_tx_sync", {"tx": b"fd1=1"}),
               _post_bytes(p, "broadcast_tx_sync", {"tx": b"fd1=1"})]
           for k, p in ports.items()}
    assert got["port"] == got["jax"]
    assert b'"code": 0' in got["port"][0]
    assert b"tx already in cache" in got["port"][1]
    st = servers["port"]._tx_batcher.snapshot()
    assert st["txs"] == st["flushes"] == 2


# --------------------------------------------------------------- refusals

def _refusals(name, monkeypatch):
    out = []
    # the connection cap: an immediate 503 without reading a request
    sv = Served(name, max_conns=1)
    try:
        port = sv.serve()
        with socket.create_connection(("127.0.0.1", port)) as hold:
            hold.sendall(b"GET /add?a=1 HTTP/1.1\r\nHost: x\r\n\r\n")
            hold.settimeout(WAIT_S)
            assert hold.recv(4096).startswith(b"HTTP/1.1 200")
            with socket.create_connection(("127.0.0.1", port)) as over:
                over.settimeout(WAIT_S)
                buf = b""
                while True:
                    chunk = over.recv(4096)
                    if not chunk:
                        break
                    buf += chunk
                out.append(buf)
        if name == "port":
            assert sv.srv.stats["rejected_conn_cap"] == 1
    finally:
        sv.stop()
    # the in-flight cap: one call held in its handler, the next refused
    monkeypatch.setattr(PKGS[name][1], "MAX_INFLIGHT", 1)
    sv = Served(name)
    entered, release = threading.Event(), threading.Event()

    def hold():
        entered.set()
        release.wait(WAIT_S)
        return "released"
    sv.srv.register("hold", hold)
    try:
        port = sv.serve()
        with socket.create_connection(("127.0.0.1", port)) as first:
            body = b'{"jsonrpc": "2.0", "id": 5, "method": "hold"}'
            first.sendall(b"POST / HTTP/1.1\r\nHost: x\r\n"
                          b"Content-Length: %d\r\n\r\n" % len(body) + body)
            assert entered.wait(WAIT_S)
            out.append(_post_bytes(port, "add", {"a": 1}, id_=6))
            release.set()
            first.settimeout(WAIT_S)
            assert b"released" in first.recv(4096)
    finally:
        release.set()
        sv.stop()
    # the per-IP token bucket: a burst of 2 tokens at 1/s
    sv = Served(name, rate_per_ip=1.0)
    try:
        port = sv.serve()
        out.append([_post_bytes(port, "add", {"a": i}, id_=i)
                    for i in range(3)])
    finally:
        sv.stop()
    return out


def test_admission_refusals_are_the_jax_bytes(monkeypatch):
    port = _refusals("port", monkeypatch)
    jax = _refusals("jax", monkeypatch)
    assert port == jax
    assert port[0].startswith(b"HTTP/1.1 503 Service Unavailable")
    assert b"-32000" in port[1] and b"server overloaded" in port[1]
    assert [b"-32005" in r for r in port[2]] == [False, False, True]


# ---------------------------------------------------------------- fan-out

@pytest.mark.parametrize("name", ["port", "jax"])
def test_event_fanout_needs_no_thread_a_subscriber(name):
    bus = (TEventBus if name == "port" else JEventBus)()
    core_mod = PKGS[name][2]
    core = core_mod.RPCCore(core_mod.RPCEnv(event_bus=bus))
    sv = Served(name)
    sv.srv.register("subscribe", core.subscribe, ws_only=True)
    clients = []
    try:
        port = sv.serve()
        before = {t.name for t in threading.enumerate()}
        clients = [tclient.WSClient("127.0.0.1", port) for _ in range(6)]
        for c in clients:
            c.subscribe("tm.event = 'Ping'")
        for i in range(5):
            bus.publish("Ping", {"i": i})
        for c in clients:
            got = [c.events.get(timeout=WAIT_S) for _ in range(5)]
            assert [g["data"]["i"] for g in got] == list(range(5))
        new = {t.name for t in threading.enumerate()} - before
        assert not [n for n in new if not n.startswith(
            ("tm-rpc-worker", "ws-client-read"))], new
        if name == "port":
            assert sv.srv.stats["subscribers"] == 6
            assert sv.srv.stats["events_sent"] == 30
    finally:
        for c in clients:
            c.close()
        sv.stop()


def test_sendmany_writes_each_socket_and_reports_what_it_could_not():
    """csrc/hostops.cpp tm_sendmany: every buffer to its socket in one
    call; a full socket takes what fits, a closed peer gives -errno."""
    import ctypes

    from tendermint_tpu_torch import native
    pairs = [socket.socketpair() for _ in range(4)]
    try:
        for a, _ in pairs:
            a.setblocking(False)
        pairs[2][0].setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        pairs[3][1].close()
        bufs = [b"one", b"two" * 100, b"x" * (4 << 20), b"gone"]
        views = [ctypes.create_string_buffer(b, len(b)) for b in bufs]
        n = len(bufs)
        sent = (ctypes.c_int64 * n)()
        native.hostops_lib().tm_sendmany(
            n, (ctypes.c_int * n)(*[a.fileno() for a, _ in pairs]),
            (ctypes.c_void_p * n)(*map(ctypes.addressof, views)),
            (ctypes.c_uint64 * n)(*map(len, bufs)), sent)
        assert sent[0] == 3 and pairs[0][1].recv(16) == b"one"
        assert sent[1] == 300 and pairs[1][1].recv(400) == b"two" * 100
        assert 0 < sent[2] < len(bufs[2])
        assert sent[3] < 0
    finally:
        for a, b in pairs:
            a.close()
            b.close()


def test_event_fanout_writes_a_tick_in_one_native_call(monkeypatch):
    """An event published to 20 subscribers leaves the port's front door
    in one tm_sendmany call (one release of the interpreter lock), not a
    socket call a subscriber; every subscriber reads it."""
    lib = taserver.native.hostops_lib()
    widths = []

    class Counting:
        def tm_sendmany(self, n, *args):
            widths.append(n)
            return lib.tm_sendmany(n, *args)
    monkeypatch.setattr(taserver.native, "hostops_lib", lambda: Counting())
    bus = TEventBus()
    core = tcore.RPCCore(tcore.RPCEnv(event_bus=bus))
    sv = Served("port")
    sv.srv.register("subscribe", core.subscribe, ws_only=True)
    clients = []
    try:
        port = sv.serve()
        clients = [tclient.WSClient("127.0.0.1", port) for _ in range(20)]
        for c in clients:
            c.subscribe("tm.event = 'Ping'")
        held, release = threading.Event(), threading.Event()

        def hold():
            held.set()
            release.wait(WAIT_S)
        sv.loop.call_soon(hold)    # the loop waits while the bus fans out
        assert held.wait(WAIT_S)
        widths.clear()
        bus.publish("Ping", {"i": 7})
        release.set()
        for c in clients:
            assert c.events.get(timeout=WAIT_S)["data"]["i"] == 7
        assert widths == [20]
    finally:
        for c in clients:
            c.close()
        sv.stop()


def _read_frame(ws: "RawWS") -> bytes:
    ws._need(2)
    ln, pos = ws.buf[1] & 0x7F, 2
    if ln == 126:
        ws._need(4)
        ln, pos = struct.unpack(">H", ws.buf[2:4])[0], 4
    elif ln == 127:
        ws._need(10)
        ln, pos = struct.unpack(">Q", ws.buf[2:10])[0], 10
    ws._need(pos + ln)
    frame, ws.buf = ws.buf[pos:pos + ln], ws.buf[pos + ln:]
    return frame


def _event_i(frame: bytes) -> int:
    return json.loads(frame)["result"]["data"]["i"]


def test_event_fanout_waits_for_a_full_socket_and_resumes():
    """A subscriber that stops reading fills its socket: the port's
    front door keeps the rest, waits for the socket (its writer armed)
    and, once the client reads, sends every event in order."""
    bus = TEventBus()
    core = tcore.RPCCore(tcore.RPCEnv(event_bus=bus))
    sv = Served("port")
    sv.srv.register("subscribe", core.subscribe, ws_only=True)
    ws = None
    try:
        ws = RawWS(sv.serve())
        ws.call("subscribe", {"query": "tm.event = 'Big'"})
        (conn,) = [c for c in list(sv.srv._conns) if c.is_ws]
        pad = "x" * 65536
        for i in range(200):     # 13 MB, far past the socket buffers
            bus.publish("Big", {"i": i, "pad": pad})
        deadline = time.monotonic() + WAIT_S
        while not conn._write_armed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert conn._write_armed
        got = [_event_i(_read_frame(ws))
               for _ in range(200)]
        assert got == list(range(200))
        while (conn._write_armed or conn.outbuf) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert not conn._write_armed and not conn.outbuf
    finally:
        if ws is not None:
            ws.close()
        sv.stop()


# -------------------------------------------------------------- TxBatcher

TXS = [b"t%d=%d" % (i, i) for i in range(3)] + [b"t1=1"] + \
    [b"t%d=%d" % (i, i) for i in range(3, 6)]


def _batched(P, core_mod):
    """TXS submitted from one thread each, in order, inside one linger:
    each thread's result and the mempool's txs after."""
    mp, _ = make_mempool(P, app=P.kv(), config=SimpleNamespace(size=4))
    b = core_mod.TxBatcher(mp, wait_s=1.0)
    results = {}
    try:
        ths = []
        for i, tx in enumerate(TXS):
            t = threading.Thread(
                target=lambda i=i, tx=tx: results.__setitem__(
                    i, b.submit(tx)))
            t.start()
            ths.append(t)
            deadline = time.monotonic() + WAIT_S
            while len(b._queue) < i + 1:     # keep the submission order
                assert time.monotonic() < deadline
                time.sleep(0.001)
        for t in ths:
            t.join(WAIT_S)
        out = [(results[i].code, results[i].log) for i in range(len(TXS))]
        return out, [bytes(t) for t in mp.reap(-1)]
    finally:
        b.close()


def test_tx_batcher_results_and_mempool_match_jax():
    port = _batched(MPORT, tcore)
    jax = _batched(MJAX, jcore)
    assert port == jax
    results, txs = port
    assert [c for c, _ in results] == [0, 0, 0, 1, 0, 1, 1]
    assert results[3][1] == "tx already in cache"
    assert results[5][1].startswith("mempool is full")
    assert txs == [b"t0=0", b"t1=1", b"t2=2", b"t3=3"]


def _core_over_batcher(P, core_mod):
    mp, _ = make_mempool(P, app=P.kv(), config=SimpleNamespace(size=2))
    core = core_mod.RPCCore(core_mod.RPCEnv(mempool=mp))
    core.enable_tx_batching()
    out = []
    try:
        for tx in (b"a=1", b"a=1", b"b=2", b"c=3"):
            out.append(_outcome(lambda tx=tx: core.broadcast_tx_sync(tx)))
        out.append(core.broadcast_tx_async(b"d=4"))
        # FIFO: this sync call returns after d=4's batch was checked
        out.append(_outcome(lambda: core.broadcast_tx_sync(b"e=5")))
        out.append([bytes(t) for t in mp.reap(-1)])
    finally:
        core.tx_batcher.close()
    return out


def test_broadcast_routes_over_the_batcher_match_jax():
    port = _core_over_batcher(MPORT, tcore)
    jax = _core_over_batcher(MJAX, jcore)
    assert port == jax
    assert port[1][2:4] == (-32000, "tx already in cache")
    assert port[3][2] == -32000 and "mempool is full" in port[3][3]
