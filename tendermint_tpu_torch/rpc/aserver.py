"""Async JSON-RPC/WebSocket server — the RPC front door on the node's
ReactorLoop: the port's copy of `tendermint_tpu/rpc/aserver.py`.

The threaded server (rpc/server.py) spends one handler thread an HTTP
connection and two threads a WebSocket subscriber (handler + event
pump), capped at 100 WebSocket connections. This server runs every
connection on the SAME event loop that owns the p2p sockets:

- non-blocking HTTP/1.1 (keep-alive) + RFC 6455 WebSocket framing,
  parsed incrementally from per-connection buffers;
- handlers run on a small FIXED worker pool (never on the loop:
  broadcast_tx_commit legitimately blocks for a commit), and replies
  marshal back through ``call_soon``;
- WebSocket event fan-out is loop-native: a subscription's bounded
  buffer (types/events.py, drop-oldest) is drained into the conn's
  bounded write buffer by a loop callback armed from ``Subscription.
  on_put``; no thread a subscriber, and backpressure ends in the
  counted drop-oldest eviction, never in unbounded memory;
- the writes of one loop tick leave together: a connection with bytes
  to send joins the tick's set, and one call of the native
  ``tm_sendmany`` (csrc/hostops.cpp) writes them all, the interpreter
  lock released once. A socket call per write gave the lock up at each
  one; with threads that compute beside the loop (a shard set's
  chains) the loop waited for it each time, and one event to 300
  subscribers took 300 such waits. The JAX server writes each at once,
  and so does this one under TM_CUDA_NO_NATIVE; the bytes on the wire
  are the same;
- admission control: a connection cap (an immediate 503 over it), an
  in-flight call cap (a structured overload error, -32000) and a
  per-client-IP token bucket (-32005). `max_conns` and `rate_per_ip`
  are constructor arguments; at 0 the TM_CUDA_RPC_MAX_CONNS and
  TM_CUDA_RPC_RATE knobs decide (0: DEFAULT_MAX_CONNS, and no rate
  limit), as the JAX server reads its TM_TPU_* pair.

The route table, parameter coercion and error envelope are the threaded
server's (RPCFunc/_coerce/_rpc_response), so both transports serve
byte-identical JSON-RPC. The JAX server's `rpc_*` families are fed at
the same points as `stats` (connections, requests, refusals and events),
the loop fan-out stamps the SLO plane's `deliver` stage, and GET
/metrics and /debug/timeline are served from `metrics_provider` and
`timeline_provider` beside `raw_routes`. `rpc_call_seconds`'s `chain`
label is resolved by the server: a shard front door installs its
mapping-backed `chain_resolver` (shard/router.py); without one the
label is "".
"""

from __future__ import annotations

import base64
import ctypes
import hashlib
import json
import socket
import struct
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qsl, urlparse

from tendermint_tpu_torch import native, telemetry
from tendermint_tpu_torch.rpc.server import (
    MAX_BODY_BYTES,
    _WS_MAGIC,
    RPCError,
    RPCFunc,
    _rpc_response,
)
from tendermint_tpu_torch.telemetry import slo as _slo
from tendermint_tpu_torch.utils import knobs

# tmlint: loop-module (async-blocking checker applies to this file)
TMLINT_LOOP_MODULE = True

_m_conns = telemetry.gauge(
    "rpc_conns", "Open RPC connections on the async front door, by kind",
    ("kind",))
_m_requests = telemetry.counter(
    "rpc_requests_total", "JSON-RPC calls admitted, by transport",
    ("transport",))
_m_rate_limited = telemetry.counter(
    "rpc_rate_limited_total",
    "Calls refused by the per-client-IP token bucket")
_m_rejected = telemetry.counter(
    "rpc_rejected_total",
    "Connections/calls refused by admission control, by reason",
    ("reason",))
_m_subscribers = telemetry.gauge(
    "rpc_ws_subscribers", "Live WebSocket event subscriptions")
_m_events_sent = telemetry.counter(
    "rpc_events_sent_total", "Events pushed to WebSocket subscribers")
# labelled by route so the SLO plane's tail attribution can separate
# broadcast_tx_* admission cost from query traffic; unregistered
# method names collapse into one "unknown" label (clients control the
# method string — it must not mint unbounded label values)
_m_call_seconds = telemetry.histogram(
    "rpc_call_seconds",
    "Handler wall time per JSON-RPC call, by route and (sharded "
    "front doors) chain",
    ("route", "chain"), buckets=(1e-4, 1e-3, 5e-3, 2.5e-2, 1e-1, 1.0,
                                 10.0))

DEFAULT_MAX_CONNS = 4096
WORKERS = 6
MAX_INFLIGHT = 512          # queued+running handler calls (overload cap)
OUT_HIGH_WATER = 512 * 1024  # stop draining events into a conn past this
OUT_HARD_LIMIT = 4 << 20     # a reader this slow gets disconnected
_RECV_CHUNK = 65536


class _Bucket:
    """Token bucket: `rate` tokens/s, burst 2x. Loop-thread only."""

    __slots__ = ("tokens", "last")

    def __init__(self, burst: float):
        self.tokens = burst
        self.last = time.monotonic()

    def take(self, rate: float) -> bool:
        now = time.monotonic()
        self.tokens = min(2.0 * rate,
                          self.tokens + (now - self.last) * rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AsyncRPCServer:
    """funcmap-compatible replacement for rpc.server.RPCServer that
    serves every connection on a ReactorLoop."""

    STATS = ("conns_http", "conns_ws", "requests_http", "requests_uri",
             "requests_ws", "rejected_conn_cap", "rejected_overload",
             "rate_limited", "subscribers", "events_sent")

    def __init__(self, loop, max_conns: int = 0,
                 rate_per_ip: float = 0.0, workers: int = WORKERS):
        self.loop = loop
        self.funcs: Dict[str, RPCFunc] = {}
        self.metrics_provider: Optional[Callable[[], str]] = None
        self.timeline_provider: Optional[Callable[[], dict]] = None
        self.raw_routes: Dict[str, tuple] = {}
        self.max_conns = int(max_conns) or knobs.knob_int(
            "TM_CUDA_RPC_MAX_CONNS", default=0) or DEFAULT_MAX_CONNS
        self.rate_per_ip = float(rate_per_ip) or knobs.knob_float(
            "TM_CUDA_RPC_RATE", default=0.0)
        # written on the loop thread (subscribers: also by a handler's
        # close callbacks, which run there too); readers take a copy
        self.stats = dict.fromkeys(self.STATS, 0)
        self._buckets: Dict[str, _Bucket] = {}   # loop-thread only
        self._conns: set = set()                 # loop-thread only
        self._listener: Optional[socket.socket] = None
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="tm-rpc-worker")
        self._inflight = 0                       # loop-thread only
        self._stopped = False
        self._tx_batcher = None   # set by make_server; closed on stop
        # bounded chain-label provider for rpc_call_seconds: a shard
        # front door (shard/router.py) installs its mapping-backed
        # resolver here; None (single-chain) labels chain=""
        self.chain_resolver: Optional[Callable] = None
        # event-render cache: one EventBus.publish fans the SAME
        # (tags, data) objects out to every matching subscriber — at
        # thousands of subscribers, re-encoding the payload per
        # subscriber would saturate the loop. Keyed by object identity
        # + query; entries hold strong refs so ids stay valid.
        self._enc_cache: Dict[tuple, tuple] = {}  # loop-thread only
        # connections with bytes to write this tick (an ordered set) and
        # whether _flush is scheduled; loop-thread only
        self._dirty: Dict["_Conn", None] = {}
        self._flush_armed = False

    def render_event(self, item, render: Callable[[Any], dict]) -> bytes:
        key = (id(item.tags), id(item.data), item.query)
        hit = self._enc_cache.get(key)
        if hit is not None and hit[0] is item.tags and \
                hit[1] is item.data:
            return hit[2]
        data = json.dumps(render(item)).encode()
        if len(self._enc_cache) >= 128:
            self._enc_cache.pop(next(iter(self._enc_cache)))
        self._enc_cache[key] = (item.tags, item.data, data)
        return data

    # --------------------------------------------------------- routes

    def register(self, name: str, fn: Callable,
                 ws_only: bool = False) -> None:
        self.funcs[name] = RPCFunc(fn, ws_only=ws_only)

    def register_all(self, routes: Dict[str, Callable]) -> None:
        for name, fn in routes.items():
            self.register(name, fn)

    def call(self, method: str, params: Dict[str, Any], ws=None) -> Any:
        func = self.funcs.get(method)
        if func is None:
            raise RPCError(-32601, f"method {method!r} not found")
        if func.ws_only and ws is None:
            raise RPCError(-32601,
                           f"method {method!r} is websocket-only")
        try:
            return func.call(params or {}, ws=ws)
        except RPCError:
            raise
        except Exception as e:
            raise RPCError(-32603, f"{type(e).__name__}: {e}",
                           data=traceback.format_exc(limit=8))

    # -------------------------------------------------------- serving

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> tuple:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(1024)
        ls.setblocking(False)
        self._listener = ls
        addr = ls.getsockname()
        if not self.loop.running:
            self.loop.start()
        # start every worker NOW, each held at a barrier until all are
        # up: the fixed thread set exists from serve() on (a worker
        # spawned mid-request would read as a thread leak to harnesses
        # that snapshot live threads)
        n = self._pool._max_workers
        barrier = threading.Barrier(n + 1)
        for _ in range(n):
            self._pool.submit(barrier.wait, 10.0)
        barrier.wait(10.0)  # tmlint: allow(async-blocking): serve() runs on the caller's thread before the listener joins the loop; the workers, not the loop, release it
        self.loop.add_reader(ls, self._on_accept, owner="rpc")
        return addr

    def stop(self) -> None:
        self._stopped = True
        ls = self._listener
        if ls is not None:
            self.loop.remove_fd(ls)
            try:
                ls.close()
            except OSError:
                pass
        done = threading.Event()

        def teardown():
            for conn in list(self._conns):
                conn.close()
            done.set()

        if self.loop.running and not self.loop.in_loop():
            self.loop.call_soon(teardown, owner="rpc")
            done.wait(2.0)  # tmlint: allow(async-blocking): only reachable from non-loop threads (in_loop() guarded one line up)
        else:
            teardown()
        if self._tx_batcher is not None:
            self._tx_batcher.close()
        self._pool.shutdown(wait=False)

    def _on_accept(self) -> None:
        for _ in range(64):
            try:
                sock, addr = self._listener.accept()  # tmlint: allow(async-blocking): O_NONBLOCK listener — raises BlockingIOError when drained
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self._stopped or len(self._conns) >= self.max_conns:
                self.stats["rejected_conn_cap"] += 1
                _m_rejected.labels("conn_cap").inc()
                try:
                    sock.setblocking(False)
                    sock.send(
                        b"HTTP/1.1 503 Service Unavailable\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(self, sock, addr[0])
            self._conns.add(conn)
            self.stats["conns_http"] += 1
            _m_conns.labels("http").inc()
            self.loop.add_reader(sock, conn.on_readable, owner="rpc")

    # ------------------------------------------------------ admission

    def _admit(self, ip: str) -> Optional[RPCError]:
        """Loop-thread: per-IP rate limit + in-flight overload cap."""
        if self.rate_per_ip > 0:
            b = self._buckets.get(ip)
            if b is None:
                if len(self._buckets) > 65536:
                    self._buckets.clear()  # bound state under IP churn
                b = self._buckets[ip] = _Bucket(2.0 * self.rate_per_ip)
            if not b.take(self.rate_per_ip):
                self.stats["rate_limited"] += 1
                _m_rate_limited.inc()
                return RPCError(-32005,
                                "rate limit exceeded for this client")
        if self._inflight >= MAX_INFLIGHT:
            self.stats["rejected_overload"] += 1
            _m_rejected.labels("overload").inc()
            return RPCError(-32000, "server overloaded; retry")
        return None

    def _dispatch(self, conn: "_Conn", transport: str, method: str,
                  params: dict, id_, ws=None,
                  reply: Optional[Callable[[dict], None]] = None) -> None:
        """Loop-thread: admission, then run the handler on the worker
        pool; the reply callback runs back on the loop."""
        err = self._admit(conn.ip)
        send = reply or conn.send_json_response
        if err is not None:
            send(_rpc_response(id_, error=err))
            return
        self.stats["requests_" + transport] += 1
        _m_requests.labels(transport).inc()
        self._inflight += 1
        tele = telemetry.enabled()
        route = method if isinstance(method, str) and \
            method in self.funcs else "unknown"
        chain = ""
        if tele and self.chain_resolver is not None:
            try:
                chain = self.chain_resolver(method, params) or ""
            except Exception:
                chain = ""   # label resolution must never fail a call

        def work():
            t0 = time.perf_counter() if tele else 0.0
            try:
                result = self.call(method, params, ws=ws)
                resp = _rpc_response(id_, result)
            except RPCError as e:
                resp = _rpc_response(id_, error=e)
            if tele:
                _m_call_seconds.labels(route, chain).observe(
                    time.perf_counter() - t0)
            self.loop.call_soon(lambda: self._complete(send, resp),
                                owner="rpc")

        try:
            self._pool.submit(work)
        except RuntimeError:   # pool shut down under us
            self._inflight -= 1

    def _want_flush(self, conn: "_Conn") -> None:
        """Loop-thread: `conn` has bytes to write; they leave with the
        rest of the tick's in _flush."""
        self._dirty[conn] = None
        if not self._flush_armed:
            self._flush_armed = True
            self.loop.call_soon(self._flush, owner="rpc")

    def _flush(self) -> None:
        """Loop-thread: write every dirty connection's buffer in one
        native call, then let each wait for its socket or drain."""
        self._flush_armed = False
        conns = [c for c in self._dirty if not c.closed]
        self._dirty.clear()
        full = [c for c in conns if c.outbuf]
        if full and native.disabled():
            for c in full:
                c._send_pure()
        elif full:
            n = len(full)
            views = [(ctypes.c_char * len(c.outbuf)).from_buffer(c.outbuf)
                     for c in full]
            fds = (ctypes.c_int * n)(*[c.sock.fileno() for c in full])
            bufs = (ctypes.c_void_p * n)(*map(ctypes.addressof, views))
            lens = (ctypes.c_uint64 * n)(*map(len, views))
            sent = (ctypes.c_int64 * n)()
            native.hostops_lib().tm_sendmany(n, fds, bufs, lens, sent)
            del views   # release the buffers before they are cut
            for c, k in zip(full, sent):
                if k < 0:
                    c.close()
                else:
                    del c.outbuf[:k]
        for c in conns:
            if not c.closed:
                c._after_write()

    def _complete(self, send: Callable[[dict], None], resp: dict) -> None:
        self._inflight -= 1
        send(resp)

    def _conn_closed(self, conn: "_Conn") -> None:
        if conn in self._conns:
            self._conns.discard(conn)
            self.stats["conns_ws" if conn.is_ws else "conns_http"] -= 1
            _m_conns.labels("ws" if conn.is_ws else "http").dec()


class _AsyncWS:
    """The `ws` facade handed to ws-aware handlers (subscribe /
    unsubscribe): same surface as rpc.server.WSConn — subscriber_id,
    send_json, on_close, open — plus attach_subscription, which
    RPCCore.subscribe uses to go loop-native instead of spawning a
    pump thread."""

    def __init__(self, conn: "_Conn"):
        self._conn = conn
        self.subscriber_id = f"ws-{conn.ip}-{id(conn)}"
        self.open = True
        self.on_close: list = []
        self._subs: list = []

    def send_json(self, obj: dict) -> None:
        """Thread-safe: marshals onto the loop."""
        conn = self._conn
        if not self.open:
            raise ConnectionError("websocket closed")
        data = json.dumps(obj).encode()
        if conn.server.loop.in_loop():
            conn.send_ws_text(data)
        else:
            conn.server.loop.call_soon(
                lambda: conn.send_ws_text(data), owner="rpc")

    def attach_subscription(self, sub, render: Callable[[Any], dict]) \
            -> None:
        """Loop-native fan-out: sub.on_put schedules a drain on the
        loop; the drain moves events from the subscription's bounded
        buffer into the conn's bounded write buffer. A slow reader
        stalls the drain at OUT_HIGH_WATER and backlogs into the
        subscription's drop-oldest eviction — bounded memory
        end-to-end."""
        conn = self._conn
        loop = conn.server.loop
        self._subs.append(sub)
        conn.server.stats["subscribers"] += 1
        _m_subscribers.inc()
        pending = [False]

        def drain():
            pending[0] = False
            if not self.open or sub.cancelled:
                return
            while len(conn.outbuf) < OUT_HIGH_WATER:
                item = sub.get_nowait()
                if item is None:
                    return
                frame = conn.server.render_event(item, render)
                # counted before the write: a client that has read the
                # event always finds it counted
                conn.server.stats["events_sent"] += 1
                _m_events_sent.inc()
                conn.send_ws_text(frame)
                _slo.deliver_item(item)
            # outbuf high: resume when the socket drains
            conn.on_drain = schedule

        def schedule():
            if pending[0] or not self.open:
                return
            pending[0] = True
            loop.call_soon(drain, owner="rpc")

        sub.on_put = schedule
        schedule()

    def close(self) -> None:
        if not self.open:
            return
        self.open = False
        self._conn.server.stats["subscribers"] -= len(self._subs)
        _m_subscribers.dec(len(self._subs))
        for cb in self.on_close:
            try:
                cb(self)
            except Exception as e:
                from tendermint_tpu_torch.utils.log import tm_logger
                tm_logger("rpc").error("ws on_close callback failed",
                                        err=repr(e))
        self._subs = []


class _Conn:
    """One client connection on the loop: HTTP state machine that may
    upgrade to WebSocket. All methods run on the loop thread except
    where noted."""

    def __init__(self, server: AsyncRPCServer, sock: socket.socket,
                 ip: str):
        self.server = server
        self.sock = sock
        self.ip = ip
        self.rbuf = bytearray()
        self.outbuf = bytearray()
        self.is_ws = False
        self.ws: Optional[_AsyncWS] = None
        self._ws_parts: list = []
        self._ws_total = 0
        self.closed = False
        self.keep_alive = True
        self.in_flight = False     # one HTTP request at a time per conn
        self.on_drain: Optional[Callable[[], None]] = None
        self._write_armed = False

    # ------------------------------------------------------------ I/O

    def on_readable(self) -> None:
        if self.closed:
            return
        try:
            data = self.sock.recv(_RECV_CHUNK)  # tmlint: allow(async-blocking): O_NONBLOCK socket — raises BlockingIOError instead of parking
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self.close()
            return
        if not data:
            self.close()
            return
        self.rbuf += data
        if len(self.rbuf) > MAX_BODY_BYTES + 65536:
            self.close()   # header/body flood
            return
        if self.is_ws:
            self._parse_ws()
        else:
            self._parse_http()

    def _send_bytes(self, data: bytes) -> None:
        if self.closed:
            return
        self.outbuf += data
        if len(self.outbuf) > OUT_HARD_LIMIT:
            self.close()   # reader irreparably slow
            return
        self.server._want_flush(self)

    def _after_write(self) -> None:
        """After a write: wait for the socket when bytes are left, else
        run the drain callback (and close a finished non-keep-alive
        HTTP connection)."""
        if self.outbuf:
            if not self._write_armed:
                self._write_armed = True
                self.server.loop.add_reader(
                    self.sock, self.on_readable, owner="rpc",
                    writer=self._on_writable)
        else:
            if self._write_armed:
                self._write_armed = False
                self.server.loop.add_reader(
                    self.sock, self.on_readable, owner="rpc",
                    writer=None)
            cb, self.on_drain = self.on_drain, None
            if cb is not None:
                cb()
            if not self.keep_alive and not self.in_flight and \
                    not self.is_ws:
                self.close()

    def _send_pure(self) -> None:
        """The flush's write of this connection in Python, one socket
        call at a time (TM_CUDA_NO_NATIVE): the JAX front door's
        `_write_some`, up to the socket's wait."""
        while self.outbuf:
            try:
                k = self.sock.send(self.outbuf)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self.close()
                return
            if k <= 0:
                return
            del self.outbuf[:k]

    def _on_writable(self) -> None:
        self.server._want_flush(self)

    def close(self) -> None:
        if self.closed:
            return
        if self.outbuf:
            try:   # what this tick queued (an error reply), best effort
                self.sock.send(self.outbuf)
            except OSError:
                pass
        self.closed = True
        if self.ws is not None:
            self.ws.close()
        self.server.loop.remove_fd(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._conn_closed(self)

    # ----------------------------------------------------------- HTTP

    def _parse_http(self) -> None:
        while not self.closed and not self.is_ws and not self.in_flight:
            head_end = self.rbuf.find(b"\r\n\r\n")
            if head_end < 0:
                return
            head = bytes(self.rbuf[:head_end]).decode(
                "latin-1", "replace")
            lines = head.split("\r\n")
            try:
                method, target, version = lines[0].split(" ", 2)
            except ValueError:
                self._plain_response(400, b"")
                self.close()
                return
            headers = {}
            for line in lines[1:]:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            try:
                clen = int(headers.get("content-length", "0") or "0")
            except ValueError:
                clen = -1
            if not 0 <= clen <= MAX_BODY_BYTES:
                self.send_json_response(_rpc_response(
                    None, error=RPCError(-32600,
                                         "request body too large")),
                    status=413)
                self.keep_alive = False
                return
            if len(self.rbuf) < head_end + 4 + clen:
                return   # body incomplete
            body = bytes(self.rbuf[head_end + 4:head_end + 4 + clen])
            del self.rbuf[:head_end + 4 + clen]
            self.keep_alive = (
                headers.get("connection", "").lower() != "close"
                and version != "HTTP/1.0")
            if headers.get("upgrade", "").lower() == "websocket":
                self._upgrade_ws(headers)
                return
            if method == "POST":
                self._http_post(body)
            elif method == "GET":
                self._http_get(target)
            else:
                self._plain_response(405, b"")

    def _http_post(self, body: bytes) -> None:
        try:
            req = json.loads(body or b"{}")
        except ValueError:
            self.send_json_response(_rpc_response(
                None, error=RPCError(-32700, "parse error")), status=400)
            return
        self.in_flight = True
        self.server._dispatch(self, "http", req.get("method", ""),
                              req.get("params") or {}, req.get("id"))

    def _http_get(self, target: str) -> None:
        url = urlparse(target)
        srv = self.server
        provider = None
        ctype = "application/json"
        if url.path == "/metrics" and srv.metrics_provider is not None:
            provider = srv.metrics_provider
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif url.path == "/debug/timeline" and \
                srv.timeline_provider is not None:
            provider = srv.timeline_provider
        elif url.path in srv.raw_routes:
            ctype, provider = srv.raw_routes[url.path]
        if provider is not None:
            self.in_flight = True
            self._dispatch_raw(provider, ctype)
            return
        method = url.path.strip("/")
        if method == "":
            self.send_json_response({"routes": sorted(srv.funcs)})
            return
        params = dict(parse_qsl(url.query))
        self.in_flight = True
        srv._dispatch(self, "uri", method, params, -1)

    def _dispatch_raw(self, provider, ctype: str) -> None:
        """Raw GET routes (healthz, pprof, metrics) run on the worker
        pool too — exposition can be ms-scale on a big registry."""
        srv = self.server
        err = srv._admit(self.ip)
        if err is not None:
            self.send_json_response(_rpc_response(None, error=err),
                                    status=429)
            return
        srv._inflight += 1

        def work():
            try:
                result = provider()
            except Exception as e:
                resp = (_rpc_response(None, error=RPCError(
                    -32603, f"provider failed: {e}")), 500, None)
            else:
                if isinstance(result, dict):
                    resp = (result, 200, None)
                else:
                    body = result.encode() if isinstance(result, str) \
                        else bytes(result)
                    resp = (None, 200, (ctype, body))
            srv.loop.call_soon(lambda: self._raw_done(resp), owner="rpc")

        try:
            srv._pool.submit(work)
        except RuntimeError:
            srv._inflight -= 1

    def _raw_done(self, resp) -> None:
        self.server._inflight -= 1
        obj, status, raw = resp
        if raw is not None:
            ctype, body = raw
            self._plain_response(status, body, ctype)
            self.in_flight = False
            self._parse_http()
        else:
            self.send_json_response(obj, status=status)

    def send_json_response(self, obj: dict, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self._plain_response(status, body, "application/json")
        self.in_flight = False
        if not self.is_ws:
            self._parse_http()   # next pipelined request, if buffered

    def _plain_response(self, status: int, body: bytes,
                        ctype: str = "application/json") -> None:
        reason = {200: "OK", 400: "Bad Request", 405: "Bad Method",
                  413: "Payload Too Large", 429: "Too Many Requests",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        conn = "keep-alive" if self.keep_alive else "close"
        head = (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: {conn}\r\n\r\n").encode()
        self._send_bytes(head + body)

    # ------------------------------------------------------ WebSocket

    def _upgrade_ws(self, headers: dict) -> None:
        key = headers.get("sec-websocket-key", "")
        accept = base64.b64encode(hashlib.sha1(
            (key + _WS_MAGIC).encode()).digest()).decode()
        self._send_bytes(
            ("HTTP/1.1 101 Switching Protocols\r\n"
             "Upgrade: websocket\r\nConnection: Upgrade\r\n"
             f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
        self.is_ws = True
        self.server.stats["conns_http"] -= 1
        self.server.stats["conns_ws"] += 1
        _m_conns.labels("http").dec()
        _m_conns.labels("ws").inc()
        self.ws = _AsyncWS(self)
        if self.rbuf:
            self._parse_ws()

    def send_ws_text(self, data: bytes) -> None:
        hdr = bytearray([0x81])
        n = len(data)
        if n < 126:
            hdr.append(n)
        elif n < (1 << 16):
            hdr.append(126)
            hdr += struct.pack(">H", n)
        else:
            hdr.append(127)
            hdr += struct.pack(">Q", n)
        self._send_bytes(bytes(hdr) + data)

    def _parse_ws(self) -> None:
        while not self.closed:
            frame = self._next_ws_frame()
            if frame is None:
                return
            opcode, payload, fin = frame
            if opcode == 0x8:     # close
                self.close()
                return
            if opcode == 0x9:     # ping -> pong
                self._send_bytes(
                    bytes([0x8A, len(payload)]) + payload)
                continue
            if opcode == 0xA:     # pong
                continue
            self._ws_parts.append(payload)
            self._ws_total += len(payload)
            if self._ws_total > MAX_BODY_BYTES:
                self.close()
                return
            if fin:
                text = b"".join(self._ws_parts)
                self._ws_parts = []
                self._ws_total = 0
                self._ws_message(text)

    def _next_ws_frame(self):
        buf = self.rbuf
        if len(buf) < 2:
            return None
        fin = buf[0] & 0x80
        opcode = buf[0] & 0x0F
        masked = buf[1] & 0x80
        n = buf[1] & 0x7F
        pos = 2
        if n == 126:
            if len(buf) < 4:
                return None
            (n,) = struct.unpack(">H", bytes(buf[2:4]))
            pos = 4
        elif n == 127:
            if len(buf) < 10:
                return None
            (n,) = struct.unpack(">Q", bytes(buf[2:10]))
            pos = 10
        if n > MAX_BODY_BYTES:
            self.close()
            return None
        mask = b"\x00" * 4
        if masked:
            if len(buf) < pos + 4:
                return None
            mask = bytes(buf[pos:pos + 4])
            pos += 4
        if len(buf) < pos + n:
            return None
        payload = bytes(buf[pos:pos + n])
        del buf[:pos + n]
        if masked and any(mask):
            payload = bytes(b ^ mask[i % 4]
                            for i, b in enumerate(payload))
        return opcode, payload, fin

    def _ws_message(self, data: bytes) -> None:
        try:
            req = json.loads(data)
        except ValueError:
            self.send_ws_text(json.dumps(_rpc_response(
                None, error=RPCError(-32700, "parse error"))).encode())
            return
        id_ = req.get("id")
        ws = self.ws

        def reply(resp: dict) -> None:
            if not self.closed:
                self.send_ws_text(json.dumps(resp).encode())

        self.server._dispatch(self, "ws", req.get("method", ""),
                              req.get("params") or {}, id_, ws=ws,
                              reply=reply)
