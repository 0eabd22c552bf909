"""Generic JSON-RPC 2.0 server framework: the port's copy of
`tendermint_tpu/rpc/server.py` (rpc/lib), on threads.

Capability parity with the reference's rpc/lib/server: one function map
serves three transports —
  * HTTP POST  JSON-RPC 2.0       (handlers.go:101)
  * HTTP GET   URI params         (handlers.go:238)
  * WebSocket  JSON-RPC + events  (handlers.go:361-520)

Handlers are plain Python callables registered with their parameter names
introspected (the reference reflects on Go func signatures,
handlers.go:41-98). Values arriving as strings are coerced to the
annotated/defaulted type for URI calls. The server recovers from handler
panics and returns structured errors (http_server.go:77).

The WebSocket endpoint implements RFC 6455 server-side framing directly —
enough for JSON-RPC calls plus event subscriptions feeding from the
EventBus.

Raw GET paths as in the JAX server: `metrics_provider` serves GET
/metrics (Prometheus text 0.0.4), `timeline_provider` GET
/debug/timeline (the causal span ring as JSON), and `raw_routes` any
other raw path (/healthz, /slo, /debug/pprof; rpc/core.make_server
installs them)."""

from __future__ import annotations

import base64
import hashlib
import inspect
import json
import socket
import struct
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qsl, urlparse

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# Upper bound on any buffered client input (one WebSocket message across
# fragments, or one HTTP POST body). The server binds non-loopback
# addresses, so unbounded client-declared lengths are a remote
# memory-exhaustion vector; anything legitimate (txs, queries) fits well
# under 1 MB.
MAX_BODY_BYTES = 1 << 20

# Cap on concurrent WebSocket connections: each one holds a handler
# thread plus an event-pump thread, so an unauthenticated client must
# not be able to grow them without bound.
MAX_WS_CONNS = 100

# Global cap on concurrent HTTP connections (each is one handler
# thread in ThreadingHTTPServer): a plain connection flood must not
# starve the host (reference: one http.Serve accept loop with the OS
# backlog as the bound, http_server.go:77). Over-limit connections get
# an immediate 503 WITHOUT spawning a thread.
MAX_HTTP_CONNS = 200


class RPCError(Exception):
    def __init__(self, code: int, message: str, data=None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data


class RPCFunc:
    """One registered handler: callable + introspected params
    (handlers.go RPCFunc)."""

    def __init__(self, fn: Callable, ws_only: bool = False):
        self.fn = fn
        self.ws_only = ws_only
        sig = inspect.signature(fn)
        self.params = [p for p in sig.parameters.values()
                       if p.name not in ("ws",)]
        self.takes_ws = "ws" in sig.parameters

    def call(self, args: Dict[str, Any], ws=None) -> Any:
        kwargs = {}
        for p in self.params:
            if p.name in args:
                kwargs[p.name] = _coerce(args[p.name], p)
            elif p.default is not inspect.Parameter.empty:
                kwargs[p.name] = p.default
            else:
                raise RPCError(-32602, f"missing param {p.name!r}")
        if self.takes_ws:
            kwargs["ws"] = ws
        return self.fn(**kwargs)


_TYPE_NAMES = {"int": int, "bool": bool, "bytes": bytes, "str": str,
               "float": float}


def _coerce(value: Any, param: inspect.Parameter) -> Any:
    """URI params arrive as strings; coerce by annotation/default type."""
    want = param.annotation
    if isinstance(want, str):  # `from __future__ import annotations`
        want = _TYPE_NAMES.get(want, inspect.Parameter.empty)
    if want is inspect.Parameter.empty and \
            param.default is not inspect.Parameter.empty and \
            param.default is not None:
        want = type(param.default)
    if want in (inspect.Parameter.empty, Any) or value is None:
        return value
    try:
        if want is int and not isinstance(value, int):
            return int(value)
        if want is bool and not isinstance(value, bool):
            return str(value).lower() in ("1", "true", "yes")
        if want is bytes:
            if isinstance(value, bytes):
                return value
            s = str(value)
            if s.startswith("0x"):
                s = s[2:]
            return bytes.fromhex(s)
        if want is str and not isinstance(value, str):
            return str(value)
    except (ValueError, TypeError) as e:
        raise RPCError(-32602,
                       f"bad value for {param.name!r}: {e}") from e
    return value


class WSConn:
    """One WebSocket connection: framing + a send lock; passed to ws-aware
    handlers (subscribe/unsubscribe) for pushing events."""

    def __init__(self, sock: socket.socket, remote: str):
        self.sock = sock
        self.remote = remote
        self.subscriber_id = f"ws-{remote}-{id(self)}"
        self._send_lock = threading.Lock()
        self.open = True
        self.on_close: list = []

    def send_json(self, obj: dict) -> None:
        self.send_text(json.dumps(obj))

    def send_text(self, text: str) -> None:
        data = text.encode()
        hdr = bytearray([0x81])  # FIN + text
        n = len(data)
        if n < 126:
            hdr.append(n)
        elif n < (1 << 16):
            hdr.append(126)
            hdr += struct.pack(">H", n)
        else:
            hdr.append(127)
            hdr += struct.pack(">Q", n)
        with self._send_lock:
            if not self.open:
                raise ConnectionError("websocket closed")
            self.sock.sendall(bytes(hdr) + data)

    def recv_message(self) -> Optional[str]:
        """One text message (handles fragmentation + control frames);
        None on close. Connections declaring frames/messages larger than
        MAX_BODY_BYTES are closed before buffering the payload."""
        parts = []
        total = 0
        while True:
            hdr = self._read_exact(2)
            if hdr is None:
                return None
            fin = hdr[0] & 0x80
            opcode = hdr[0] & 0x0F
            masked = hdr[1] & 0x80
            n = hdr[1] & 0x7F
            if n == 126:
                ext = self._read_exact(2)
                if ext is None:
                    return None
                (n,) = struct.unpack(">H", ext)
            elif n == 127:
                ext = self._read_exact(8)
                if ext is None:
                    return None
                (n,) = struct.unpack(">Q", ext)
            if opcode in (0x1, 0x2, 0x0):
                total += n
            if n > MAX_BODY_BYTES or total > MAX_BODY_BYTES:
                self.close()
                return None
            mask = self._read_exact(4) if masked else b"\x00" * 4
            if mask is None:
                return None
            payload = self._read_exact(n) if n else b""
            if payload is None:
                return None
            if masked:
                payload = bytes(b ^ mask[i % 4]
                                for i, b in enumerate(payload))
            if opcode == 0x8:   # close
                self.close()
                return None
            if opcode == 0x9:   # ping -> pong
                with self._send_lock:
                    if self.open:
                        self.sock.sendall(
                            bytes([0x8A, len(payload)]) + payload)
                continue
            if opcode == 0xA:   # pong
                continue
            parts.append(payload)
            if fin:
                return b"".join(parts).decode()

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def close(self) -> None:
        self.open = False
        for cb in self.on_close:
            try:
                cb(self)
            except Exception as e:
                from tendermint_tpu_torch.utils.log import tm_logger
                tm_logger("rpc").error("ws on_close callback failed",
                                        err=repr(e))
        try:
            # shutdown BEFORE close: the handler thread is blocked in
            # recv on this socket, which pins the fd — a bare close()
            # would neither wake it nor send FIN to the peer
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _rpc_response(id_, result=None, error: Optional[RPCError] = None) -> dict:
    if error is not None:
        return {"jsonrpc": "2.0", "id": id_,
                "error": {"code": error.code, "message": error.message,
                          "data": error.data}}
    return {"jsonrpc": "2.0", "id": id_, "result": result}


class _BoundedHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a hard cap on live handler threads."""

    daemon_threads = True

    def __init__(self, addr, handler, max_conns: int = MAX_HTTP_CONNS):
        super().__init__(addr, handler)
        self._conn_sema = threading.BoundedSemaphore(max_conns)

    def process_request(self, request, client_address):
        if not self._conn_sema.acquire(blocking=False):
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Length: 0\r\nConnection: close\r\n\r\n")
            except OSError:
                pass
            self.shutdown_request(request)
            return
        try:
            super().process_request(request, client_address)
        except Exception:
            self._conn_sema.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._conn_sema.release()


class RPCServer:
    """funcmap + HTTP server; `register` mirrors RegisterRPCFuncs
    (handlers.go:27)."""

    def __init__(self, max_http_conns: int = MAX_HTTP_CONNS):
        self.funcs: Dict[str, RPCFunc] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._ws_conns: list = []
        self.max_http_conns = max_http_conns
        # when set, GET /metrics serves this callable's text verbatim as
        # Prometheus exposition (text/plain) instead of JSON-RPC routing
        # — scrapers speak raw HTTP, not JSON-RPC envelopes
        self.metrics_provider: Optional[Callable[[], str]] = None
        # when set, GET /debug/timeline serves this callable's dict as
        # JSON — the causal span ring for merge/curl consumers
        self.timeline_provider: Optional[Callable[[], dict]] = None
        # raw GET paths: path -> (content_type, provider). A str/bytes
        # result is served verbatim with that content type; a dict
        # result is served as JSON (plain-HTTP consumers, no JSON-RPC
        # envelope)
        self.raw_routes: Dict[str, tuple] = {}

    def register(self, name: str, fn: Callable, ws_only: bool = False) -> None:
        self.funcs[name] = RPCFunc(fn, ws_only=ws_only)

    def register_all(self, routes: Dict[str, Callable]) -> None:
        for name, fn in routes.items():
            self.register(name, fn)

    # ------------------------------------------------------------ dispatch

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

    # -------------------------------------------------------------- serving

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> tuple:
        """Start the HTTP/WS server in background threads; returns the
        bound (host, port)."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # a connection that sends nothing must not hold its handler
            # thread (and its semaphore slot) forever
            timeout = 60

            def log_message(self, *a):  # silence
                pass

            def _reply(self, obj: dict, status: int = 200) -> None:
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if not (0 <= n <= MAX_BODY_BYTES):
                        self._reply(_rpc_response(None, error=RPCError(
                            -32600, "request body too large")), 413)
                        self.close_connection = True
                        return
                    req = json.loads(self.rfile.read(n) or b"{}")
                except Exception:
                    self._reply(_rpc_response(
                        None, error=RPCError(-32700, "parse error")), 400)
                    return
                id_ = req.get("id")
                try:
                    result = server.call(req.get("method", ""),
                                         req.get("params") or {})
                    self._reply(_rpc_response(id_, result))
                except RPCError as e:
                    self._reply(_rpc_response(id_, error=e))

            def do_GET(self):
                if self.headers.get("Upgrade", "").lower() == "websocket":
                    self._upgrade_websocket()
                    return
                url = urlparse(self.path)
                if url.path == "/metrics" and \
                        server.metrics_provider is not None:
                    try:
                        body = server.metrics_provider().encode()
                    except Exception as e:
                        self._reply(_rpc_response(None, error=RPCError(
                            -32603, f"metrics provider failed: {e}")), 500)
                        return
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if url.path == "/debug/timeline" and \
                        server.timeline_provider is not None:
                    try:
                        self._reply(server.timeline_provider())
                    except Exception as e:
                        self._reply(_rpc_response(None, error=RPCError(
                            -32603, f"timeline provider failed: {e}")),
                            500)
                    return
                if url.path in server.raw_routes:
                    ctype, provider = server.raw_routes[url.path]
                    try:
                        result = provider()
                    except Exception as e:
                        self._reply(_rpc_response(None, error=RPCError(
                            -32603, f"{url.path} provider failed: "
                                    f"{e}")), 500)
                        return
                    if isinstance(result, dict):
                        self._reply(result)
                        return
                    body = result.encode() if isinstance(result, str) \
                        else bytes(result)
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                method = url.path.strip("/")
                if method == "":
                    # route listing, like the reference's index page
                    self._reply({"routes": sorted(server.funcs)})
                    return
                params = dict(parse_qsl(url.query))
                try:
                    result = server.call(method, params)
                    self._reply(_rpc_response(-1, result))
                except RPCError as e:
                    self._reply(_rpc_response(-1, error=e))

            def _upgrade_websocket(self):
                if len(server._ws_conns) >= MAX_WS_CONNS:
                    self._reply(_rpc_response(None, error=RPCError(
                        -32000, "too many websocket connections")), 503)
                    self.close_connection = True
                    return
                key = self.headers.get("Sec-WebSocket-Key", "")
                accept = base64.b64encode(hashlib.sha1(
                    (key + _WS_MAGIC).encode()).digest()).decode()
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept)
                self.end_headers()
                # undo the handler's slow-client read timeout: a healthy
                # subscriber may legitimately send nothing for hours
                self.request.settimeout(None)
                ws = WSConn(self.request, self.client_address[0])
                server._ws_conns.append(ws)
                try:
                    server._ws_loop(ws)
                finally:
                    ws.close()
                    if ws in server._ws_conns:
                        server._ws_conns.remove(ws)
                    self.close_connection = True

        self._httpd = _BoundedHTTPServer((host, port), Handler,
                                         max_conns=self.max_http_conns)
        t = threading.Thread(target=self._httpd.serve_forever,
                             daemon=True, name="rpc-http")
        t.start()
        return self._httpd.server_address

    def _ws_loop(self, ws: WSConn) -> None:
        """Per-connection JSON-RPC loop (ws_handler.go semantics)."""
        while ws.open:
            text = ws.recv_message()
            if text is None:
                return
            try:
                req = json.loads(text)
            except ValueError:
                ws.send_json(_rpc_response(
                    None, error=RPCError(-32700, "parse error")))
                continue
            id_ = req.get("id")
            try:
                result = self.call(req.get("method", ""),
                                   req.get("params") or {}, ws=ws)
                ws.send_json(_rpc_response(id_, result))
            except RPCError as e:
                ws.send_json(_rpc_response(id_, error=e))
            except ConnectionError:
                return

    def stop(self) -> None:
        for ws in list(self._ws_conns):
            ws.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
