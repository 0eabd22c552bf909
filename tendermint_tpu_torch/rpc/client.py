"""RPC clients: the port's copy of `tendermint_tpu/rpc/client.py`
(rpc/lib/client + rpc/client).

JSONRPCClient  — HTTP POST JSON-RPC 2.0   (http_client.go:66)
URIClient      — HTTP GET with URI params (http_client.go:109)
WSClient       — websocket JSON-RPC + event stream (ws_client.go:30)
LocalClient    — in-process dispatch against an RPCServer funcmap
                 (rpc/client/localclient.go)
"""

from __future__ import annotations

import base64
import json
import os
import queue
import socket
import struct
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional
from urllib.parse import urlencode
from urllib.request import Request, urlopen


class RPCClientError(Exception):
    def __init__(self, code, message, data=None):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.data = data


def _unwrap(resp: dict) -> Any:
    if resp.get("error"):
        e = resp["error"]
        raise RPCClientError(e.get("code"), e.get("message"),
                             e.get("data"))
    return resp.get("result")


def _encode_params(params: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.hex() if isinstance(v, (bytes, bytearray)) else v)
            for k, v in params.items()}


class JSONRPCClient:
    def __init__(self, address: str, timeout: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, **params) -> Any:
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                           "method": method,
                           "params": _encode_params(params)}).encode()
        req = Request(self.address, data=body,
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=self.timeout) as resp:
            return _unwrap(json.loads(resp.read()))


class URIClient:
    def __init__(self, address: str, timeout: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout = timeout

    def call(self, method: str, **params) -> Any:
        url = f"{self.address}/{method}"
        if params:
            url += "?" + urlencode(_encode_params(params))
        with urlopen(url, timeout=self.timeout) as resp:
            return _unwrap(json.loads(resp.read()))


class WSClient:
    """Minimal RFC 6455 client for JSON-RPC + event subscriptions."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            f"GET /websocket HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        # consume the 101 response headers
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(1024)
            if not chunk:
                raise ConnectionError("ws handshake failed")
            buf += chunk
        if b" 101 " not in buf.split(b"\r\n", 1)[0]:
            raise ConnectionError(f"ws upgrade refused: {buf[:120]!r}")
        self._id = 0
        self.events: "queue.Queue[dict]" = queue.Queue()
        self._replies: Dict[Any, "queue.Queue[dict]"] = {}
        self._lock = threading.Lock()
        self.open = True
        threading.Thread(target=self._read_loop, daemon=True,
                         name="ws-client-read").start()

    # ---------------------------------------------------------------- frames

    def _send_text(self, text: str) -> None:
        data = text.encode()
        mask = os.urandom(4)
        hdr = bytearray([0x81])
        n = len(data)
        if n < 126:
            hdr.append(0x80 | n)
        elif n < (1 << 16):
            hdr.append(0x80 | 126)
            hdr += struct.pack(">H", n)
        else:
            hdr.append(0x80 | 127)
            hdr += struct.pack(">Q", n)
        hdr += mask
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        with self._lock:
            self.sock.sendall(bytes(hdr) + masked)

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

    def _read_message(self) -> Optional[str]:
        parts = []
        while True:
            hdr = self._read_exact(2)
            if hdr is None:
                return None
            fin, opcode = hdr[0] & 0x80, hdr[0] & 0x0F
            n = hdr[1] & 0x7F
            if n == 126:
                ext = self._read_exact(2)
                if ext is None:
                    return None  # truncated frame = connection gone
                (n,) = struct.unpack(">H", ext)
            elif n == 127:
                ext = self._read_exact(8)
                if ext is None:
                    return None
                (n,) = struct.unpack(">Q", ext)
            payload = self._read_exact(n) if n else b""
            if payload is None:
                return None
            if opcode == 0x8:
                return None
            if opcode in (0x9, 0xA):
                continue
            parts.append(payload)
            if fin:
                return b"".join(parts).decode()

    def _read_loop(self) -> None:
        while self.open:
            text = self._read_message()
            if text is None:
                self.open = False
                return
            try:
                msg = json.loads(text)
            except ValueError:
                continue
            if msg.get("id") == "#event":
                self.events.put(msg.get("result"))
            else:
                q = self._replies.pop(msg.get("id"), None)
                if q is not None:
                    q.put(msg)

    # ------------------------------------------------------------------ api

    def cast(self, method: str, **params) -> None:
        """Fire-and-forget call over the persistent connection: the
        server's reply is read and dropped by the reader thread. This
        is the tm-bench load-generation shape — thousands of
        broadcast_tx casts per second over one socket, no per-call
        round-trip wait (benchmarks/simu/counter.go's WS spammer)."""
        self._id += 1
        self._send_text(json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method,
             "params": _encode_params(params)}))

    def call(self, method: str, timeout: float = 30.0, **params) -> Any:
        self._id += 1
        id_ = self._id
        q: "queue.Queue[dict]" = queue.Queue()
        self._replies[id_] = q
        try:
            self._send_text(json.dumps(
                {"jsonrpc": "2.0", "id": id_, "method": method,
                 "params": _encode_params(params)}))
            try:
                reply = q.get(timeout=timeout)
            except queue.Empty:
                raise RPCClientError(
                    -32000, f"no reply to {method!r} within {timeout}s")
            return _unwrap(reply)
        finally:
            self._replies.pop(id_, None)

    def subscribe(self, query: str) -> None:
        self.call("subscribe", query=query)

    def next_event(self, timeout: float = 30.0) -> dict:
        return self.events.get(timeout=timeout)

    def close(self) -> None:
        self.open = False
        try:
            # wake the read loop blocked in recv (close alone wouldn't)
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class ReconnectingWSClient:
    """WSClient with automatic reconnect — the reference's ws_client.go
    (:30-140): on connection loss, redial with exponential backoff (+
    jitter), re-subscribe every recorded query, and keep delivering
    events through ONE stable queue across reconnects. Tracks per-call
    latency (the reference hangs a go-metrics timer on the same spot).

    call() during an outage raises RPCClientError immediately (the
    reference errors too); subscriptions resume without caller action.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 max_backoff_s: float = 10.0, on_reconnect=None):
        self.host, self.port, self.timeout = host, port, timeout
        self.max_backoff_s = max_backoff_s
        self.on_reconnect = on_reconnect
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.open = True
        self.reconnects = 0
        self.latency = {"count": 0, "total_s": 0.0, "max_s": 0.0,
                        "min_s": None}
        self._subs: list = []
        self._lock = threading.RLock()
        self._client: Optional[WSClient] = None
        self._connect()
        threading.Thread(target=self._monitor, daemon=True,
                         name="tm-ws-reconnect").start()

    def _connect(self) -> None:
        c = WSClient(self.host, self.port, timeout=self.timeout)
        c.events = self.events  # events survive the client swap
        with self._lock:
            if not self.open:
                # close() raced the redial: don't leak the fresh conn
                c.close()
                raise OSError("client closed during reconnect")
            self._client = c

    def _monitor(self) -> None:
        import random
        import time as _t
        backoff = 0.2
        while self.open:
            c = self._client
            if c is not None and c.open:
                backoff = 0.2
                _t.sleep(0.1)
                continue
            try:
                self._connect()
            except OSError:
                if not self.open:
                    return
                _t.sleep(backoff * (1 + random.random() / 2))
                backoff = min(backoff * 2, self.max_backoff_s)
                continue
            self.reconnects += 1
            with self._lock:
                subs = list(self._subs)
            try:
                for q_ in subs:
                    self._client.call("subscribe", query=q_)
            except (OSError, RPCClientError):
                continue  # died again mid-resubscribe; monitor retries
            if self.on_reconnect is not None:
                try:
                    self.on_reconnect(self)
                except Exception as e:
                    from tendermint_tpu_torch.utils.log import tm_logger
                    tm_logger("rpc.client").error(
                        "on_reconnect callback failed", err=repr(e))

    def call(self, method: str, timeout: float = 30.0, **params) -> Any:
        import time as _t
        c = self._client
        if c is None or not c.open:
            raise RPCClientError(-32000, "websocket disconnected "
                                 "(reconnecting)")
        t0 = _t.perf_counter()
        result = c.call(method, timeout=timeout, **params)
        dt = _t.perf_counter() - t0
        lat = self.latency
        lat["count"] += 1
        lat["total_s"] += dt
        lat["max_s"] = max(lat["max_s"], dt)
        lat["min_s"] = dt if lat["min_s"] is None else min(lat["min_s"], dt)
        return result

    def subscribe(self, query: str) -> None:
        with self._lock:
            if query not in self._subs:
                self._subs.append(query)
        self.call("subscribe", query=query)

    def unsubscribe(self, query: str) -> None:
        with self._lock:
            if query in self._subs:
                self._subs.remove(query)
        self.call("unsubscribe", query=query)

    def next_event(self, timeout: float = 30.0) -> dict:
        return self.events.get(timeout=timeout)

    def close(self) -> None:
        # under the lock: _connect() checks self.open and installs the
        # new client inside the same lock, so close() can never
        # interleave between that check and the install (which would
        # leak a live connection)
        with self._lock:
            self.open = False
            c = self._client
        if c is not None:
            c.close()


class LocalClient:
    """In-process client: same interface, no sockets
    (rpc/client/localclient.go)."""

    def __init__(self, server):
        self.server = server

    def call(self, method: str, **params) -> Any:
        from tendermint_tpu_torch.rpc.core import jsonify
        return jsonify(self.server.call(method, params))


@dataclass
class Call:
    """One recorded RPC invocation (rpc/client/mock/client.go Call)."""
    method: str
    params: Dict[str, Any]
    response: Any = None
    error: Optional[Exception] = None


class MockClient:
    """Recording/canned-response client (rpc/client/mock/client.go:135).

    Two modes, combinable per method:
      * canned: `expect(method, response=... | error=...)` queues what the
        next call of `method` returns;
      * passthrough: constructed with an inner client (Local/JSONRPC),
        un-canned methods are forwarded.
    Every invocation is recorded in `.calls` for assertions.
    """

    def __init__(self, inner=None):
        self.inner = inner
        self.calls: List[Call] = []
        self._canned: Dict[str, List[Call]] = {}

    def expect(self, method: str, response: Any = None,
               error: Optional[Exception] = None) -> None:
        self._canned.setdefault(method, []).append(
            Call(method, {}, response, error))

    def call(self, method: str, **params) -> Any:
        queued = self._canned.get(method)
        if queued:
            canned = queued.pop(0)
            rec = Call(method, params, canned.response, canned.error)
            self.calls.append(rec)
            if canned.error is not None:
                raise canned.error
            return canned.response
        if self.inner is None:
            err = RPCClientError(-32601, f"no canned response and no "
                                 f"inner client for {method!r}")
            self.calls.append(Call(method, params, None, err))
            raise err
        try:
            resp = self.inner.call(method, **params)
        except Exception as e:
            self.calls.append(Call(method, params, None, e))
            raise
        self.calls.append(Call(method, params, resp, None))
        return resp

    def calls_to(self, method: str) -> List[Call]:
        return [c for c in self.calls if c.method == method]
