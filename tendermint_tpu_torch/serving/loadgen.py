"""Open-loop load harness: the port's copy of
`tendermint_tpu/serving/loadgen.py` (pure client code).

A selector-based fleet of virtual clients — thousands of persistent
WebSocket connections driven by ONE thread — issuing a Poisson-paced mix
of writes, proven reads, tx searches and subscriptions at a FIXED offered
rate, however slowly the server answers.

Why open loop: a closed-loop client waits for each response before it
sends the next request, so when the server slows down the clients send
less, and the measured throughput and latency stay flattering. This
harness (1) schedules arrivals from an exponential inter-arrival clock
that never looks at responses, and (2) measures latency from the
SCHEDULED arrival time, so queueing delay — including delay caused by
the harness falling behind — counts. Sweeping the offered rate exposes
the knee: the last rate the system absorbs before goodput detaches from
load. The same seed gives the JAX copy's schedule op for op.

Error taxonomy (the async front door's admission plane): HTTP 503 at the
WebSocket handshake = a shed connection (conn cap), -32005 =
rate-limited, -32000 = overloaded (shed at dispatch).
"""

from __future__ import annotations

import json
import random
import selectors
import socket as _socket
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch import telemetry

_m_offered = telemetry.counter(
    "load_ops_offered_total", "Operations offered by the open-loop "
    "harness, by kind", ("kind",))
_m_completed = telemetry.counter(
    "load_ops_completed_total", "Operations completed (any response), "
    "by kind and outcome", ("kind", "outcome"))
_m_conns = telemetry.gauge(
    "load_conns", "Virtual-client connections the harness holds open")

_WS_KEY = b"bG9hZGdlbi13cy1rZXktMDE="


def _pct(xs: List[float], p: float) -> Optional[float]:
    if not xs:
        return None
    return round(xs[min(len(xs) - 1, int(p * len(xs)))], 2)


def _ws_frame(data: bytes) -> bytes:
    """Client text frame, zero mask (payload rides unchanged)."""
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
    hdr += b"\x00\x00\x00\x00"
    return bytes(hdr) + data


class _VirtConn:
    """One virtual client: a persistent WS connection multiplexing
    JSON-RPC calls by id. Requests in flight live in ``pending`` until
    their response frame (or the drain deadline) resolves them."""

    __slots__ = ("sock", "buf", "pending", "events", "subscribed",
                 "wbuf", "alive")

    def __init__(self, sock):
        self.sock = sock
        self.buf = bytearray()
        self.wbuf = bytearray()        # backpressure: unsent bytes
        self.pending: Dict[int, Tuple[str, float]] = {}
        self.events = 0                # subscription pushes received
        self.subscribed = False
        self.alive = True


class OpenLoopFleet:
    """The virtual-client fleet against one RPC front door."""

    def __init__(self, host: str, port: int, seed: int = 0):
        self.host, self.port = host, port
        self.sel = selectors.DefaultSelector()
        self.conns: List[_VirtConn] = []
        self.shed_conns = 0            # refused at handshake (503 path)
        self.rng = random.Random(seed)
        self._next_id = 0

    # ---------------------------------------------------- connections

    def connect(self, n: int, timeout: float = 5.0) -> int:
        """Open n virtual-client connections (WS upgrade each).
        Returns how many were admitted; refused handshakes count as
        shed connections — the conn-cap admission surface."""
        ok = 0
        for _ in range(n):
            try:
                s = _socket.create_connection((self.host, self.port),
                                              timeout=timeout)
                s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                s.sendall(b"GET / HTTP/1.1\r\nHost: loadgen\r\n"
                          b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                          b"Sec-WebSocket-Key: " + _WS_KEY + b"\r\n"
                          b"Sec-WebSocket-Version: 13\r\n\r\n")
                head = b""
                while b"\r\n\r\n" not in head:
                    chunk = s.recv(4096)
                    if not chunk:
                        raise ConnectionError("closed in handshake")
                    head += chunk
                if b" 101 " not in head.split(b"\r\n", 1)[0]:
                    s.close()
                    self.shed_conns += 1
                    continue
                conn = _VirtConn(s)
                conn.buf += head.partition(b"\r\n\r\n")[2]
                s.setblocking(False)
                self.sel.register(s, selectors.EVENT_READ, conn)
                self.conns.append(conn)
                ok += 1
            except OSError:
                self.shed_conns += 1
        _m_conns.set(len(self.conns))
        return ok

    def subscribe(self, n: int, query: str = "") -> int:
        """Turn n of the fleet's connections into event subscribers
        (they still multiplex request/response traffic)."""
        targets = [c for c in self.conns if not c.subscribed][:n]
        for conn in targets:
            self._send(conn, "subscribe", {"query": query},
                       kind="subscribe", offered_t=time.perf_counter())
            conn.subscribed = True
        return len(targets)

    # ----------------------------------------------------- the engine

    def _send(self, conn: _VirtConn, method: str, params: dict,
              kind: str, offered_t: float) -> int:
        self._next_id += 1
        id_ = self._next_id
        body = json.dumps({"jsonrpc": "2.0", "id": id_,
                           "method": method,
                           "params": params}).encode()
        conn.pending[id_] = (kind, offered_t)
        conn.wbuf += _ws_frame(body)
        self._flush(conn)
        return id_

    def _flush(self, conn: _VirtConn) -> None:
        """Write what the socket will take; the rest waits (and its
        latency keeps running — that's the open-loop point)."""
        if not conn.wbuf or not conn.alive:
            return
        try:
            sent = conn.sock.send(bytes(conn.wbuf))
            del conn.wbuf[:sent]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop(conn)

    def _drop(self, conn: _VirtConn) -> None:
        if not conn.alive:
            return
        conn.alive = False
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        _m_conns.set(sum(1 for c in self.conns if c.alive))

    def _pump_conn(self, conn: _VirtConn, out: dict) -> None:
        """Parse complete WS frames off a connection's buffer."""
        buf = conn.buf
        while len(buf) >= 2:
            ln = buf[1] & 0x7F
            pos = 2
            if ln == 126:
                if len(buf) < 4:
                    break
                (ln,) = struct.unpack(">H", bytes(buf[2:4]))
                pos = 4
            elif ln == 127:
                if len(buf) < 10:
                    break
                (ln,) = struct.unpack(">Q", bytes(buf[2:10]))
                pos = 10
            if len(buf) < pos + ln:
                break
            payload = bytes(buf[pos:pos + ln])
            opcode = buf[0] & 0x0F
            del buf[:pos + ln]
            if opcode == 0x8:          # server close
                self._drop(conn)
                return
            if opcode in (0x9, 0xA):   # ping/pong
                continue
            try:
                doc = json.loads(payload)
            except ValueError:
                continue
            id_ = doc.get("id")
            entry = conn.pending.pop(id_, None) if id_ is not None \
                else None
            if entry is None:
                # unsolicited = subscription event push
                conn.events += 1
                continue
            kind, t0 = entry
            now = time.perf_counter()
            err = doc.get("error")
            if err is None:
                outcome = "ok"
            else:
                code = err.get("code")
                outcome = {(-32005): "rate_limited",
                           (-32000): "overloaded"}.get(code, "error")
            out["lat"].setdefault(kind, []).append((now - t0) * 1000.0)
            out["outcomes"].setdefault(kind, {}).setdefault(outcome, 0)
            out["outcomes"][kind][outcome] += 1
            _m_completed.labels(kind, outcome).inc()

    def _pump(self, out: dict, timeout: float) -> None:
        for key, _ in self.sel.select(timeout=timeout):
            conn = key.data
            try:
                data = conn.sock.recv(262144)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                self._drop(conn)
                continue
            if not data:
                self._drop(conn)
                continue
            conn.buf += data
            self._pump_conn(conn, out)
            self._flush(conn)

    def run(self, duration_s: float, rate: float,
            mix: List[Tuple[str, float, Callable]],
            drain_s: float = 5.0) -> dict:
        """Offer `rate` ops/s for `duration_s` from the fleet.

        `mix` rows are (kind, weight, build) where build(rng, i) ->
        (method, params). Arrivals are Poisson (exponential
        inter-arrival at the aggregate rate); each op goes out on a
        round-robin connection AT its scheduled time, and its latency
        clock starts at that scheduled time — a server (or socket)
        that queues pays for the queueing."""
        live = [c for c in self.conns if c.alive]
        if not live:
            raise RuntimeError("no live connections; connect() first")
        kinds = [m[0] for m in mix]
        weights = [m[1] for m in mix]
        builders = {m[0]: m[2] for m in mix}
        out: dict = {"lat": {}, "outcomes": {}}
        offered: Dict[str, int] = {k: 0 for k in kinds}
        start = time.perf_counter()
        end = start + duration_s
        next_arrival = start + self.rng.expovariate(rate)
        i = 0
        rr = 0
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if now < next_arrival:
                self._pump(out, timeout=min(next_arrival - now, 0.05))
                continue
            # issue every arrival whose scheduled time has passed —
            # falling behind compresses sends, not the offered clock
            while next_arrival <= now:
                kind = self.rng.choices(kinds, weights)[0]
                method, params = builders[kind](self.rng, i)
                i += 1
                for _ in range(len(live)):
                    conn = live[rr % len(live)]
                    rr += 1
                    if conn.alive:
                        break
                else:
                    raise RuntimeError("every connection died mid-run")
                self._send(conn, method, params, kind,
                           offered_t=next_arrival)
                offered[kind] += 1
                _m_offered.labels(kind).inc()
                next_arrival += self.rng.expovariate(rate)
            self._pump(out, timeout=0)
        # drain: give in-flight ops a grace window, then count the
        # rest as unanswered (they failed the open-loop contract)
        drain_end = time.perf_counter() + drain_s
        while time.perf_counter() < drain_end and \
                any(c.pending for c in self.conns if c.alive):
            self._pump(out, timeout=0.05)
        unanswered = {k: 0 for k in kinds}
        for conn in self.conns:
            for kind, _t in conn.pending.values():
                if kind in unanswered:
                    unanswered[kind] += 1
            conn.pending.clear()
        return self._report(duration_s, rate, offered, unanswered, out)

    def _report(self, duration_s: float, rate: float,
                offered: Dict[str, int], unanswered: Dict[str, int],
                out: dict) -> dict:
        total_offered = sum(offered.values())
        per_kind = {}
        all_lat: List[float] = []
        errors = {"rate_limited": 0, "overloaded": 0, "error": 0}
        completed_ok = 0
        for kind, n_off in offered.items():
            lats = sorted(out["lat"].get(kind, []))
            outcomes = out["outcomes"].get(kind, {})
            ok = outcomes.get("ok", 0)
            completed_ok += ok
            for b in errors:
                errors[b] += outcomes.get(b, 0)
            per_kind[kind] = {
                "offered": n_off,
                "ok": ok,
                "shed": {b: outcomes.get(b, 0) for b in errors
                         if outcomes.get(b, 0)},
                "unanswered": unanswered.get(kind, 0),
                "p50_ms": _pct(lats, 0.50),
                "p95_ms": _pct(lats, 0.95),
                "p99_ms": _pct(lats, 0.99),
            }
            all_lat.extend(lats)
        all_lat.sort()
        return {
            "offered_rate": rate,
            "duration_s": duration_s,
            "offered": total_offered,
            "completed_ok": completed_ok,
            "achieved_rate": round(completed_ok / duration_s, 1),
            "goodput_ratio": round(completed_ok / total_offered, 4)
            if total_offered else None,
            "errors": errors,
            "unanswered": sum(unanswered.values()),
            "p50_ms": _pct(all_lat, 0.50),
            "p95_ms": _pct(all_lat, 0.95),
            "p99_ms": _pct(all_lat, 0.99),
            "per_kind": per_kind,
            "conns": sum(1 for c in self.conns if c.alive),
            "shed_conns": self.shed_conns,
            "events": sum(c.events for c in self.conns),
        }

    def close(self) -> None:
        for conn in self.conns:
            self._drop(conn)
        self.sel.close()
        _m_conns.set(0)


# ------------------------------------------------------- op builders

def op_write(keyspace: int = 1000, prefix: str = "lk"):
    """broadcast_tx_async of a kvstore `key=value` tx. Keys cycle a
    bounded keyspace so proven reads hit populated keys."""
    def build(rng: random.Random, i: int):
        k = f"{prefix}{rng.randrange(keyspace)}"
        return ("broadcast_tx_async",
                {"tx": f"{k}={i}".encode().hex()})
    return build


def op_query_prove(keyspace: int = 1000, prefix: str = "lk"):
    """abci_query prove=true — the per-key statetree proof path."""
    def build(rng: random.Random, i: int):
        k = f"{prefix}{rng.randrange(keyspace)}"
        return ("abci_query", {"data": k.encode().hex(),
                               "prove": True})
    return build


def op_tx_search(keyspace: int = 1000, prefix: str = "lk"):
    def build(rng: random.Random, i: int):
        k = f"{prefix}{rng.randrange(keyspace)}"
        return ("tx_search", {"query": f"app.key = '{k}'",
                              "per_page": 5})
    return build


def op_replica_read(keyspace: int = 1000, prefix: str = "lk"):
    """Certified proof-carrying read at a replica (serving/edge.py)."""
    def build(rng: random.Random, i: int):
        k = f"{prefix}{rng.randrange(keyspace)}"
        return ("replica_read", {"key": k.encode().hex()})
    return build


def default_mix(keyspace: int = 1000) -> List[Tuple[str, float, Callable]]:
    """The serving mix: mostly reads, a write stream, a tag-search
    tail (subscriptions ride separately on the fleet's subscriber
    connections)."""
    return [
        ("write", 0.30, op_write(keyspace)),
        ("query_prove", 0.55, op_query_prove(keyspace)),
        ("tx_search", 0.15, op_tx_search(keyspace)),
    ]


# ------------------------------------------------------ sweep / knee

def sweep(fleet: OpenLoopFleet, rates: List[float], duration_s: float,
          mix: List[Tuple[str, float, Callable]],
          settle_s: float = 1.0, on_point=None) -> List[dict]:
    """Run the same mix at each offered rate, low to high. Points are
    independent measurements; a settle pause between them lets queues
    from an overloaded point drain before the next."""
    points = []
    for rate in rates:
        point = fleet.run(duration_s, rate, mix)
        points.append(point)
        if on_point is not None:
            on_point(point)
        time.sleep(settle_s)
    return points


def find_knee(points: List[dict], goodput_floor: float = 0.85,
              p99_slo_ms: Optional[float] = None) -> Optional[dict]:
    """The knee: the highest offered rate the system still absorbs —
    goodput >= floor (completed-ok keeping up with offered) and, when
    given, p99 within the SLO. Points beyond it are the overload
    regime the SLO verdicts describe."""
    knee = None
    for p in points:
        ratio = p.get("goodput_ratio") or 0.0
        if ratio < goodput_floor:
            break
        if p99_slo_ms is not None and (p.get("p99_ms") or 0) > p99_slo_ms:
            break
        knee = p
    return knee
