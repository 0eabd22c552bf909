"""Wire-level chaos — seeded deterministic fault injection for REAL
TCP links: the port's copy of `tendermint_tpu/chaos/wire.py`.

The in-process step relay (chaos/runner.py) exercises every consensus
invariant under faults; this module puts faults on the path a deployed
net runs — real sockets driven by the nodes' event loops — with an
in-process TCP fault proxy: each directed p2p link (dialer -> target)
gets one listener; the dialer's persistent_peers entry points at the
proxy port and the proxy forwards to the real node, injecting

  latency     per-frame delivery delay (geo matrices + delay faults)
  loss        a sealed frame silently dropped — on the AEAD counter-
              nonce stream this desyncs the receiver's cipher, so the
              victim disconnects + redials (the graceful-degradation
              path under test, not a recoverable hiccup)
  corruption  one byte of a sealed frame flipped (same consequence)
  resets      both sides of a link's conn closed with an RST mid-stream
  stalls      slow-loris windows: the proxy stops forwarding a link's
              bytes (conns stay open, the victim's outbuf backs up)
  partitions  FaultSchedule-style group windows: cross-group frames are
              buffered (up to a cap) until the window heals

Determinism contract: all TIME-SCHEDULED events (resets, stalls,
partitions) are generated up front from (spec, seed) — the plan, whose
canonical JSON digest is byte-identical across constructions. PER-FRAME
decisions (drop/corrupt/delay/jitter) are drawn from an RNG seeded by
(seed, link, conn#) strictly in frame order, so the k-th frame of the
j-th conn on a link always sees the same decision. Together these form
the wire-fault log: same (spec, seed) => byte-identical plan and
byte-identical per-conn decision streams; only WHICH prefix of each
stream fires depends on how much traffic the run generates (recorded
as applied counts).

Spec grammar (the FaultSchedule keys that make sense on a wire, plus
wire-only ones; steps convert to wall time via step_ms):

    {
      "drop": 0.001,            # P(frame silently dropped)
      "delay": 0.10,            # P(frame delayed delay_steps extra)
      "delay_steps": [1, 3],
      "corrupt": 0.0005,        # P(one byte of the frame flipped)
      "resets": [{"at": 120, "links": [[0, 1]]}],   # explicit, and/or
      "reset_every_steps": 300, # rotating-link resets from the RNG
      "stalls": [{"start": 60, "stop": 100, "links": [[2, 3]]}],
      "partitions": [{"start": 200, "stop": 280,
                      "groups": [[0], [1, 2, 3]]}],
      "geo": {"profile": "wan3"},   # chaos.schedule.GEO_PROFILES
      "step_ms": 50,            # wall milliseconds per step
      "horizon_steps": 2000,    # plan generation horizon
      "buffer_cap": 1 << 22,    # partition buffer bytes per direction
    }

`SocketInvariantMonitor` is the oracle for these runs: it polls every
node's RPC (exactly what an operator's scrape would see) and asserts
agreement + AppHash identity per height, per-node height monotonicity,
and bounded recovery after each planned fault episode heals.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import random
import selectors
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.chaos.schedule import FaultSchedule

_m_faults = telemetry.counter(
    "wire_faults_injected_total",
    "Wire-level faults injected by the TCP fault proxy, by kind",
    ("kind",))
_m_frames = telemetry.counter(
    "wire_frames_forwarded_total",
    "Sealed frames forwarded by the wire proxy")
_m_bytes = telemetry.counter(
    "wire_bytes_forwarded_total",
    "Wire bytes forwarded by the proxy (both directions)")
_m_conns = telemetry.gauge(
    "wire_proxied_conns", "Live TCP connections through the wire proxy")

#: handshake prelude before length-prefixed frames begin: each side's
#: 32-byte ephemeral X25519 pubkey is sent raw (secret.py make())
_PRELUDE = 32
#: sealed frame ceiling (secret.py: DATA_MAX_SIZE + 2 + tag); anything
#: bigger in a length prefix means the stream already desynced — the
#: framer stops parsing and forwards the rest as opaque bytes
_FRAME_MAX = 1024 + 2 + 16

_WIRE_KEYS = ("drop", "delay", "delay_steps", "corrupt", "resets",
              "reset_every_steps", "stalls", "partitions", "geo",
              "step_ms", "horizon_steps", "buffer_cap")

FAULT_KINDS = ("drop", "corrupt", "delay", "reset", "stall_window",
               "partition_window", "partition_drop", "geo_delay")


class WireSchedule:
    """Deterministic wire-fault plan + per-conn decision streams."""

    def __init__(self, spec: Optional[dict] = None, seed: int = 0,
                 n_nodes: int = 4):
        spec = dict(spec or {})
        for k in spec:
            if k not in _WIRE_KEYS:
                raise ValueError(f"unknown wire spec key {k!r} "
                                 f"(known: {_WIRE_KEYS})")
        self.spec = spec
        self.seed = int(seed)
        self.n_nodes = int(n_nodes)
        self.step_ms = float(spec.get("step_ms", 50.0))
        self.horizon_steps = int(spec.get("horizon_steps", 2000))
        self.buffer_cap = int(spec.get("buffer_cap", 1 << 22))
        self.rates = {k: float(spec.get(k, 0.0))
                      for k in ("drop", "delay", "corrupt")}
        lo, hi = spec.get("delay_steps", (1, 3))
        self.delay_lo, self.delay_hi = int(lo), int(hi)
        # geo matrices resolved by the ONE grammar the step relay uses
        self.geo = FaultSchedule._resolve_geo(spec.get("geo"))
        self._plan = self._build_plan(spec)
        # applied-fault accounting (traffic-dependent; counts only)
        self._lock = threading.Lock()
        self.applied: Dict[str, int] = {}       #: guarded_by _lock
        self.applied_log: List[dict] = []       #: guarded_by _lock

    # ------------------------------------------------------------- plan

    def _links(self) -> List[Tuple[int, int]]:
        return [(s, d) for s in range(self.n_nodes)
                for d in range(self.n_nodes) if s != d]

    def _build_plan(self, spec: dict) -> List[dict]:
        """Every time-scheduled event, generated up front: THIS is the
        byte-identical wire-fault log (plan_digest pins it)."""
        plan: List[dict] = []
        for p in spec.get("partitions", ()):
            plan.append({"kind": "partition", "start": int(p["start"]),
                         "stop": int(p["stop"]),
                         "groups": [sorted(int(x) for x in g)
                                    for g in p["groups"]]})
        for s in spec.get("stalls", ()):
            links = [tuple(int(x) for x in ln)
                     for ln in s.get("links", ())] or self._links()
            plan.append({"kind": "stall", "start": int(s["start"]),
                         "stop": int(s["stop"]),
                         "links": sorted(list(ln) for ln in links)})
        for r in spec.get("resets", ()):
            plan.append({"kind": "reset", "at": int(r["at"]),
                         "links": sorted(list(int(x) for x in ln)
                                         for ln in r["links"])})
        every = int(spec.get("reset_every_steps", 0))
        if every > 0:
            # rotating-link resets from the seeded RNG — part of the
            # deterministic plan, NOT drawn at runtime
            rng = random.Random((self.seed << 16) ^ 0x5EED)
            links = self._links()
            for at in range(every, self.horizon_steps + 1, every):
                ln = links[rng.randrange(len(links))]
                plan.append({"kind": "reset", "at": at,
                             "links": [list(ln)]})
        plan.sort(key=lambda e: (e.get("at", e.get("start", 0)),
                                 e["kind"], json.dumps(e, sort_keys=True)))
        return plan

    @property
    def plan(self) -> List[dict]:
        return [dict(e) for e in self._plan]

    def plan_digest(self) -> str:
        """sha256 of the canonical plan JSON — the determinism witness
        two same-(spec,seed) constructions must reproduce byte-for-byte."""
        blob = json.dumps(self._plan, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def episodes(self) -> List[dict]:
        """Fault windows with end points, in steps — the monitor turns
        these into recovery-latency checks once armed (t0-relative)."""
        out = []
        for e in self._plan:
            if e["kind"] in ("partition", "stall"):
                out.append({"kind": e["kind"], "start": e["start"],
                            "end": e["stop"]})
            elif e["kind"] == "reset":
                out.append({"kind": "reset", "start": e["at"],
                            "end": e["at"]})
        return out

    # -------------------------------------------------------- decisions

    def region_of(self, node: int) -> int:
        if self.geo is None:
            return 0
        return self.geo["assign"].get(node, node % self.geo["regions"])

    def link_stream(self, src: int, dst: int,
                    conn_index: int) -> "_ConnFaults":
        """The per-conn decision stream for direction src->dst of the
        conn_index-th connection on this link. Seeded by (seed, link,
        conn#): the k-th frame of a given conn always draws the same
        decision, run after run."""
        key = f"{src}->{dst}#{conn_index}".encode()
        rng = random.Random((self.seed << 20) ^ zlib.crc32(key))
        return _ConnFaults(self, src, dst, rng)

    def blocked(self, step: float, src: int, dst: int) -> Optional[str]:
        """'partition'/'stall' when the plan blocks src->dst at `step`,
        else None."""
        for e in self._plan:
            if e["kind"] == "partition" and \
                    e["start"] <= step < e["stop"]:
                ga = next((i for i, g in enumerate(e["groups"])
                           if src in g), None)
                gb = next((i for i, g in enumerate(e["groups"])
                           if dst in g), None)
                if ga != gb:
                    return "partition"
            elif e["kind"] == "stall" and \
                    e["start"] <= step < e["stop"] and \
                    [src, dst] in e["links"]:
                return "stall"
        return None

    def resets(self) -> List[Tuple[int, Tuple[int, int]]]:
        out = []
        for e in self._plan:
            if e["kind"] == "reset":
                for ln in e["links"]:
                    out.append((e["at"], (ln[0], ln[1])))
        return out

    def note_applied(self, kind: str, src: int, dst: int,
                     frame: int = -1) -> None:
        with self._lock:
            self.applied[kind] = self.applied.get(kind, 0) + 1
            if len(self.applied_log) < 10000:
                self.applied_log.append(
                    {"kind": kind, "link": f"{src}->{dst}",
                     "frame": frame})
        _m_faults.labels(kind).inc()

    def applied_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.applied)


class _ConnFaults:
    """One direction of one proxied conn: frame-ordered fault decisions.
    NOT thread-safe — the proxy loop is the only caller."""

    def __init__(self, sched: WireSchedule, src: int, dst: int,
                 rng: random.Random):
        self.sched = sched
        self.src, self.dst = src, dst
        self.rng = rng
        self.frame = 0
        g = sched.geo
        if g is not None:
            rs, rd = sched.region_of(src), sched.region_of(dst)
            self._geo_latency_steps = g["latency_steps"][rs][rd]
            self._geo_jitter = g["jitter_steps"] \
                if self._geo_latency_steps else 0
        else:
            self._geo_latency_steps = 0
            self._geo_jitter = 0

    def decide(self) -> dict:
        """Decision for the NEXT frame: {"action": pass|drop|corrupt,
        "delay_s": float, "pos": corrupt-byte index draw}. Exactly the
        same RNG draws happen per frame regardless of outcome, so the
        stream stays aligned with the frame index."""
        idx = self.frame
        self.frame += 1
        r = self.sched.rates
        rng = self.rng
        u_drop, u_corrupt, u_delay = (rng.random(), rng.random(),
                                      rng.random())
        pos = rng.randrange(1 << 16)
        delay_steps = rng.randint(self.sched.delay_lo,
                                  self.sched.delay_hi)
        jitter = rng.randint(0, self._geo_jitter) \
            if self._geo_jitter else 0
        action = "pass"
        if r["drop"] and u_drop < r["drop"]:
            action = "drop"
        elif r["corrupt"] and u_corrupt < r["corrupt"]:
            action = "corrupt"
        delay_s = (self._geo_latency_steps + jitter) \
            * self.sched.step_ms / 1e3
        if r["delay"] and u_delay < r["delay"]:
            delay_s += delay_steps * self.sched.step_ms / 1e3
            if action == "pass":
                self.sched.note_applied("delay", self.src, self.dst,
                                        idx)
        if action != "pass":
            self.sched.note_applied(action, self.src, self.dst, idx)
        elif self._geo_latency_steps:
            # geo latency is topology, not a fault — counted, not logged
            _m_faults.labels("geo_delay").inc()
        return {"action": action, "delay_s": delay_s, "pos": pos,
                "frame": idx}

    def digest(self, n_frames: int) -> str:
        """sha256 over the first n_frames decisions — a fresh stream's
        determinism witness (consumes this instance's RNG)."""
        h = hashlib.sha256()
        for _ in range(n_frames):
            d = self.decide()
            h.update(json.dumps(d, sort_keys=True).encode())
        return h.hexdigest()


# ----------------------------------------------------------------- proxy


class _Direction:
    """One direction of a proxied conn: framer + fault application."""

    def __init__(self, faults: _ConnFaults, dst_leg: "_Leg"):
        self.faults = faults
        self.dst_leg = dst_leg
        self.buf = bytearray()
        self.prelude_left = _PRELUDE
        self.opaque = False         # framing lost: forward as-is
        self.held: List[bytes] = []  # frames held during partition
        self.held_bytes = 0
        # latency is FIFO per direction, like real TCP: a delayed
        # frame delays everything behind it. Reordering frames inside
        # one direction would desync the AEAD counter nonces on EVERY
        # delay fault and read as a corruption storm, not latency.
        self.last_due = 0.0


class _Leg:
    """One socket of a proxied conn pair."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.out = bytearray()
        self.closed = False


class WireProxy:
    """The seeded TCP fault proxy: one listener per directed link, one
    selector thread forwarding frames with schedule-driven faults.

    `targets` maps (src, dst) -> (host, port) of the REAL destination
    node; `listen()` binds each link's proxy port and returns the map
    the testnet's persistent_peers must be rewritten to. The schedule
    stays inert (clean passthrough, zero RNG draws) until `arm()` —
    boot traffic is not part of the measured fault window."""

    def __init__(self, schedule: WireSchedule,
                 targets: Dict[Tuple[int, int], Tuple[str, int]],
                 host: str = "127.0.0.1"):
        self.schedule = schedule
        self.targets = dict(targets)
        self.host = host
        self.ports: Dict[Tuple[int, int], int] = {}
        self._listeners: Dict[int, Tuple[int, int]] = {}  # fd -> link
        self._sel = selectors.DefaultSelector()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._t0: Optional[float] = None
        self._conn_seq: Dict[Tuple[int, int], int] = {}
        self._pending: list = []     # heap: (due, seq, leg, bytes)
        self._pending_seq = 0
        self._conns: List[Tuple[_Leg, _Leg, tuple]] = []
        self._legs: Dict[int, tuple] = {}  # fd -> (leg, direction, link)
        self._fired_resets: set = set()
        self._lock = threading.Lock()

    # ---------------------------------------------------------- control

    def listen(self) -> Dict[Tuple[int, int], int]:
        for link in sorted(self.targets):
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((self.host, 0))
            ls.listen(16)
            ls.setblocking(False)
            self.ports[link] = ls.getsockname()[1]
            self._listeners[ls.fileno()] = link
            self._sel.register(ls, selectors.EVENT_READ,
                               ("listener", ls, link))
        return dict(self.ports)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="wire-proxy")
        self._thread.start()

    def arm(self) -> float:
        """Start the fault clock: plan steps are measured from here."""
        self._t0 = time.monotonic()
        return self._t0

    @property
    def armed(self) -> bool:
        return self._t0 is not None

    def step_now(self) -> float:
        if self._t0 is None:
            return -1.0
        return (time.monotonic() - self._t0) * 1e3 / self.schedule.step_ms

    def stop(self) -> None:
        self._stopped = True
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        for key in list(self._sel.get_map().values()):
            kind = key.data[0]
            obj = key.data[1] if kind == "listener" else key.data[1].sock
            try:
                obj.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:
            pass

    # -------------------------------------------------------------- run

    def _run(self) -> None:
        while not self._stopped:
            timeout = self._next_timeout()
            try:
                events = self._sel.select(timeout)
            except OSError:
                if self._stopped:
                    return
                time.sleep(0.01)
                continue
            for key, mask in events:
                kind = key.data[0]
                if kind == "listener":
                    self._accept(key.data[1], key.data[2])
                elif kind == "leg":
                    if mask & selectors.EVENT_READ:
                        self._readable(key.data[1])
                    if mask & selectors.EVENT_WRITE:
                        self._writable(key.data[1])
            self._deliver_due()
            self._apply_plan()

    def _next_timeout(self) -> float:
        if self._pending:
            return max(0.0, min(0.05,
                                self._pending[0][0] - time.monotonic()))
        return 0.05

    # ----------------------------------------------------------- accept

    def _accept(self, ls: socket.socket, link: Tuple[int, int]) -> None:
        try:
            client, _ = ls.accept()
        except OSError:
            return
        try:
            target = socket.create_connection(self.targets[link],
                                              timeout=3.0)
        except OSError:
            try:
                client.close()
            except OSError:
                pass
            return
        client.setblocking(False)
        target.setblocking(False)
        for s in (client, target):
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        idx = self._conn_seq.get(link, 0)
        self._conn_seq[link] = idx + 1
        src, dst = link
        leg_c = _Leg(client)
        leg_t = _Leg(target)
        # client->target carries src->dst traffic; target->client the
        # reverse direction, its own decision stream
        dir_fwd = _Direction(self.schedule.link_stream(src, dst, idx),
                             leg_t)
        dir_rev = _Direction(self.schedule.link_stream(dst, src, idx),
                             leg_c)
        self._conns.append((leg_c, leg_t, link))
        self._legs[client.fileno()] = (leg_c, dir_fwd, link)
        self._legs[target.fileno()] = (leg_t, dir_rev, (dst, src))
        self._sel.register(client, selectors.EVENT_READ,
                           ("leg", leg_c))
        self._sel.register(target, selectors.EVENT_READ,
                           ("leg", leg_t))
        _m_conns.set(sum(1 for c in self._conns
                         if not c[0].closed and not c[1].closed))

    # ------------------------------------------------------------ frames

    def _readable(self, leg: _Leg) -> None:
        ent = self._legs.get(self._fileno(leg))
        if ent is None:
            return
        _, direction, link = ent
        try:
            data = leg.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_pair(leg)
            return
        if not data:
            self._close_pair(leg)
            return
        _m_bytes.inc(len(data))
        direction.buf += data
        self._pump(direction, link)

    def _pump(self, d: _Direction, link: Tuple[int, int]) -> None:
        """Parse complete wire units out of the direction buffer and
        forward them through the fault pipeline."""
        src, dst = link
        while True:
            unit = self._next_unit(d)
            if unit is None:
                return
            if not unit:
                continue  # prelude already forwarded inside _next_unit
            if not self.armed:
                self._forward(d, unit, 0.0)
                continue
            step = self.step_now()
            blocked = self.schedule.blocked(step, src, dst)
            if blocked is None and d.held:
                # the window healed between plan sweeps: the backlog
                # must go out FIRST or this frame overtakes it (AEAD
                # nonce order)
                self._flush_held(d)
            if blocked is not None:
                if not d.held:
                    # note once per hold window, not per held frame
                    self.schedule.note_applied(blocked + "_window",
                                               src, dst)
                d.held.append(unit)
                d.held_bytes += len(unit)
                if d.held_bytes > self.schedule.buffer_cap:
                    dropped = d.held.pop(0)
                    d.held_bytes -= len(dropped)
                    self.schedule.note_applied("partition_drop", src,
                                               dst)
                continue
            if d.opaque:
                # framing lost on this stream (oversized prefix after a
                # corruption): keep forwarding verbatim, no decisions
                self._forward(d, unit, 0.0)
                continue
            dec = d.faults.decide()
            if dec["action"] == "drop":
                continue
            if dec["action"] == "corrupt" and len(unit) > 0:
                pos = dec["pos"] % len(unit)
                unit = bytes(unit[:pos]) + \
                    bytes([unit[pos] ^ 0xFF]) + bytes(unit[pos + 1:])
            _m_frames.inc()
            self._forward(d, unit, dec["delay_s"])

    def _next_unit(self, d: _Direction) -> Optional[bytes]:
        """One wire unit: prelude bytes, then 4-byte-length frames. On a
        desynced prefix (impossible frame length) the stream degrades to
        opaque passthrough — the victim node is about to kill the conn
        anyway; the proxy must not stall it."""
        if d.prelude_left > 0:
            if not d.buf:
                return None
            take = min(d.prelude_left, len(d.buf))
            unit = bytes(d.buf[:take])
            del d.buf[:take]
            d.prelude_left -= take
            # prelude rides outside the frame fault pipeline
            self._forward(d, unit, 0.0)
            return b"" if not d.buf else self._next_unit(d)
        if d.opaque:
            if not d.buf:
                return None
            unit = bytes(d.buf)
            d.buf.clear()
            return unit
        if len(d.buf) < 4:
            return None
        (clen,) = struct.unpack(">I", bytes(d.buf[:4]))
        if clen > _FRAME_MAX:
            d.opaque = True
            unit = bytes(d.buf)
            d.buf.clear()
            return unit
        if len(d.buf) < 4 + clen:
            return None
        unit = bytes(d.buf[:4 + clen])
        del d.buf[:4 + clen]
        return unit

    def _forward(self, d: _Direction, unit: bytes,
                 delay_s: float) -> None:
        if not unit:
            return
        now = time.monotonic()
        # FIFO latency: this frame may not overtake an earlier delayed
        # one on the same direction (due is monotonic per direction;
        # the heap breaks due ties by push order)
        due = max(now + delay_s, d.last_due)
        d.last_due = due
        if due <= now:
            self._send(d.dst_leg, unit)
        else:
            self._pending_seq += 1
            heapq.heappush(self._pending,
                           (due, self._pending_seq, d.dst_leg, unit))

    def _deliver_due(self) -> None:
        now = time.monotonic()
        while self._pending and self._pending[0][0] <= now:
            _, _, leg, unit = heapq.heappop(self._pending)
            self._send(leg, unit)

    def _send(self, leg: _Leg, data: bytes) -> None:
        if leg.closed:
            return
        leg.out += data
        self._flush(leg)

    def _flush(self, leg: _Leg) -> None:
        while leg.out:
            try:
                n = leg.sock.send(leg.out)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_pair(leg)
                return
            if n <= 0:
                break
            del leg.out[:n]
        events = selectors.EVENT_READ
        if leg.out:
            events |= selectors.EVENT_WRITE
        try:
            self._sel.modify(leg.sock, events, ("leg", leg))
        except (KeyError, ValueError, OSError):
            pass

    def _writable(self, leg: _Leg) -> None:
        self._flush(leg)

    # ------------------------------------------------------------- plan

    def _apply_plan(self) -> None:
        if not self.armed:
            return
        step = self.step_now()
        for at, link in self.schedule.resets():
            if step >= at and (at, link) not in self._fired_resets:
                self._fired_resets.add((at, link))
                self._reset_link(link)
                self.schedule.note_applied("reset", link[0], link[1])
        # heal windows: flush frames held during a partition/stall
        for fd, (leg, d, link) in list(self._legs.items()):
            if d.held and self.schedule.blocked(step, *link) is None:
                self._flush_held(d)

    def _flush_held(self, d: _Direction) -> None:
        held, d.held = d.held, []
        d.held_bytes = 0
        for unit in held:
            self._forward(d, unit, 0.0)

    def _reset_link(self, link: Tuple[int, int]) -> None:
        """RST both sockets of every conn carrying this link, either
        direction — a mid-stream reset is bidirectional."""
        for leg_c, leg_t, ln in self._conns:
            if ln == link or ln == (link[1], link[0]):
                for leg in (leg_c, leg_t):
                    if leg.closed:
                        continue
                    try:
                        leg.sock.setsockopt(
                            socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
                    except OSError:
                        pass
                    self._close_pair(leg)

    # ---------------------------------------------------------- cleanup

    def _fileno(self, leg: _Leg) -> int:
        try:
            return leg.sock.fileno()
        except OSError:
            return -1

    def _close_pair(self, leg: _Leg) -> None:
        """Close a leg AND its partner: a proxied conn is one TCP path;
        half-open proxy legs would hide peer death from the victim."""
        for leg_c, leg_t, _ in self._conns:
            if leg is leg_c or leg is leg_t:
                for side in (leg_c, leg_t):
                    if side.closed:
                        continue
                    side.closed = True
                    fd = self._fileno(side)
                    self._legs.pop(fd, None)
                    try:
                        self._sel.unregister(side.sock)
                    except (KeyError, ValueError, OSError):
                        pass
                    try:
                        side.sock.close()
                    except OSError:
                        pass
                break
        self._conns = [c for c in self._conns
                       if not (c[0].closed and c[1].closed)]
        _m_conns.set(len(self._conns))


# --------------------------------------------------------------- monitor


class SocketInvariantMonitor:
    """RPC-polling oracle for socket-plane chaos runs.

    Polls every node's status + block metas (the operator's view — no
    in-process shortcuts) and checks, while wire faults fire:

      agreement   one block hash per height across all nodes
      apphash     one header.app_hash per height across all nodes
                  (bit-identical AppHash chain)
      validity    per node, reported heights never go backwards
      liveness    the min frontier advances within a bound after every
                  planned fault episode heals (finalize())

    Violations are recorded, never raised mid-run — the run must keep
    going so the report shows what happened after the violation."""

    def __init__(self, urls: List[str], poll_s: float = 0.25):
        from tendermint_tpu_torch.rpc.client import JSONRPCClient
        self.clients = [JSONRPCClient(u) for u in urls]
        self.poll_s = poll_s
        self.violations: List[dict] = []
        self.checks: Dict[str, int] = {}
        self.heights: Dict[int, int] = {}          # node -> frontier
        self.per_height: Dict[int, dict] = {}      # h -> node -> (hash, app)
        self.progress: List[Tuple[float, int]] = []  # (t, min frontier)
        self._audited: Dict[int, int] = {}  # node -> newest audited height
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="wire-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _check(self, inv: str) -> None:
        self.checks[inv] = self.checks.get(inv, 0) + 1

    def _violate(self, inv: str, **detail) -> None:
        self.violations.append({"invariant": inv, **detail})

    def _run(self) -> None:
        from tendermint_tpu_torch.rpc.client import RPCClientError
        while not self._stop.is_set():
            for i, c in enumerate(self.clients):
                try:
                    self._poll_node(i, c)
                except (OSError, RPCClientError):
                    continue  # node busy/mid-restart: next poll decides
            mins = min(self.heights.values()) if len(self.heights) == \
                len(self.clients) else 0
            if mins and (not self.progress or
                         self.progress[-1][1] < mins):
                self.progress.append((time.monotonic(), mins))
            self._stop.wait(self.poll_s)

    def _poll_node(self, i, client) -> None:
        h = client.call("status")["latest_block_height"]
        last = self.heights.get(i, 0)
        self._check("validity")
        if h < last:
            self._violate("validity", node=i, height=h, last=last)
        self.heights[i] = h
        # audit new metas (hash + app_hash per height), paging the
        # 20-meta route cap
        lo = self._audited.get(i, 0) + 1
        while lo <= h:
            hi = min(lo + 19, h)
            metas = client.call("blockchain", min_height=lo,
                                max_height=hi)["block_metas"]
            for m in metas:
                hh = m["header"]["height"]
                rec = self.per_height.setdefault(hh, {})
                entry = (m["block_id"]["hash"],
                         m["header"]["app_hash"])
                for other_node, other in rec.items():
                    if other_node == i:
                        continue
                    self._check("agreement")
                    if other[0] != entry[0]:
                        self._violate("agreement", height=hh, node=i,
                                      hash=entry[0], expected=other[0])
                    self._check("apphash")
                    if other[1] != entry[1]:
                        self._violate("apphash", height=hh, node=i,
                                      app_hash=entry[1],
                                      expected=other[1])
                rec[i] = entry
            lo = hi + 1
        self._audited[i] = h

    # --------------------------------------------------------- finalize

    def finalize(self, episode_ends_s: List[Tuple[str, float]],
                 liveness_bound_s: float = 30.0) -> dict:
        """`episode_ends_s`: (kind, monotonic end time) per healed fault
        episode. Recovery latency = first min-frontier advance at or
        after the heal; missing/over-bound = liveness violation."""
        latencies = []
        episodes = []
        for kind, end_t in episode_ends_s:
            self._check("liveness")
            after = [t for t, _ in self.progress if t >= end_t]
            lat = (after[0] - end_t) if after else None
            episodes.append({"kind": kind,
                             "recovery_s": round(lat, 3)
                             if lat is not None else None})
            if lat is None or lat > liveness_bound_s:
                self._violate("liveness", episode=kind,
                              recovery_s=lat, bound=liveness_bound_s)
            else:
                latencies.append(lat)
        fully_audited = [h for h, rec in self.per_height.items()
                         if len(rec) == len(self.clients)]
        lat_sorted = sorted(latencies)

        def pct(p):
            if not lat_sorted:
                return None
            return round(lat_sorted[min(len(lat_sorted) - 1,
                                        int(p * len(lat_sorted)))], 3)

        return {
            "checks": dict(self.checks),
            "checks_total": sum(self.checks.values()),
            "violations": list(self.violations),
            "heights": dict(self.heights),
            "heights_audited_all_nodes": len(fully_audited),
            "max_height_audited": max(fully_audited, default=0),
            "app_hash_chain_identical": not any(
                v["invariant"] == "apphash" for v in self.violations),
            "recovery": {
                "episodes": episodes,
                "latency_seconds": {
                    "p50": pct(0.50), "p90": pct(0.90),
                    "max": lat_sorted[-1] if lat_sorted else None,
                    "n": len(lat_sorted)},
            },
        }


def proxy_for_testnet(spec: dict, seed: int, n_nodes: int,
                      p2p_port: Callable[[int], int],
                      host: str = "127.0.0.1"
                      ) -> Tuple[WireProxy, WireSchedule]:
    """Build the full-mesh proxy for an n-node testnet whose node i
    listens on p2p_port(i): one listener per directed (dialer, target)
    link. The caller rewrites node i's persistent_peers to
    proxy.ports[(i, j)] and starts/arms the proxy around the run."""
    sched = WireSchedule(spec, seed=seed, n_nodes=n_nodes)
    targets = {(i, j): (host, p2p_port(j))
               for i in range(n_nodes) for j in range(n_nodes)
               if i != j}
    proxy = WireProxy(sched, targets, host=host)
    proxy.listen()
    return proxy, sched
