"""Async reactor core — ONE event loop for every peer socket and RPC
connection of a node: the port's copy of `tendermint_tpu/p2p/conn/loop.py`.

The thread plane spends two threads a peer connection, three gossip
threads a peer and a thread an RPC connection. This module replaces it
with one selector loop a node:

- ``ReactorLoop``: a ``selectors`` event loop thread owning every
  registered socket, with monotonic timers, thread-safe ``call_soon`` /
  ``call_later``, and cooperative ``Task``s (the per-peer gossip routines
  run here as tasks instead of threads).
- ``LoopMConnection``: MConnection semantics (prioritised channels,
  packets of at most 1000 payload bytes, ping/pong keepalive, flow
  accounting) without send/recv threads. Reads drain whole frame bursts
  a readiness event into the link's codec (`link.feed_wire`); writes
  seal whole bursts (`link.seal_frames`) into a bounded wire buffer with
  partial-write resumption. Backpressure: bounded per-channel queues and
  a bounded outbuf. When a slow reader fills them, a blocking `send`
  from a foreign thread parks on a condition, a task on the loop sees
  False and retries on the drain wake; nothing buffers without bound.

The plane is chosen by `config.base.reactor` (`config.resolve_reactor`):
auto and loop give the event loop, threads the thread plane. Only a Node
consults it; a directly built MConnection or Switch runs on threads
unless handed a loop. The JAX module's `loop_*` families are fed beside
`ReactorLoop.stats` (ticks, callbacks and busy time); callbacks run
through `_invoke`, whose ``__owner__`` tag lets the sampling profiler
charge loop time to the subsystem that scheduled it; each conn's send
queues are registered with the queue observatory.
"""

from __future__ import annotations

import heapq
import selectors
import socket as _socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.p2p.conn.burst import Burst
from tendermint_tpu_torch.p2p.conn.flowrate import FlowMonitor
from tendermint_tpu_torch.p2p.conn.mconn import (
    _m_frames_per_burst,
    _m_keepalive_rtt,
    PACKET_MSG,
    PACKET_PING,
    PACKET_PONG,
    _Channel,
)
from tendermint_tpu_torch.telemetry import queues as queue_obs
from tendermint_tpu_torch.utils import knobs
from tendermint_tpu_torch.utils.log import get_logger

# tmlint: loop-module (async-blocking checker applies to this file)
TMLINT_LOOP_MODULE = True

_m_tick = telemetry.histogram(
    "loop_tick_seconds",
    "Busy time per reactor-loop tick (select wake to idle)",
    buckets=(1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 2.5e-2, 1e-1, 1.0))
_m_dispatch = telemetry.counter(
    "loop_dispatch_total",
    "Callbacks dispatched by the reactor loop, by kind",
    ("kind",))
_m_fds = telemetry.gauge(
    "loop_fds", "File descriptors registered on the reactor loop")
_m_tasks = telemetry.gauge(
    "loop_tasks", "Cooperative tasks alive on the reactor loop")

# Bounded wire buffer a connection: past this the loop stops sealing new
# packets for the conn, channel queues fill, and senders stall.
OUTBUF_HIGH_WATER = 256 * 1024
#: the send flush's linger by default (TM_CUDA_P2P_FLUSH_LINGER_MS sets
#: it; 0 flushes at every wakeup): a flush on an idle conn runs at once,
#: the next one waits out this window so that sends under load ride one
#: sealed burst
FLUSH_LINGER_MS = 4.0


class _Timer:
    __slots__ = ("due", "fn", "owner", "cancelled")

    def __init__(self, due: float, fn: Callable, owner: str):
        self.due = due
        self.fn = fn
        self.owner = owner
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class Task:
    """A cooperative routine: ``fn()`` runs on the loop and returns
    - a float: run again after that many seconds,
    - None: park until someone calls ``wake()``,
    - "stop": the task is done.
    All steps run on the loop thread, so ``fn`` needs no locking against
    itself. ``wake()`` is thread-safe and idempotent."""

    def __init__(self, loop: "ReactorLoop", fn: Callable[[], object],
                 owner: str, name: str = ""):
        self.loop = loop
        self.fn = fn
        self.owner = owner
        self.name = name or getattr(fn, "__name__", "task")
        self._lock = threading.Lock()
        self._scheduled = False               #: guarded_by _lock
        self._timer: Optional[_Timer] = None  #: guarded_by _lock
        self.stopped = False

    def wake(self) -> None:
        with self._lock:
            if self.stopped or self._scheduled:
                return
            self._scheduled = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        self.loop.call_soon(self._step, owner=self.owner)

    def stop(self) -> None:
        with self._lock:
            self.stopped = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        self.loop._task_done(self)

    def _step(self) -> None:
        with self._lock:
            self._scheduled = False
        if self.stopped:
            return
        try:
            r = self.fn()
        except Exception as e:
            get_logger(__name__).error("loop task failed", task=self.name,
                                       err=repr(e))
            self.stop()
            return
        if r == "stop":
            self.stop()
            return
        if r is None:
            return  # parked; wake() reschedules
        with self._lock:
            if self.stopped or self._scheduled:
                return
            if float(r) <= 0:
                self._scheduled = True
            else:
                self._timer = self.loop.call_later(
                    float(r), self._resume, owner=self.owner)
                return
        self.loop.call_soon(self._step, owner=self.owner)

    def _resume(self) -> None:
        with self._lock:
            self._timer = None
            if self.stopped or self._scheduled:
                return
            self._scheduled = True
        # already on the loop thread: step directly
        self._step()


class ReactorLoop:
    """One event-loop thread: selector + timers + ready queue + tasks.

    Registration and callbacks all execute on the loop thread;
    ``call_soon``/``call_later``/``add_reader`` are safe from any thread
    (cross-thread calls enqueue and wake the selector).

    ``stats``: ticks (select wakes), callbacks by kind (read, write,
    timer, soon), busy_s (time from a select's return to the next
    select) and max_tick_s; ``busy_share()`` is busy_s over the wall
    since start."""

    STATS = ("ticks", "read", "write", "timer", "soon", "busy_s",
             "max_tick_s")

    def __init__(self, name: str = "tm-reactor-loop"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._ready: deque = deque()      #: guarded_by _lock
        self._timers: list = []           # heap, loop-thread only
        self._timer_seq = 0
        self._fds: Dict[int, list] = {}   # fileno -> [fileobj, r, w, owner]
        self._tasks: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._wake_r, self._wake_w = _socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._woken = False               #: guarded_by _lock
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        # written on the loop thread only; readers take a copy
        self.stats = dict.fromkeys(self.STATS, 0)
        self.stats["busy_s"] = self.stats["max_tick_s"] = 0.0
        self._t_start = 0.0

    # ------------------------------------------------------------ control

    def start(self) -> None:
        if self._thread is not None:
            return
        self._t_start = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        self._stopped = True
        self._wakeup()
        t = self._thread
        if join and t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stopped

    def in_loop(self) -> bool:
        return threading.current_thread() is self._thread

    def busy_share(self) -> float:
        """Time in callbacks over the wall since start()."""
        wall = time.perf_counter() - self._t_start if self._t_start else 0.0
        return self.stats["busy_s"] / wall if wall > 0 else 0.0

    # ---------------------------------------------------------- schedule

    def _wakeup(self) -> None:
        with self._lock:
            if self._woken:
                return
            self._woken = True
        try:
            self._wake_w.send(b"\x00")
        except (OSError, ValueError):
            pass

    def call_soon(self, fn: Callable, owner: str = "loop") -> None:
        with self._lock:
            self._ready.append((fn, owner))
        if not self.in_loop():
            self._wakeup()

    def call_later(self, delay: float, fn: Callable,
                   owner: str = "loop") -> _Timer:
        t = _Timer(time.monotonic() + max(0.0, delay), fn, owner)
        if self.in_loop():
            self._push_timer(t)
        else:
            self.call_soon(lambda: self._push_timer(t))
        return t

    def _push_timer(self, t: _Timer) -> None:
        self._timer_seq += 1
        heapq.heappush(self._timers, (t.due, self._timer_seq, t))

    def add_reader(self, fileobj, cb: Optional[Callable],
                   owner: str = "p2p",
                   writer: Optional[Callable] = None) -> None:
        """Register/modify read+write callbacks for a socket. Safe from
        any thread (applies on the loop)."""
        if self.in_loop():
            self._set_handlers(fileobj, cb, writer, owner)
        else:
            self.call_soon(
                lambda: self._set_handlers(fileobj, cb, writer, owner),
                owner=owner)

    def remove_fd(self, fileobj) -> None:
        if self.in_loop():
            self._unregister(fileobj)
        else:
            self.call_soon(lambda: self._unregister(fileobj))

    def _set_handlers(self, fileobj, reader, writer, owner) -> None:
        try:
            fd = fileobj.fileno()
        except (OSError, ValueError):
            return
        if fd < 0:
            return
        ent = self._fds.get(fd)
        if ent is None:
            ent = [fileobj, reader, writer, owner]
            self._fds[fd] = ent
            try:
                self._sel.register(fileobj, self._events(ent), fd)
            except (KeyError, ValueError, OSError):
                self._fds.pop(fd, None)
        else:
            ent[0], ent[1], ent[2], ent[3] = fileobj, reader, writer, owner
            self._apply_interest(ent)
        _m_fds.set(len(self._fds))

    @staticmethod
    def _events(ent) -> int:
        ev = 0
        if ent[1] is not None:
            ev |= selectors.EVENT_READ
        if ent[2] is not None:
            ev |= selectors.EVENT_WRITE
        return ev or selectors.EVENT_READ

    def _apply_interest(self, ent) -> None:
        try:
            self._sel.modify(ent[0], self._events(ent), ent[0].fileno())
        except (KeyError, ValueError, OSError):
            pass

    def _unregister(self, fileobj) -> None:
        try:
            fd = fileobj.fileno()
        except (OSError, ValueError):
            fd = None
        if fd is None or fd not in self._fds:
            # closed already: find by object identity
            for k, ent in list(self._fds.items()):
                if ent[0] is fileobj:
                    fd = k
                    break
        if fd is None or fd not in self._fds:
            return
        ent = self._fds.pop(fd)
        try:
            self._sel.unregister(ent[0])
        except (KeyError, ValueError, OSError):
            pass
        _m_fds.set(len(self._fds))

    def spawn(self, fn: Callable[[], object], owner: str = "loop",
              name: str = "") -> Task:
        task = Task(self, fn, owner, name)
        self._tasks.add(task)
        _m_tasks.set(len(self._tasks))
        task.wake()
        return task

    def _task_done(self, task: Task) -> None:
        self._tasks.discard(task)
        _m_tasks.set(len(self._tasks))

    @property
    def n_fds(self) -> int:
        return len(self._fds)

    @property
    def n_tasks(self) -> int:
        return len(self._tasks)

    # --------------------------------------------------------------- run

    def _run(self) -> None:
        st = self.stats
        tele = telemetry.enabled()
        while not self._stopped:
            timeout = self._next_timeout()
            try:
                events = self._sel.select(timeout)  # tmlint: allow(async-blocking): the loop's ONE park point — select with a timer-derived timeout
            except OSError:
                if self._stopped:
                    return
                time.sleep(0.01)  # tmlint: allow(async-blocking): EBADF backoff while an fd is torn down mid-select
                continue
            t0 = time.perf_counter()
            for key, mask in events:
                if key.data is None:       # wake pipe
                    self._drain_wake()
                    continue
                ent = self._fds.get(key.data)
                if ent is None:
                    continue
                if mask & selectors.EVENT_READ and ent[1] is not None:
                    st["read"] += 1
                    _m_dispatch.labels("read").inc()
                    self._safe(ent[1], ent[3])
                if mask & selectors.EVENT_WRITE and ent[2] is not None:
                    st["write"] += 1
                    _m_dispatch.labels("write").inc()
                    self._safe(ent[2], ent[3])
            self._fire_timers()
            self._drain_ready()
            dt = time.perf_counter() - t0
            st["ticks"] += 1
            st["busy_s"] += dt
            if dt > st["max_tick_s"]:
                st["max_tick_s"] = dt
            if tele:
                _m_tick.observe(dt)

    @staticmethod
    def _invoke(cb: Callable, __owner__: str) -> None:
        """Every callback runs through here; the sampling profiler reads
        ``__owner__`` off this frame to attribute loop time to the
        owning subsystem (telemetry/profile.py)."""
        cb()

    @staticmethod
    def _safe(cb: Callable, owner: str) -> None:
        try:
            ReactorLoop._invoke(cb, owner)
        except Exception as e:
            get_logger(__name__).error("loop callback failed", owner=owner,
                                       err=repr(e))

    def _drain_wake(self) -> None:
        with self._lock:
            self._woken = False
        try:
            while self._wake_r.recv(4096):  # tmlint: allow(async-blocking): non-blocking socketpair drain (O_NONBLOCK, exits via BlockingIOError)
                pass
        except (BlockingIOError, OSError):
            pass

    def _next_timeout(self) -> Optional[float]:
        with self._lock:
            if self._ready:
                return 0.0
        while self._timers and self._timers[0][2].cancelled:
            heapq.heappop(self._timers)
        if not self._timers:
            return 1.0
        return max(0.0, self._timers[0][0] - time.monotonic())

    def _fire_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _, _, t = heapq.heappop(self._timers)
            if t.cancelled:
                continue
            self.stats["timer"] += 1
            _m_dispatch.labels("timer").inc()
            self._safe(t.fn, t.owner)

    def _drain_ready(self) -> None:
        # snapshot: callbacks scheduled DURING the drain run next tick,
        # so a self-rescheduling callback cannot starve the selector
        with self._lock:
            batch = list(self._ready)
            self._ready.clear()
        for fn, owner in batch:
            self.stats["soon"] += 1
            _m_dispatch.labels("soon").inc()
            self._safe(fn, owner)


# -------------------------------------------------------- loop mconn


def raw_socket(link):
    """The OS socket under a (possibly wrapped) link: SecretConnection
    and PlainFramedConn expose .conn; a wrapper exposes .link."""
    seen = 0
    while seen < 8:
        conn = getattr(link, "conn", None)
        if conn is not None and hasattr(conn, "fileno"):
            return conn
        inner = getattr(link, "link", None)
        if inner is None:
            raise TypeError(f"link {type(link).__name__} exposes no "
                            f"raw socket")
        link = inner
        seen += 1
    raise TypeError("link wrapper chain too deep")


class LoopMConnection:
    """MConnection semantics on a ReactorLoop — no send/recv threads.

    The link must expose the codec surface (``seal_frames``/``feed_wire``)
    besides ``close``; the raw socket is driven non-blocking by the loop,
    so the link never touches the socket itself on this path."""

    def __init__(self, loop: ReactorLoop, link, channel_descs,
                 on_receive: Callable[[int, bytes], None],
                 on_error: Callable[[Exception], None] = lambda e: None,
                 send_rate: float = 0.0, recv_rate: float = 0.0,
                 ping_interval: float = 10.0,
                 idle_timeout: float = 35.0, burst: Burst = Burst()):
        self.loop = loop
        self.link = link
        self.sock = raw_socket(link)
        self.channels: Dict[int, _Channel] = {
            d.id: _Channel(d) for d in channel_descs}
        self.on_receive = on_receive
        self.on_error = on_error
        # monitors are stats-only here (no limit => update never
        # sleeps); throttling is the non-blocking pause logic below
        self.send_monitor = FlowMonitor(0.0)
        self.recv_monitor = FlowMonitor(0.0)
        self._send_limit = float(send_rate or 0.0)
        self._recv_limit = float(recv_rate or 0.0)
        self._t0 = time.monotonic()
        self.ping_interval = ping_interval
        self.idle_timeout = idle_timeout
        self._cond = threading.Condition()
        self._stopped = False             #: guarded_by _cond
        self._errored = False             #: guarded_by _cond
        self._pong_due = 0                #: guarded_by _cond
        self._ping_sent = 0.0             # loop-thread only
        self._last_rtt = 0.0              #: guarded_by _cond
        self._last_recv = time.monotonic()  # loop-thread only
        self._last_ping = time.monotonic()
        self._outbuf = bytearray()        # loop-thread only (wire bytes)
        self._flush_scheduled = False     #: guarded_by _cond
        self._write_armed = False         # loop-thread only
        self._recv_paused = False         # loop-thread only
        self._attached = False            # loop-thread only
        self._detached = threading.Event()
        self._timers: List[_Timer] = []   # loop-thread only
        self._threads: tuple = ()         # MConnection's surface: none
        _, self._burst_max = burst.resolve()
        # the linger is a rate limiter, not a delay: a send on an idle
        # conn flushes at once, but once a flush has run the next one
        # waits out the window, so under load sends accumulate into full
        # bursts while sporadic sends pay nothing
        self._flush_linger_s = max(0.0, knobs.knob_float(
            "TM_CUDA_P2P_FLUSH_LINGER_MS", default=FLUSH_LINGER_MS)) / 1e3
        self._last_flush = 0.0  # written on the loop; racy reads benign
        self.drain_listeners: List[Callable[[], None]] = []
        self._queue_probes = [
            queue_obs.register(
                f"mconn.send.{d.id:#04x}", self,
                depth=lambda c, _id=d.id: len(c.channels[_id].queue),
                capacity=d.send_queue_capacity)
            for d in channel_descs]

    # ------------------------------------------------------------ control

    def start(self) -> None:
        self.sock.setblocking(False)
        self.loop.call_soon(self._attach, owner="p2p")

    def _attach(self) -> None:
        with self._cond:
            if self._stopped:
                return
        self._attached = True
        self.loop.add_reader(self.sock, self._on_readable, owner="p2p",
                             writer=None)
        self._timers = [
            self.loop.call_later(self.ping_interval, self._ping_tick,
                                 owner="p2p"),
            self.loop.call_later(self.idle_timeout, self._idle_tick,
                                 owner="p2p"),
        ]
        # the handshake's buffered over-read may already hold frames
        try:
            frames = self.link.feed_wire(b"")
        except Exception as e:
            self._error(e)
            return
        for f in frames:
            self._handle_frame(f)
        self._flush()

    def stop(self, join: bool = False, timeout: float = 2.0) -> None:
        """join=True waits until the loop has detached the socket, so a
        Switch teardown can guarantee no callback for this conn runs
        after stop() returns."""
        with self._cond:
            already = self._stopped
            self._stopped = True
            self._cond.notify_all()
        if not already:
            for probe in self._queue_probes:
                probe.close()
            if self.loop.running and not self.loop.in_loop():
                self.loop.call_soon(self._teardown, owner="p2p")
            else:
                self._teardown()
        if join and not self.loop.in_loop():
            self._detached.wait(timeout)  # tmlint: allow(async-blocking): only reachable from non-loop threads (in_loop() guarded one line up)

    def _teardown(self) -> None:
        for t in self._timers:
            t.cancel()
        self._timers = []
        if self._attached:
            self.loop.remove_fd(self.sock)
            self._attached = False
        try:
            self.link.close()
        except Exception:  # socket already dead either way
            pass
        self._detached.set()

    @property
    def running(self) -> bool:
        with self._cond:
            return not self._stopped

    def rtt_s(self) -> float:
        with self._cond:
            return self._last_rtt

    def _error(self, e: Exception) -> None:
        with self._cond:
            if self._stopped or self._errored:
                return
            self._errored = True
        self.stop()
        self.on_error(e)

    # ------------------------------------------------------------- send

    def send(self, ch_id: int, msg: bytes, timeout: float = 10.0) -> bool:
        """Queue a full message. From a foreign thread a full channel
        queue blocks (bounded by `timeout`) as the threaded MConnection
        does; ON the loop thread blocking would deadlock the reactor, so
        a full queue returns False and loop tasks retry on the drain
        wake."""
        ch = self.channels.get(ch_id)
        if ch is None:
            return False
        deadline = time.monotonic() + timeout
        with self._cond:
            if self._stopped:
                return False
            while len(ch.queue) >= ch.desc.send_queue_capacity:
                if self.loop.in_loop():
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopped:
                    return False
                self._cond.wait(timeout=remaining)  # tmlint: allow(async-blocking): only reachable from non-loop threads (in_loop() returns False above)
            if self._stopped:
                return False
            ch.queue.append(bytes(msg))
        self._schedule_flush()
        return True

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        ch = self.channels.get(ch_id)
        if ch is None:
            return False
        with self._cond:
            if self._stopped or \
                    len(ch.queue) >= ch.desc.send_queue_capacity:
                return False
            ch.queue.append(bytes(msg))
        self._schedule_flush()
        return True

    def can_send(self, ch_id: int) -> bool:
        ch = self.channels.get(ch_id)
        if ch is None:
            return False
        with self._cond:
            return len(ch.queue) < ch.desc.send_queue_capacity

    def _schedule_flush(self) -> None:
        with self._cond:
            if self._flush_scheduled or self._stopped:
                return
            self._flush_scheduled = True
        linger = self._flush_linger_s
        since = time.monotonic() - self._last_flush
        if since < linger:
            # a flush just ran: everything arriving inside the window
            # rides the next seal as one burst
            self.loop.call_later(linger - since, self._flush, owner="p2p")
            return
        self.loop.call_soon(self._flush, owner="p2p")

    def _pick_channel(self) -> Optional[_Channel]:
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.has_data():
                continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_ahead(self) -> float:
        if self._send_limit <= 0:
            return 0.0
        elapsed = time.monotonic() - self._t0
        ahead = self.send_monitor.total - self._send_limit * elapsed
        return max(0.0, ahead / self._send_limit)

    def _flush(self) -> None:
        """Loop thread: drain channel queues into sealed wire bytes
        (bounded by OUTBUF_HIGH_WATER) and push them to the socket."""
        with self._cond:
            self._flush_scheduled = False
            if self._stopped:
                return
        if not self._attached:
            return  # _attach ends with a flush; queued data drains then
        self._last_flush = time.monotonic()
        pause = self._send_ahead()
        if pause > 0.01:
            # non-blocking throttle: resume when the sliding budget
            # recovers (the threaded plane sleeps here instead)
            self.loop.call_later(min(pause, 1.0), self._flush,
                                 owner="p2p")
            return
        # drain bursts until the queues are empty or the outbuf hits its
        # high water: the seal stays amortized over full bursts
        while True:
            chunks: List[bytes] = []
            payload_bytes = 0
            drained = False
            with self._cond:
                pongs, self._pong_due = self._pong_due, 0
                for _ in range(pongs):
                    chunks.append(bytes([PACKET_PONG]))
                while len(chunks) < self._burst_max and \
                        len(self._outbuf) < OUTBUF_HIGH_WATER:
                    ch = self._pick_channel()
                    if ch is None:
                        break
                    payload, eof = ch.next_packet()
                    chunks.append(struct.pack(
                        ">BBB", PACKET_MSG, ch.desc.id, 1 if eof else 0
                    ) + payload)
                    ch.recently_sent += len(payload)
                    payload_bytes += len(payload) + 3
                    drained = True
                self._cond.notify_all()  # wake senders blocked on queues
            if drained:
                for cb in self.drain_listeners:
                    cb()
            if not chunks:
                return
            try:
                wire = self.link.seal_frames(chunks)
            except Exception as e:
                self._error(e)
                return
            if len(chunks) > 1 and telemetry.enabled():
                _m_frames_per_burst.labels("send").observe(len(chunks))
            self.send_monitor.update(payload_bytes + pongs)
            self._outbuf += wire
            self._write_some()
            with self._cond:
                if self._stopped or \
                        len(self._outbuf) >= OUTBUF_HIGH_WATER:
                    return
                if not any(c.has_data() for c in self.channels.values()):
                    return

    def _write_some(self) -> None:
        while self._outbuf:
            try:
                n = self.sock.send(self._outbuf)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                self._error(e)
                return
            if n <= 0:
                break
            del self._outbuf[:n]
        if self._outbuf:
            if not self._write_armed:
                self._write_armed = True
                self.loop.add_reader(self.sock, self._on_readable,
                                     owner="p2p",
                                     writer=self._on_writable)
        else:
            if self._write_armed:
                self._write_armed = False
                self.loop.add_reader(self.sock, self._on_readable,
                                     owner="p2p", writer=None)
            # room again: seal whatever accumulated meanwhile
            with self._cond:
                more = any(ch.has_data() for ch in self.channels.values())
            if more:
                self._schedule_flush()

    def _on_writable(self) -> None:
        with self._cond:
            if self._stopped:
                return
        self._write_some()

    # ------------------------------------------------------------- recv

    def _recv_ahead(self) -> float:
        if self._recv_limit <= 0:
            return 0.0
        elapsed = time.monotonic() - self._t0
        ahead = self.recv_monitor.total - self._recv_limit * elapsed
        return max(0.0, ahead / self._recv_limit)

    def _on_readable(self) -> None:
        with self._cond:
            if self._stopped:
                return
        try:
            data = self.sock.recv(65536)  # tmlint: allow(async-blocking): O_NONBLOCK socket — returns or raises BlockingIOError, never parks
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._error(e)
            return
        if not data:
            self._error(ConnectionError("connection closed by peer"))
            return
        self._last_recv = time.monotonic()
        try:
            frames = self.link.feed_wire(data)
        except Exception as e:
            self._error(e)
            return
        if frames:
            self.recv_monitor.update(sum(len(f) for f in frames))
            if len(frames) > 1 and telemetry.enabled():
                _m_frames_per_burst.labels("recv").observe(len(frames))
        for f in frames:
            try:
                self._handle_frame(f)
            except Exception as e:
                self._error(e)
                return
        pause = self._recv_ahead()
        if pause > 0.01 and not self._recv_paused:
            # non-blocking recv throttle: drop read interest, resume on
            # a timer (the threaded plane sleeps in FlowMonitor instead)
            self._recv_paused = True
            self.loop.add_reader(self.sock, None, owner="p2p",
                                 writer=(self._on_writable
                                         if self._write_armed else None))
            self.loop.call_later(min(pause, 1.0), self._resume_recv,
                                 owner="p2p")

    def _resume_recv(self) -> None:
        with self._cond:
            if self._stopped:
                return
        self._recv_paused = False
        self.loop.add_reader(self.sock, self._on_readable, owner="p2p",
                             writer=(self._on_writable
                                     if self._write_armed else None))

    def _handle_frame(self, frame: bytes) -> None:
        ptype = frame[0]
        if ptype == PACKET_PING:
            with self._cond:
                self._pong_due += 1
            self._schedule_flush()
        elif ptype == PACKET_PONG:
            if self._ping_sent:
                rtt = time.monotonic() - self._ping_sent
                self._ping_sent = 0.0
                with self._cond:
                    self._last_rtt = rtt
                if rtt and telemetry.enabled():
                    _m_keepalive_rtt.observe(rtt)
        elif ptype == PACKET_MSG:
            ch_id, eof = frame[1], frame[2]
            ch = self.channels.get(ch_id)
            if ch is None:
                raise ValueError(f"unknown channel {ch_id:#x}")
            payload = frame[3:]
            ch.recv_len += len(payload)
            if ch.recv_len > ch.desc.recv_message_capacity:
                raise ValueError(
                    f"recv msg exceeds capacity on ch {ch_id:#x}")
            ch.recv_buf.append(payload)
            if eof:
                msg = b"".join(ch.recv_buf)
                ch.recv_buf = []
                ch.recv_len = 0
                self.on_receive(ch_id, msg)
        else:
            raise ValueError(f"unknown packet type {ptype:#x}")

    # ----------------------------------------------------------- timers

    def _ping_tick(self) -> None:
        with self._cond:
            if self._stopped:
                return
        now = time.monotonic()
        if now - self._last_ping >= self.ping_interval:
            self._last_ping = now
            try:
                wire = self.link.seal_frames([bytes([PACKET_PING])])
                self._ping_sent = time.monotonic()
                self._outbuf += wire
                self.send_monitor.update(1)
                self._write_some()
            except Exception as e:
                self._error(e)
                return
        self._timers[0] = self.loop.call_later(
            self.ping_interval, self._ping_tick, owner="p2p")

    def _idle_tick(self) -> None:
        with self._cond:
            if self._stopped:
                return
        idle = time.monotonic() - self._last_recv
        if idle > self.idle_timeout:
            self._error(ConnectionError(
                f"no data for {self.idle_timeout}s (keepalive)"))
            return
        self._timers[1] = self.loop.call_later(
            max(0.5, self.idle_timeout - idle), self._idle_tick,
            owner="p2p")
