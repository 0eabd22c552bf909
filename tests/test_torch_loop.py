"""The port's event-loop plane (p2p/conn/loop.py) against the JAX
package's, on the CPU, tolerance 0 (callback order, wire bytes, every
message delivered).

- ReactorLoop: one script of call_soon, call_later (one timer
  cancelled), and a task that reschedules at once, after a delay, parks,
  is woken and stops (a wake after its stop is a no-op), run on each
  package's loop, logs the same callback order.
- LoopMConnection: a seeded sequence of sends on channels of different
  priorities, queued before the start, over a SecretConnection whose
  node keys and ephemeral X25519 secrets are pinned to the same seeded
  values, puts the same bytes on the wire from the port's LoopMConnection,
  the JAX package's LoopMConnection and the port's threaded MConnection,
  with bursts on and off.
- Cross links over socketpairs deliver every message both ways: a JAX
  loop conn and a port loop conn (encrypted), a port loop conn and a JAX
  threaded MConnection.
- Bounds: a message far above the socket buffer completes through the
  partial-write resumption; frames fed one byte at a time reassemble
  (partial reads); a reader that never drains stalls the sender with the
  queue and the outbuf bounded, and the backlog flows once it reads; a
  blocking send from a foreign thread parks on a full queue and resumes
  (every wait here is on an event or a condition with a deadline of
  seconds, never on a fixed sleep).
- `config.resolve_reactor` of `base.reactor` matches the JAX loop's
  `resolve` spellings.
"""

import socket
import threading
import time

import pytest

from tendermint_tpu.p2p.conn import loop as jloop
from tendermint_tpu.p2p.conn import mconn as jmconn
from tendermint_tpu.p2p.conn import secret as jsecret
import tendermint_tpu.p2p as jp2p
from tendermint_tpu.types.keys import PrivKey as JPrivKey
import tendermint_tpu_torch.p2p as tp2p
from tendermint_tpu_torch.config import resolve_reactor
from tendermint_tpu_torch.p2p.conn import loop as tloop
from tendermint_tpu_torch.p2p.conn import mconn as tmconn
from tendermint_tpu_torch.p2p.conn import secret as tsecret
from tendermint_tpu_torch.p2p.conn.burst import Burst
from tendermint_tpu_torch.types.keys import PrivKey

from test_torch_p2p import CHANNELS, _pin_eph, _sends, run_both, wait_for

@pytest.fixture
def rloop():
    lp = tloop.ReactorLoop(name="tm-reactor-loop-test")
    lp.start()
    yield lp
    lp.stop()


# ------------------------------------------------------------ the loop

def _script(mod) -> list:
    """Run the callback script on a fresh loop of `mod`; its log."""
    lp = mod.ReactorLoop(name="tm-reactor-loop-script")
    log, done = [], threading.Event()
    n = [0]

    def task():
        n[0] += 1
        log.append(f"task{n[0]}")
        return {1: 0.0, 2: 0.25, 3: None}.get(n[0], "stop")

    def start():
        log.append("start")
        lp.call_soon(lambda: log.append("soon1"))
        lp.call_later(0.2, lambda: log.append("later200"))
        lp.call_later(0.1, lambda: log.append("later100"))
        lp.call_later(0.15, lambda: log.append("cancelled")).cancel()
        lp.call_soon(lambda: log.append("soon2"))
        tk = lp.spawn(task, owner="consensus", name="t")
        lp.call_later(0.4, lambda: (log.append("wake"), tk.wake()))
        lp.call_later(0.5, lambda: (log.append("wake2"), tk.wake()))
        lp.call_later(0.6, lambda: (log.append("wake3"), tk.wake()))
        lp.call_later(0.7, lambda: (log.append("end"), done.set()))

    lp.start()
    try:
        lp.call_soon(start)      # from this (foreign) thread
        assert done.wait(10.0)
    finally:
        lp.stop()
    return log


def test_loop_script_runs_in_the_jax_order():
    port, jax = _script(tloop), _script(jloop)
    assert port == jax
    assert port == ["start", "soon1", "soon2", "task1", "task2",
                    "later100", "later200", "task3", "wake", "task4",
                    "wake2", "wake3", "end"]


@pytest.mark.parametrize("mode", ["auto", "loop", "on", "", "threads",
                                  "thread", "off", "0", "none", "bogus"])
def test_reactor_mode_resolves_as_in_jax(monkeypatch, mode):
    monkeypatch.delenv("TM_TPU_REACTOR", raising=False)
    jloop.configure(mode)
    try:
        want = jloop.resolve()
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            resolve_reactor(mode)
        assert str(te.value) == str(e).replace("TM_TPU_REACTOR", "reactor")
        return
    finally:
        jloop.configure("auto")
    assert resolve_reactor(mode) == want


# ------------------------------------------------- wire bytes, pinned

def _handshake(pkg, monkeypatch, burst, a_sock, b_sock, seed=7):
    rng = __import__("numpy").random.RandomState(seed)
    secrets, keys = [rng.bytes(32), rng.bytes(32)], [rng.bytes(32),
                                                     rng.bytes(32)]
    if pkg == "jax":
        _pin_eph(monkeypatch, jsecret, secrets)
        monkeypatch.setenv("TM_TPU_P2P_BURST", "on" if burst else "off")
        nk = [jp2p.NodeKey(JPrivKey.generate(k)) for k in keys]
        make = jsecret.SecretConnection.make
    else:
        _pin_eph(monkeypatch, tsecret, secrets)
        nk = [tp2p.NodeKey(PrivKey.generate(k)) for k in keys]

        def make(conn, k):
            return tsecret.SecretConnection.make(conn, k, burst=burst)
    return run_both(lambda: make(a_sock, nk[0]), lambda: make(b_sock, nk[1]))


def _wire(variant, monkeypatch, burst, seed):
    """The bytes end a puts on the wire for _sends(seed), read raw at
    end b (which counts the frames through its own codec)."""
    pkg = "jax" if variant == "jax-loop" else "port"
    a_sock, b_sock = socket.socketpair()
    lp = None
    try:
        link_a, link_b = _handshake(pkg, monkeypatch, burst, a_sock, b_sock)
        m = jmconn if pkg == "jax" else tmconn
        descs = [m.ChannelDescriptor(c, priority=p, send_queue_capacity=q)
                 for c, p, q in CHANNELS]
        kw = dict(on_receive=lambda c, x: None, send_rate=1e12,
                  recv_rate=1e12)
        if variant == "port-threads":
            conn = tmconn.MConnection(link_a, descs, burst=Burst(on=burst),
                                      **kw)
        elif variant == "port-loop":
            lp = tloop.ReactorLoop(name="tm-reactor-loop-wire")
            conn = tloop.LoopMConnection(lp, link_a, descs,
                                         burst=Burst(on=burst), **kw)
        else:
            lp = jloop.ReactorLoop(name="tm-reactor-loop-wire")
            conn = jloop.LoopMConnection(lp, link_a, descs, **kw)
        if lp is not None:
            lp.start()
        sends = _sends(seed)
        for ch, msg in sends:
            assert conn.send(ch, msg, timeout=5.0)
        want = sum(max(1, -(-len(msg) // 1000)) for _, msg in sends)
        conn.start()
        raw, frames = bytearray(), 0
        b_sock.settimeout(20.0)
        while frames < want:
            chunk = b_sock.recv(65536)
            assert chunk, "end a closed early"
            raw += chunk
            frames += len(link_b.feed_wire(chunk))
        assert frames == want
        conn.stop(join=True)
        return bytes(raw)
    finally:
        if lp is not None:
            lp.stop()
        a_sock.close()
        b_sock.close()


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "per-frame"])
def test_loop_mconn_wire_bytes_equal_jax_and_threads(monkeypatch, burst):
    port = _wire("port-loop", monkeypatch, burst, 5)
    jax = _wire("jax-loop", monkeypatch, burst, 5)
    threads = _wire("port-threads", monkeypatch, burst, 5)
    assert port == jax == threads


# ------------------------------------------------------------ cross links

def _secret_cross(a_sock, b_sock):
    tk = tp2p.NodeKey(PrivKey.generate(b"\x01" * 32))
    jk = jp2p.NodeKey(JPrivKey.generate(b"\x02" * 32))
    return run_both(lambda: tsecret.SecretConnection.make(a_sock, tk),
                    lambda: jsecret.SecretConnection.make(b_sock, jk))


@pytest.mark.parametrize("other", ["jax-loop", "jax-threads"])
def test_cross_links_deliver_every_message(rloop, other):
    a_sock, b_sock = socket.socketpair()
    jl = jloop.ReactorLoop(name="tm-reactor-loop-jax") \
        if other == "jax-loop" else None
    got = {"port": [], "jax": []}
    done = threading.Event()
    sends = _sends(9)

    def recv(name):
        def on(ch, msg):
            got[name].append((ch, msg))
            if len(got["port"]) == len(got["jax"]) == len(sends):
                done.set()
        return on
    conns = []
    try:
        link_t, link_j = _secret_cross(a_sock, b_sock)
        tdescs = [tmconn.ChannelDescriptor(c, priority=p,
                                           send_queue_capacity=100)
                  for c, p, _ in CHANNELS]
        jdescs = [jmconn.ChannelDescriptor(c, priority=p,
                                           send_queue_capacity=100)
                  for c, p, _ in CHANNELS]
        conns.append(tloop.LoopMConnection(rloop, link_t, tdescs,
                                           on_receive=recv("port")))
        if jl is not None:
            jl.start()
            conns.append(jloop.LoopMConnection(jl, link_j, jdescs,
                                               on_receive=recv("jax")))
        else:
            conns.append(jmconn.MConnection(link_j, jdescs,
                                            on_receive=recv("jax")))
        for c in conns:
            c.start()
        for ch, msg in sends:
            assert conns[0].send(ch, msg, timeout=10.0)
            assert conns[1].send(ch, msg[::-1], timeout=10.0)
        assert done.wait(20.0), (len(got["port"]), len(got["jax"]))
        # per channel, in order
        for ch, _, _ in CHANNELS:
            want = [m for c, m in sends if c == ch]
            assert [m for c, m in got["jax"] if c == ch] == want
            assert [m for c, m in got["port"] if c == ch] == \
                [m[::-1] for m in want]
    finally:
        for c in conns:
            c.stop(join=True)
        if jl is not None:
            jl.stop()
        a_sock.close()
        b_sock.close()


# ----------------------------------------------------------------- bounds

def _plain_pair(rloop, on_b, cap=100, sndbuf=None):
    a, b = socket.socketpair()
    if sndbuf:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
    ca = tloop.LoopMConnection(
        rloop, tmconn.PlainFramedConn(a),
        [tmconn.ChannelDescriptor(1, send_queue_capacity=cap)],
        on_receive=lambda ch, m: None)
    cb = tloop.LoopMConnection(
        rloop, tmconn.PlainFramedConn(b), [tmconn.ChannelDescriptor(1)],
        on_receive=on_b)
    return ca, cb, (a, b)


def test_partial_write_resumption(rloop):
    got, done = [], threading.Event()
    ca, cb, socks = _plain_pair(
        rloop, lambda ch, m: (got.append(m), done.set()), sndbuf=4096)
    big = bytes(range(256)) * 2000      # 512000 B, far above the buffer
    try:
        ca.start()
        cb.start()
        assert ca.send(1, big)
        assert done.wait(20.0)
        assert got == [big]
    finally:
        ca.stop(join=True)
        cb.stop(join=True)


def test_partial_reads_reassemble():
    a_sock, b_sock = socket.socketpair()
    try:
        sa, sb = run_both(
            lambda: tsecret.SecretConnection.make(
                a_sock, tp2p.NodeKey(PrivKey.generate(b"\x11" * 32))),
            lambda: tsecret.SecretConnection.make(
                b_sock, tp2p.NodeKey(PrivKey.generate(b"\x22" * 32))))
        kinds = [bytes([tmconn.PACKET_MSG, 0x30, 0]) + b"m" * 333,
                 bytes([tmconn.PACKET_MSG, 0x30, 1]) + b"z",
                 bytes([tmconn.PACKET_PING])]
        wire = sa.seal_frames(list(kinds))
        got = []
        for i in range(len(wire)):      # one byte at a time
            got.extend(sb.feed_wire(wire[i:i + 1]))
        assert got == kinds
    finally:
        a_sock.close()
        b_sock.close()


def test_slow_reader_stalls_the_sender_within_bounds(rloop):
    got, cond = [], threading.Condition()

    def on_b(ch, m):
        with cond:
            got.append(m)
            cond.notify_all()
    ca, cb, socks = _plain_pair(rloop, on_b, cap=4, sndbuf=4096)
    try:
        ca.start()                # b is not read: a stalled remote
        msg = b"q" * 900
        accepted = 0
        for _ in range(2000):
            if ca.try_send(1, msg):
                accepted += 1
            else:
                time.sleep(0.002)
        # the channel queue (4) + the outbuf's high water + the kernel's
        # buffers: far below the 2000 offered
        assert accepted < 400
        assert len(ca._outbuf) <= tloop.OUTBUF_HIGH_WATER + 64 * 1100
        cb.start()                # the reader drains: the backlog flows
        with cond:
            assert cond.wait_for(lambda: len(got) >= accepted - 8, 20.0)
    finally:
        ca.stop(join=True)
        cb.stop(join=True)


def test_blocking_send_from_a_foreign_thread_resumes(rloop):
    got, done = [], threading.Event()

    def on_b(ch, m):
        got.append(m)
        if len(got) == 300:
            done.set()
    ca, cb, socks = _plain_pair(rloop, on_b)
    sent = threading.Event()

    def sender():
        for i in range(300):
            assert ca.send(1, b"m%03d" % i, timeout=10.0)
        sent.set()
    try:
        ca.start()
        cb.start()
        t = threading.Thread(target=sender, daemon=True)
        t.start()
        assert done.wait(20.0) and sent.wait(10.0)
        assert got == [b"m%03d" % i for i in range(300)]
        t.join(10.0)
    finally:
        ca.stop(join=True)
        cb.stop(join=True)


def test_loop_counts_its_callbacks_and_busy_time(rloop):
    done = threading.Event()
    rloop.call_later(0.05, done.set)
    assert done.wait(10.0)
    assert wait_for(lambda: rloop.stats["timer"] >= 1, 10.0)
    st = dict(rloop.stats)
    assert st["ticks"] >= 1 and st["soon"] >= 1
    assert 0.0 <= rloop.busy_share() < 1.0
