"""The port's p2p plane (tendermint_tpu_torch.p2p) against the JAX
package's, on the CPU, tolerance 0: bytes, verdicts, exception classes
and messages.

- Primitives: the RFC 7748 (X25519), 5869 (HKDF-SHA256) and 8439
  (ChaCha20-Poly1305) vectors through the port's purecrypto, the port's
  native AEAD (csrc/aead.cpp, built by g++ here) and `cryptography`; the
  native bursts against the JAX package's on seeded frame arrays; a
  tampered frame raises on both; a failed build or self-check raises.
- SecretConnection: with both packages' ephemeral keys pinned to the same
  seeded secrets, the handshake transcript and the sealed frames of a
  seeded message sequence are byte-equal, bursts on and off; a JAX and a
  port connection authenticate each other and talk, all four burst
  combinations.
- MConnection: the frames of a seeded sequence of sends on channels of
  different priorities equal the JAX package's, in order; large messages
  reassemble; an unknown channel fails as in JAX; a JAX and a port
  MConnection talk over a socketpair.
- Identity and addresses: NodeKey files, NetAddress parsing and
  classification, NodeInfo bytes and compatibility errors, the trust
  metric on seeded event sequences.
- Switch: a JAX and a port switch handshake (encrypted) and route; a
  network mismatch and a wrong dialled id fail with JAX's errors; a
  disconnect reaches the reactors; the dial tiebreak; bans and their
  escalation.

Every wait is bounded (at most 30 s) and every socket is closed in a
finally.
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey, X25519PublicKey)
from cryptography.hazmat.primitives.ciphers.aead import (
    ChaCha20Poly1305 as OsslAead)
from cryptography.hazmat.primitives.hashes import SHA256
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

import tendermint_tpu.p2p as jp2p
from tendermint_tpu import native as jnative
from tendermint_tpu.config import P2PConfig as JP2PConfig
from tendermint_tpu.p2p import switch as jswitch
from tendermint_tpu.p2p import trust as jtrust
from tendermint_tpu.p2p.conn import mconn as jmconn
from tendermint_tpu.p2p.conn import secret as jsecret
from tendermint_tpu.p2p.test_util import make_switch as jmake_switch
from tendermint_tpu.storage.db import MemDB as JMemDB
from tendermint_tpu.types.keys import PrivKey as JPrivKey
import tendermint_tpu_torch.p2p as tp2p
from tendermint_tpu_torch import native
from tendermint_tpu_torch.config import P2PConfig
from tendermint_tpu_torch.consensus import compact as tcompact
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.p2p import switch as tswitch
from tendermint_tpu_torch.p2p import trust as ttrust
from tendermint_tpu_torch.p2p.conn import mconn as tmconn
from tendermint_tpu_torch.p2p.conn import purecrypto as tpc
from tendermint_tpu_torch.p2p.conn import secret as tsecret
from tendermint_tpu_torch.p2p.conn.burst import Burst
from tendermint_tpu_torch.p2p.test_util import (connect_switches,
                                                make_connected_switches,
                                                make_switch)
from tendermint_tpu_torch.storage.db import MemDB
from tendermint_tpu_torch.types.keys import PrivKey

WAIT_S = 30.0


def wait_for(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def run_both_outcomes(fa, fb, timeout=WAIT_S):
    """fa() and fb() on two threads (a handshake blocks on its other
    end); -> ({name: result}, {name: exception})."""
    out, err = {}, {}

    def run(name, f):
        try:
            out[name] = f()
        except Exception as e:  # returned to the caller
            err[name] = e
    ts = [threading.Thread(target=run, args=("a", fa), name="end-a"),
          threading.Thread(target=run, args=("b", fb), name="end-b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "handshake did not end"
    return out, err


def run_both(fa, fb, timeout=WAIT_S):
    """Both results, re-raising the first end's exception, else the
    second's."""
    out, err = run_both_outcomes(fa, fb, timeout)
    for name in ("a", "b"):
        if name in err:
            raise err[name]
    return out["a"], out["b"]


def read_msg(sc, n):
    """One message of n bytes written with one write(): its frames."""
    buf = sc.read()
    while len(buf) < n:
        buf += sc.read()
    return buf


# ------------------------------------------------------------ primitives

X25519_VECTORS = [
    # RFC 7748 5.2, the first scalar-multiplication vector
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    # RFC 7748 6.1: Alice's public key, then the shared secret with Bob
    ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
     "0900000000000000000000000000000000000000000000000000000000000000",
     "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"),
    ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
     "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f",
     "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"),
]


def _ossl_x25519(k, u):
    return X25519PrivateKey.from_private_bytes(k).exchange(
        X25519PublicKey.from_public_bytes(u))


@pytest.mark.parametrize("route", ["purecrypto", "cryptography"])
@pytest.mark.parametrize("k,u,want", X25519_VECTORS)
def test_x25519_rfc7748(route, k, u, want):
    f = tpc.x25519 if route == "purecrypto" else _ossl_x25519
    assert f(bytes.fromhex(k), bytes.fromhex(u)) == bytes.fromhex(want)


@pytest.mark.parametrize("route", ["purecrypto", "cryptography"])
def test_hkdf_rfc5869_case1(route):
    ikm, info = bytes.fromhex("0b" * 22), bytes.fromhex("f0f1f2f3f4f5f6f7f8f9")
    salt = bytes.fromhex("000102030405060708090a0b0c")
    if route == "purecrypto":
        okm = tpc.hkdf_sha256(ikm, info, 42, salt=salt)
    else:
        okm = HKDF(algorithm=SHA256(), length=42, salt=salt,
                   info=info).derive(ikm)
    assert okm == bytes.fromhex(
        "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56"
        "ecc4c5bf34007208d5b887185865")


def test_hkdf_empty_salt_matches_cryptography():
    """The handshake's HKDF runs with no salt on both routes."""
    ikm, info = bytes(range(32)), b"tendermint_tpu/secret/" + bytes(64)
    assert tpc.hkdf_sha256(ikm, info, 96) == HKDF(
        algorithm=SHA256(), length=96, salt=None, info=info).derive(ikm)


RFC8439 = dict(
    key=bytes(range(0x80, 0xA0)),
    nonce=bytes.fromhex("070000004041424344454647"),
    aad=bytes.fromhex("50515253c0c1c2c3c4c5c6c7"),
    pt=(b"Ladies and Gentlemen of the class of '99: If I could offer you "
        b"only one tip for the future, sunscreen would be it."))


@pytest.mark.parametrize("route", ["purecrypto", "native", "cryptography"])
def test_chacha20poly1305_rfc8439(route):
    v = RFC8439
    if route == "purecrypto":
        ct = tpc.ChaCha20Poly1305(v["key"]).encrypt(v["nonce"], v["pt"],
                                                     v["aad"])
    elif route == "native":
        ct = native.aead_seal_one(v["key"], v["nonce"], v["aad"], v["pt"])
    else:
        ct = OsslAead(v["key"]).encrypt(v["nonce"], v["pt"], v["aad"])
    assert ct[:16] == bytes.fromhex("d31a8d34648e60db7b86afbc53ef7ec2")
    assert ct[-16:] == bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")
    assert len(ct) == len(v["pt"]) + 16
    assert OsslAead(v["key"]).decrypt(v["nonce"], ct, v["aad"]) == v["pt"]


def _frames(seed, n):
    rng = np.random.RandomState(seed)
    sizes = [0, 1, 1024, 1023, 17] + [int(rng.randint(0, 1025))
                                       for _ in range(n)]
    return rng.bytes(32), [rng.bytes(z) for z in sizes]


@pytest.mark.parametrize("seed,nonce", [(1, 0), (2, 7), (3, 2 ** 32 - 3),
                                        (4, 2 ** 64 - 2)])
def test_native_bursts_match_jax_and_per_frame(seed, nonce):
    key, chunks = _frames(seed, 40)
    wire = native.aead_seal_burst(key, nonce, chunks)
    assert wire == jnative.aead_seal_burst(key, nonce, chunks)
    # the per-frame AEAD's bytes: be32 length || seal(be16 len || chunk)
    per = b"".join(
        struct.pack(">I", len(c) + 18) + OsslAead(key).encrypt(
            (nonce + i).to_bytes(12, "little"), struct.pack(">H", len(c)) + c,
            b"") for i, c in enumerate(chunks))
    assert wire == per
    sealed = native.split_wire(wire)
    plains = native.aead_open_burst(key, nonce, sealed)
    assert plains == jnative.aead_open_burst(key, nonce, sealed)
    assert [p[2:] for p in plains] == chunks


@pytest.mark.parametrize("where", ["ciphertext", "tag"])
def test_tampered_frame_raises_on_both(where):
    key, chunks = _frames(5, 6)
    sealed = native.split_wire(native.aead_seal_burst(key, 3, chunks))
    bad = bytearray(sealed[4])
    bad[0 if where == "ciphertext" else -1] ^= 0x10
    frames = sealed[:4] + [bytes(bad)] + sealed[5:]
    with pytest.raises(native.AeadTagError) as te:
        native.aead_open_burst(key, 3, frames)
    with pytest.raises(jnative.AeadTagError) as je:
        jnative.aead_open_burst(key, 3, frames)
    assert str(te.value) == str(je.value)


def test_oversized_chunk_refused_before_the_native_call():
    with pytest.raises(ValueError, match="frame chunk exceeds 1024B"):
        native.aead_seal_burst(bytes(32), 0, [bytes(1025)])


def test_failed_aead_build_raises_and_nothing_falls_back(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "aead.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "AEAD_SRC", bad)
    with pytest.raises(RuntimeError, match="building aead.cpp failed"):
        native.aead_build()
    # a process that has not loaded it yet: the first frame raises
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_aead_checked", False)
    with pytest.raises(RuntimeError, match="building aead.cpp failed"):
        native.aead_seal_burst(bytes(32), 0, [b"x"])


def test_failed_self_check_raises():
    class Zeros:  # a library whose seal writes nothing
        def tm_aead_seal_one(self, *args):
            pass
    with pytest.raises(RuntimeError, match="RFC 8439 2.8.2 vector"):
        native._aead_self_check(Zeros())


# ------------------------------------------------------- SecretConnection

class Tap:
    """A socket end that records every byte sent through it."""

    def __init__(self, sock):
        self.sock = sock
        self.sent = bytearray()

    def sendall(self, data):
        self.sent += data
        self.sock.sendall(data)

    def recv(self, n):
        return self.sock.recv(n)

    def shutdown(self, how):
        self.sock.shutdown(how)

    def close(self):
        self.sock.close()


def _pin_eph(monkeypatch, module, seeds):
    """module._eph_keypair hands the X25519 key of seeds[0] to the
    handshake on thread end-a and of seeds[1] to end-b (both packages'
    handles are cryptography keys)."""
    def eph():
        end = threading.current_thread().name
        priv = X25519PrivateKey.from_private_bytes(
            seeds[{"end-a": 0, "end-b": 1}[end]])
        return priv, priv.public_key().public_bytes_raw()
    monkeypatch.setattr(module, "_eph_keypair", eph)


def _messages(seed):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(z)) for z in
            [0, 1, 1024, 1025, 3000] + list(rng.randint(0, 2500, 12))]


def _transcript(pkg, monkeypatch, burst, seed):
    """Bytes each end of a handshake and a seeded exchange sends."""
    rng = np.random.RandomState(seed)
    secrets = [rng.bytes(32), rng.bytes(32)]
    keys = [rng.bytes(32), rng.bytes(32)]
    a_sock, b_sock = socket.socketpair()
    try:
        a, b = Tap(a_sock), Tap(b_sock)
        if pkg == "port":
            _pin_eph(monkeypatch, tsecret, secrets)
            nk = [tp2p.NodeKey(PrivKey.generate(k)) for k in keys]

            def make(conn, k):
                return tsecret.SecretConnection.make(conn, k, burst=burst)
        else:
            _pin_eph(monkeypatch, jsecret, secrets)
            monkeypatch.setenv("TM_TPU_P2P_BURST", "on" if burst else "off")
            nk = [jp2p.NodeKey(JPrivKey.generate(k)) for k in keys]
            make = jsecret.SecretConnection.make
        sa, sb = run_both(lambda: make(a, nk[0]), lambda: make(b, nk[1]))
        msgs = _messages(seed + 1)
        got = []
        for m in msgs:
            sa.write(m)
            got.append(read_msg(sb, len(m)))
            sb.write(m[::-1])
            assert read_msg(sa, len(m)) == m[::-1]
        sa.write_many([m[:1024] for m in msgs[:6]])
        many = [sb.read() for _ in range(6)]
        assert got == msgs and many == [m[:1024] for m in msgs[:6]]
        assert sa.remote_pubkey == nk[1].pubkey
        assert sb.remote_pubkey == nk[0].pubkey
        return bytes(a.sent), bytes(b.sent)
    finally:
        a_sock.close()
        b_sock.close()


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "per-frame"])
def test_handshake_and_frames_byte_equal_to_jax(monkeypatch, burst):
    """Same node keys and ephemeral secrets: the handshake transcript
    and every sealed frame of a seeded exchange are the same bytes."""
    tsecret.frame_stats.reset()
    port = _transcript("port", monkeypatch, burst, 11)
    jax = _transcript("jax", monkeypatch, burst, 11)
    assert port == jax
    st = tsecret.frame_stats.snapshot()
    if burst:
        assert st["sealed_frame"] == st["opened_frame"] == 0
        assert st["sealed_burst"] > 0 and st["opened_burst"] > 0
    else:
        assert st["sealed_burst"] == st["opened_burst"] == 0
        assert st["sealed_frame"] > 0 and st["opened_frame"] > 0


@pytest.mark.parametrize("port_burst", [True, False])
@pytest.mark.parametrize("jax_burst", [True, False])
def test_jax_and_port_secret_connections_interoperate(monkeypatch,
                                                      port_burst,
                                                      jax_burst):
    monkeypatch.setenv("TM_TPU_P2P_BURST", "on" if jax_burst else "off")
    s1, s2 = socket.socketpair()
    try:
        tk = tp2p.NodeKey(PrivKey.generate(b"\x01" * 32))
        jk = jp2p.NodeKey(JPrivKey.generate(b"\x02" * 32))
        t, j = run_both(
            lambda: tsecret.SecretConnection.make(s1, tk, burst=port_burst),
            lambda: jsecret.SecretConnection.make(s2, jk))
        assert t.remote_pubkey == jk.pubkey and j.remote_pubkey == tk.pubkey
        for m in _messages(3):
            t.write(m)
            assert read_msg(j, len(m)) == m
            j.write(m[::-1])
            assert read_msg(t, len(m)) == m[::-1]
        t.write_many([b"a", b"bc", b""])
        j.write_many([b"x" * 1024, b"y"])
        assert [j.read() for _ in range(3)] == [b"a", b"bc", b""]
        got = t.read_burst()
        while len(got) < 2:
            got += t.read_burst()
        assert got == [b"x" * 1024, b"y"]
    finally:
        s1.close()
        s2.close()


def test_forged_identity_refused_as_in_jax(monkeypatch):
    """A peer whose auth message signs another challenge is refused with
    the JAX package's error."""
    def forge(module, cls_key, seed):
        nk = cls_key(seed)
        real = nk.sign
        monkeypatch.setattr(nk, "sign", lambda m: real(m[::-1]))
        return nk
    errors = []
    for mod, NK, PK in ((tsecret, tp2p.NodeKey, PrivKey),
                        (jsecret, jp2p.NodeKey, JPrivKey)):
        s1, s2 = socket.socketpair()
        try:
            good = NK(PK.generate(b"\x01" * 32))
            bad = forge(mod, lambda s: NK(PK.generate(s)), b"\x02" * 32)
            with pytest.raises(ValueError) as e:
                run_both(lambda: mod.SecretConnection.make(s1, good),
                         lambda: mod.SecretConnection.make(s2, bad))
            errors.append(str(e.value))
        finally:
            s1.close()
            s2.close()
    assert errors[0] == errors[1] == \
        "secret handshake: invalid identity signature"


# ----------------------------------------------------------- MConnection

class SinkSock:
    """A socket end that records what is sent and blocks recv until
    closed (then EOF)."""

    def __init__(self):
        self.sent = bytearray()
        self.lock = threading.Lock()
        self.closed = threading.Event()

    def sendall(self, data):
        with self.lock:
            self.sent += data

    def recv(self, n):
        self.closed.wait(WAIT_S)
        return b""

    def shutdown(self, how):
        self.closed.set()

    def close(self):
        self.closed.set()


CHANNELS = [(0x20, 5, 100), (0x21, 10, 100), (0x22, 5, 100), (0x23, 1, 2),
            (0x30, 5, 100)]


def _sends(seed):
    rng = np.random.RandomState(seed)
    out = []
    for ch, _, cap in CHANNELS:
        for _ in range(min(cap, 6)):
            out.append((ch, rng.bytes(int(rng.randint(0, 3500)))))
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _mconn_frames(pkg, monkeypatch, burst, seed):
    sink = SinkSock()
    if pkg == "port":
        descs = [tmconn.ChannelDescriptor(c, priority=p, send_queue_capacity=q)
                 for c, p, q in CHANNELS]
        mc = tmconn.MConnection(tmconn.PlainFramedConn(sink), descs,
                                on_receive=lambda c, m: None,
                                send_rate=1e12, recv_rate=1e12,
                                burst=Burst(on=burst))
    else:
        monkeypatch.setenv("TM_TPU_P2P_BURST", "on" if burst else "off")
        descs = [jmconn.ChannelDescriptor(c, priority=p, send_queue_capacity=q)
                 for c, p, q in CHANNELS]
        mc = jmconn.MConnection(jmconn.PlainFramedConn(sink), descs,
                                on_receive=lambda c, m: None,
                                send_rate=1e12, recv_rate=1e12)
    sends = _sends(seed)
    for ch, m in sends:
        assert mc.send(ch, m, timeout=1.0)
    want = sum(4 + 3 + len(m) + 4 * (max(0, len(m) - 1) // 1000) + 3 *
               (max(0, len(m) - 1) // 1000) for _, m in sends)
    mc.start()
    try:
        assert wait_for(lambda: len(sink.sent) >= want)
        with sink.lock:
            return bytes(sink.sent)
    finally:
        mc.stop(join=True)


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "per-frame"])
@pytest.mark.parametrize("seed", [1, 2])
def test_mconn_frames_match_jax_in_order(monkeypatch, burst, seed):
    port = _mconn_frames("port", monkeypatch, burst, seed)
    jax = _mconn_frames("jax", monkeypatch, burst, seed)
    assert port == jax
    # and they are the priority-ordered packets of every message
    frames = tmconn.PlainFramedConn(None)
    frames._rbuf += port
    pkts = frames.feed_wire(b"")
    assert sum(p[2] for p in pkts) == len(_sends(seed))


def _mconn_pair(a_pkg, b_pkg, received, errors):
    s1, s2 = socket.socketpair()
    conns = []
    for pkg, sock, name in ((a_pkg, s1, "a"), (b_pkg, s2, "b")):
        m = tmconn if pkg == "port" else jmconn
        descs = [m.ChannelDescriptor(0x10), m.ChannelDescriptor(0x11,
                                                                priority=3)]
        conns.append(m.MConnection(
            m.PlainFramedConn(sock), descs,
            on_receive=lambda c, msg, n=name: received[n].append((c, msg)),
            on_error=lambda e, n=name: errors[n].append(e)))
    for c in conns:
        c.start()
    return conns, (s1, s2)


def test_mconn_large_message_reassembles_and_interoperates():
    received, errors = {"a": [], "b": []}, {"a": [], "b": []}
    conns, socks = _mconn_pair("port", "jax", received, errors)
    try:
        big = bytes(range(256)) * 400          # 102400 bytes, 103 packets
        assert conns[0].send(0x10, big)
        assert conns[1].send(0x11, big[::-1])
        assert conns[0].send(0x11, b"")
        assert wait_for(lambda: len(received["b"]) == 2
                        and len(received["a"]) == 1)
        # one message a channel: the empty one on 0x11 (priority 3)
        # overtakes the 103 packets of 0x10's
        assert sorted(received["b"]) == [(0x10, big), (0x11, b"")]
        assert received["a"] == [(0x11, big[::-1])]
        assert not errors["a"] and not errors["b"]
    finally:
        for c in conns:
            c.stop(join=True)
        for s in socks:
            s.close()


def test_mconn_unknown_channel_fails_as_in_jax():
    # sending on a channel the connection does not have
    for m in (tmconn, jmconn):
        c = m.MConnection(m.PlainFramedConn(SinkSock()),
                          [m.ChannelDescriptor(0x10)], lambda c, x: None)
        assert c.send(0x99, b"x") is False and c.try_send(0x99, b"x") is False
        assert c.can_send(0x99) is False
    # receiving a packet on one: the same error class and message
    msgs = []
    for m in (tmconn, jmconn):
        errs = []
        c = m.MConnection(m.PlainFramedConn(SinkSock()),
                          [m.ChannelDescriptor(0x10)], lambda c, x: None,
                          on_error=errs.append)
        with pytest.raises(ValueError) as e:
            c._handle_frame(bytes([m.PACKET_MSG, 0x42, 1]) + b"payload")
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            c._handle_frame(bytes([0x09]))
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:] == ["unknown channel 0x42",
                                    "unknown packet type 0x9"]


# -------------------------------------------------- identity and addresses

def test_node_key_files_round_trip_across_packages(tmp_path):
    p1, p2 = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tk = tp2p.NodeKey.load_or_generate(p1)
    assert jp2p.NodeKey.load(p1).id() == tk.id()
    jk = jp2p.NodeKey.load_or_generate(p2)
    assert tp2p.NodeKey.load(p2).id() == jk.id()
    seeded = tp2p.NodeKey(PrivKey.generate(b"\x07" * 32))
    seeded.save(p1)
    jp2p.NodeKey(JPrivKey.generate(b"\x07" * 32)).save(p2)
    assert open(p1).read() == open(p2).read()
    assert seeded.id() == tp2p.pubkey_to_id(seeded.pubkey) == \
        jp2p.pubkey_to_id(seeded.pubkey)


_ID = "ab" * 20
ADDRESSES = [
    "127.0.0.1:46656", "8.8.8.8:26656", f"{_ID}@10.0.0.1:26656",
    "0.0.0.0:1", "255.255.255.255:80", "192.168.1.7:65535", "[::1]:80",
    "::1:80", "169.254.3.4:99", "224.0.0.1:5", "node.example:1234",
    "nohost", "zz@1.2.3.4:80", "1.2.3.4:0", "1.2.3.4:65536",
    "1.2.3.4:port", f"{_ID[:-2]}@1.2.3.4:80", f"{_ID}@1.2.3.4",
]


def _parse(pkg, s):
    NetAddress = tp2p.NetAddress if pkg == "port" else jp2p.NetAddress
    try:
        a = NetAddress.from_string(s)
    except Exception as e:
        return type(e).__name__, str(e)
    other = NetAddress.from_string("10.0.99.9:80")
    return (str(a), a.to_obj(), a.dial_string(), a.local(), a.routable(),
            a.valid(), a.same_group(other))


@pytest.mark.parametrize("s", ADDRESSES)
def test_netaddress_parsing_and_classification_match_jax(s):
    assert _parse("port", s) == _parse("jax", s)


def _infos(pkg, **kw):
    NodeInfo = tp2p.NodeInfo if pkg == "port" else jp2p.NodeInfo
    pk = PrivKey.generate(b"\x03" * 32).pubkey.ed25519
    return NodeInfo(pubkey=pk, **kw)


def test_node_info_bytes_match_with_compact_capabilities():
    from tendermint_tpu.consensus import compact as jcompact
    from tendermint_tpu.types import encoding as jenc
    from tendermint_tpu_torch.types import encoding as tenc
    assert tcompact.wire_capabilities() == jcompact.wire_capabilities()
    for caps in (tcompact.wire_capabilities(),
                 tcompact.wire_capabilities(False, False), ["compact/1"]):
        kw = dict(moniker="n0", network="bench-socknet",
                  channels=[0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40],
                  listen_addr="127.0.0.1:4000", other=caps)
        t, j = _infos("port", **kw), _infos("jax", **kw)
        assert tenc.cdumps(t.to_obj()) == jenc.cdumps(j.to_obj())
        assert t.id == j.id
        back = tp2p.NodeInfo.from_obj(json.loads(tenc.cdumps(t.to_obj())))
        assert back == t


COMPAT = [
    (dict(network="a"), dict(network="b")),
    (dict(version="1.0.0"), dict(version="2.0.0")),
    (dict(version="1.0.0"), dict(version="1.9.3")),
    (dict(channels=[1, 2]), dict(channels=[3])),
    (dict(channels=[1, 2]), dict(channels=[2, 9])),
    (dict(channels=[]), dict(channels=[3])),
]


def _outcome(f):
    try:
        f()
        return None
    except Exception as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("mine,theirs", COMPAT)
def test_compatible_with_errors_match_jax(mine, theirs):
    got = _outcome(lambda: _infos("port", **mine).compatible_with(
        _infos("port", **theirs)))
    want = _outcome(lambda: _infos("jax", **mine).compatible_with(
        _infos("jax", **theirs)))
    assert got == want


@pytest.mark.parametrize("kw", [dict(channels=list(range(17))),
                                dict(channels=[1, 1]), dict()])
def test_node_info_validate_matches_jax(kw):
    assert _outcome(lambda: _infos("port", **kw).validate()) == \
        _outcome(lambda: _infos("jax", **kw).validate())
    short = tp2p.NodeInfo(pubkey=b"\x01" * 31)
    jshort = jp2p.NodeInfo(pubkey=b"\x01" * 31)
    assert _outcome(short.validate) == _outcome(jshort.validate)


def _trust_run(mod, seed):
    rng = np.random.RandomState(seed)
    now = [0.0]
    m = mod.TrustMetric(interval_s=5.0, now_fn=lambda: now[0])
    out = []
    for _ in range(200):
        r = rng.randint(0, 4)
        if r == 0:
            m.good_events(float(rng.randint(1, 4)))
        elif r == 1:
            m.bad_events(float(rng.randint(1, 11)))
        else:
            now[0] += float(rng.randint(0, 40)) / 10.0
        out.append((m.trust_value(), m.trust_score(), m.to_obj()))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trust_metric_matches_jax_on_seeded_events(seed):
    assert _trust_run(ttrust, seed) == _trust_run(jtrust, seed)


def test_trust_store_persists_the_jax_bytes():
    dbs = []
    for mod, DB in ((ttrust, MemDB), (jtrust, JMemDB)):
        db = DB()
        store = mod.TrustMetricStore(db)
        store.get_metric("aa").bad_events(3)
        store.get_metric("bb").good_events(2)
        store.save()
        dbs.append(db.get(b"trust-metrics"))
        assert mod.TrustMetricStore(db).metrics.keys() == {"aa", "bb"}
    assert dbs[0] == dbs[1]


# ----------------------------------------------------------------- switch

class EchoReactor(tp2p.Reactor):
    def __init__(self, ch_id=0x10, echo=False, base=tp2p.Reactor):
        base.__init__(self, "echo")
        self.ch_id = ch_id
        self.echo = echo
        self.received, self.added, self.removed = [], [], []

    def get_channels(self):
        return [tp2p.ChannelDescriptor(self.ch_id)]

    def add_peer(self, peer):
        self.added.append(peer.id)

    def remove_peer(self, peer, reason):
        self.removed.append(peer.id)

    def receive(self, ch_id, peer, msg):
        self.received.append((peer.id, msg))
        if self.echo:
            peer.try_send(ch_id, b"echo:" + msg)


class JEchoReactor(jp2p.Reactor):
    """The same reactor on the JAX package's base."""

    def __init__(self, ch_id=0x10, echo=False):
        EchoReactor.__init__(self, ch_id, echo, base=jp2p.Reactor)

    def get_channels(self):
        return [jp2p.ChannelDescriptor(self.ch_id)]

    add_peer = EchoReactor.add_peer
    remove_peer = EchoReactor.remove_peer
    receive = EchoReactor.receive


def _switches():
    t = make_switch(network="net", seed=b"\x01" * 32, encrypt=True)
    j = jmake_switch(network="net", seed=b"\x02" * 32, encrypt=True)
    t.add_reactor("echo", EchoReactor(echo=False))
    j.add_reactor("echo", JEchoReactor(echo=True))
    t.start()
    j.start()
    return t, j


def test_jax_and_port_switches_handshake_and_route():
    t, j = _switches()
    try:
        addr = j.listen("127.0.0.1", 0)
        peer = t.dial_peer(addr)
        assert peer.id == j.node_info.id
        assert wait_for(lambda: j.peers.size() == 1)
        assert j.peers.list()[0].id == t.node_info.id
        for m in (b"hello", bytes(5000), b""):
            assert peer.send(0x10, m)
        r = t.reactor("echo")
        assert wait_for(lambda: len(r.received) == 3)
        assert [m for _, m in r.received] == [b"echo:hello",
                                              b"echo:" + bytes(5000), b"echo:"]
        # and the other way round: the JAX switch dials the port's
        t2 = make_switch(network="net", seed=b"\x05" * 32, encrypt=True)
        t2.add_reactor("echo", EchoReactor(echo=True))
        t2.start()
        try:
            p = j.dial_peer(t2.listen("127.0.0.1", 0))
            assert p.id == t2.node_info.id
            j.broadcast(0x10, b"flood")
            assert wait_for(lambda: t2.reactor("echo").received)
            assert wait_for(lambda: any(m == b"echo:flood" for _, m in
                                        j.reactor("echo").received))
        finally:
            t2.stop()
    finally:
        t.stop()
        j.stop()


def _dial_error(dialer, listener, addr_of):
    addr = listener.listen("127.0.0.1", 0)
    with pytest.raises(Exception) as e:
        dialer.dial_peer(addr_of(addr))
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", ["network", "wrong-id"])
def test_refusals_carry_the_jax_errors(case):
    got = []
    for mk, R in ((make_switch, EchoReactor), (jmake_switch, JEchoReactor)):
        a = mk(network="chain-A", seed=b"\x01" * 32, encrypt=True)
        b = mk(network="chain-A" if case == "wrong-id" else "chain-B",
               seed=b"\x02" * 32, encrypt=True)
        for sw in (a, b):
            sw.add_reactor("echo", R())
            sw.start()
        try:
            wrong = tp2p.pubkey_to_id(b"\xff" * 32)
            got.append(_dial_error(
                a, b, (lambda ad: type(ad)(ad.ip, ad.port, wrong))
                if case == "wrong-id" else (lambda ad: ad)))
            assert a.peers.size() == 0
        finally:
            a.stop()
            b.stop()
    assert got[0] == got[1]
    wrong = tp2p.pubkey_to_id(b"\xff" * 32)
    other = make_switch(seed=b"\x02" * 32).node_info.id
    assert got[0][1] == ("network mismatch: 'chain-A' vs 'chain-B'"
                         if case == "network" else
                         f"dialed {wrong} but got {other}")


def test_peer_disconnect_reaches_the_reactors():
    rs = [EchoReactor(), EchoReactor()]
    sws = make_connected_switches(2, lambda i: {"echo": rs[i]},
                                  encrypt=True)
    try:
        peer = sws[0].peers.list()[0]
        sws[0].stop_peer_for_error(peer, RuntimeError("test"))
        assert rs[0].removed == [peer.id]
        assert sws[0].peers.size() == 0
        assert wait_for(lambda: sws[1].peers.size() == 0)
        assert rs[1].removed == [sws[0].node_info.id]
    finally:
        for sw in sws:
            sw.stop()


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_dial_tiebreak_agrees_with_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        a, b = rng.bytes(20).hex(), rng.bytes(20).hex()
        for new_out in (True, False):
            for old_out in (True, False):
                assert tswitch.dial_tiebreak_keep_new(a, b, new_out, old_out) \
                    == jswitch.dial_tiebreak_keep_new(a, b, new_out, old_out)
                # both ends agree on the survivor
                if new_out != old_out:
                    assert tswitch.dial_tiebreak_keep_new(
                        a, b, new_out, old_out) != \
                        tswitch.dial_tiebreak_keep_new(b, a, new_out, old_out)


def test_ban_refuses_the_banned_id_at_the_handshake():
    msgs = []
    for mk, R in ((make_switch, EchoReactor), (jmake_switch, JEchoReactor)):
        a = mk(seed=b"\x01" * 32, encrypt=True)
        b = mk(seed=b"\x02" * 32, encrypt=True)
        for sw in (a, b):
            sw.add_reactor("echo", R())
            sw.start()
        s1, s2 = socket.socketpair()
        try:
            a.ban_peer(b.node_info.id, reason="test")
            assert a.is_banned(b.node_info.id)
            _, err = run_both_outcomes(
                lambda: a.add_peer_from_socket(s1, False, None),
                lambda: b.add_peer_from_socket(s2, True, None))
            msgs.append((type(err["a"]).__name__, str(err["a"])))
            assert "b" in err
            assert a.peers.size() == 0 and b.peers.size() == 0
        finally:
            a.stop()
            b.stop()
            s1.close()
            s2.close()
    banned = make_switch(seed=b"\x02" * 32).node_info.id
    assert msgs[0] == msgs[1] == ("SwitchError", f"peer {banned} is banned")


def test_ban_escalation_and_decay_match_jax(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    t = tswitch.Switch(P2PConfig(ban_base_s=10.0), tp2p.NodeKey(
        PrivKey.generate(b"\x01" * 32)), tp2p.NodeInfo(
        pubkey=PrivKey.generate(b"\x01" * 32).pubkey.ed25519))
    cfg = JP2PConfig()
    cfg.ban_base_s = 10.0
    j = jswitch.Switch(cfg, jp2p.NodeKey(JPrivKey.generate(b"\x01" * 32)),
                       jp2p.NodeInfo(pubkey=PrivKey.generate(
                           b"\x01" * 32).pubkey.ed25519))
    for step in (0, 5, 20, 1, 100, 500, 3, 0.5):
        now[0] += step
        for sw in (t, j):
            sw.ban_peer("p1")
        assert t.banned == j.banned
        now[0] += 11
        assert t.is_banned("p1") == j.is_banned("p1")
        assert t.banned == j.banned
    assert t._ban_score == j._ban_score and t._fd_headroom == j._fd_headroom


@pytest.mark.parametrize("plane", ["threads", "loop"])
def test_add_peer_reaches_reactors_only_for_the_registered_connection(plane):
    """The simultaneous-dial tiebreak can replace a connection between its
    registration and the reactors' add_peer; the JAX package's switch
    then still calls add_peer for the dead one, whose state overwrites
    the live peer's by id. The port's switch tells the reactors only of
    the connection registered for the id, on the thread plane and on the
    event loop (where each peer is a LoopMConnection)."""
    from tendermint_tpu_torch.p2p.conn.loop import (LoopMConnection,
                                                    ReactorLoop)
    loop = ReactorLoop(name="tm-reactor-loop-test") \
        if plane == "loop" else None
    socks = []

    def link():
        if loop is None:
            return tmconn.PlainFramedConn(SinkSock())
        a, b = socket.socketpair()
        socks.extend((a, b))
        return tmconn.PlainFramedConn(a)
    try:
        if loop is not None:
            loop.start()
        sw = make_switch(seed=b"\x01" * 32)
        sw.loop = loop
        r = EchoReactor()
        sw.add_reactor("echo", r)
        other = make_switch(seed=b"\x02" * 32).node_info
        dead, live = (tp2p.Peer(link(), other, sw.channel_descs,
                                outbound=o, loop=loop)
                      for o in (True, False))
        assert isinstance(live.mconn, LoopMConnection) == (plane == "loop")
        assert sw.peers.add(live)
        sw._notify_added(dead)
        assert r.added == []
        sw._notify_added(live)
        assert r.added == [other.id]
        sw._remove_peer(dead, "replaced")   # a late error of the dead one
        assert r.removed == [] and sw.peers.get(other.id) is live
        sw._remove_peer(live, "gone")
        assert r.removed == [other.id] and sw.peers.size() == 0
    finally:
        if loop is not None:
            loop.stop()
        for s in socks:
            s.close()


# ------------------------------------------------- settings off their default

class WritesSock(SinkSock):
    """A SinkSock that keeps the size of every sendall."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def sendall(self, data):
        with self.lock:
            self.sent += data
            self.writes.append(len(data))


def _burst_writes(pkg, monkeypatch, burst_max):
    """The sendall sizes of an MConnection that drains one channel's 20
    queued 300-byte messages with bursts of at most burst_max packets."""
    sink = WritesSock()
    msgs = [bytes([i]) * 300 for i in range(20)]
    if pkg == "port":
        mc = tmconn.MConnection(
            tmconn.PlainFramedConn(sink), [tmconn.ChannelDescriptor(0x20)],
            on_receive=lambda c, m: None, send_rate=1e12, recv_rate=1e12,
            burst=Burst.from_config(P2PConfig(burst_max=burst_max)))
    else:
        monkeypatch.setenv("TM_TPU_P2P_BURST", str(burst_max))
        mc = jmconn.MConnection(
            jmconn.PlainFramedConn(sink), [jmconn.ChannelDescriptor(0x20)],
            on_receive=lambda c, m: None, send_rate=1e12, recv_rate=1e12)
    for m in msgs:
        assert mc.send(0x20, m, timeout=1.0)
    mc.start()
    try:
        assert wait_for(lambda: len(sink.sent) >= 20 * (4 + 3 + 300))
        with sink.lock:
            return list(sink.writes), bytes(sink.sent)
    finally:
        mc.stop(join=True)


@pytest.mark.parametrize("burst_max", [1, 3])
def test_burst_max_caps_the_packets_of_a_write_as_in_jax(monkeypatch,
                                                         burst_max):
    port_writes, port_bytes = _burst_writes("port", monkeypatch, burst_max)
    jax_writes, jax_bytes = _burst_writes("jax", monkeypatch, burst_max)
    assert port_bytes == jax_bytes
    assert max(port_writes) <= burst_max * (4 + 3 + 300)
    assert sorted(port_writes) == sorted(jax_writes)


@pytest.mark.parametrize("headroom", [5, 10, 11, 64])
def test_fd_headroom_setting_admits_or_sheds_as_in_jax(headroom):
    """90 of 100 fds in use: an inbound accept passes while the free fds
    are at least fd_headroom."""
    t = tswitch.Switch(P2PConfig(fd_headroom=headroom), tp2p.NodeKey(
        PrivKey.generate(b"\x01" * 32)), tp2p.NodeInfo(
        pubkey=PrivKey.generate(b"\x01" * 32).pubkey.ed25519))
    cfg = JP2PConfig()
    cfg.fd_headroom = headroom
    j = jswitch.Switch(cfg, jp2p.NodeKey(JPrivKey.generate(b"\x01" * 32)),
                       jp2p.NodeInfo(pubkey=PrivKey.generate(
                           b"\x01" * 32).pubkey.ed25519))
    for sw in (t, j):
        sw._fd_budget = lambda: (100, 90)
    assert t._fd_headroom_ok() == j._fd_headroom_ok() == (headroom <= 10)


# ---------------------------------- the trust hazard, recorded in ROADMAP

@pytest.mark.parametrize("gap_s,banned", [(10.0, False), (30.5, True)],
                         ids=["same-interval", "next-interval"])
def test_one_transport_error_bans_an_honest_peer_as_in_jax(gap_s, banned):
    """A peer with a good handshake whose link then fails once (a
    transport error, weight 1): in the same 30 s trust interval its score
    stays 60; as the first event of the next interval it scores 20 < 30,
    and both packages ban it for ban_base_s (ROADMAP Queue 3)."""
    other = make_switch(seed=b"\x02" * 32).node_info
    results = []
    for sw, pkg, Peer, Plain, DB in (
            (make_switch(seed=b"\x01" * 32), ttrust, tp2p.Peer,
             tmconn.PlainFramedConn, MemDB),
            (jmake_switch(seed=b"\x01" * 32), jtrust, jp2p.Peer,
             jmconn.PlainFramedConn, JMemDB)):
        now = [1000.0]
        sw.trust_store = pkg.TrustMetricStore(DB())
        sw.trust_store.metrics[other.id] = pkg.TrustMetric(
            now_fn=lambda now=now: now[0])
        peer = Peer(Plain(SinkSock()), other, sw.channel_descs,
                    outbound=False)
        assert sw.peers.add(peer)
        sw.trust_store.get_metric(other.id).good_events(1)
        now[0] += gap_s
        try:
            sw.stop_peer_for_error(peer, ConnectionResetError(
                "[Errno 104] Connection reset by peer"))
            score = sw.trust_store.get_metric(other.id).trust_score()
            results.append((score, sw.is_banned(other.id)))
        finally:
            sw.stop()
    assert results[0] == results[1] == ((20, True) if banned else (60, False))
