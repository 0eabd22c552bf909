"""SecretConnection — authenticated encryption for peer links: the port's
copy of `tendermint_tpu/p2p/conn/secret.py` (p2p/conn/secret_connection.go,
an STS-like protocol), on the same wire.

Ephemeral X25519 DH, keys derived with HKDF-SHA256, then each side proves
its long-term Ed25519 identity by signing the handshake challenge. Frames
are length-prefixed ChaCha20-Poly1305 ciphertexts with counter nonces;
a frame carries at most 1024 plaintext bytes (secret_connection.go:22).

Handshake transcript:
  1. exchange 32-byte ephemeral X25519 pubkeys (plaintext)
  2. secret = X25519(our_eph, their_eph)
     (k_send, k_recv, challenge) = HKDF(secret, info=sorted eph pubs)
  3. over the now-encrypted link, exchange (node pubkey, sig(challenge))
     and verify — the authenticated remote identity is `remote_pubkey`

With bursts on (the default) every frame seals and opens in the native
AEAD (`native.aead_*_burst`), a whole write or a whole receive buffer in
one call; a failed build of it raises. With bursts off, or under
TM_CUDA_NO_NATIVE, each frame takes the per-frame AEAD: `cryptography` (OpenSSL) when it imports, else
`purecrypto`. X25519 and HKDF take the same two routes. `frame_stats`
counts the frames of each route in the process; the JAX module's
`p2p_seal_seconds` / `p2p_open_seconds` and frame counters are fed at
the same points.
"""

from __future__ import annotations

import socket as _socket
import struct
import threading
import time
from typing import List

try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.hashes import SHA256
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    HAVE_CRYPTOGRAPHY = True
except ImportError:
    HAVE_CRYPTOGRAPHY = False

from tendermint_tpu_torch import native, telemetry
from tendermint_tpu_torch.p2p.conn import purecrypto
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.keys import PubKey

DATA_MAX_SIZE = native.FRAME_MAX  # plaintext bytes a frame (:22)
_TAG = 16             # poly1305 tag
_RECV_CHUNK = 65536   # burst-mode socket read size

# AEAD cost per seal/open CALL (one frame on the per-frame path, a whole
# burst on the native path), so per-frame cost = _sum / frames. Buckets
# are µs-scaled.
_AEAD_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 2.5e-2, 1e-1, 1.0)
_m_seal = telemetry.histogram(
    "p2p_seal_seconds", "AEAD seal wall time per call (burst = 1 call)",
    buckets=_AEAD_BUCKETS)
_m_open = telemetry.histogram(
    "p2p_open_seconds", "AEAD open wall time per call (burst = 1 call)",
    buckets=_AEAD_BUCKETS)
_m_sealed = telemetry.counter(
    "p2p_frames_sealed_total", "Frames sealed (all paths)")
_m_opened = telemetry.counter(
    "p2p_frames_opened_total", "Frames opened (all paths)")


class FrameStats:
    """Frames sealed and opened in this process, by route (`burst`: the
    native AEAD, `frame`: the per-frame AEAD), with the calls and host
    seconds of each direction's native bursts."""

    FIELDS = ("sealed_burst", "sealed_frame", "opened_burst", "opened_frame",
              "seal_calls", "open_calls", "seal_s", "open_s")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._c = dict.fromkeys(self.FIELDS, 0)

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                self._c[k] += v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


frame_stats = FrameStats()


def _hkdf(secret: bytes, info: bytes, n: int) -> bytes:
    """RFC 5869 HKDF-SHA256."""
    if HAVE_CRYPTOGRAPHY:
        return HKDF(algorithm=SHA256(), length=n, salt=None,
                    info=info).derive(secret)
    return purecrypto.hkdf_sha256(secret, info, n)


def _aead(key: bytes):
    if HAVE_CRYPTOGRAPHY:
        return ChaCha20Poly1305(key)
    return purecrypto.ChaCha20Poly1305(key)


def _eph_keypair():
    """-> (private_handle, public32). The private handle is whatever
    _dh() below expects for the active backend."""
    if HAVE_CRYPTOGRAPHY:
        priv = X25519PrivateKey.generate()
        return priv, priv.public_key().public_bytes_raw()
    return purecrypto.x25519_keypair()


def _dh(priv, their_pub32: bytes) -> bytes:
    if HAVE_CRYPTOGRAPHY:
        return priv.exchange(X25519PublicKey.from_public_bytes(their_pub32))
    return purecrypto.x25519(priv, their_pub32)


class _Cipher:
    """One direction: a 32-byte key and a 96-bit counter nonce. The
    native bursts take the key bytes and the counter; the per-frame AEAD
    object is built only when a frame takes that route."""

    def __init__(self, key: bytes):
        self.key = bytes(key)
        self.nonce = 0
        self._aead = None

    def _next_nonce(self) -> bytes:
        n = self.nonce
        self.nonce += 1
        return n.to_bytes(12, "little")

    def seal(self, plaintext: bytes) -> bytes:
        if self._aead is None:
            self._aead = _aead(self.key)
        return self._aead.encrypt(self._next_nonce(), plaintext, b"")

    def open(self, ciphertext: bytes) -> bytes:
        if self._aead is None:
            self._aead = _aead(self.key)
        return self._aead.decrypt(self._next_nonce(), ciphertext, b"")


class SecretConnection:
    """Wraps a raw socket-like conn (sendall/recv/close) with AEAD frames.

    `make(conn, node_key, burst)` performs the full handshake and returns
    the connection with `remote_pubkey` authenticated."""

    def __init__(self, conn, send_cipher: _Cipher, recv_cipher: _Cipher,
                 remote_pubkey: bytes = b"", burst: bool = True):
        self.conn = conn
        self._send = send_cipher         #: guarded_by _send_lock
        self._recv = recv_cipher         #: guarded_by _rlock
        self.remote_pubkey = remote_pubkey
        self._send_lock = threading.Lock()
        # two concurrent readers would otherwise interleave counter
        # nonces and poison the stream with spurious tag failures
        self._rlock = threading.Lock()
        self._rbuf = bytearray()  #: guarded_by _rlock (socket read-ahead)
        # TM_CUDA_NO_NATIVE: every frame takes the per-frame AEAD
        self._burst = burst and not native.disabled()

    # ------------------------------------------------------------- handshake

    @classmethod
    def make(cls, conn, node_key, burst: bool = True) -> "SecretConnection":
        eph_priv, eph_pub = _eph_keypair()
        conn.sendall(eph_pub)
        their_eph = _read_exact(conn, 32)

        secret = _dh(eph_priv, their_eph)
        lo, hi = sorted((eph_pub, their_eph))
        keys = _hkdf(secret, b"tendermint_tpu/secret/" + lo + hi, 96)
        k_lo, k_hi, challenge = keys[:32], keys[32:64], keys[64:]
        if eph_pub == lo:
            send_c, recv_c = _Cipher(k_lo), _Cipher(k_hi)
        else:
            send_c, recv_c = _Cipher(k_hi), _Cipher(k_lo)

        sc = cls(conn, send_c, recv_c, burst=burst)

        # authenticate over the encrypted link
        auth = encoding.cdumps({"pubkey": node_key.pubkey.hex(),
                                "sig": node_key.sign(challenge).hex()})
        sc.write(auth)
        their_auth = encoding.cloads(sc.read())
        their_pub = bytes.fromhex(their_auth["pubkey"])
        their_sig = bytes.fromhex(their_auth["sig"])
        if not PubKey(their_pub).verify(challenge, their_sig):
            conn.close()
            raise ValueError("secret handshake: invalid identity signature")
        sc.remote_pubkey = their_pub
        return sc

    # ----------------------------------------------------------------- frames

    def write(self, data: bytes) -> int:
        """Fragment into <=1024B plaintext frames, under one lock so that
        concurrent writers cannot interleave nonce order. With bursts on
        every frame of the payload seals in one native call and ships in
        one sendall; off, one seal and one sendall a frame. Same nonces,
        same wire bytes."""
        chunks = _chunk(data)
        with self._send_lock:
            self._write_chunks_locked(chunks)
        return len(data)

    def write_many(self, chunks: List[bytes]) -> int:
        """Vectored frame write: each chunk (<=1024B) becomes exactly one
        frame — the layout MConnection needs, where one frame is one
        packet. Wire bytes equal write(chunk) per chunk."""
        total = 0
        for c in chunks:
            if len(c) > DATA_MAX_SIZE:
                raise ValueError(f"frame chunk exceeds {DATA_MAX_SIZE}B")
            total += len(c)
        with self._send_lock:
            self._write_chunks_locked(list(chunks))
        return total

    def _write_chunks_locked(self, chunks: List[bytes]) -> None:
        if self._burst:
            self.conn.sendall(self._seal_wire_locked(chunks))
            return
        tele = telemetry.enabled()
        for chunk in chunks:
            t0 = time.perf_counter() if tele else 0.0
            sealed = self._send.seal(struct.pack(">H", len(chunk)) + chunk)
            if tele:
                _m_seal.observe(time.perf_counter() - t0)
                _m_sealed.inc()
            self.conn.sendall(struct.pack(">I", len(sealed)) + sealed)
        frame_stats.add(sealed_frame=len(chunks))

    def _seal_wire_locked(self, chunks: List[bytes]) -> bytes:
        """Wire bytes for `chunks`, one frame each, from one native burst
        (caller holds _send_lock)."""
        t0 = time.perf_counter()
        wire = native.aead_seal_burst(self._send.key, self._send.nonce,
                                      chunks)
        self._send.nonce += len(chunks)
        dt = time.perf_counter() - t0
        frame_stats.add(sealed_burst=len(chunks), seal_calls=1, seal_s=dt)
        if telemetry.enabled():
            _m_seal.observe(dt)
            _m_sealed.inc(len(chunks))
        return wire

    def seal_frames(self, chunks: List[bytes]) -> bytes:
        """The wire bytes for `chunks` (one <=1024B frame each) without
        touching the socket — byte-identical to what write_many sends."""
        for c in chunks:
            if len(c) > DATA_MAX_SIZE:
                raise ValueError(f"frame chunk exceeds {DATA_MAX_SIZE}B")
        with self._send_lock:
            if self._burst:
                return self._seal_wire_locked(list(chunks))
            t0 = time.perf_counter() if telemetry.enabled() else 0.0
            parts = []
            for chunk in chunks:
                sealed = self._send.seal(
                    struct.pack(">H", len(chunk)) + chunk)
                parts += [struct.pack(">I", len(sealed)), sealed]
            if t0:
                _m_seal.observe(time.perf_counter() - t0)
                _m_sealed.inc(len(chunks))
            frame_stats.add(sealed_frame=len(chunks))
            return b"".join(parts)

    def read(self) -> bytes:
        """One frame's plaintext (<=1024B). b'' on clean EOF."""
        with self._rlock:
            if not self._burst:
                return self._read_frame_unbuffered_locked()
            frames = self._read_frames_locked(limit=1)
            return frames[0] if frames else b""

    def read_burst(self) -> List[bytes]:
        """Every complete frame already buffered from the socket, opened
        in one native call — blocks only for the first. [] on clean EOF.
        Interoperates frame for frame with a per-frame peer: bursts are a
        receive-side batching decision, not a wire format."""
        with self._rlock:
            if not self._burst:
                frame = self._read_frame_unbuffered_locked()
                return [frame] if frame != b"" else []
            return self._read_frames_locked(limit=0)

    def _read_frame_unbuffered_locked(self) -> bytes:
        """The per-frame read path (bursts off): exact-size recvs, one
        AEAD open a frame. Caller holds _rlock."""
        hdr = _read_exact(self.conn, 4, allow_eof=True)
        if hdr == b"":
            return b""
        (clen,) = struct.unpack(">I", hdr)
        if clen > DATA_MAX_SIZE + 2 + _TAG:
            raise ValueError(f"oversized secret frame: {clen}")
        sealed = _read_exact(self.conn, clen)
        t0 = time.perf_counter() if telemetry.enabled() else 0.0
        plain = self._recv.open(sealed)
        if t0:
            _m_open.observe(time.perf_counter() - t0)
            _m_opened.inc()
        frame_stats.add(opened_frame=1)
        return _strip_frame(plain)

    def _fill_locked(self, need: int, allow_eof: bool = False) -> bool:
        """Grow the read-ahead buffer to >= need bytes. False on clean
        EOF (only when allow_eof and nothing is buffered)."""
        while len(self._rbuf) < need:
            chunk = self.conn.recv(_RECV_CHUNK)
            if not chunk:
                if allow_eof and not self._rbuf:
                    return False
                raise ConnectionError("unexpected EOF")
            self._rbuf += chunk
        return True

    def _take_sealed_locked(self, block: bool, limit: int = 0) -> List[bytes]:
        """Cut complete sealed frames off the read-ahead buffer; with
        `block`, wait on the socket until the first one is complete."""
        sealed: List[bytes] = []
        while len(self._rbuf) >= 4:
            (clen,) = struct.unpack(">I", bytes(self._rbuf[:4]))
            if clen > DATA_MAX_SIZE + 2 + _TAG:
                raise ValueError(f"oversized secret frame: {clen}")
            if len(self._rbuf) < 4 + clen:
                if sealed or not block:
                    break  # later frames: don't block mid-burst
                self._fill_locked(4 + clen)
            sealed.append(bytes(self._rbuf[4:4 + clen]))
            del self._rbuf[:4 + clen]
            if limit and len(sealed) >= limit:
                break
        return sealed

    def _read_frames_locked(self, limit: int = 0) -> List[bytes]:
        """Parse sealed frames out of the read-ahead buffer (blocking
        until the first is complete), open them in one burst, and return
        the payloads. limit=0 means every complete frame buffered."""
        if not self._fill_locked(4, allow_eof=True):
            return []
        return self._open_sealed_locked(
            self._take_sealed_locked(True, limit))

    def _open_sealed_locked(self, sealed: List[bytes]) -> List[bytes]:
        if not sealed:
            return []
        t0 = time.perf_counter()
        plains = native.aead_open_burst(self._recv.key, self._recv.nonce,
                                        sealed)
        self._recv.nonce += len(sealed)
        dt = time.perf_counter() - t0
        frame_stats.add(opened_burst=len(sealed), open_calls=1, open_s=dt)
        if telemetry.enabled():
            _m_open.observe(dt)
            _m_opened.inc(len(sealed))
        return [_strip_frame(p) for p in plains]

    def feed_wire(self, data: bytes) -> List[bytes]:
        """Append raw socket bytes to the read-ahead buffer and return
        every COMPLETE frame's plaintext (one burst open). Never reads the
        socket; partial frames stay buffered until the next feed.
        feed_wire(b'') drains frames the handshake's over-read already
        buffered."""
        with self._rlock:
            if data:
                self._rbuf += data
            sealed = self._take_sealed_locked(False)
            if self._burst:
                return self._open_sealed_locked(sealed)
            t0 = time.perf_counter() if telemetry.enabled() and sealed \
                else 0.0
            plains = [_strip_frame(self._recv.open(f)) for f in sealed]
            if t0:
                _m_open.observe(time.perf_counter() - t0)
                _m_opened.inc(len(sealed))
            frame_stats.add(opened_frame=len(sealed))
            return plains

    def close(self) -> None:
        # shutdown wakes any recv() blocked in another thread and sends
        # FIN immediately; bare close() does neither reliably
        try:
            self.conn.shutdown(_socket.SHUT_RDWR)
        except (OSError, AttributeError):
            pass
        try:
            self.conn.close()
        except OSError:
            pass


def _chunk(data: bytes) -> List[bytes]:
    """<=1024B plaintext chunks; an empty payload is one empty frame."""
    if not data:
        return [b""]
    view = memoryview(data)
    return [bytes(view[i:i + DATA_MAX_SIZE])
            for i in range(0, len(data), DATA_MAX_SIZE)]


def _strip_frame(plain: bytes) -> bytes:
    (dlen,) = struct.unpack(">H", plain[:2])
    if 2 + dlen > len(plain):
        raise ValueError(
            f"secret frame length {dlen} exceeds plaintext "
            f"({len(plain) - 2} data bytes)")
    return plain[2:2 + dlen]


def _read_exact(conn, n: int, allow_eof: bool = False) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            if allow_eof and not buf:
                return b""
            raise ConnectionError("unexpected EOF")
        buf += chunk
    return buf
