"""X25519, HKDF-SHA256 and ChaCha20-Poly1305 in pure Python: the port's
copy of `tendermint_tpu/p2p/conn/purecrypto.py`.

  - X25519 (RFC 7748 montgomery ladder)
  - HKDF-SHA256 (RFC 5869, via hmac/hashlib)
  - ChaCha20-Poly1305 AEAD (RFC 8439)

SecretConnection takes these when the `cryptography` package does not
import: for the handshake's key exchange and key derivation always, and
for the frames only with frame bursts off (with bursts on every frame
seals and opens in the native AEAD, `native.aead_*_burst`). Wire
compatible with the OpenSSL-backed path; pinned to the RFC vectors in
tests/test_torch_p2p.py.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

# --------------------------------------------------------------- X25519

_P = 2**255 - 19
_A24 = 121665
X25519_BASE = (9).to_bytes(32, "little")


def _decode_u(u: bytes) -> int:
    b = bytearray(u[:32])
    b[31] &= 127
    return int.from_bytes(b, "little")


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k[:32])
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def x25519(scalar: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 scalar multiplication (constant-structure ladder;
    Python ints are not constant-time — acceptable for the fallback)."""
    k = _decode_scalar(scalar)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * (z3 * z3 % _P) % _P
        x2 = aa * bb % _P
        z2 = e * ((aa + _A24 * e) % _P) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


def x25519_keypair() -> tuple:
    """(private32, public32) from os.urandom."""
    priv = os.urandom(32)
    return priv, x25519(priv, X25519_BASE)


# ---------------------------------------------------------- HKDF-SHA256


def hkdf_sha256(ikm: bytes, info: bytes, length: int,
                salt: bytes = b"") -> bytes:
    """RFC 5869; empty salt means a hash-length zero block, matching
    cryptography's HKDF(salt=None)."""
    if not salt:
        salt = b"\x00" * 32
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


# -------------------------------------------------- ChaCha20 + Poly1305

_M32 = 0xFFFFFFFF


def _quarter(s, a, b, c, d) -> None:
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & _M32
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & _M32


def _chacha20_block(key_words, counter: int, nonce_words) -> bytes:
    init = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
            *key_words, counter & _M32, *nonce_words]
    w = list(init)
    for _ in range(10):
        _quarter(w, 0, 4, 8, 12)
        _quarter(w, 1, 5, 9, 13)
        _quarter(w, 2, 6, 10, 14)
        _quarter(w, 3, 7, 11, 15)
        _quarter(w, 0, 5, 10, 15)
        _quarter(w, 1, 6, 11, 12)
        _quarter(w, 2, 7, 8, 13)
        _quarter(w, 3, 4, 9, 14)
    return struct.pack("<16I",
                       *((w[i] + init[i]) & _M32 for i in range(16)))


def chacha20_xor(key: bytes, counter: int, nonce: bytes,
                 data: bytes) -> bytes:
    key_words = struct.unpack("<8I", key)
    nonce_words = struct.unpack("<3I", nonce)
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        ks = _chacha20_block(key_words, counter + i // 64, nonce_words)
        chunk = data[i:i + 64]
        out[i:i + len(chunk)] = bytes(
            x ^ y for x, y in zip(chunk, ks))
    return bytes(out)


def poly1305_mac(otk32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(otk32[:16], "little") \
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(otk32[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        n = int.from_bytes(msg[i:i + 16] + b"\x01", "little")
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


class InvalidTag(Exception):
    """AEAD authentication failure (mirrors cryptography's InvalidTag)."""


def _pad16(x: bytes) -> bytes:
    return b"\x00" * (-len(x) % 16)


class ChaCha20Poly1305:
    """RFC 8439 AEAD with the same encrypt/decrypt signature as
    cryptography.hazmat.primitives.ciphers.aead.ChaCha20Poly1305."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        otk = chacha20_xor(self._key, 0, nonce, b"\x00" * 32)
        mac_data = (aad + _pad16(aad) + ct + _pad16(ct) +
                    struct.pack("<QQ", len(aad), len(ct)))
        return poly1305_mac(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes = b"") -> bytes:
        aad = associated_data or b""
        ct = chacha20_xor(self._key, 1, nonce, data)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes = b"") -> bytes:
        aad = associated_data or b""
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the tag")
        ct, tag = data[:-16], data[-16:]
        if not hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise InvalidTag("poly1305 tag mismatch")
        return chacha20_xor(self._key, 1, nonce, ct)
