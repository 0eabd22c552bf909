"""Pure-Python secp256k1 ECDSA-SHA256: the port's copy of the JAX
package's `utils/secp256k1_ref.py`, and the route of `types/keys.py` when
the optional `cryptography` (OpenSSL) package is absent.

Wire-compatible with the OpenSSL path: compressed SEC1 public keys,
DER-encoded (r, s) signatures, RFC 6979 deterministic nonces. `verify`
here parses DER leniently (a non-minimal integer, or one whose high bit
makes it negative, still decodes); `types/keys.Secp256k1PubKey.verify`
adds the strict re-encoding check that makes its verdicts OpenSSL's.
Python big-int math is not constant-time.
"""

from __future__ import annotations

import hashlib
import hmac

# curve: y^2 = x^3 + 7 over F_P
P = 2**256 - 2**32 - 977
N = int("fffffffffffffffffffffffffffffffe"
        "baaedce6af48a03bbfd25e8cd0364141", 16)
G = (int("79be667ef9dcbbac55a06295ce870b07"
         "029bfcdb2dce28d959f2815b16f81798", 16),
     int("483ada7726a3c4655da4fbfc0e1108a8"
         "fd17b448a68554199c47d08ffb10d4b8", 16))


def _add(p1, p2):
    """Affine point addition; None is the point at infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(k: int, point):
    out = None
    addend = point
    while k:
        if k & 1:
            out = _add(out, addend)
        addend = _add(addend, addend)
        k >>= 1
    return out


def _compress(point) -> bytes:
    x, y = point
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decompress(pub33: bytes):
    if len(pub33) != 33 or pub33[0] not in (2, 3):
        raise ValueError("not a compressed SEC1 secp256k1 point")
    x = int.from_bytes(pub33[1:], "big")
    if x >= P:
        raise ValueError("point x out of range")
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)  # P % 4 == 3
    if y * y % P != y2:
        raise ValueError("point not on curve")
    if (y & 1) != (pub33[0] & 1):
        y = P - y
    return x, y


def pubkey_of(seed32: bytes) -> bytes:
    """Private scalar (32B big-endian) -> compressed public key."""
    d = int.from_bytes(seed32, "big")
    if not 1 <= d < N:
        raise ValueError("private scalar out of range")
    return _compress(_mul(d, G))


# ------------------------------------------------------------------- DER


def _der_int(v: int) -> bytes:
    b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if b[0] & 0x80:
        b = b"\x00" + b
    return b"\x02" + bytes([len(b)]) + b


def _der_encode(r: int, s: int) -> bytes:
    body = _der_int(r) + _der_int(s)
    return b"\x30" + bytes([len(body)]) + body


def _der_decode(sig: bytes):
    """-> (r, s); raises ValueError on malformed input."""
    if len(sig) < 8 or sig[0] != 0x30 or sig[1] != len(sig) - 2:
        raise ValueError("bad DER sequence")
    out = []
    i = 2
    for _ in range(2):
        if i + 2 > len(sig) or sig[i] != 0x02:
            raise ValueError("bad DER integer")
        ln = sig[i + 1]
        val = sig[i + 2:i + 2 + ln]
        if len(val) != ln or ln == 0:
            raise ValueError("bad DER integer length")
        out.append(int.from_bytes(val, "big"))
        i += 2 + ln
    if i != len(sig):
        raise ValueError("trailing DER bytes")
    return out[0], out[1]


# ----------------------------------------------------------------- ECDSA


def _rfc6979_k(d: int, h1: bytes) -> int:
    """RFC 6979 §3.2 deterministic nonce (HMAC-SHA256)."""
    x = d.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(seed32: bytes, msg: bytes) -> bytes:
    """ECDSA-SHA256 over msg -> DER(r, s)."""
    d = int.from_bytes(seed32, "big")
    if not 1 <= d < N:
        raise ValueError("private scalar out of range")
    h1 = hashlib.sha256(msg).digest()
    e = int.from_bytes(h1, "big") % N
    while True:
        k = _rfc6979_k(d, h1)
        pt = _mul(k, G)
        r = pt[0] % N
        if r == 0:
            h1 = hashlib.sha256(h1).digest()  # re-derive (never in practice)
            continue
        s = pow(k, -1, N) * (e + r * d) % N
        if s == 0:
            h1 = hashlib.sha256(h1).digest()
            continue
        return _der_encode(r, s)


def verify(pub33: bytes, msg: bytes, der_sig: bytes) -> bool:
    try:
        r, s = _der_decode(der_sig)
        q = _decompress(pub33)
    except (ValueError, TypeError):
        return False
    if not (1 <= r < N and 1 <= s < N):
        return False
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
    w = pow(s, -1, N)
    pt = _add(_mul(e * w % N, G), _mul(r * w % N, q))
    if pt is None:
        return False
    return pt[0] % N == r
