"""A plain Ed25519 verify (RFC 8032, section 5.1.7) in Python integers.

The reference that the benchmark holds the port's verdicts against. It
imports nothing of the port. Its rules are the port's: the key and the
signature have their lengths; s < L; the key decodes to a point (y < p,
a square root exists, x = 0 only with the sign bit clear); and the
canonical encoding of [s]B - [h]A, h = SHA-512(R || A || M) mod L,
equals R byte for byte (the cofactorless check, so an R that does not
encode canonically never matches).
"""

from __future__ import annotations

import hashlib

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


def _decode(enc: bytes):
    y = int.from_bytes(enc, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(k: int, pt):
    acc = (0, 1, 1, 0)
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def _encode(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


_BY = 4 * pow(5, P - 2, P) % P
B = (_recover_x(_BY, 0), _BY, 1, _recover_x(_BY, 0) * _BY % P)


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    if len(pubkey) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    a = _decode(pubkey)
    if a is None:
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + pubkey + msg).digest(),
                       "little") % L
    neg_a = ((P - a[0]) % P, a[1], 1, (P - a[3]) % P)
    return _encode(_add(_mul(s, B), _mul(h, neg_a))) == sig[:32]
