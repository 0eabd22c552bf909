"""Seeded Ed25519 verification vectors with edge lanes, for holding the
kernels against their plain versions and the oracle (CPU tests and
`chip_smoke.py`).

`edge_batch(n, seed)` cycles through the lane kinds of KINDS:

  valid        a real RFC 8032 signature
  bad_r        R with one bit flipped
  bad_s        s with one bit flipped (still < L)
  bad_msg      signature over another message
  bad_pubkey   a pubkey that is not a curve point
  x0_sign      pubkey x = 0 with the sign bit set (y = 1): invalid
  noncanon_y   pubkey y = p + 1 (≡ 1, the identity): accepted after
               reduction, with a signature made valid for it
  zero         all-zero bytes, as in a padding lane

`probe_batch(n, seed)` cycles through the lanes of PROBE_KINDS, the
small-order and non-canonical encodings:

  torsion_pk   pubkey one of the 8 points of order dividing 8, R = s*B
  torsion_r    R one of those 8 points, s = 0, a real pubkey
  mixed_order  pubkey a*B + T (T of order 2, 4 or 8) signed with a
  noncanon_r   R with y = p ... p + 18 (no sign bit), a real pubkey
  x0_sign_ym1  pubkey x = 0 with the sign bit set and y = p - 1

Rows are the kernels' inputs: pk, R, s, h as uint8[n, 32] (h already
reduced mod L) and the oracle's verdict per lane. `edge_items(n, seed)`
gives edge_batch's lanes as (pubkey, msg, sig) verifier items.
"""

from __future__ import annotations

import hashlib

import numpy as np

from tendermint_tpu_torch.utils import ed25519_fast
from tendermint_tpu_torch.utils import ed25519_ref as ref

KINDS = ("valid", "bad_r", "bad_s", "bad_msg", "bad_pubkey", "x0_sign",
         "noncanon_y", "zero")


def _h(rb: bytes, pk: bytes, msg: bytes) -> bytes:
    h = int.from_bytes(hashlib.sha512(rb + pk + msg).digest(), "little")
    return (h % ref.L).to_bytes(32, "little")


def _invalid_pubkey(rng) -> bytes:
    while True:
        b = rng.bytes(32)
        if ref.point_decompress(b) is None:
            return b


def _edge_lanes(n: int, seed: int, n_keys: int):
    """(kind, pubkey, msg, sig) of each lane of KINDS, cycled ("zero"
    lanes carry the honest values, which edge_batch replaces)."""
    rng = np.random.RandomState(seed)
    keys = []
    for _ in range(n_keys):
        sk = rng.bytes(32)
        a, prefix = ref.secret_expand(sk)
        keys.append((a, prefix, ed25519_fast.public_key(sk)))
    noncanon = (ref.P + 1).to_bytes(32, "little")
    x0_sign = (1 | (1 << 255)).to_bytes(32, "little")
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        msg = rng.bytes(int(rng.randint(0, 64)))
        a, prefix, pk = keys[i % n_keys]
        sig = ed25519_fast.sign_expanded(a, prefix, pk, msg)
        if kind == "bad_r":
            sig = bytes([sig[0] ^ 0x04]) + sig[1:]
        elif kind == "bad_s":
            sig = sig[:33] + bytes([sig[33] ^ 0x01]) + sig[34:]
        elif kind == "bad_msg":
            msg = msg + b"x"
        elif kind == "bad_pubkey":
            pk = _invalid_pubkey(rng)
        elif kind == "x0_sign":
            pk = x0_sign
        elif kind == "noncanon_y":
            # A is the identity, so s*B - h*A = s*B for any h
            s = int.from_bytes(rng.bytes(32), "little") % ref.L
            pk = noncanon
            sig = ref.point_compress(ed25519_fast._mul_base(s)) + \
                s.to_bytes(32, "little")
        yield kind, pk, msg, sig


def edge_batch(n: int, seed: int, n_keys: int = 16) -> dict:
    """{"pk", "rb", "s", "h": uint8[n, 32], "expect": bool[n],
    "kind": list[str]}."""
    rows = {"pk": [], "rb": [], "s": [], "h": [], "expect": [], "kind": []}
    for kind, pk, msg, sig in _edge_lanes(n, seed, n_keys):
        if kind == "zero":
            pk, rb, s_b, h_b, ok = (b"\x00" * 32,) * 4 + (False,)
        else:
            rb, s_b, h_b = sig[:32], sig[32:], _h(sig[:32], pk, msg)
            ok = ed25519_fast.verify(pk, msg, sig)
        for key, val in (("pk", pk), ("rb", rb), ("s", s_b), ("h", h_b)):
            rows[key].append(np.frombuffer(val, np.uint8))
        rows["expect"].append(ok)
        rows["kind"].append(kind)
    out = {k: np.stack(rows[k]) for k in ("pk", "rb", "s", "h")}
    out["expect"] = np.array(rows["expect"], np.bool_)
    out["kind"] = rows["kind"]
    return out


def edge_items(n: int, seed: int, n_keys: int = 16) -> tuple:
    """The lanes of edge_batch as verifier items: ([(pubkey, msg, sig)],
    [oracle verdict]); a "zero" lane is an all-zero key and signature."""
    items, expect = [], []
    for kind, pk, msg, sig in _edge_lanes(n, seed, n_keys):
        if kind == "zero":
            pk, msg, sig = b"\x00" * 32, b"", b"\x00" * 64
        items.append((pk, msg, sig))
        expect.append(ed25519_fast.verify(pk, msg, sig))
    return items, expect


PROBE_KINDS = ("torsion_pk", "torsion_r", "mixed_order", "noncanon_r",
               "x0_sign_ym1")


def torsion_points() -> list:
    """k * T8 for k = 0..7, T8 a point of order 8: every point whose
    order divides 8 (the identity first)."""
    y = 2
    while True:
        pt = ref.point_decompress(y.to_bytes(32, "little"))
        y += 1
        if pt is None:
            continue
        t8 = ref.point_mul(ref.L, pt)   # the torsion part of pt
        if not ref.point_equal(ref.point_mul(4, t8), ref.IDENT):
            return [ref.point_mul(k, t8) for k in range(8)]


def probe_batch(n: int, seed: int, n_keys: int = 8) -> dict:
    """The small-order and non-canonical lanes of PROBE_KINDS, cycled;
    the same dict as edge_batch."""
    rng = np.random.RandomState(seed)
    torsion = torsion_points()
    keys = []
    for _ in range(n_keys):
        a, prefix = ref.secret_expand(rng.bytes(32))
        keys.append((a, prefix, ref.point_compress(ed25519_fast._mul_base(a))))
    x0_sign_ym1 = ((ref.P - 1) | (1 << 255)).to_bytes(32, "little")
    rows = {"pk": [], "rb": [], "s": [], "h": [], "expect": [], "kind": []}
    for i in range(n):
        kind = PROBE_KINDS[i % len(PROBE_KINDS)]
        k = i // len(PROBE_KINDS)
        msg = rng.bytes(int(rng.randint(0, 64)))
        a, prefix, pk = keys[i % n_keys]
        s = int.from_bytes(rng.bytes(32), "little") % ref.L
        rb = ref.point_compress(ed25519_fast._mul_base(s))
        if kind == "torsion_pk":
            pk = ref.point_compress(torsion[k % 8])
        elif kind == "torsion_r":
            rb, s = ref.point_compress(torsion[k % 8]), 0
        elif kind == "mixed_order":
            pk = ref.point_compress(ref.point_add(
                ed25519_fast._mul_base(a), torsion[1 + k % 7]))
            r = int.from_bytes(rng.bytes(32), "little") % ref.L
            rb = ref.point_compress(ed25519_fast._mul_base(r))
            s = (r + int.from_bytes(_h(rb, pk, msg), "little") * a) % ref.L
        elif kind == "noncanon_r":
            rb = (ref.P + k % 19).to_bytes(32, "little")
        else:
            pk = x0_sign_ym1
        s_b = s.to_bytes(32, "little")
        for key, val in (("pk", pk), ("rb", rb), ("s", s_b),
                         ("h", _h(rb, pk, msg))):
            rows[key].append(np.frombuffer(val, np.uint8))
        rows["expect"].append(ed25519_fast.verify(pk, msg, rb + s_b))
        rows["kind"].append(kind)
    out = {k: np.stack(rows[k]) for k in ("pk", "rb", "s", "h")}
    out["expect"] = np.array(rows["expect"], np.bool_)
    out["kind"] = rows["kind"]
    return out


def small_scalar_batch(n: int, seed: int, n_windows: int = 8) -> dict:
    """Crafted instances with s, h < 2^(4 n_windows): random A = a*B and
    R = s*B - h*A, so enc(s*B + h*(-A)) == R holds by construction; every
    fourth lane gets a flipped bit in R. The truncated ladder
    (`n_windows` windows) must accept exactly the untouched lanes."""
    rng = np.random.RandomState(seed)
    bound = 1 << (4 * n_windows)
    rows = {"pk": [], "rb": [], "s": [], "h": [], "expect": []}
    for i in range(n):
        a = int.from_bytes(rng.bytes(32), "little") % ref.L
        s = int.from_bytes(rng.bytes(8), "little") % bound
        h = int.from_bytes(rng.bytes(8), "little") % bound
        A = ed25519_fast._mul_base(a)
        R = ref.point_add(ed25519_fast._mul_base(s),
                          ref.point_mul((ref.L - h) % ref.L, A))
        rb = ref.point_compress(R)
        tampered = i % 4 == 3
        if tampered:
            rb = bytes([rb[0] ^ 0x01]) + rb[1:]
        for key, val in (("pk", ref.point_compress(A)), ("rb", rb),
                         ("s", s.to_bytes(32, "little")),
                         ("h", h.to_bytes(32, "little"))):
            rows[key].append(np.frombuffer(val, np.uint8))
        rows["expect"].append(not tampered)
    out = {k: np.stack(rows[k]) for k in ("pk", "rb", "s", "h")}
    out["expect"] = np.array(rows["expect"], np.bool_)
    return out
