"""Precomputed-table cofactorless Ed25519 verify — the HOST bulk path.

Same verification equation as utils/ed25519_ref.verify (cofactorless,
encode(s*B - h*A) == sig[:32], s < L, canonical decompress) computed
with precomputed point tables instead of two fresh 256-step ladders:

  - a fixed 4-bit-window table for the base point B (global, built once:
    s*B becomes <= 63 additions instead of a 253-double ladder), and
  - a per-pubkey table of (-A)*2^i doubles (built once per validator key,
    cached LRU: h*(-A) becomes ~126 additions on average).

Consensus verifies the SAME validator set's keys for every vote and
commit, so the per-key build (one ladder's worth of doubles) amortizes
to nothing — steady-state cost drops from ~1030 point ops per signature
to ~190, a 4-6x speedup of the pure-Python oracle. This is what makes
the dispatch coalescer's merged host batches fast on machines without
OpenSSL (`cryptography`) and without a usable accelerator: the scalar
oracle is the consensus-critical fallback there, and it is exactly the
path the coalescer saturates.

SEMANTICS ARE BIT-IDENTICAL to ed25519_ref.verify: the checks are the
same code, and s*B - h*A is the same group element whether computed by
ladder or by table walk (extended-Edwards addition is complete), so
point_compress yields the same 32 bytes. Its verdicts are the expected
values of the edge lanes in utils/vectors.py, which the tests and
chip_smoke.py hold the kernels and the oracle to.

`sign_expanded` reuses the same fixed-base table for the two base-point
multiplies of RFC 8032 signing (R = r*B, plus the caller's one-time
A = a*B), turning the ~50 ms pure-Python `ed25519_ref.sign` into ~4 ms
— the per-vote signing latency that sat on the consensus critical path
of OpenSSL-less hosts. Key hygiene: this module CACHES only public
material (the B table, per-pubkey tables); the secret scalar/prefix
pass through `sign_expanded` as arguments and are retained by the
owning PrivKey instance (types/keys.py), never stored here.

A copy of `tendermint_tpu/utils/ed25519_fast.py` for the port, which
imports nothing of the JAX package; `public_key` is added so that key
generation uses the same table.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from tendermint_tpu_torch.utils import ed25519_ref as ref
from tendermint_tpu_torch.utils import knobs

_P = ref.P
_L = ref.L

# ---------------------------------------------------------------- B table
# _b_table[j][d] = d * 16^j * B for j in 0..63, d in 0..15 (index 0 is
# the identity so the window walk never branches on representation).
# h,s < L < 2^253, so 64 4-bit windows cover every reduced scalar.

_b_table = None
_b_lock = threading.Lock()


def _build_b_table():
    tbl = []
    base = ref.BASE
    for _ in range(64):
        row = [ref.IDENT]
        for _ in range(15):
            row.append(ref.point_add(row[-1], base))
        tbl.append(row)
        for _ in range(4):  # base <<= 4 for the next window
            base = ref.point_add(base, base)
    return tbl


def _mul_base(s: int):
    """s*B via the fixed window table (<= 63 additions)."""
    global _b_table
    tbl = _b_table
    if tbl is None:
        with _b_lock:
            if _b_table is None:
                _b_table = _build_b_table()
            tbl = _b_table
    q = ref.IDENT
    j = 0
    while s:
        d = s & 15
        if d:
            q = ref.point_add(q, tbl[j][d])
        s >>= 4
        j += 1
    return q


# ---------------------------------------------------------- per-key tables
# pubkey bytes -> list of 253 doubles of (-A), or _INVALID for byte
# strings that fail canonical decompression (cached too: a forged key
# must not re-pay the sqrt on every retry). LRU-capped: tables are
# ~60KB of Python ints each, and only live validator keys stay hot.

_INVALID = object()
_TABLE_MAX = knobs.knob_int("TM_CUDA_HOST_TABLE_CACHE", default=256)
_tables: "OrderedDict[bytes, object]" = OrderedDict()
_tables_lock = threading.Lock()


def _negA_table(pubkey: bytes):
    with _tables_lock:
        ent = _tables.get(pubkey)
        if ent is not None:
            _tables.move_to_end(pubkey)
            return ent
    A = ref.point_decompress(pubkey)
    if A is None:
        ent = _INVALID
    else:
        neg = (_P - A[0], A[1], A[2], _P - A[3])
        ent = [neg]
        for _ in range(252):
            ent.append(ref.point_add(ent[-1], ent[-1]))
    with _tables_lock:
        _tables[pubkey] = ent
        while len(_tables) > _TABLE_MAX:
            _tables.popitem(last=False)
    return ent


def _mul_negA(h: int, tbl) -> tuple:
    q = ref.IDENT
    i = 0
    while h:
        if h & 1:
            q = ref.point_add(q, tbl[i])
        h >>= 1
        i += 1
    return q


def cache_clear() -> None:
    """Tests / memory pressure."""
    with _tables_lock:
        _tables.clear()


def has_table(pubkey: bytes) -> bool:
    """True when this key's table (or its cached invalid-verdict) is
    already resident — the scalar-verify router (types/keys.verify_any)
    upgrades ONLY such keys to the table path, so one-off interactive
    verifies never populate a cache they will not reuse while
    steady-state consensus traffic (the same validator keys, vote after
    vote) always hits the fast path."""
    with _tables_lock:
        return bytes(pubkey) in _tables


def sign_expanded(a: int, prefix: bytes, pub: bytes, msg: bytes) -> bytes:
    """RFC 8032 sign from pre-expanded secrets — bit-identical to
    ed25519_ref.sign(seed, msg) where (a, prefix) = secret_expand(seed)
    and pub = point_compress(a*B): signing is deterministic and
    _mul_base computes the same group element as the ladder. The caller
    (PrivKey.sign) owns the expansion cache; nothing secret is stored
    here."""
    r = ref._sha512(prefix, msg) % _L
    R = ref.point_compress(_mul_base(r))
    h = ref._sha512(R, pub, msg) % _L
    s = (r + h * a) % _L
    return R + s.to_bytes(32, "little")


def public_key(seed: bytes) -> bytes:
    """RFC 8032 public key of a seed, byte-equal to
    ed25519_ref.public_key(seed), through the fixed-base table."""
    a, _ = ref.secret_expand(seed)
    return ref.point_compress(_mul_base(a))


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Drop-in for ed25519_ref.verify — identical verdicts, table math."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    tbl = _negA_table(bytes(pubkey))
    if tbl is _INVALID:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= _L:
        return False
    h = ref._sha512(sig[:32], pubkey, msg) % _L
    q = ref.point_add(_mul_base(s), _mul_negA(h, tbl))
    return ref.point_compress(q) == sig[:32]
