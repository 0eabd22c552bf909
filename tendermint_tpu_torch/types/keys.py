"""Ed25519 keys and the scalar host verify.

Counterpart of the Ed25519 half of `tendermint_tpu/types/keys.py`.
Address = first 20 bytes of SHA-256(pubkey). OpenSSL (`cryptography`)
verifies and signs when it imports; otherwise the table oracle
(`utils/ed25519_fast`) or the pure oracle (`utils/ed25519_ref`) does,
with bit-identical verdicts.

secp256k1 is not in the port yet: a 33-byte compressed SEC1 key raises
NotImplementedError rather than return a verdict that could differ from
the JAX package's.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from tendermint_tpu_torch.utils import ed25519_fast
from tendermint_tpu_torch.utils import ed25519_ref as _ref

_P255 = (1 << 255) - 19
# minimum ed25519 members before a host batch without OpenSSL uses the
# per-key table oracle (a one-off verify must not fill its cache)
_HOST_TABLE_MIN = 4


def address_of(pubkey: bytes) -> bytes:
    return hashlib.sha256(pubkey).digest()[:20]


def is_secp256k1(pubkey) -> bool:
    """A 33-byte compressed SEC1 key (0x02/0x03 prefix)."""
    return len(pubkey) == 33 and pubkey[0] in (2, 3)


def _reject_secp256k1(pubkey) -> None:
    if is_secp256k1(pubkey):
        raise NotImplementedError(
            "secp256k1 keys are not supported by the port yet")


def _openssl_classes():
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey, Ed25519PublicKey)
        return Ed25519PrivateKey, Ed25519PublicKey
    except ImportError:
        return None


_ossl = _openssl_classes()


def _noncanonical_point(enc: bytes) -> bool:
    """Encodings where OpenSSL is lenient but the oracle and the kernels
    reject: y >= p, or x = 0 (y = ±1) with the sign bit set. Routed to
    the pure oracle so verdicts agree everywhere."""
    y = int.from_bytes(enc, "little") & ((1 << 255) - 1)
    if y >= _P255:
        return True
    sign = enc[31] >> 7
    return bool(sign) and y in (1, _P255 - 1)


def _openssl_verify(pubkey: bytes, msg: bytes, sig: bytes):
    """Verdict through OpenSSL, or None when it is absent or the inputs
    fall in its leniency gap (the pure oracle then decides)."""
    if _ossl is None:
        return None
    if len(pubkey) == 32 and len(sig) == 64 and (
            _noncanonical_point(pubkey) or _noncanonical_point(sig[:32])):
        return None
    try:
        _ossl[1].from_public_bytes(pubkey).verify(sig, msg)
        return True
    except Exception:
        return False


@dataclass(frozen=True)
class PubKey:
    ed25519: bytes  # 32 bytes

    @property
    def address(self) -> bytes:
        return address_of(self.ed25519)


@dataclass(frozen=True)
class PrivKey:
    seed: bytes  # 32 bytes

    @classmethod
    def generate(cls, seed: bytes | None = None) -> "PrivKey":
        return cls(seed if seed is not None else os.urandom(32))

    @property
    def pubkey(self) -> PubKey:
        # cached per instance, never in a module-level memo (that would
        # keep raw seeds alive past the owning key)
        pk = self.__dict__.get("_pub")
        if pk is None:
            pk = PubKey(ed25519_fast.public_key(self.seed))
            self.__dict__["_pub"] = pk
        return pk

    def sign(self, msg: bytes) -> bytes:
        """RFC 8032 signature (deterministic: OpenSSL and the table
        signer give the same bytes)."""
        k = self.__dict__.get("_osslk")
        if k is None:
            if _ossl is None:
                exp = self.__dict__.get("_exp")
                if exp is None:
                    a, prefix = _ref.secret_expand(self.seed)
                    exp = (a, prefix, self.pubkey.ed25519)
                    self.__dict__["_exp"] = exp
                return ed25519_fast.sign_expanded(*exp, msg)
            k = _ossl[0].from_private_bytes(self.seed)
            self.__dict__["_osslk"] = k
        return k.sign(msg)


def verify_any(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Scalar verify: 32-byte keys are Ed25519 (OpenSSL, else the table
    oracle for resident keys, else the pure oracle); secp256k1 raises
    NotImplementedError; anything else is False."""
    _reject_secp256k1(pubkey)
    if len(pubkey) != 32:
        return False
    out = _openssl_verify(pubkey, msg, sig)
    if out is not None:
        return out
    if ed25519_fast.has_table(pubkey):
        return ed25519_fast.verify(pubkey, msg, sig)
    return _ref.verify(pubkey, msg, sig)


def verify_many(items) -> list:
    """Host batch verify of (pubkey, msg, sig) triples, routed as
    verify_any, except that without OpenSSL a batch of at least
    _HOST_TABLE_MIN Ed25519 members uses the per-key table oracle."""
    for p, _m, _s in items:
        _reject_secp256k1(p)
    ed = sum(1 for it in items
             if isinstance(it[0], (bytes, bytearray)) and len(it[0]) == 32)
    if ed >= _HOST_TABLE_MIN and _ossl is None:
        return [ed25519_fast.verify(p, m, s)
                if isinstance(p, (bytes, bytearray)) and len(p) == 32
                else verify_any(p, m, s)
                for p, m, s in items]
    return [verify_any(p, m, s) for p, m, s in items]
