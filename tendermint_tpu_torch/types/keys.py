"""Key types and the scalar host verify: Ed25519 and secp256k1.

Counterpart of `tendermint_tpu/types/keys.py`. Address = first 20 bytes
of SHA-256(pubkey).

Ed25519 (32-byte keys): OpenSSL (`cryptography`) verifies and signs when
it imports; otherwise the table oracle (`utils/ed25519_fast`) or the pure
oracle (`utils/ed25519_ref`) does, with bit-identical verdicts.

secp256k1 (33-byte compressed SEC1 keys, DER ECDSA-SHA256 signatures)
verifies on the host only: OpenSSL when it imports, else
`utils/secp256k1_ref` behind a strict DER check, so that both routes give
OpenSSL's verdict (the pure parser alone accepts non-minimal and negative
DER integers). Signing is RFC 6979 on both routes, byte-equal to
`secp256k1_ref.sign`.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from tendermint_tpu_torch.utils import ed25519_fast
from tendermint_tpu_torch.utils import ed25519_ref as _ref
from tendermint_tpu_torch.utils import secp256k1_ref

_P255 = (1 << 255) - 19
# minimum ed25519 members before a host batch without OpenSSL uses the
# per-key table oracle (a one-off verify must not fill its cache)
_HOST_TABLE_MIN = 4


def address_of(pubkey: bytes) -> bytes:
    return hashlib.sha256(pubkey).digest()[:20]


def is_secp256k1(pubkey) -> bool:
    """A 33-byte compressed SEC1 key (0x02/0x03 prefix)."""
    return len(pubkey) == 33 and pubkey[0] in (2, 3)


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

    def verify(self, msg: bytes, sig: bytes) -> bool:
        return verify_any(self.ed25519, msg, sig)

    def to_obj(self):
        return {"type": "ed25519", "value": self.ed25519.hex()}

    @classmethod
    def from_obj(cls, obj) -> "PubKey":
        if obj["type"] != "ed25519":
            raise ValueError(f"not an ed25519 key: {obj['type']!r}")
        return cls(bytes.fromhex(obj["value"]))


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

    def to_obj(self):
        return {"type": "ed25519", "value": self.seed.hex()}

    @classmethod
    def from_obj(cls, obj) -> "PrivKey":
        if obj["type"] != "ed25519":
            raise ValueError(f"not an ed25519 key: {obj['type']!r}")
        return cls(bytes.fromhex(obj["value"]))


# ---------------------------------------------------------------- secp256k1

def _ec():
    """OpenSSL's EC bindings, or None when `cryptography` is absent."""
    try:
        from cryptography.hazmat.primitives.asymmetric import ec
        return ec
    except ImportError:
        return None


def _der_strict(sig: bytes) -> bool:
    """The signature is the minimal DER of its own (r, s): what OpenSSL
    requires and the pure parser does not check."""
    try:
        r, s = secp256k1_ref._der_decode(sig)
    except (ValueError, TypeError):
        return False
    return secp256k1_ref._der_encode(r, s) == bytes(sig)


@dataclass(frozen=True)
class Secp256k1PubKey:
    """Compressed SEC1 point (33 bytes); DER-encoded ECDSA-SHA256
    signatures."""
    secp256k1: bytes

    @property
    def address(self) -> bytes:
        return address_of(self.secp256k1)

    def verify(self, msg: bytes, sig: bytes) -> bool:
        ec = _ec()
        if ec is None:
            return _der_strict(sig) and secp256k1_ref.verify(
                self.secp256k1, msg, sig)
        from cryptography.hazmat.primitives import hashes
        try:
            pub = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256K1(), self.secp256k1)
            pub.verify(sig, msg, ec.ECDSA(hashes.SHA256()))
            return True
        except Exception:
            return False

    def to_obj(self):
        return {"type": "secp256k1", "value": self.secp256k1.hex()}

    @classmethod
    def from_obj(cls, obj) -> "Secp256k1PubKey":
        if obj["type"] != "secp256k1":
            raise ValueError(f"not a secp256k1 key: {obj['type']!r}")
        return cls(bytes.fromhex(obj["value"]))


@dataclass(frozen=True)
class Secp256k1PrivKey:
    seed: bytes  # 32-byte big-endian private scalar in [1, n-1]

    @classmethod
    def generate(cls, seed: bytes | None = None) -> "Secp256k1PrivKey":
        """Any 32 bytes map into [1, n-1]: v = seed mod (n - 1) + 1."""
        if seed is None:
            seed = os.urandom(32)
        v = int.from_bytes(seed, "big") % (secp256k1_ref.N - 1) + 1
        return cls(v.to_bytes(32, "big"))

    def _key(self, ec):
        k = self.__dict__.get("_osslk")
        if k is None:
            k = ec.derive_private_key(int.from_bytes(self.seed, "big"),
                                      ec.SECP256K1())
            self.__dict__["_osslk"] = k
        return k

    @property
    def pubkey(self) -> Secp256k1PubKey:
        pk = self.__dict__.get("_pub")
        if pk is None:
            ec = _ec()
            if ec is None:
                pk = Secp256k1PubKey(secp256k1_ref.pubkey_of(self.seed))
            else:
                from cryptography.hazmat.primitives import serialization
                pk = Secp256k1PubKey(self._key(ec).public_key().public_bytes(
                    serialization.Encoding.X962,
                    serialization.PublicFormat.CompressedPoint))
            self.__dict__["_pub"] = pk
        return pk

    def sign(self, msg: bytes) -> bytes:
        """DER(r, s) with the RFC 6979 nonce on both routes."""
        ec = _ec()
        if ec is None:
            return secp256k1_ref.sign(self.seed, msg)
        from cryptography.hazmat.primitives import hashes
        return self._key(ec).sign(
            msg, ec.ECDSA(hashes.SHA256(), deterministic_signing=True))

    def to_obj(self):
        return {"type": "secp256k1", "value": self.seed.hex()}

    @classmethod
    def from_obj(cls, obj) -> "Secp256k1PrivKey":
        if obj["type"] != "secp256k1":
            raise ValueError(f"not a secp256k1 key: {obj['type']!r}")
        return cls(bytes.fromhex(obj["value"]))


def pubkey_from_obj(obj):
    """{type, value} -> PubKey or Secp256k1PubKey."""
    if obj["type"] == "ed25519":
        return PubKey.from_obj(obj)
    if obj["type"] == "secp256k1":
        return Secp256k1PubKey.from_obj(obj)
    raise ValueError(f"unknown pubkey type {obj['type']!r}")


def privkey_from_obj(obj):
    if obj["type"] == "ed25519":
        return PrivKey.from_obj(obj)
    if obj["type"] == "secp256k1":
        return Secp256k1PrivKey.from_obj(obj)
    raise ValueError(f"unknown privkey type {obj['type']!r}")


def verify_any(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Scalar verify routed by key encoding: 32-byte keys are Ed25519
    (OpenSSL, else the table oracle for resident keys, else the pure
    oracle), 33-byte 0x02/0x03 keys secp256k1; anything else is False."""
    if len(pubkey) == 32:
        out = _openssl_verify(pubkey, msg, sig)
        if out is not None:
            return out
        if ed25519_fast.has_table(pubkey):
            return ed25519_fast.verify(pubkey, msg, sig)
        return _ref.verify(pubkey, msg, sig)
    if is_secp256k1(pubkey):
        return Secp256k1PubKey(bytes(pubkey)).verify(msg, sig)
    return False


def verify_many(items) -> list:
    """Host batch verify of (pubkey, msg, sig) triples, routed as
    verify_any, except that without OpenSSL a batch of at least
    _HOST_TABLE_MIN Ed25519 members uses the per-key table oracle."""
    ed = sum(1 for it in items
             if isinstance(it[0], (bytes, bytearray)) and len(it[0]) == 32)
    if ed >= _HOST_TABLE_MIN and _ossl is None:
        return [ed25519_fast.verify(p, m, s)
                if isinstance(p, (bytes, bytearray)) and len(p) == 32
                else verify_any(p, m, s)
                for p, m, s in items]
    return [verify_any(p, m, s) for p, m, s in items]
