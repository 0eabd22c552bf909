"""Canonical deterministic encoding: UTF-8 JSON with sorted keys, minimal
separators, bytes as lowercase hex, integer nanosecond times, no floats.

Counterpart of `tendermint_tpu/types/encoding.py` (its specification
path; the JAX package's native encoder is byte-equal to it).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any


def _canon(obj: Any) -> Any:
    if isinstance(obj, (bytes, bytearray)):
        return obj.hex()
    if isinstance(obj, dict):
        return {k: _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, float):
        raise TypeError("floats are not deterministic; forbidden in "
                        "canonical encoding")
    if hasattr(obj, "to_obj"):
        return _canon(obj.to_obj())
    return obj


def cdumps(obj: Any) -> bytes:
    """Canonical JSON bytes of a plain obj tree."""
    return json.dumps(_canon(obj), sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode()


def cloads(data: bytes) -> Any:
    return json.loads(data.decode())


def chash(obj: Any) -> bytes:
    """SHA-256 of the canonical encoding."""
    return hashlib.sha256(cdumps(obj)).digest()


def hex_to_bytes(s: str | None) -> bytes | None:
    return None if s is None else bytes.fromhex(s)
