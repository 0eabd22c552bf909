"""Canonical deterministic encoding: UTF-8 JSON with sorted keys, minimal
separators, bytes as lowercase hex, integer nanosecond times, no floats.

Counterpart of `tendermint_tpu/types/encoding.py`. `cdumps` encodes with
the native codec (`csrc/codec.cpp` through `native.codec()`), as the JAX
package does; `_pure_cdumps` is the specification, which the codec
equals byte for byte. The codec raises its `Fallback` for shapes it does
not encode (a non-str dict key, a lone surrogate, an object type it does
not know), and only then does `cdumps` take the specification path, the
reference's own rule. Under TM_CUDA_NO_NATIVE (`native.disabled()`)
every call takes the specification path, counted as `pure`. `stats()`
counts the calls by route. A codec that fails to build raises; nothing
drops quietly to Python.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any

from tendermint_tpu_torch import native


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


def _pure_cdumps(obj: Any) -> bytes:
    """The specification path: _canon + json.dumps."""
    return json.dumps(_canon(obj), sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode()


# (canonical_dumps, Fallback) of the codec, resolved at the first cdumps
_codec = None
_stats_lock = threading.Lock()
_stats = {"native": 0, "fallback": 0, "pure": 0}


def cdumps(obj: Any) -> bytes:
    """Canonical JSON bytes of a plain obj tree (dicts, lists, ints, str,
    bytes, None), through the native codec (the specification path under
    TM_CUDA_NO_NATIVE)."""
    global _codec
    if native.disabled():
        with _stats_lock:
            _stats["pure"] += 1
        return _pure_cdumps(obj)
    if _codec is None:
        mod = native.codec()
        _codec = (mod.canonical_dumps, mod.Fallback)
    fn, fallback = _codec
    try:
        out = fn(obj)
    except fallback:
        with _stats_lock:
            _stats["fallback"] += 1
        return _pure_cdumps(obj)
    with _stats_lock:
        _stats["native"] += 1
    return out


def stats() -> dict:
    """Calls the codec encoded (`native`), those it handed to the
    specification path (`fallback`) and those TM_CUDA_NO_NATIVE sent
    there (`pure`), since the process started."""
    with _stats_lock:
        return dict(_stats)


def cloads(data: bytes) -> Any:
    return json.loads(data.decode())


def chash(obj: Any) -> bytes:
    """SHA-256 of the canonical encoding."""
    return hashlib.sha256(cdumps(obj)).digest()


def hex_to_bytes(s: str | None) -> bytes | None:
    return None if s is None else bytes.fromhex(s)
