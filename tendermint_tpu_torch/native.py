"""Native host ops of the port: batched Ed25519 verify prep and the two
host phases of batched signing.

`csrc/prep.cpp` (with `csrc/ed25519_host.h`) is built with g++ at first
use into `tendermint_tpu_torch/_build/` (named by a hash of both sources
and the flags, under the build lock of `ops/_build.py`), against the
running interpreter's `Python.h`. The one library is loaded twice:

  as the CPython extension `_tmtorch_prep`: prep_items, sign_phase1,
      sign_phase2 (each hash loop with the GIL released), sha512_impl
  with ctypes: tm_ed25519_prepare (the verify prep over packed arrays)

SHA-512 is OpenSSL's when `libcrypto.so.3` loads at run time, a portable
one otherwise. A failed build raises with the compiler's output; nothing
falls back. Callers that want the hashlib versions call them by name
(`ops/ed25519.*_plain`).
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import shutil
import sysconfig
import threading

import numpy as np

from tendermint_tpu_torch.ops import _build

MODULE = "_tmtorch_prep"
PREP_SRC = _build.CSRC / "prep.cpp"
PREP_HEADERS = (_build.CSRC / "ed25519_host.h",)

_lock = threading.Lock()
_mod = None


def python_include() -> str:
    """The directory of the running interpreter's Python.h."""
    inc = sysconfig.get_paths().get("include") or ""
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(
            f"Python.h not found in {inc!r}: the host prep extension "
            f"(csrc/prep.cpp) cannot be built")
    return inc


def prep_flags() -> list:
    return ["-O3", "-shared", "-fPIC", "-std=c++17",
            f"-I{python_include()}"]


def build():
    """Build the prep library unless it is built; returns its path."""
    gxx = shutil.which("g++") or "g++"
    return _build._build("tmtorch_prep", gxx, prep_flags(), PREP_SRC,
                         headers=PREP_HEADERS)


def module():
    """The `_tmtorch_prep` extension module, built at first use."""
    global _mod
    with _lock:
        if _mod is None:
            spec = importlib.util.spec_from_file_location(MODULE,
                                                          str(build()))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mod = mod
        return _mod


_P = ctypes.c_void_p


def lib() -> ctypes.CDLL:
    """The same library through ctypes, for tm_ed25519_prepare."""
    return _build._load(
        "tmtorch_prep", build,
        [("tm_ed25519_prepare", [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_char_p, _P, ctypes.c_uint64,
                                 _P, _P], None)])


def sha512_impl() -> str:
    """"openssl" or "portable": the SHA-512 the extension hashes with."""
    return module().sha512_impl


def prep_items(items):
    """One-call verify prep: items [(pk, msg, sig), ...] -> (pk, R, s, h
    u8[N, 32], pre bool[N]) writable numpy arrays, or None when the batch
    needs the general path (a secp256k1 key, a member that is not
    `bytes`, an item that is not a triple)."""
    out = module().prep_items(items)
    if out is None:
        return None
    n = len(items)
    pk_b, rb_b, s_b, h_b, pre_b = out
    # one writable copy of each buffer a batch: views of bytes are
    # read-only, and torch.from_numpy warns on those

    def mat(b):
        return np.frombuffer(b, np.uint8).reshape(n, 32).copy()

    pre = np.frombuffer(pre_b, np.uint8).astype(np.bool_)
    return mat(pk_b), mat(rb_b), mat(s_b), mat(h_b), pre


def ed25519_prepare(pk_cat: bytes, sig_cat: bytes, msgs):
    """Verify prep over packed arrays in one C call: pk_cat n*32 bytes,
    sig_cat n*64, msgs n bytes objects -> (h u8[n, 32] =
    SHA-512(R || A || M) mod L, zero where s >= L; pre bool[n], s < L)."""
    n = len(msgs)
    if len(pk_cat) != 32 * n or len(sig_cat) != 64 * n:
        raise ValueError(
            f"ed25519_prepare: {n} msgs need {32 * n}/{64 * n} pk/sig "
            f"bytes, got {len(pk_cat)}/{len(sig_cat)}")
    data = b"".join(msgs)
    off = np.zeros(n + 1, np.uint64)
    np.cumsum(np.fromiter(map(len, msgs), np.uint64, n), out=off[1:])
    h = np.empty((n, 32), np.uint8)
    pre = np.empty(max(n, 1), np.uint8)
    lib().tm_ed25519_prepare(pk_cat, sig_cat, data, off.ctypes.data, n,
                             h.ctypes.data, pre.ctypes.data)
    return h, pre[:n].astype(np.bool_)


def sign_phase1(prefixes: bytes, msgs) -> bytes:
    """n*32 bytes of nonces r = SHA-512(prefix || M) mod L; prefixes is
    n*32 bytes, msgs n bytes objects."""
    return module().sign_phase1(prefixes, msgs)


def sign_phase2(renc: bytes, pks: bytes, msgs, rs: bytes,
                as_: bytes) -> bytes:
    """n*64 bytes of signatures R || s, k = SHA-512(R || A || M) mod L,
    s = (r + k*a) mod L; renc, pks, rs, as_ are n*32 bytes."""
    return module().sign_phase2(renc, pks, msgs, rs, as_)
