"""Native host ops of the port: batched Ed25519 verify prep, the two host
phases of batched signing, and the ChaCha20-Poly1305 AEAD of the p2p
frame plane.

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

`csrc/aead.cpp` (RFC 8439 ChaCha20-Poly1305, the port's copy of the JAX
package's host AEAD) is built the same way into its own library, loaded
with ctypes, and held at first use to the RFC 8439 section 2.8.2 vector,
a burst round trip and a tamper rejection. A failed build or a failed
check raises: the frame plane never drops quietly to per-frame crypto.

`csrc/hostops.cpp` (SHA-256 with its SHA-NI compress, Merkle roots and
proofs, the part-set skeleton) is built the same way and loaded with
ctypes. `csrc/codec.cpp` (the canonical-JSON encoder) and
`csrc/kvcore.cpp` (the kvstore app's core; it includes hostops.cpp) are
CPython extensions, `_tmtorch_codec` and `_tmtorch_kv`. Each is the
port's copy of the JAX package's `native/` source of that name. A failed
build or load raises with the compiler's output; the plain Python
versions are called by name (`ops/merkle.*_plain`,
`types/encoding._pure_cdumps`, `KVStoreApp(use_native=False)`).

TM_CUDA_NO_NATIVE (any non-empty value; `disabled()`, read once a
process) is the operator's choice of the pure host routes, as
TM_TPU_NO_NATIVE is the JAX package's, read in its loaders: the callers
with one take it (the codec, the kv core, verify prep and the sign
phases, SHA-256 and the Merkle roots and proofs, the part-set build, the
front door's writes, the frame AEAD's per-frame path). Under the knob
each loader (`module`, `lib`, `aead_lib`, `hostops_lib`, `codec`, `kv`)
raises NativeDisabled, naming itself: a caller without a pure route
fails at its first use. The knob never disables a CUDA kernel.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import shutil
import sysconfig
import threading
from typing import List

import numpy as np

from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.utils import knobs

MODULE = "_tmtorch_prep"
PREP_SRC = _build.CSRC / "prep.cpp"
PREP_HEADERS = (_build.CSRC / "ed25519_host.h",)

_lock = threading.Lock()
_mod = None


class NativeDisabled(RuntimeError):
    """A native function was called with TM_CUDA_NO_NATIVE set."""


_no_native = None   # TM_CUDA_NO_NATIVE, read at the first disabled()


def disabled() -> bool:
    """True when TM_CUDA_NO_NATIVE is set (any non-empty value), read once
    a process."""
    global _no_native
    if _no_native is None:
        _no_native = knobs.knob_set("TM_CUDA_NO_NATIVE")
    return _no_native


def _refuse_if_disabled(loader: str) -> None:
    """The loaders' one check of TM_CUDA_NO_NATIVE."""
    if disabled():
        raise NativeDisabled(
            f"native.{loader}: TM_CUDA_NO_NATIVE is set and this caller "
            f"has no pure host route")


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
    _refuse_if_disabled("module")
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
    _refuse_if_disabled("lib")
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


# -- ChaCha20-Poly1305 (p2p SecretConnection frames) ------------------------

AEAD_SRC = _build.CSRC / "aead.cpp"
AEAD_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
FRAME_MAX = 1024   # plaintext bytes a frame carries (secret.DATA_MAX_SIZE)
_TAG = 16

_aead_checked = False


class AeadTagError(Exception):
    """A frame of a burst failed Poly1305 authentication."""


def aead_build():
    """Build the AEAD library unless it is built; returns its path."""
    gxx = shutil.which("g++") or "g++"
    return _build._build("tmtorch_aead", gxx, AEAD_FLAGS, AEAD_SRC,
                         headers=())


def aead_lib() -> ctypes.CDLL:
    """The AEAD library, built at first use and self-checked once."""
    global _aead_checked
    _refuse_if_disabled("aead_lib")
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    lib = _build._load(
        "tmtorch_aead", aead_build,
        [("tm_aead_seal_one", [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_char_p, u64, ctypes.c_char_p, u64,
                               _P], None),
         ("tm_aead_seal_burst", [ctypes.c_char_p, u64, u32, ctypes.c_char_p,
                                 _P, u64, _P], None),
         ("tm_aead_open_burst", [ctypes.c_char_p, u64, u32, ctypes.c_char_p,
                                 _P, u64, _P], ctypes.c_int64)])
    with _lock:
        if not _aead_checked:
            _aead_self_check(lib)
            _aead_checked = True
    return lib


_RFC8439_KEY = bytes(range(0x80, 0xA0))
_RFC8439_NONCE = bytes.fromhex("070000004041424344454647")
_RFC8439_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
_RFC8439_PT = (b"Ladies and Gentlemen of the class of '99: If I could "
               b"offer you only one tip for the future, sunscreen would "
               b"be it.")
_RFC8439_CT_HEAD = bytes.fromhex("d31a8d34648e60db7b86afbc53ef7ec2")
_RFC8439_TAG = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")


def _aead_self_check(lib) -> None:
    """Raise unless the built library reproduces the RFC 8439 section
    2.8.2 seal, round-trips a burst with counter nonces and refuses a
    flipped ciphertext bit."""
    sealed = _seal_one(lib, _RFC8439_KEY, _RFC8439_NONCE, _RFC8439_AAD,
                       _RFC8439_PT)
    if sealed[:16] != _RFC8439_CT_HEAD or sealed[-16:] != _RFC8439_TAG:
        raise RuntimeError("csrc/aead.cpp fails the RFC 8439 2.8.2 vector")
    key = bytes(range(32))
    chunks = [b"", b"a", b"frame-two", b"x" * FRAME_MAX]
    frames = split_wire(_seal_burst(lib, key, 5, chunks))
    opened = _open_burst(lib, key, 5, frames)
    if opened is None or [p[2:] for p in opened] != chunks or \
            [int.from_bytes(p[:2], "big") for p in opened] != \
            [len(c) for c in chunks]:
        raise RuntimeError("csrc/aead.cpp fails its burst round trip")
    bad = bytearray(frames[2])
    bad[0] ^= 1
    if _open_burst(lib, key, 5, [frames[0], frames[1], bytes(bad)]) \
            is not None:
        raise RuntimeError("csrc/aead.cpp opened a tampered frame")


def split_wire(wire: bytes) -> List[bytes]:
    """The sealed frames (ct || tag) of wire bytes: be32 length prefixes
    stripped."""
    frames, pos = [], 0
    while pos < len(wire):
        clen = int.from_bytes(wire[pos:pos + 4], "big")
        frames.append(wire[pos + 4:pos + 4 + clen])
        pos += 4 + clen
    return frames


def _offsets(parts) -> np.ndarray:
    off = np.zeros(len(parts) + 1, np.uint64)
    np.cumsum(np.fromiter(map(len, parts), np.uint64, len(parts)),
              out=off[1:])
    return off


def _nonce_split(nonce_start: int):
    return nonce_start & 0xFFFFFFFFFFFFFFFF, (nonce_start >> 64) & 0xFFFFFFFF


def _seal_one(lib, key, nonce12, aad, pt) -> bytes:
    out = ctypes.create_string_buffer(len(pt) + _TAG)
    lib.tm_aead_seal_one(key, nonce12, aad, len(aad), pt, len(pt), out)
    return out.raw


def _seal_burst(lib, key: bytes, nonce_start: int, chunks) -> bytes:
    off = _offsets(chunks)
    total = int(off[-1]) + 22 * len(chunks)
    out = ctypes.create_string_buffer(max(1, total))
    lo, hi = _nonce_split(nonce_start)
    lib.tm_aead_seal_burst(key, lo, hi, b"".join(chunks), off.ctypes.data,
                           len(chunks), out)
    return out.raw[:total]


def _open_burst(lib, key: bytes, nonce_start: int, frames):
    off = _offsets(frames)
    sizes = [len(f) - _TAG for f in frames]
    out = ctypes.create_string_buffer(max(1, sum(max(0, z) for z in sizes)))
    lo, hi = _nonce_split(nonce_start)
    rc = lib.tm_aead_open_burst(key, lo, hi, b"".join(frames),
                                off.ctypes.data, len(frames), out)
    if rc != len(frames):
        return None
    raw = out.raw
    plains, pos = [], 0
    for z in sizes:
        plains.append(raw[pos:pos + z])
        pos += z
    return plains


def _check_key(key: bytes) -> None:
    if len(key) != 32:
        raise ValueError(f"AEAD key must be 32 bytes, got {len(key)}")


def aead_seal_one(key: bytes, nonce12: bytes, aad: bytes,
                  pt: bytes) -> bytes:
    """One seal with an arbitrary 12-byte nonce and aad -> ct || tag (the
    surface the RFC vectors drive; frames always take the bursts)."""
    _check_key(key)
    if len(nonce12) != 12:
        raise ValueError(f"AEAD nonce must be 12 bytes, got {len(nonce12)}")
    return _seal_one(aead_lib(), key, nonce12, aad, pt)


def aead_seal_burst(key: bytes, nonce_start: int,
                    chunks: List[bytes]) -> bytes:
    """Seal each chunk (a payload of at most FRAME_MAX bytes, without its
    2-byte length header) as one SecretConnection frame, counter nonces
    from nonce_start; returns the wire bytes (be32 length prefix, then
    ct || tag, a frame) that per-frame sealing gives."""
    _check_key(key)
    for c in chunks:
        if len(c) > FRAME_MAX:
            raise ValueError(f"frame chunk exceeds {FRAME_MAX}B")
    return _seal_burst(aead_lib(), key, nonce_start, chunks)


def aead_open_burst(key: bytes, nonce_start: int,
                    frames: List[bytes]) -> List[bytes]:
    """Open sealed frames (ct || tag, wire length prefix stripped) with
    counter nonces from nonce_start; returns the plaintexts, each still
    carrying its 2-byte length header. Raises AeadTagError at the first
    frame that fails authentication."""
    _check_key(key)
    out = _open_burst(aead_lib(), key, nonce_start, frames)
    if out is None:
        raise AeadTagError("burst frame failed AEAD authentication")
    return out


# -- SHA-256, Merkle trees and part sets (csrc/hostops.cpp) -----------------

HOSTOPS_SRC = _build.CSRC / "hostops.cpp"
HOSTOPS_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# the same source with the SHA-NI route compiled out (tests of the
# portable compress on a CPU that has SHA-NI)
HOSTOPS_PORTABLE_FLAGS = HOSTOPS_FLAGS + ["-DTM_SHA256_PORTABLE"]

_U64 = ctypes.c_uint64
_HOSTOPS_SIGNATURES = [
    ("tm_sha256_batch", [ctypes.c_char_p, _P, _U64, _P], None),
    ("tm_merkle_root", [ctypes.c_char_p, _P, _U64, _P], None),
    ("tm_merkle_root_from_digests", [ctypes.c_char_p, _U64, _P], None),
    ("tm_merkle_proof", [ctypes.c_char_p, _P, _U64, _U64, _P, _P], _U64),
    ("tm_merkle_tree_proofs", [ctypes.c_char_p, _P, _U64, _P, _P], _U64),
    ("tm_partset_build", [ctypes.c_char_p, _U64, _U64, _P, _P], _U64),
    ("tm_sha256_shani", [], ctypes.c_int),
    ("tm_sendmany", [ctypes.c_int, _P, _P, _P, _P], None)]


def hostops_build(portable: bool = False):
    """Build the host-ops library unless it is built; returns its path."""
    gxx = shutil.which("g++") or "g++"
    if portable:
        return _build._build("tmtorch_hostops_portable", gxx,
                             HOSTOPS_PORTABLE_FLAGS, HOSTOPS_SRC, headers=())
    return _build._build("tmtorch_hostops", gxx, HOSTOPS_FLAGS, HOSTOPS_SRC,
                         headers=())


def hostops_lib(portable: bool = False) -> ctypes.CDLL:
    """The host-ops library (`portable`: without SHA-NI), built at first
    use."""
    _refuse_if_disabled("hostops_lib")
    return _build._load("hostops_portable" if portable else "hostops",
                        lambda: hostops_build(portable), _HOSTOPS_SIGNATURES)


def sha256_shani(lib=None) -> bool:
    """True when the library compresses SHA-256 with SHA-NI."""
    return bool((lib or hostops_lib()).tm_sha256_shani())


def _packed(items):
    """(concatenated bytes, uint64 offsets[n + 1]) of a list of bytes."""
    return b"".join(items), _offsets(items)


def _depth(n: int) -> int:
    return max(0, (max(n, 1) - 1).bit_length())


def _split_proofs(raw: bytes, n: int, depth: int) -> list:
    step = 32 * depth
    return [[raw[step * i + 32 * j:step * i + 32 * (j + 1)]
             for j in range(depth)] for i in range(n)]


def sha256_batch(items: List[bytes], lib=None) -> List[bytes]:
    """One SHA-256 digest an item, in one C call."""
    lib = lib or hostops_lib()
    data, off = _packed(items)
    out = ctypes.create_string_buffer(32 * max(1, len(items)))
    lib.tm_sha256_batch(data, off.ctypes.data, len(items), out)
    raw = out.raw
    return [raw[32 * i:32 * (i + 1)] for i in range(len(items))]


def merkle_root(items: List[bytes], lib=None) -> bytes:
    """Merkle root of raw items (leaf = SHA-256(0x00 || item))."""
    lib = lib or hostops_lib()
    data, off = _packed(items)
    out = ctypes.create_string_buffer(32)
    lib.tm_merkle_root(data, off.ctypes.data, len(items), out)
    return out.raw


def merkle_root_from_digests(digests, lib=None) -> bytes:
    """Merkle root over 32-byte leaf digests: a list of them or one flat
    bytes-like blob (length a multiple of 32)."""
    lib = lib or hostops_lib()
    if isinstance(digests, (bytes, bytearray, memoryview)):
        data = bytes(digests)
        n = len(data) // 32
    else:
        data = b"".join(digests)
        n = len(digests)
    out = ctypes.create_string_buffer(32)
    lib.tm_merkle_root_from_digests(data, n, out)
    return out.raw


def merkle_proof(items: List[bytes], index: int, lib=None):
    """(root, aunts leaf-up) of item `index`."""
    lib = lib or hostops_lib()
    data, off = _packed(items)
    root = ctypes.create_string_buffer(32)
    aunts = ctypes.create_string_buffer(32 * max(1, _depth(len(items))))
    depth = lib.tm_merkle_proof(data, off.ctypes.data, len(items), index,
                                root, aunts)
    raw = aunts.raw
    return root.raw, [raw[32 * j:32 * (j + 1)] for j in range(depth)]


def merkle_tree_proofs(items: List[bytes], lib=None):
    """(root, [aunts of each item]) from one tree build."""
    lib = lib or hostops_lib()
    n = len(items)
    data, off = _packed(items)
    root = ctypes.create_string_buffer(32)
    aunts = ctypes.create_string_buffer(32 * max(1, _depth(n) * n))
    depth = lib.tm_merkle_tree_proofs(data, off.ctypes.data, n, root, aunts)
    return root.raw, _split_proofs(aunts.raw, n, depth)


def partset_build(data: bytes, part_size: int, lib=None):
    """(root, [aunts of each part]) of the split of `data` into part_size
    chunks (one empty part for empty data): split, leaf hashing, tree and
    every proof in one C call."""
    if part_size <= 0:
        raise ValueError("part_size must be positive")
    lib = lib or hostops_lib()
    n = max(1, -(-len(data) // part_size))
    data = bytes(data)
    root = ctypes.create_string_buffer(32)
    aunts = ctypes.create_string_buffer(32 * max(1, _depth(n) * n))
    depth = lib.tm_partset_build(data, len(data), part_size, root, aunts)
    return root.raw, _split_proofs(aunts.raw, n, depth)


# -- canonical JSON and the kvstore core (CPython extensions) ---------------

CODEC_SRC = _build.CSRC / "codec.cpp"
KV_SRC = _build.CSRC / "kvcore.cpp"

_ext_mods: dict = {}


def codec_flags() -> list:
    return ["-O2", "-shared", "-fPIC", "-std=c++17",
            f"-I{python_include()}"]


def kv_flags() -> list:
    # C++20: the core's unordered_map takes transparent lookups
    return ["-O3", "-shared", "-fPIC", "-std=c++20",
            f"-I{python_include()}"]


def codec_build():
    """Build the canonical-JSON extension unless it is built."""
    gxx = shutil.which("g++") or "g++"
    return _build._build("tmtorch_codec", gxx, codec_flags(), CODEC_SRC,
                         headers=())


def kv_build():
    """Build the kvstore core extension unless it is built."""
    gxx = shutil.which("g++") or "g++"
    return _build._build("tmtorch_kv", gxx, kv_flags(), KV_SRC,
                         headers=(HOSTOPS_SRC,))


def _extension(modname: str, build):
    with _lock:
        mod = _ext_mods.get(modname)
        if mod is None:
            spec = importlib.util.spec_from_file_location(modname,
                                                          str(build()))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _ext_mods[modname] = mod
        return mod


def codec():
    """The `_tmtorch_codec` extension: canonical_dumps(obj) -> bytes, and
    the Fallback exception it raises for a shape it does not encode."""
    _refuse_if_disabled("codec")
    return _extension("_tmtorch_codec", codec_build)


def kv():
    """The `_tmtorch_kv` extension: kv_new, deliver_batch, set_one,
    commit, get, size, items."""
    _refuse_if_disabled("kv")
    return _extension("_tmtorch_kv", kv_build)
