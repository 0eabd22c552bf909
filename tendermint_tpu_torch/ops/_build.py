"""Build and load the hand-written kernels of `csrc/` at first use.

The CUDA kernel is compiled by `nvcc` into a shared library with a plain
C interface and loaded with ctypes; no source includes PyTorch's headers,
so a build takes seconds. Pointers and the stream cross as integers
(`tensor.data_ptr()`, `torch.cuda.current_stream().cuda_stream`).

Libraries go to `tendermint_tpu_torch/_build/` (listed in `.gitignore`),
named by a hash of their sources and flags, so an edit rebuilds. A file
lock makes concurrent processes build once. A failed build raises with
the compiler's output; nothing falls back.

The same arithmetic header also builds with g++ into a CPU shim
(`csrc/cpu_shim.cpp`) that the CPU tests load, and g++ builds the host
prep extension (`csrc/prep.cpp`, loaded by `tendermint_tpu_torch.native`).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock, open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(sources):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _build(name, compiler, flags, main_src, headers=None) -> Path:
    """Compile `main_src` (with `headers`, by default every *.cuh of
    csrc/) into _build/lib<name>_<hash>.so unless it is there; returns
    the path. The hash covers the sources and the flags. The compiler's
    stderr is kept beside it as <lib>.log."""
    if headers is None:
        headers = sorted(CSRC.glob("*.cuh"))
    sources = [main_src, *headers]
    out = BUILD_DIR / f"lib{name}_{_digest(sources, flags)}.so"
    with _build_lock():
        if out.exists():
            return out
        tmp = out.with_suffix(".so.tmp")
        cmd = [compiler, *flags, "-I", str(CSRC), "-o", str(tmp),
               str(main_src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {main_src.name} failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        tmp.replace(out)
    return out


def _load(key, build, signatures):
    with _lock:
        lib = _libs.get(key)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build()))
    for fn, argtypes, restype in signatures:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    with _lock:
        _libs[key] = lib
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


def ladder_lib() -> ctypes.CDLL:
    """The CUDA verify and sign kernels (csrc/ladder.cu), built with
    nvcc."""
    return _load(
        "ladder",
        lambda: _build("ladder", find_nvcc(), NVCC_FLAGS, CSRC / "ladder.cu"),
        [("tm_ladder_verify", [_P] * 6 + [_I, _I, _P], _I),
         ("tm_ladder_verify_pre", [_P] * 8 + [_I, _I, _P], _I),
         ("tm_ladder_sign_rb", [_P] * 3 + [_I, _I, _P], _I),
         ("tm_ladder_occupancy", [_I], _I),
         ("tm_cuda_error_string", [_I], ctypes.c_char_p)])


def ladder_build_log() -> str:
    """nvcc's output for the current ladder build (registers, spills)."""
    sources = [CSRC / "ladder.cu"] + sorted(CSRC.glob("*.cuh"))
    log = BUILD_DIR / f"libladder_{_digest(sources, NVCC_FLAGS)}.log"
    return log.read_text() if log.exists() else ""


def cuda_error_string(lib, err: int) -> str:
    return f"{err} ({lib.tm_cuda_error_string(err).decode()})"


def cpu_shim_lib() -> ctypes.CDLL:
    """The kernel's arithmetic built for the CPU with g++ (tests only)."""
    gxx = shutil.which("g++") or "g++"
    return _load(
        "cpu_shim",
        lambda: _build("fe25519_cpu", gxx, GXX_FLAGS,
                       CSRC / "cpu_shim.cpp"),
        [("tm_cpu_fe_mul", [_P, _P, _P, _I], None),
         ("tm_cpu_fe_invert", [_P, _P, _I], None),
         ("tm_cpu_fe_canon", [_P, _P, _I], None),
         ("tm_cpu_verify", [_P] * 6 + [_I, _I], None),
         ("tm_cpu_verify_pre", [_P] * 8 + [_I, _I], None),
         ("tm_cpu_point_op", [_I, _I] + [_P] * 3 + [_I], None),
         ("tm_cpu_sign_rb", [_P] * 3 + [_I, _I], None)])
