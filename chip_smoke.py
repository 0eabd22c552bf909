"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and power limit (nvidia-smi), then the build
   of the host prep extension (csrc/prep.cpp with g++ against the
   interpreter's Python.h: compiler, flags, include path, seconds, and
   the SHA-512 it hashes with) and of the CUDA kernels from csrc/ (nvcc),
   with its time and each kernel's registers, stack and spills from the
   ptxas report; the SM count and nvidia-smi's clocks.max.sm, which give
   the integer pipe's rate the kernels' bound is taken at. Beside the
   build nvcc compiles a standalone probe of one and of two chained field
   products; the difference of their SASS is printed as a diagnostic of
   the compiler's overhead: the IMAD issue slots it spends on a product,
   against the SLOTS_PER_MUL the product needs.
2. kernels: a seeded batch of 1024 signatures with edge lanes (valid,
   tampered R / s / message, a pubkey off the curve, x = 0 with the sign
   bit set, y >= p, zero padding) and 256 small-order probe lanes
   (torsion and mixed-order keys, torsion R with s = 0, R with y = p ...
   p + 18, x = 0 with the sign bit and y = p - 1) through both verify
   kernels and their plain PyTorch versions on the card; verdicts must be
   bit-equal to each other and to the oracle. Then the lanes sweep: the
   edge rows tiled to 2048 (the 10k commit's padded tail), 8192 (the main
   path's chunk) and 32768 signatures, each launch timed, held to the
   oracle at every size and to the plain version at 2048 and 8192.
3. commit path: a 10,000-validator commit (seeded keys, signed with the
   port's table signer) through ValidatorSet.verify_commit ->
   BatchVerifier("auto") -> native prep -> CUDA kernels, three times: the
   predecompression cache must walk full -> fill -> hit, and every item
   must take the native prep (`prep_stats`). Then one more hit call,
   its wall split into stages read inside that call, at the functions
   the path itself calls (commit items, native prep, padding, cache-row
   assembly, the six uploads, the kernel launch, the rest of the
   dispatch, the resolver's wait and mask, the power check; the kernels'
   device time from their events), and the hashlib prep on the call's
   items, which must give the same bytes as its native prep. A commit
   with one flipped signature byte must raise "invalid signature in
   commit". Kernel launch counts are zeroed just before and read just
   after: the five calls launch B1 and B2 themselves.
4. mixed commit: the same commit with 16 validators (seeded places) on
   secp256k1 keys, from a cold cache: full -> fill -> hit over the
   Ed25519 chunks, the secp256k1 items verified on the host. Verdicts of
   a copy with four tampered items of each kind are held to the oracles
   (secp256k1_ref on every secp256k1 item, the Ed25519 oracle on the
   tampered ones and a seeded sample). A flipped byte in one secp256k1
   precommit, and the same precommit re-encoded with a non-minimal DER
   integer, must each raise "invalid signature in commit". Launch counts
   zeroed just before, read just after.
5. sign kernel: a seeded batch of 1024 scalars with edge values (0, 1, 2,
   L - 1, 2^252, 2^252 - 1, and unreduced ones whose signed recoding
   carries out of the top window: L, L + 1, 2^255, 2^256 - 1, every
   nibble 8) through the r*B kernel (a fixed-base comb) and its plain
   version (the TPU kernel's windowed schedule) on the card; encodings
   must be byte-equal to each other and to the oracle. Then the same rows
   tiled to 4096, 16384 (the signing chunk) and 65536 scalars, each
   launch timed and held to both again; and at 16384 the kernel at one
   window, checked the same way: the one-window time is the floor of
   inverse and encode, the rest of the 64-window time is the 63 comb adds.
6. lite path: a light-client header chain at BASELINE.json config 5's
   width (64 validators of power 10; 4096 headers, the one cut), every
   commit signed through sign_batch_async (native nonce and finish
   phases, r*B on the sign kernel), a seeded sample held against the
   table signer, then certify_chain -> BatchVerifier("auto") -> native
   prep -> verify kernels, whose cache routes must be 1 full, 1 fill, 30
   hit. Launch counts are zeroed before the build and read after the
   certify. Three forgeries must then fail with the JAX package's
   messages: a flipped signature byte, a header changed after signing,
   another trusted set.
7. block height: one consensus height of the 10,000-validator chain of
   phase 3 through the port's block plane. Propose a block of 5,000 txs
   (BASELINE.json config 4's width), with phase 3's commit as its last
   commit and one duplicate-vote evidence: fill_header, its part set at
   ConsensusParams' 65536-byte parts and its block id. Gossip: a receiver
   adds every part through its proof, refuses one with a flipped payload
   byte, and rebuilds the block, whose hash and block id must equal the
   proposer's. Prevotes, then precommits: 10,000 of each signed with
   sign_batch_async (the sign kernel), fed with a flipped signature, a
   duplicate and a conflicting vote through one VoteSet.add_votes_batch,
   which must make one verify_async call that reaches the verify kernels
   and give the expected results and errors, and +2/3 for the block; the
   call's host stages are read inside it. make_commit, verify_commit on
   the card, and its hash in the next header. The evidence through a
   BatchVerifier("cuda") and the default verifier (its host loop at two
   signatures); a forged copy must raise on both. The device Merkle
   plane: merkle.root of the txs against Data.hash, and hash_fixed on a
   seeded uint8[65536, 64] batch against hashlib, each timed beside
   hashlib. Launch counts zeroed at the start of the phase, read at its
   end.
8. the kernel table as one JSON line, the card again, then the last line
   {"ok": true, "device": {...}}.

Any mismatch or exception ends the run with a non-zero code before the
last line. Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tendermint_tpu_torch import native
from tendermint_tpu_torch.lite import (CertificationError, FullCommit,
                                       SignedHeader, ValidatorsChangedError,
                                       certify_chain, default_window)
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import _build, ladder, merkle, sha256
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.types.block import (Block, BlockID, Commit, Data,
                                              EvidenceData, Header,
                                              PartSetHeader)
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.keys import PrivKey, Secp256k1PrivKey
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote, VoteType
from tendermint_tpu_torch.types.vote_set import ConflictingVoteError, VoteSet
from tendermint_tpu_torch.utils import (ed25519_fast, ed25519_ref,
                                        secp256k1_ref, vectors)

SEED = 20261016
N_CHECK = 1024            # edge batch for kernel vs plain
N_PROBE = 256             # small-order probe lanes for kernel vs plain
N_TIME = 8192             # the main path's full chunk
N_VALIDATORS = 10_000     # BASELINE.json config 3
TIME_REPS = 5
CHAIN = "chip-smoke"
HEIGHT = 3
N_SIGN_CHECK = 1024       # edge scalars for the sign kernel vs plain
LITE_VALIDATORS = 64      # BASELINE.json config 5's width
LITE_HEADERS = 4096       # config 5 has 1M headers: the one cut
LITE_CHAIN = "chip-smoke-lite"
LITE_ROUTES = {"full": 1, "fill": 1, "hit": 30}
N_SECP = 16               # secp256k1 validators of the mixed commit
N_ORACLE_SAMPLE = 128     # untampered Ed25519 items held to the oracle
SWEEP = (2048, 8192, 32768)  # verify lanes timed; the first two also
PLAIN_CHECK = (2048, 8192)   # held to the plain version
SIGN_SWEEP = (4096, 16384, 65536)  # sign scalars timed; 16384 the chunk
BLOCK_TXS = 5000          # BASELINE.json config 4's block width
# the block's gossip parts: ConsensusParams' default, 65536 bytes
BLOCK_PART_SIZE = ConsensusParams().block_gossip.block_part_size_bytes
SHA_ROWS = 65536          # hash_fixed batch of 64-byte rows
# H100 SXM published HBM rate (NVIDIA data sheet), bytes/s
HBM_BYTES_S = 3.35e12
# 32-bit integer multiply-adds an SM issues per clock on sm_90 (CUDA C++
# Programming Guide, arithmetic instruction throughput): half the
# float32 rate. The field products run on this pipe.
IMAD_PER_SM_CLOCK = 64
# Issue slots of that pipe one field product of csrc/fe25519.cuh (fe_mul;
# a squaring is computed, and counted, as a product) needs: 100 signed
# 32x32->64 multiply-adds at two slots each (200), the 9 limbs of g used
# times 19 and the 5 odd limbs of f times 2 at one slot each (14), and
# the carry's fold of the top carry times 19, one wide multiply-add (2).
SLOTS_PER_MUL = 200 + 14 + 2
# one field product, and two chained: the difference of their SASS is
# what the compiler spends on a product (a diagnostic, not the bound)
PROBE_SRC = r"""
#include "fe25519.cuh"
using fe25519::fe;
extern "C" __global__ void probe_mul1(const fe *a, const fe *b, fe *o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = fe25519::fe_mul(a[i], b[i]);
}
extern "C" __global__ void probe_mul2(const fe *a, const fe *b, fe *o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = fe25519::fe_mul(fe25519::fe_mul(a[i], b[i]), b[i]);
}
"""

KERNELS = {
    "verify": {"name": "verify (B1, fused)",
               "replaces": "tendermint_tpu/ops/ladder_pallas.py:432"},
    "verify_pre": {"name": "verify_pre (B2, predecompressed)",
                   "replaces": "tendermint_tpu/ops/ladder_pallas.py:511"},
    "sign_rb": {"name": "sign_rb (B3, fixed-base r*B)",
                "replaces": "tendermint_tpu/ops/ladder_pallas.py:589"},
}
VERIFY_KERNELS = ("verify", "verify_pre")


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


_PTXAS_NAMES = {"ladder_kernelILb1": "verify", "ladder_kernelILb0": "verify_pre",
                "sign_rb_kernel": "sign_rb"}


def _ptxas(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel, from nvcc's
    -Xptxas -v report."""
    out: dict = {}
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln) or re.search(
            r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = next((v for k, v in _PTXAS_NAMES.items()
                        if k in m.group(1)), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def _start_probe(nvcc: str) -> tuple:
    """Start nvcc on the field-product probe; returns (process, cubin)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "fe_mul_probe.cu"
    src.write_text(PROBE_SRC)
    cubin = _build.BUILD_DIR / "fe_mul_probe.cubin"
    cmd = [nvcc, "-cubin", "-O3", "-gencode=arch=compute_90a,code=sm_90a",
           "-std=c++17", "-I", str(_build.CSRC), "-o", str(cubin), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), cubin


def _sass_counts(nvcc: str, cubin) -> dict:
    """{function: {opcode: count}} from cuobjdump -sass."""
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = counts.setdefault(m.group(1), {})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      ln)
        if m and fn is not None:
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    return counts


def _imad_slots(ops: dict) -> int:
    """Issue slots on the integer multiply-add pipe: a 32x32->64 wide
    multiply-add (IMAD.WIDE*) takes two, every other IMAD* one."""
    return sum(c * (2 if ".WIDE" in op else 1)
               for op, c in ops.items() if op.startswith("IMAD"))


def phase_build() -> tuple:
    """Build the kernels (and the probe beside them); returns (the
    integer rate the bounds are taken at, each kernel's ptxas report and
    blocks per SM)."""
    t0 = time.perf_counter()
    prep_lib = native.build()
    prep = {"compiler": shutil.which("g++"), "flags": native.prep_flags(),
            "include": native.python_include(), "library": prep_lib.name,
            "seconds": time.perf_counter() - t0,
            "sha512_impl": native.sha512_impl()}
    t0 = time.perf_counter()
    nvcc = _build.find_nvcc()
    probe, cubin = _start_probe(nvcc)
    lib = _build.ladder_lib()
    build_s = time.perf_counter() - t0
    probe_log = probe.communicate()[0]
    require(probe.returncode == 0, f"the field-product probe failed to "
                                   f"build:\n{probe_log}")
    counts = _sass_counts(nvcc, cubin)
    one, two = counts["probe_mul1"], counts["probe_mul2"]
    slots = _imad_slots(two) - _imad_slots(one)
    instrs = sum(two.values()) - sum(one.values())
    require(slots > 0, f"no IMAD in the probe's SASS: {counts}")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = {"slots_per_mul": SLOTS_PER_MUL,
            "probe_imad_slots_per_mul": slots,
            "probe_instructions_per_mul": instrs,
            "probe_imad_opcodes_per_mul": {
                op: two.get(op, 0) - one.get(op, 0) for op in two
                if op.startswith("IMAD") and two.get(op, 0) != one.get(op, 0)},
            "sm_count": sms, "sm_clock_max_mhz": clock_mhz,
            "imad_slots_per_s": sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6}
    ptxas = _ptxas(_build.ladder_build_log())
    require(set(ptxas) == set(KERNELS), f"ptxas report incomplete: {ptxas}")
    for k, name in enumerate(KERNELS):
        ptxas[name]["blocks_per_sm"] = lib.tm_ladder_occupancy(k)
        require(ptxas[name]["blocks_per_sm"] > 0, f"occupancy of {name}")
    emit({"phase": "build", "seconds": round(build_s, 3), "ptxas": ptxas,
          "int_rate": rate, "prep": prep})
    return rate, ptxas


def _cuda_rows(batch, device):
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ("pk", "rb", "s", "h")}


def _kernel_and_plain(name, t):
    """Both callables of one kernel on the rows `t` (its inputs on the
    card): the wrapper that launches the kernel, and its plain version."""
    digs = (ladder.digits_from_bytes(t["s"]), ladder.digits_from_bytes(t["h"]))
    if name == "verify":
        return (lambda: ladder.verify(t["pk"], t["rb"], t["s"], t["h"]),
                lambda: ladder.verify_plain(t["pk"], t["rb"], *digs))
    dec = ted._decompress_to_bytes(t["pk"])
    return (lambda: ladder.verify_pre(*dec, t["rb"], t["s"], t["h"]),
            lambda: ladder.verify_pre_plain(*dec, t["rb"], *digs))


def _time_ms(fn, reps: int) -> tuple:
    """(ms per call over `reps` calls after one warm call, the output of
    the last call)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def _compare(name, got, want, expect, n, lanes) -> int:
    """Hold kernel verdicts against the plain version's (unless `want` is
    None) and the oracle's; returns the largest absolute difference from
    the plain version."""
    err = 0 if want is None else int((got.int() - want.int()).abs().max())
    agree = (want is None or bool(torch.equal(got, want))) and bool(
        (got.cpu().numpy() == expect).all())
    emit({"phase": "kernel_check", "kernel": name, "n": n, "lanes": lanes,
          "max_abs_err": err, "held_to_plain": want is not None,
          "equal_to_plain_and_oracle": agree})
    require(agree and err == 0,
            f"{name} disagrees with its plain version or the oracle at {n}")
    return err


# bytes one lane reads and writes: pk, R, s, h in and a verdict out; the
# cached (-A).x, A.y, ok, R, s, h in and a verdict out; r in and R out
LANE_BYTES = {"verify": 4 * 32 + 4, "verify_pre": 5 * 32 + 1 + 4,
              "sign_rb": 32 + 32}


def _muls_ms(muls: float, rate: dict) -> float:
    """ms that `muls` field products take at the integer pipe's rate."""
    return 1e3 * muls * rate["slots_per_mul"] / rate["imad_slots_per_s"]


def _bound(name: str, n: int, rate: dict,
           n_windows: int = ladder.N_WINDOWS) -> tuple:
    """(least ms the card could take for n lanes of a kernel, what bounds
    it): each input byte read once and each output byte written once at
    the HBM rate, against the launch's field products
    (`ladder.bound_field_muls`: for the sign kernel the least work of the
    batch, one inverse shared by all) of SLOTS_PER_MUL each at the
    integer multiply-add pipe's rate."""
    bytes_ms = 1e3 * n * LANE_BYTES[name] / HBM_BYTES_S
    ops_ms = _muls_ms(ladder.bound_field_muls(name, n, n_windows), rate)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _tiled(batch, n: int) -> tuple:
    """The rows of `batch` tiled to n lanes, and the oracle's verdicts."""
    reps = -(-n // len(batch["expect"]))
    rows = {k: np.ascontiguousarray(np.tile(batch[k], (reps, 1))[:n])
            for k in ("pk", "rb", "s", "h")}
    return rows, np.tile(batch["expect"], reps)[:n]


def phase_kernels(device, rate: dict) -> dict:
    batch = vectors.edge_batch(N_CHECK, seed=SEED)
    lanes = sorted(set(batch["kind"]))
    t = _cuda_rows(batch, device)
    results = {}
    for name in VERIFY_KERNELS:
        kernel, plain = _kernel_and_plain(name, t)
        got, want = kernel(), plain()
        results[name] = {"max_abs_err": _compare(
            name, got, want, batch["expect"], N_CHECK, lanes)}
    # the small-order and non-canonical lanes of vectors.probe_batch
    probe = vectors.probe_batch(N_PROBE, seed=SEED + 4)
    tp = _cuda_rows(probe, device)
    for name in VERIFY_KERNELS:
        kernel, plain = _kernel_and_plain(name, tp)
        err = _compare(name, kernel(), plain(), probe["expect"], N_PROBE,
                       sorted(set(probe["kind"])))
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    # the lanes sweep: the edge rows tiled to the main path's shapes
    # (2048 is the 10k commit's padded tail, 8192 the full chunk) and to
    # 32768, each launch timed
    require(ted._bucket(N_VALIDATORS % tverifier.BATCH_CHUNK) in SWEEP
            and N_TIME in PLAIN_CHECK, "the sweep misses a main-path shape")
    for name in VERIFY_KERNELS:
        err = results[name]["max_abs_err"]
        sweep = {}
        for n in SWEEP:
            rows, expect = _tiled(batch, n)
            kernel, plain = _kernel_and_plain(name, _cuda_rows(rows, device))
            ms, got = _time_ms(kernel, TIME_REPS)
            want = None
            if n in PLAIN_CHECK:
                p_ms, want = _time_ms(plain, 1)
                if n == N_TIME:
                    plain_ms = p_ms
            err = max(err, _compare(name, got, want, expect, n, lanes))
            bound_ms, _ = _bound(name, n, rate)
            sweep[n] = ms
            emit({"phase": "kernel_sweep", "kernel": name, "n": n, "ms": ms,
                  "us_per_signature": 1e3 * ms / n, "bound_ms": bound_ms})
        bound_ms, bound_by = _bound(name, N_TIME, rate)
        results[name] = {
            "max_abs_err": err, "ms": sweep[N_TIME], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / sweep[N_TIME], "n": N_TIME,
            "sweep_ms": sweep}
        emit({"phase": "kernel_time", "kernel": name, **results[name]})
    return results


def _seeds(n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [rng.bytes(32) for _ in range(n)]


def _keys(n: int, seed: int):
    """(a, prefix, pubkey) of the RFC 8032 seeds _seeds(n, seed)."""
    out = []
    for s in _seeds(n, seed):
        a, prefix = ed25519_ref.secret_expand(s)
        pub = ed25519_ref.point_compress(ed25519_fast._mul_base(a))
        out.append((a, prefix, pub))
    return out


def build_commit(keys, secp=None):
    """(valset, block_id, commit): every validator precommits for one
    block with its own timestamp, signed with the port's table signer;
    `secp` {index in keys: Secp256k1PrivKey} puts secp256k1 keys in
    those validators' places."""
    secp = secp or {}
    pubs = [secp[i].pubkey.secp256k1 if i in secp else pub
            for i, (_, _, pub) in enumerate(keys)]
    vs = ValidatorSet([Validator(p, 10 + i % 7) for i, p in enumerate(pubs)])
    by_pub = {p: secp.get(i, keys[i]) for i, p in enumerate(pubs)}
    bid = BlockID(b"\x5a" * 32, PartSetHeader(4, b"\xa5" * 32))
    votes = []
    for idx, val in enumerate(vs.validators):
        v = Vote(val.address, idx, HEIGHT, 0, 1_700_000_000_000 + idx,
                 VoteType.PRECOMMIT, bid)
        key = by_pub[val.pubkey]
        sb = v.sign_bytes(CHAIN)
        v.signature = key.sign(sb) if isinstance(key, Secp256k1PrivKey) \
            else ed25519_fast.sign_expanded(key[0], key[1], val.pubkey, sb)
        votes.append(v)
    return vs, bid, Commit(bid, votes)


def _time_launches(log: list):
    """Wrap the kernels' launcher so that every launch records CUDA events
    around itself on the current stream into `log` as (name, n, start,
    end). Returns the launcher it wrapped, for the caller to put back."""
    inner = ladder._launch

    def launch(name, fn_name, rows, n_windows, **kw):
        stream = torch.cuda.current_stream(rows[0].device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = inner(name, fn_name, rows, n_windows, **kw)
        end.record(stream)
        log.append((name, rows[0].shape[0], start, end))
        return out

    ladder._launch = launch
    return inner


def _kernel_ms(timed) -> dict:
    """Sum of the CUDA event times of the launches in `timed`, by kernel."""
    out: dict = {}
    for name, _, start, end in timed:
        end.synchronize()
        out[name] = out.get(name, 0.0) + start.elapsed_time(end)
    return out


def _route(before, after) -> dict:
    return {k: after[k] - before[k] for k in ("full", "fill", "hit")}


def _prep_delta(before) -> dict:
    after = ted.prep_stats()
    return {k: after[k] - before[k] for k in after}


def _zero_launches() -> None:
    for name in ladder.launches:
        ladder.launches[name] = 0


def _require_launched(launches: dict, kernels, path: str) -> None:
    require(all(launches[k] > 0 for k in kernels),
            f"a kernel of the {path} path never launched: {launches}")


def _verify_routes(phase: str, vs, bid, commit, n_ed: int, timer: list,
                   card: str) -> list:
    """verify_commit three times; the cache must walk full -> fill -> hit
    over the commit's Ed25519 chunks, and every item must take the
    native prep. Returns the walls in ms."""
    chunks = -(-n_ed // tverifier.BATCH_CHUNK)
    prep_before = ted.prep_stats()
    walls = []
    for call, route in enumerate(("full", "fill", "hit")):
        before = ted.predecomp_stats()
        mark = len(timer)
        t1 = time.perf_counter()
        vs.verify_commit(CHAIN, bid, HEIGHT, commit)
        wall = time.perf_counter() - t1
        walls.append(wall * 1e3)
        timed = timer[mark:]
        kernel_ms = sum(_kernel_ms(timed).values())
        got = _route(before, ted.predecomp_stats())
        emit({"phase": phase, "call": call, "route": got,
              "launches": [(nm, n) for nm, n, _, _ in timed],
              "wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
              "sigs_per_s": len(vs) / wall, "card": card})
        require(got == {"full": 0, "fill": 0, "hit": 0, route: chunks},
                f"{phase} call {call} took cache route {got}, want "
                f"{chunks} x {route}")
    prep = _prep_delta(prep_before)
    emit({"phase": "prep_route", "path": phase, **prep})
    require(prep["native"] == 3 * n_ed and prep["plain"] == 0,
            f"the {phase} calls did not all take the native prep: {prep}")
    return walls


def _restore(saved) -> None:
    for owner, name, fn in saved:
        if fn is None:              # a method of the instance's class
            delattr(owner, name)
        else:
            setattr(owner, name, fn)


def _patched(patches):
    """Install (owner, name, fn) patches; returns what to restore."""
    saved = [(owner, name, vars(owner).get(name)) for owner, name, _ in patches]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    return saved


def _hit_breakdown(vs, bid, commit, timer: list, card: str) -> None:
    """Where a steady-state (hit) call's wall goes, read inside one more
    real hit call of verify_commit: the functions at its stage boundaries
    are wrapped for that call so that each adds its host time to a stage
    (commit items, native prep, padding, cache-row assembly, uploads,
    kernel launch, the rest of the dispatch — the pinned copies and the
    event —, the resolver's wait and mask, the power check); the kernels'
    device time comes from their events. Then the hashlib prep on the
    call's own items, which must give the same bytes as its native prep."""
    verifier = tverifier.default_verifier()
    st = dict.fromkeys(("items_ms", "dispatch_ms", "host_prep_ms", "pad_ms",
                        "assembly_ms", "upload_ms", "launch_ms",
                        "resolve_ms", "check_ms"), 0.0)
    kept: dict = {}

    def timed(fn, stage):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                st[stage] += (time.perf_counter() - t0) * 1e3
        return call

    def prep_and_keep(items, prep=ted.prep_items):
        kept["items"], kept["prep"] = items, prep(items)
        return kept["prep"]

    def dispatch(items, verify_async=verifier.verify_async):
        return timed(verify_async(items), "resolve_ms")

    patches = [
        (vs, "commit_verification_items",
         timed(vs.commit_verification_items, "items_ms")),
        (vs, "check_commit_results",
         timed(vs.check_commit_results, "check_ms")),
        (verifier, "verify_async", timed(dispatch, "dispatch_ms")),
        (ted, "prep_items", timed(prep_and_keep, "host_prep_ms")),
        (ted, "_pad_to", timed(ted._pad_to, "pad_ms")),
        (ted, "_predecomp_rows", timed(ted._predecomp_rows, "assembly_ms")),
        (ted, "_upload", timed(ted._upload, "upload_ms")),
        (ladder, "verify_pre", timed(ladder.verify_pre, "launch_ms"))]
    route_before, prep_before, mark = (ted.predecomp_stats(),
                                       ted.prep_stats(), len(timer))
    saved = _patched(patches)
    try:
        t0 = time.perf_counter()
        vs.verify_commit(CHAIN, bid, HEIGHT, commit)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        _restore(saved)
    items = kept["items"]
    chunks = -(-len(items) // tverifier.BATCH_CHUNK)
    got = _route(route_before, ted.predecomp_stats())
    require(got == {"full": 0, "fill": 0, "hit": chunks},
            f"the breakdown's call took cache route {got}")
    require(_prep_delta(prep_before)["native"] == len(items),
            "the hit call's items did not take the native prep")
    t0 = time.perf_counter()
    plain = ted.prepare_batch_bytes_plain(*zip(*items))
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(np.array_equal(a, b) for a, b in zip(kept["prep"], plain))
    require(same, "native prep differs from the hashlib prep")
    # dispatch_ms holds the prep ... launch stages; the rest of it is the
    # pinned copies, the event and the chunk loop
    st["dispatch_rest_ms"] = st["dispatch_ms"] - sum(
        st[k] for k in ("host_prep_ms", "pad_ms", "assembly_ms", "upload_ms",
                        "launch_ms"))
    host_ms = sum(st[k] for k in ("items_ms", "dispatch_ms", "resolve_ms",
                                  "check_ms"))
    emit({"phase": "hit_breakdown", "wall_ms": wall, **st,
          "unattributed_ms": wall - host_ms,
          "kernel_ms": sum(_kernel_ms(timer[mark:]).values()),
          "plain_prep_ms": plain_ms, "prep_equal_to_plain": same,
          "sha512_impl": native.sha512_impl(), "card": card})


def phase_main(card: str, n_validators: int = N_VALIDATORS) -> tuple:
    t0 = time.perf_counter()
    keys = _keys(n_validators, SEED)
    vs, bid, commit = build_commit(keys)
    emit({"phase": "generate", "validators": n_validators,
          "seconds": round(time.perf_counter() - t0, 3)})

    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    _verify_routes("verify_commit", vs, bid, commit, n_validators, timer,
                   card)
    _hit_breakdown(vs, bid, commit, timer, card)

    bad = Commit(bid, list(commit.precommits))
    k = n_validators // 3
    vote = copy.copy(bad.precommits[k])
    vote.signature = vote.signature[:20] + bytes([vote.signature[20] ^ 1]) + \
        vote.signature[21:]
    bad.precommits[k] = vote
    raised = None
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, bad)
    except ValueError as e:
        raised = str(e)
    emit({"phase": "tampered_commit", "raised": raised})
    require(raised == "invalid signature in commit",
            f"tampered commit: {raised!r}")
    launches = dict(ladder.launches)
    ladder._launch = inner
    _require_launched(launches, VERIFY_KERNELS, "commit")
    return launches, keys, (vs, bid, commit)


def _nonminimal_der(sig: bytes) -> bytes:
    """The same (r, s) with r's DER integer given one more leading zero
    byte: not DER, which OpenSSL rejects and secp256k1_ref.verify accepts."""
    r, s = secp256k1_ref._der_decode(sig)
    ri = secp256k1_ref._der_int(r)
    body = b"\x02" + bytes([ri[1] + 1]) + b"\x00" + ri[2:] + \
        secp256k1_ref._der_int(s)
    return b"\x30" + bytes([len(body)]) + body


def _flip(sig: bytes, i: int) -> bytes:
    return sig[:i] + bytes([sig[i] ^ 1]) + sig[i + 1:]


def _commit_raises(vs, bid, commit, k: int, sig: bytes):
    bad = Commit(bid, list(commit.precommits))
    vote = copy.copy(bad.precommits[k])
    vote.signature = sig
    bad.precommits[k] = vote
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, bad)
    except ValueError as e:
        return str(e)
    return None


@contextlib.contextmanager
def _secp_route(route: str):
    """Run the body with types/keys' secp256k1 route as named: "pure"
    hides `cryptography`'s EC bindings, "openssl" leaves them."""
    name = "cryptography.hazmat.primitives.asymmetric"
    saved = sys.modules.get(name, _secp_route)
    if route == "pure":
        sys.modules[name] = None
    try:
        require(route == ("openssl" if tkeys._ec() else "pure"),
                f"secp256k1 route {route} not in force")
        yield
    finally:
        if saved is _secp_route:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = saved


def phase_mixed(card: str, keys) -> dict:
    """The 10,000-validator commit with N_SECP validators (seeded places)
    on secp256k1 keys: through verify_commit from a cold cache (full ->
    fill -> hit: B1, then B2), the secp256k1 items verified on the host;
    verdicts on a batch with tampered items of both kinds held to the
    oracles; a flipped byte and a non-minimal DER re-encoding in one
    secp256k1 precommit must each raise."""
    rng = np.random.RandomState(SEED + 5)
    places = sorted(int(i) for i in rng.choice(len(keys), N_SECP,
                                                replace=False))
    secp = {i: Secp256k1PrivKey.generate(rng.bytes(32)) for i in places}
    t0 = time.perf_counter()
    vs, bid, commit = build_commit(keys, secp)
    emit({"phase": "mixed_generate", "validators": len(vs),
          "secp256k1": N_SECP, "places": places,
          "seconds": time.perf_counter() - t0})
    n_ed = len(vs) - N_SECP
    with ted._predecomp_lock:       # a cold cache: the path walks all routes
        ted._predecomp.clear()
        ted._predecomp_seen.clear()
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    walls = _verify_routes("mixed_commit", vs, bid, commit, n_ed, timer,
                           card)

    items, _ = vs.commit_verification_items(CHAIN, bid, HEIGHT, commit)
    secp_idx = [i for i, it in enumerate(items) if len(it[0]) == 33]
    ed_idx = [i for i, it in enumerate(items) if len(it[0]) == 32]
    require(len(secp_idx) == N_SECP and len(ed_idx) == n_ed,
            "the mixed commit's key kinds")
    bad = set(rng.choice(secp_idx, 4, replace=False).tolist()) | \
        set(rng.choice(ed_idx, 4, replace=False).tolist())
    items = [(p, m, _flip(sg, 10)) if i in bad else (p, m, sg)
             for i, (p, m, sg) in enumerate(items)]
    t0 = time.perf_counter()
    got = tverifier.default_verifier().verify(items)
    verify_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    expect = np.ones(len(items), np.bool_)
    for i in secp_idx:
        expect[i] = secp256k1_ref.verify(*items[i])
    secp_ms = (time.perf_counter() - t0) * 1e3
    sample = sorted(set(rng.choice(ed_idx, N_ORACLE_SAMPLE, replace=False)
                        .tolist()) | (bad & set(ed_idx)))
    for i in sample:
        expect[i] = ed25519_fast.verify(*items[i])
    agree = bool(np.array_equal(got, expect))
    emit({"phase": "mixed_verdicts", "items": len(items),
          "secp_route": "openssl" if tkeys._ec() else "pure",
          "tampered": sorted(bad), "rejected": int((~got).sum()),
          "oracle_sample": len(sample), "equal_to_oracles": agree,
          "verify_ms": verify_ms, "secp_oracle_ms": secp_ms, "card": card})
    require(agree and int((~got).sum()) == len(bad),
            "mixed-key verdicts differ from the oracles")

    k = next(j for j, v in enumerate(vs.validators) if len(v.pubkey) == 33)
    sig = commit.precommits[k].signature
    nonmin = _nonminimal_der(sig)
    require(secp256k1_ref.verify(vs.validators[k].pubkey,
                                 commit.precommits[k].sign_bytes(CHAIN),
                                 nonmin),
            "the pure parser should accept the non-minimal DER integer")
    # both secp256k1 routes of types/keys: OpenSSL where `cryptography`
    # imports, and the pure one (its EC bindings hidden) in any case
    routes = ["openssl", "pure"] if tkeys._ec() is not None else ["pure"]
    for route in routes:
        with _secp_route(route):
            for what, forged in (("flipped secp256k1 signature byte",
                                  _flip(sig, 12)),
                                 ("non-minimal DER integer", nonmin)):
                raised = _commit_raises(vs, bid, commit, k, forged)
                emit({"phase": "mixed_tampered", "secp_route": route,
                      "forgery": what, "raised": raised})
                require(raised == "invalid signature in commit",
                        f"mixed commit, {route} route, {what}: {raised!r}")
    launches = dict(ladder.launches)
    ladder._launch = inner
    _require_launched(launches, VERIFY_KERNELS, "mixed commit")
    emit({"phase": "mixed_commit_summary", "walls_ms": walls,
          "launches": launches, "card": card})
    return launches


def _sign_edge_scalars(n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    L = ed25519_ref.L
    edge = [0, 1, 2, L - 1, 1 << 252, (1 << 252) - 1,
            # unreduced: the comb's recoding carries out of window 63
            L, L + 1, 1 << 255, (1 << 256) - 1, int("88" * 32, 16)]
    return edge + [int.from_bytes(rng.bytes(32), "little") % L
                   for _ in range(n - len(edge))]


SIGN_LANES = ("r = 0, 1, 2, L-1, 2^252, 2^252-1, L, L+1, 2^255, 2^256-1, "
              "0x88..88, random < L")


def _rb_oracle(rs, n_windows: int) -> np.ndarray:
    """enc((r mod 16^n_windows) * B) of each r, by the reference."""
    m = 1 << 4 * n_windows
    return np.stack([np.frombuffer(ed25519_ref.point_compress(
        ed25519_ref.point_mul(r % m, ed25519_ref.BASE)), np.uint8)
        for r in rs])


def phase_sign_kernel(device, rate: dict) -> dict:
    """The r*B kernel against its plain version and the oracle on 1024
    edge scalars, then on those tiled to SIGN_SWEEP, each size timed;
    then at the signing chunk at one window, timed and checked."""
    rs = _sign_edge_scalars(N_SIGN_CHECK, SEED + 1)
    r_np = np.stack([np.frombuffer(r.to_bytes(32, "little"), np.uint8)
                     for r in rs])
    n_chunk = ted.SIGN_CHUNK
    require(n_chunk in SIGN_SWEEP, "the sign sweep misses the chunk")
    err, sweep, by_windows = 0, {}, {}
    full = ladder.N_WINDOWS
    for n_windows, sizes in ((full, (N_SIGN_CHECK,) + SIGN_SWEEP),
                             (1, (n_chunk,))):
        expect = _rb_oracle(rs, n_windows)
        for n in sizes:
            reps = -(-n // N_SIGN_CHECK)
            r = torch.from_numpy(np.ascontiguousarray(
                np.tile(r_np, (reps, 1))[:n])).to(device)
            digits = ladder.digits_from_bytes(r)
            ms, got = _time_ms(lambda: ladder.sign_rb(r, n_windows),
                               TIME_REPS)
            if n == n_chunk:
                p_ms, want = _time_ms(
                    lambda: ladder.sign_rb_plain(digits, n_windows), 1)
                by_windows[n_windows] = ms
                if n_windows == full:
                    plain_ms = p_ms
            else:
                want = ladder.sign_rb_plain(digits, n_windows)
            e = int((got.int() - want.int()).abs().max())
            agree = bool(torch.equal(got, want)) and bool(
                (got.cpu().numpy() == np.tile(expect, (reps, 1))[:n]).all())
            emit({"phase": "kernel_check", "kernel": "sign_rb", "n": n,
                  "n_windows": n_windows, "lanes": SIGN_LANES,
                  "max_abs_err": e, "equal_to_plain_and_oracle": agree})
            require(agree and e == 0,
                    f"sign_rb disagrees with its plain version or the "
                    f"oracle at {n} scalars, {n_windows} windows")
            err = max(err, e)
            if n in SIGN_SWEEP:
                bound_ms, _ = _bound("sign_rb", n, rate, n_windows)
                if n_windows == full:
                    sweep[n] = ms
                emit({"phase": "kernel_sweep", "kernel": "sign_rb", "n": n,
                      "n_windows": n_windows, "ms": ms,
                      "us_per_scalar": 1e3 * ms / n, "bound_ms": bound_ms})
    # where the 64-window time goes: the one-window launch is one comb add,
    # the carry's add, the inverse and the encode; the rest is 63 adds
    adds_ms = by_windows[full] - by_windows[1]
    emit({"phase": "sign_windows", "n": n_chunk,
          "ms_by_windows": by_windows,
          "field_muls_by_windows": {w: ladder.field_muls("sign_rb", w)
                                    for w in by_windows},
          "floor_ms": by_windows[1], "adds_ms": adds_ms,
          "ms_per_window": adds_ms / (full - 1),
          "floor_share": by_windows[1] / by_windows[full]})
    bound_ms, bound_by = _bound("sign_rb", n_chunk, rate)
    # beside it, the bound on the TPU kernel's windowed schedule (the plain
    # version's), the yardstick of the kernel this one replaced
    windowed_ms = _muls_ms(
        n_chunk * ladder.field_muls("sign_rb_plain"), rate)
    res = {"max_abs_err": err, "ms": sweep[n_chunk], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / sweep[n_chunk],
           "bound_ms_windowed": windowed_ms,
           "share_of_windowed_bound": windowed_ms / sweep[n_chunk],
           "n": n_chunk, "sweep_ms": sweep}
    emit({"phase": "kernel_time", "kernel": "sign_rb", **res})
    return {"sign_rb": res}


def build_lite_chain(n_vals: int, n_headers: int):
    """(valset, FullCommits of heights 1..n_headers, a seeded sample of
    (seed, msg, sig), timings): every validator signs every header's
    precommit; the signatures come from sign_batch_async, dispatched
    before the vote objects are built and resolved after."""
    t0 = time.perf_counter()
    seeds = [(i + 1).to_bytes(32, "little") for i in range(n_vals)]
    keys = [PrivKey.generate(s) for s in seeds]
    valset = ValidatorSet([Validator(k.pubkey.ed25519, 10) for k in keys])
    order = {k.pubkey.address: i for i, k in enumerate(keys)}
    idx_of = [order[v.address] for v in valset.validators]
    vals = valset.validators
    vhash = valset.hash()
    headers, bids = [], []
    for h in range(1, n_headers + 1):
        header = Header(chain_id=LITE_CHAIN, height=h, time_ns=h,
                        validators_hash=vhash, app_hash=h.to_bytes(32, "big"))
        headers.append(header)
        bids.append(BlockID(header.hash(), PartSetHeader(1, b"\x22" * 32)))
    # v0.16 sign bytes carry no validator identity: one message a height
    msgs = [Vote(vals[0].address, 0, h, 0, h, VoteType.PRECOMMIT,
                 bids[h - 1]).sign_bytes(LITE_CHAIN)
            for h in range(1, n_headers + 1)]
    sig_seeds = [seeds[idx_of[j]] for _ in range(n_headers)
                 for j in range(n_vals)]
    sig_msgs = [m for m in msgs for _ in range(n_vals)]
    t1 = time.perf_counter()
    resolve = ted.sign_batch_async(sig_seeds, sig_msgs)
    t2 = time.perf_counter()
    fcs, votes = [], []
    for i, h in enumerate(range(1, n_headers + 1)):
        precommits = [Vote(v.address, j, h, 0, h, VoteType.PRECOMMIT,
                           bids[i]) for j, v in enumerate(vals)]
        votes.extend(precommits)
        fcs.append(FullCommit(SignedHeader(headers[i],
                                           Commit(bids[i], precommits),
                                           bids[i]), valset))
    t3 = time.perf_counter()
    sigs = resolve()
    t4 = time.perf_counter()
    for v, sig in zip(votes, sigs):
        v.signature = sig
    n_sigs = len(sigs)
    rng = np.random.RandomState(SEED + 2)
    sample = [(sig_seeds[i], sig_msgs[i], sigs[i])
              for i in rng.choice(n_sigs, 1024, replace=False)]
    times = {"headers_ms": (t1 - t0) * 1e3, "sign_dispatch_ms": (t2 - t1) * 1e3,
             "votes_ms": (t3 - t2) * 1e3, "sign_resolve_ms": (t4 - t3) * 1e3,
             "sign_wall_ms": ((t2 - t1) + (t4 - t3)) * 1e3,
             "build_s": time.perf_counter() - t0}
    return valset, fcs, sample, times


def _check_sample(sample) -> None:
    """Each sampled signature byte-equal to the table signer's."""
    expanded: dict = {}
    bad = 0
    for seed, msg, sig in sample:
        exp = expanded.get(seed)
        if exp is None:
            a, prefix = ed25519_ref.secret_expand(seed)
            exp = expanded[seed] = (a, prefix, ed25519_fast.public_key(seed))
        bad += ed25519_fast.sign_expanded(*exp, msg) != sig
    emit({"phase": "lite_sign_sample", "n": len(sample), "mismatched": bad})
    require(bad == 0, f"{bad} of {len(sample)} sampled signatures differ "
                      "from the table signer's")


def _expect_raise(what: str, fcs, trusted, cls, check) -> None:
    raised = None
    try:
        certify_chain(LITE_CHAIN, fcs, trusted=trusted)
    except CertificationError as e:
        raised = e
    msg = None if raised is None else f"{type(raised).__name__}: {raised}"
    emit({"phase": "lite_forgery", "forgery": what, "raised": msg})
    require(isinstance(raised, cls) and check(str(raised)),
            f"forgery {what!r}: {msg}")


def phase_lite(card: str) -> dict:
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    prep_before = ted.prep_stats()
    valset, fcs, sample, times = build_lite_chain(LITE_VALIDATORS,
                                                  LITE_HEADERS)
    n_sigs = LITE_VALIDATORS * LITE_HEADERS
    sign_prep = _prep_delta(prep_before)
    sign_ms = _kernel_ms(timer).get("sign_rb", 0.0)
    emit({"phase": "lite_build", "validators": LITE_VALIDATORS,
          "headers": LITE_HEADERS, "signatures": n_sigs, **times,
          "sign_kernel_ms": sign_ms,
          "sign_sigs_per_s": n_sigs / (times["sign_wall_ms"] / 1e3),
          "prep_route": sign_prep, "card": card})
    require(sign_prep["sign_native"] == n_sigs,
            f"the chain's signing did not take the native phases: "
            f"{sign_prep}")
    _check_sample(sample)

    mark = len(timer)
    before = ted.predecomp_stats()
    prep_before = ted.prep_stats()
    t0 = time.perf_counter()
    certify_chain(LITE_CHAIN, fcs, trusted=valset)
    wall = time.perf_counter() - t0
    routes = _route(before, ted.predecomp_stats())
    certify_prep = _prep_delta(prep_before)
    launches = dict(ladder.launches)
    kernel_ms = _kernel_ms(timer[mark:])
    emit({"phase": "lite_certify", "headers": LITE_HEADERS,
          "window": default_window(LITE_VALIDATORS), "route": routes,
          "wall_ms": wall * 1e3, "headers_per_s": LITE_HEADERS / wall,
          "sigs_per_s": n_sigs / wall, "kernel_ms": kernel_ms,
          "device_busy": sum(kernel_ms.values()) / (wall * 1e3),
          "launches": launches, "prep_route": certify_prep, "card": card})
    require(routes == LITE_ROUTES,
            f"certify_chain took cache routes {routes}, want {LITE_ROUTES}")
    require(certify_prep["native"] == n_sigs and certify_prep["plain"] == 0,
            f"certify_chain's items did not take the native prep: "
            f"{certify_prep}")
    _require_launched(launches, KERNELS, "lite")
    ladder._launch = inner

    rng = np.random.RandomState(SEED + 3)
    h_bad = int(rng.randint(1, LITE_HEADERS + 1))
    j_bad = int(rng.randint(LITE_VALIDATORS))
    fc = fcs[h_bad - 1]
    sh = fc.signed_header
    precommits = list(sh.commit.precommits)
    vote = copy.copy(precommits[j_bad])
    vote.signature = vote.signature[:40] + bytes([vote.signature[40] ^ 1]) \
        + vote.signature[41:]
    precommits[j_bad] = vote
    forged = list(fcs)
    forged[h_bad - 1] = FullCommit(SignedHeader(
        sh.header, Commit(sh.block_id, precommits), sh.block_id), valset)
    _expect_raise(f"flipped signature byte at height {h_bad}", forged,
                  valset, CertificationError,
                  lambda m: m == f"height {h_bad}: invalid signature in "
                                "commit")

    h_moved = int(rng.randint(1, LITE_HEADERS + 1))
    sh = fcs[h_moved - 1].signed_header
    header = copy.copy(sh.header)
    header.app_hash = b"\xee" * 32
    moved = list(fcs)
    moved[h_moved - 1] = FullCommit(SignedHeader(header, sh.commit,
                                                 sh.block_id), valset)
    _expect_raise(f"app_hash changed after signing at height {h_moved}",
                  moved, valset, CertificationError,
                  lambda m: m == "commit is not for this header")

    other = ValidatorSet([Validator(v.pubkey, v.voting_power + 1)
                          for v in valset.validators])
    _expect_raise("another trusted set", fcs, other, ValidatorsChangedError,
                  lambda m: m == "valset discontinuity at height 1")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: one consensus height through the block plane
# ---------------------------------------------------------------------------

def _ms() -> float:
    return time.perf_counter() * 1e3


def _launch_delta(before: dict) -> dict:
    return {k: ladder.launches[k] - before[k] for k in ladder.launches}


def _step_kernels(timer: list, mark: int) -> dict:
    """The kernels' event ms and launches of the launches logged since
    `mark`."""
    timed = timer[mark:]
    counts: dict = {}
    for name, _, _, _ in timed:
        counts[name] = counts.get(name, 0) + 1
    return {"kernel_ms": _kernel_ms(timed), "launches": counts}


def _block_evidence(vs, last_commit, key_of) -> DuplicateVoteEvidence:
    """A validator's precommit in the last commit, and its second
    precommit at that height and round for another block, signed with
    the table signer."""
    j = len(vs) // 2
    val = vs.validators[j]
    a, prefix, pub = key_of[val.pubkey]
    first = last_commit.precommits[j]
    second = Vote(val.address, j, first.height, first.round,
                  first.timestamp_ns + 1, VoteType.PRECOMMIT,
                  BlockID(b"\xe7" * 32, first.block_id.parts))
    second.signature = ed25519_fast.sign_expanded(
        a, prefix, pub, second.sign_bytes(CHAIN))
    return DuplicateVoteEvidence(val.pubkey, first, second)


def _step_propose(vs, last_commit, evidence, height, part_size, card):
    """Step 1: build and fill the block, its part set and its block id."""
    txs = [b"k%d.%d=v" % (height, i) for i in range(BLOCK_TXS)]
    t0 = _ms()
    header = Header(chain_id=CHAIN, height=height,
                    time_ns=1_700_000_000_000_000_000 + height,
                    num_txs=len(txs), total_txs=len(txs),
                    last_block_id=last_commit.block_id,
                    validators_hash=vs.hash(),
                    consensus_hash=ConsensusParams().hash(),
                    app_hash=b"\x0a" * 32)
    block = Block(header, Data(txs), EvidenceData([evidence]), last_commit)
    t1 = _ms()
    block.fill_header()
    t2 = _ms()
    data = block.to_bytes()
    t3 = _ms()
    ps = block.make_part_set(part_size)
    t4 = _ms()
    block_id = block.block_id(part_size)
    t5 = _ms()
    block.validate_basic()
    emit({"phase": "block_propose", "height": height, "txs": len(txs),
          "last_commit_precommits": last_commit.size(), "evidence": 1,
          "block_bytes": len(data), "part_size": part_size,
          "parts": ps.total, "wall_ms": t5 - t0,
          "stages_ms": {"header": t1 - t0, "fill_header": t2 - t1,
                        "to_bytes": t3 - t2, "part_set": t4 - t3,
                        "block_id": t5 - t4},
          "card": card})
    require(ps.total > 1 and block_id.parts == ps.header(),
            "the block's part set")
    return block, ps, block_id


def _step_gossip(block, ps, block_id, part_size, card) -> None:
    """Step 2: a receiver takes every part through its proof, refuses a
    part with a flipped payload byte, and rebuilds the block."""
    rx = PartSet.from_header(block_id.parts)
    good = ps.get_part(ps.total // 2)
    bad = Part(good.index, _flip(good.payload, 100), good.proof)
    t0 = _ms()
    refused = None
    try:
        rx.add_part(bad)
    except ValueError as e:
        refused = str(e)
    t1 = _ms()
    added = [rx.add_part(ps.get_part(i)) for i in range(ps.total)]
    t2 = _ms()
    got = Block.from_bytes(rx.get_data())
    t3 = _ms()
    same = got.hash() == block.hash() and got.block_id(part_size) == block_id
    t4 = _ms()
    emit({"phase": "block_gossip", "parts": ps.total, "refused": refused,
          "proofs_verified": sum(added), "equal_to_proposer": same,
          "wall_ms": t4 - t0,
          "stages_ms": {"tampered_part": t1 - t0, "add_parts": t2 - t1,
                        "from_bytes": t3 - t2, "hash_and_block_id": t4 - t3},
          "card": card})
    require(refused == "invalid part proof" and rx.bit_array()[good.index],
            f"the tampered part: {refused!r}")
    require(all(added) and rx.is_complete(), "a part's proof failed")
    require(same, "the received block's hash or block id differs")


def _add_batch_read(vset, votes, timer):
    """vset.add_votes_batch(votes), its host stages read inside the call
    by wrapping, for that call only, what it calls at their boundaries:
    the first Vote.sign_bytes ends the validation loop, the verifier's
    verify_async call ends the sign bytes and is the dispatch (native
    prep inside it), its resolver is the wait, and what follows the
    resolver is the _add_verified loop. Returns (results, errors, stats)."""
    verifier = tverifier.default_verifier()
    marks: dict = {}
    prep = {"ms": 0.0}
    calls: list = []
    sign_bytes = Vote.sign_bytes

    def first_sign_bytes(self, chain_id):
        if "sign_bytes" not in marks:
            marks["sign_bytes"] = _ms()
        return sign_bytes(self, chain_id)

    def timed_prep(items, fn=ted.prep_items):
        t0 = _ms()
        try:
            return fn(items)
        finally:
            prep["ms"] += _ms() - t0

    def dispatch(items, verify_async=verifier.verify_async):
        marks["dispatch"] = _ms()
        launched = dict(ladder.launches)
        res = verify_async(items)
        marks["dispatched"] = _ms()
        calls.append((len(items), _launch_delta(launched)))

        def resolve():
            marks["resolve"] = _ms()
            try:
                return res()
            finally:
                marks["resolved"] = _ms()
        return resolve

    mark = len(timer)
    route_before, prep_before = ted.predecomp_stats(), ted.prep_stats()
    saved = _patched([(Vote, "sign_bytes", first_sign_bytes),
                      (ted, "prep_items", timed_prep),
                      (verifier, "verify_async", dispatch)])
    try:
        t0 = _ms()
        results, errors = vset.add_votes_batch(votes)
        t1 = _ms()
    finally:
        _restore(saved)
    stages = {"validation": marks["sign_bytes"] - t0,
              "sign_bytes": marks["dispatch"] - marks["sign_bytes"],
              "dispatch": marks["dispatched"] - marks["dispatch"],
              "native_prep": prep["ms"],
              "resolve": marks["resolved"] - marks["resolve"],
              "add_verified": t1 - marks["resolved"]}
    stages["unattributed"] = (t1 - t0) - sum(
        v for k, v in stages.items() if k != "native_prep")
    kern = _step_kernels(timer, mark)
    stats = {"wall_ms": t1 - t0, "stages_ms": stages,
             "verify_async_calls": len(calls),
             "items": [n for n, _ in calls],
             "launches_in_call": [d for _, d in calls],
             "route": _route(route_before, ted.predecomp_stats()),
             "prep_route": _prep_delta(prep_before), **kern,
             "device_busy": sum(kern["kernel_ms"].values()) / (t1 - t0)}
    return results, errors, stats


def _step_votes(type_, vs, block_id, seed_of, height, timer, card):
    """Steps 3 and 4: sign one vote of each validator for the block (and
    a conflicting one of a third) with sign_batch_async, then feed them
    with a flipped signature and a duplicate through one add_votes_batch;
    returns the VoteSet."""
    n = len(vs)
    what = "prevotes" if type_ == VoteType.PREVOTE else "precommits"
    other = BlockID(b"\xc3" * 32, block_id.parts)
    votes = [Vote(v.address, i, height, 0, 1_800_000_000_000 + i, type_,
                  block_id) for i, v in enumerate(vs.validators)]
    k_bad, k_dup, k_conf = n // 5, n // 3, n // 2
    conflict = Vote(vs.validators[k_conf].address, k_conf, height, 0,
                    1_900_000_000_000, type_, other)
    signed = votes + [conflict]
    seeds = [seed_of[v.pubkey] for v in vs.validators] + \
        [seed_of[vs.validators[k_conf].pubkey]]
    mark = len(timer)
    prep_before = ted.prep_stats()
    t0 = _ms()
    msgs = [v.sign_bytes(CHAIN) for v in signed]
    t1 = _ms()
    resolve = ted.sign_batch_async(seeds, msgs)
    t2 = _ms()
    sigs = resolve()
    t3 = _ms()
    for v, sg in zip(signed, sigs):
        v.signature = sg
    sign = {"wall_ms": t3 - t0, "sign_bytes_ms": t1 - t0,
            "dispatch_ms": t2 - t1, "resolve_ms": t3 - t2,
            "signatures": len(sigs), "prep_route": _prep_delta(prep_before),
            **_step_kernels(timer, mark)}
    require(sign["prep_route"]["sign_native"] == len(sigs),
            f"the {what}' signing did not take the native phases")
    flipped = dataclasses.replace(
        votes[k_bad], signature=_flip(votes[k_bad].signature, 17))
    vset = VoteSet(CHAIN, height, 0, type_, vs)
    results, errors, stats = _add_batch_read(
        vset, votes + [flipped, votes[k_dup], conflict], timer)
    got_errors = [(p, type(e).__name__) for p, e in errors]
    maj = vset.two_thirds_majority()
    emit({"phase": f"block_{what}", "validators": n, "sign": sign,
          "add_votes_batch": stats, "errors": got_errors,
          "majority_for_block": maj == block_id, "card": card})
    off = [i for i, r in enumerate(results) if r != (i < n)]
    require(not off and len(results) == n + 3, f"{what}: results at {off}")
    require(got_errors == [(n, "ValueError"), (n + 2, "ConflictingVoteError")]
            and str(errors[0][1]) == f"invalid signature on {flipped}"
            and not errors[1][1].added, f"{what}: errors {got_errors}")
    require(maj == block_id and vset.has_two_thirds_majority(),
            f"{what}: no +2/3 for the block")
    require(stats["verify_async_calls"] == 1 and stats["items"] == [n + 3]
            and sum(stats["launches_in_call"][0][k]
                    for k in VERIFY_KERNELS) > 0,
            f"{what}: the batch did not reach the verify kernels in one call")
    require(stats["prep_route"]["native"] == n + 3,
            f"{what}: items off the native prep {stats['prep_route']}")
    return vset


def _step_commit(vset, vs, block_id, height, timer, card):
    """Step 4's end: make_commit, verify_commit on the card, and the
    commit's hash in the next block's header."""
    mark = len(timer)
    route_before = ted.predecomp_stats()
    t0 = _ms()
    commit = vset.make_commit()
    t1 = _ms()
    vs.verify_commit(CHAIN, block_id, height, commit)
    t2 = _ms()
    nxt = Block(Header(chain_id=CHAIN, height=height + 1,
                       last_block_id=block_id, validators_hash=vs.hash()),
                last_commit=commit)
    nxt.fill_header()
    t3 = _ms()
    kern = _step_kernels(timer, mark)
    emit({"phase": "block_commit", "precommits": sum(
              p is not None for p in commit.precommits),
          "make_commit_ms": t1 - t0, "verify_commit_ms": t2 - t1,
          "next_header_ms": t3 - t2,
          "route": _route(route_before, ted.predecomp_stats()), **kern,
          "device_busy": sum(kern["kernel_ms"].values()) / (t2 - t1),
          "card": card})
    require(sum(p is not None for p in commit.precommits) == len(vs),
            "make_commit lost a precommit")
    require(nxt.header.last_commit_hash == commit.hash(),
            "the next header's last_commit_hash")


def _step_evidence(evidence, timer, card) -> None:
    """Step 5: the evidence through a BatchVerifier("cuda") and the
    default verifier, whose "auto" takes its host loop at two signatures;
    a forged second vote must raise on both."""
    cuda_v = tverifier.BatchVerifier("cuda")
    auto_v = tverifier.default_verifier()
    auto_before = dict(auto_v.stats)
    forged = DuplicateVoteEvidence(
        evidence.pubkey, evidence.vote_a, dataclasses.replace(
            evidence.vote_b, signature=_flip(evidence.vote_b.signature, 33)))
    out = {}
    for route, verifier in (("cuda", cuda_v), ("auto", None)):
        mark = len(timer)
        t0 = _ms()
        evidence.verify(CHAIN, evidence.pubkey, verifier=verifier)
        t1 = _ms()
        raised = None
        try:
            forged.verify(CHAIN, forged.pubkey, verifier=verifier)
        except ValueError as e:
            raised = str(e)
        out[route] = {"verify_ms": t1 - t0, "forged_raised": raised,
                      **_step_kernels(timer, mark)}
    auto_sigs = auto_v.stats["sigs"] - auto_before["sigs"]
    auto_cuda = auto_v.stats["cuda_sigs"] - auto_before["cuda_sigs"]
    emit({"phase": "block_evidence", **out, "cuda_route_sigs":
          cuda_v.stats["cuda_sigs"], "auto_route_sigs": auto_sigs,
          "auto_batch_path_sigs": auto_cuda, "card": card})
    require(all(o["forged_raised"] == "invalid signature in evidence"
                for o in out.values()), f"the forged evidence: {out}")
    require(cuda_v.stats["cuda_sigs"] == 4 and auto_sigs == 4
            and auto_cuda == 0, "the evidence's verifier routes")


def _profiled_device_ms(fn):
    """Device time of the kernels `fn` launches, summed from
    torch.profiler's CUDA activity; None when it records none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        total += us
    return total / 1e3 if total > 0 else None


def _step_merkle(block, device, card) -> None:
    """Step 6: the device Merkle root of the txs against Data.hash and
    hashlib, and hash_fixed on SHA_ROWS seeded 64-byte rows against
    hashlib; CUDA-event times (launch gaps included), the profiler's sum
    of kernel time for the tree's widest level and for hash_fixed, and
    the hashlib times beside them."""
    txs = block.data.txs
    n = len(txs)
    t0 = _ms()
    host_root = merkle.root_host(txs)
    t1 = _ms()
    dev_root = merkle.root(txs)
    t2 = _ms()
    merkle.root(txs)
    t3 = _ms()
    digests = b"".join(merkle.leaf_hash(t) for t in txs)
    t4 = _ms()
    padded = torch.from_numpy(merkle.pad_digests(np.frombuffer(
        digests, np.uint8).reshape(n, 32).copy())).to(device)
    tree_ms, tree_root = _time_ms(
        lambda: merkle.root_from_digests(padded, n), 3)
    # the profiler's post-processing grows with the kernels it records
    # (~5,000 a level): it reads one level, the widest, not the tree
    level_ms, _ = _time_ms(lambda: merkle._level_up(padded), 3)
    t5 = _ms()
    level_busy_ms = _profiled_device_ms(lambda: merkle._level_up(padded))
    t6 = _ms()
    rows = np.random.RandomState(SEED + 6).randint(
        0, 256, (SHA_ROWS, 64), dtype=np.uint8)
    rows_dev = torch.from_numpy(rows).to(device)
    sha_ms, got = _time_ms(lambda: sha256.hash_fixed(rows_dev), 3)
    t7 = _ms()
    sha_busy_ms = _profiled_device_ms(lambda: sha256.hash_fixed(rows_dev))
    t8 = _ms()
    flat = rows.tobytes()
    want = merkle.sha256_many_host(
        [flat[64 * i:64 * (i + 1)] for i in range(SHA_ROWS)])
    t9 = _ms()
    sha_equal = got.cpu().numpy().tobytes() == b"".join(want)
    emit({"phase": "block_merkle", "leaves": n,
          "padded_leaves": padded.shape[0],
          "root_equal": dev_root == host_root == block.data.hash(),
          "root_wall_ms": t2 - t1, "root_wall_warm_ms": t3 - t2,
          "host_leaf_ms": t4 - t3, "device_tree_ms": tree_ms,
          "device_level_ms": level_ms, "device_level_kernel_ms": level_busy_ms,
          "hashlib_root_ms": t1 - t0, "sha_rows": SHA_ROWS,
          "hash_fixed_ms": sha_ms, "hash_fixed_kernel_ms": sha_busy_ms,
          "hashlib_ms": t9 - t8, "hash_fixed_equal": sha_equal,
          "profiler_wall_ms": (t6 - t5) + (t8 - t7), "card": card})
    require(dev_root == host_root == block.data.hash()
            and tree_root.cpu().numpy().tobytes() == host_root,
            "the device Merkle root differs from the host's")
    require(sha_equal, "hash_fixed differs from hashlib")


def phase_block(card: str, keys, commit_path, device) -> dict:
    """One consensus height of phase 3's 10,000-validator chain: propose,
    gossip, prevotes, precommits and commit, evidence, device Merkle."""
    vs, _, last_commit = commit_path
    height = HEIGHT + 1
    part_size = BLOCK_PART_SIZE
    seeds = _seeds(len(keys), SEED)
    seed_of = {pub: s for (_, _, pub), s in zip(keys, seeds)}
    key_of = {k[2]: k for k in keys}
    evidence = _block_evidence(vs, last_commit, key_of)
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    t0 = _ms()
    block, ps, block_id = _step_propose(vs, last_commit, evidence, height,
                                        part_size, card)
    t1 = _ms()
    _step_gossip(block, ps, block_id, part_size, card)
    t2 = _ms()
    _step_votes(VoteType.PREVOTE, vs, block_id, seed_of, height, timer, card)
    t3 = _ms()
    vset = _step_votes(VoteType.PRECOMMIT, vs, block_id, seed_of, height,
                       timer, card)
    _step_commit(vset, vs, block_id, height, timer, card)
    t4 = _ms()
    _step_evidence(evidence, timer, card)
    t5 = _ms()
    _step_merkle(block, device, card)
    t6 = _ms()
    launches = dict(ladder.launches)
    ladder._launch = inner
    emit({"phase": "block_height_summary", "validators": len(vs),
          "walls_ms": {"propose": t1 - t0, "gossip": t2 - t1,
                       "prevotes": t3 - t2, "precommits_and_commit": t4 - t3,
                       "evidence": t5 - t4, "merkle": t6 - t5},
          "kernel_ms": _kernel_ms(timer), "launches": launches,
          "card": card})
    _require_launched(launches, KERNELS, "block height")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    rate, ptxas = phase_build()
    kernels = phase_kernels(device, rate)
    commit_launches, keys, commit_path = phase_main(card)
    mixed_launches = phase_mixed(card, keys)
    kernels.update(phase_sign_kernel(device, rate))
    lite_launches = phase_lite(card)
    block_launches = phase_block(card, keys, commit_path, device)
    table = []
    for name, info in KERNELS.items():
        table.append({
            "name": info["name"], "route": "cuda",
            "source": "tendermint_tpu_torch/csrc/ladder.cu",
            "replaces": info["replaces"], "status": "ported",
            "checked": True, "launches": lite_launches[name],
            "launches_by_path": {"commit_10k": commit_launches[name],
                                 "mixed_commit": mixed_launches[name],
                                 "lite_chain": lite_launches[name],
                                 "block_height": block_launches[name]},
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
            "bound_ms": kernels[name]["bound_ms"],
            "bound_by": kernels[name]["bound_by"],
            "library_ms": None, "shape_n": kernels[name]["n"],
            "sweep_ms": kernels[name]["sweep_ms"], "ptxas": ptxas[name]})
    emit({"kernels": table, "not_ported": [], "card": card})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
