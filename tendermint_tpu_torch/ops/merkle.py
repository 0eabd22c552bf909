"""The SHA-256 Merkle spec: a host half (hashlib) and a device half (torch).

Counterpart of `tendermint_tpu/ops/merkle.py`, byte for byte:

  leaf     = SHA256(0x00 || item)
  node     = SHA256(0x01 || left || right)
  pad leaf = 32 zero bytes
  tree     = leaves padded to the next power of two, perfect binary tree
  root     = SHA256(0x02 || uint64_le(n_leaves) || tree_root)

The host half takes the native C++ tree builder (`csrc/hostops.cpp`
through `native.py`), as the JAX package's does: `root_host`,
`root_from_digests_host`, `proof_host` and `tree_proofs_host` are one C
call a tree. Their hashlib versions stay, as `*_plain`, for the tests
and for TM_CUDA_NO_NATIVE, under which the host half takes them.
Headers, commits, validator sets, block data, results and part sets hash
with it. `sha256_many_host` is the state tree's batched rehash, routed
as the JAX function routes it: a device batch of `ops/sha256.hash_fixed`
for a wave of >= 512 payloads of one length, else the native batch, else
(`native_lib=False`) hashlib. The device half runs each tree level as one
batched `ops/sha256.hash_fixed` over [m, 65] rows; `root` hashes the
leaves on the host and the tree on the card.

Mesh route (the JAX `_mesh_root_kernel`): at an explicit mesh width N
(TM_CUDA_MESH=N, else a node's `base.verifier_mesh` through
`configure_mesh`), `root_host` and `root_from_digests_host` send trees
of >= _MESH_MIN_LEAVES leaves to the sharded device root
(`parallel/mesh.sharded_merkle_root`), counted under
`merkle_roots_total{impl="mesh"}`; trees whose padded size is below the
mesh width stay native, and N above the devices present raises
RuntimeError. Under "auto" (the default, where the verifier shards over
every card) and "off", roots stay native, unlike the JAX package's: the
sharded root hashes each level with the plain-PyTorch SHA-256
(ops/sha256.py), a launch a step, and on an H100 takes seconds for a
10,000-leaf tree that the native root hashes in milliseconds
(chip_smoke.py's phase 19b times both).
"""

from __future__ import annotations

import hashlib
import struct
import threading

import numpy as np
import torch

from tendermint_tpu_torch import native, telemetry
from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.utils import device as _device
from tendermint_tpu_torch.utils import knobs

EMPTY_DIGEST = b"\x00" * 32

# Each public root/proof entry point counts once; `impl` says which
# route served it (the native tree builder on the host half).
_m_roots = telemetry.counter(
    "merkle_roots_total", "Merkle roots computed on host", ("impl",))
_m_leaves = telemetry.histogram(
    "merkle_leaves", "Leaves per host-side Merkle root",
    buckets=telemetry.POW2_BUCKETS)
_m_proofs = telemetry.counter(
    "merkle_proofs_total", "Merkle proofs computed on host")
_m_sha_batches = telemetry.counter(
    "merkle_sha_batches_total", "Batched SHA-256 dispatches", ("impl",))


# ---------------------------------------------------------------------------
# Mesh dispatch: big roots shard over the device mesh
# ---------------------------------------------------------------------------

# leaves below this stay on the host (interactive sizes skip a dispatch)
_MESH_MIN_LEAVES = 64
_mesh_lock = threading.Lock()
# the node's base.verifier_mesh (configure_mesh); TM_CUDA_MESH wins
_mesh_config = "auto"
# None = unresolved; (kernel, n_devices) once resolved ((None, 1) = no
# mesh). Tests and chip_smoke reset it to re-resolve under another knob.
_mesh_state: "tuple | None" = None


def configure_mesh(spec: str = "auto") -> None:
    """Node-level wiring (config.base.verifier_mesh): the mesh the roots
    take unless TM_CUDA_MESH is set. Drops a resolved mesh."""
    global _mesh_config, _mesh_state
    from tendermint_tpu_torch.parallel import mesh as pmesh
    spec = str(pmesh.parse_mesh_spec(spec))
    with _mesh_lock:
        _mesh_config, _mesh_state = spec, None


def _mesh_root_kernel() -> tuple:
    """(sharded root kernel | None, n_devices), resolved once with the
    verifier's spec grammar from TM_CUDA_MESH, else the configured
    spec. Only an explicit N shards, and raises RuntimeError when N
    exceeds the devices present; "auto" and "off" give (None, 1)."""
    global _mesh_state
    st = _mesh_state
    if st is not None:
        return st
    with _mesh_lock:
        if _mesh_state is not None:
            return _mesh_state
        from tendermint_tpu_torch.parallel import mesh as pmesh
        spec = pmesh.parse_mesh_spec(knobs.knob_str(
            "TM_CUDA_MESH", config=_mesh_config, default="auto"))
        n = 1
        if spec not in ("auto", "off"):
            kind = "cuda" if torch.cuda.is_available() else "cpu"
            n = pmesh.resolve_mesh_size(spec,
                                        len(pmesh.logical_devices(kind)))
        if n < 2:
            _mesh_state = (None, 1)
        else:
            _mesh_state = (pmesh.sharded_merkle_root(
                pmesh.make_mesh(n, kind)), n)
        return _mesh_state


def _mesh_root_from_digest_rows(rows: np.ndarray, n: int) -> "bytes | None":
    """Sharded device root of uint8[n, 32] leaf digests, or None when no
    mesh is active or the tree is too small for its width."""
    if n < _MESH_MIN_LEAVES:
        return None
    kernel, ndev = _mesh_root_kernel()
    if kernel is None or _padded_size(n) < ndev:
        return None
    from tendermint_tpu_torch.parallel import mesh as pmesh
    padded = pad_digests(rows)
    pmesh.record_dispatch("merkle", n, padded.shape[0])
    if telemetry.enabled():
        _m_roots.labels("mesh").inc()
        _m_leaves.observe(n)
    return kernel(padded, n).cpu().numpy().tobytes()


def leaf_hash(item: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + item).digest()


def node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def _final_hash(n: int, tree_root: bytes) -> bytes:
    return hashlib.sha256(b"\x02" + struct.pack("<Q", n) + tree_root).digest()


def _padded_size(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# Host half: the native tree builder, and its hashlib versions
# ---------------------------------------------------------------------------

def root_host(items: list) -> bytes:
    """Merkle root of raw items, in one C call; a tree of at least
    _MESH_MIN_LEAVES items through the active device mesh."""
    n = len(items)
    if n >= _MESH_MIN_LEAVES and _mesh_root_kernel()[0] is not None:
        rows = np.frombuffer(b"".join(leaf_hash(it) for it in items),
                             np.uint8).reshape(n, 32)
        out = _mesh_root_from_digest_rows(rows, n)
        if out is not None:
            return out
    if native.disabled():
        return root_from_digests_host([leaf_hash(it) for it in items])
    out = native.merkle_root(items)
    if telemetry.enabled():
        _m_roots.labels("native").inc()
        _m_leaves.observe(len(items))
    return out


def root_from_digests_host(digests) -> bytes:
    """Root over leaf digests (a list of 32-byte hashes or one flat
    bytes-like blob, length a multiple of 32), in one C call; a tree of
    at least _MESH_MIN_LEAVES leaves through the active device mesh."""
    flat = isinstance(digests, (bytes, bytearray, memoryview))
    n = len(digests) // 32 if flat else len(digests)
    if n >= _MESH_MIN_LEAVES and _mesh_root_kernel()[0] is not None:
        rows = np.frombuffer(bytes(digests) if flat else b"".join(digests),
                             np.uint8).reshape(n, 32)
        out = _mesh_root_from_digest_rows(rows, n)
        if out is not None:
            return out
    if native.disabled():
        if n and telemetry.enabled():
            _m_leaves.observe(n)
            _m_roots.labels("host").inc()
        return root_from_digests_plain(digests)
    if n and telemetry.enabled():
        _m_leaves.observe(n)
        _m_roots.labels("native").inc()
    return native.merkle_root_from_digests(digests)


def proof_host(items: list, index: int):
    """(root, aunts): the aunts leaf-up, 32 bytes each."""
    assert 0 <= index < len(items)
    _m_proofs.inc()
    if native.disabled():
        return proof_plain(items, index)
    return native.merkle_proof(items, index)


def tree_proofs_host(items: list):
    """(root, [aunts of each item]): every proof from one tree build."""
    if native.disabled():
        return tree_proofs_plain(items)
    return native.merkle_tree_proofs(items)


def root_plain(items: list) -> bytes:
    """root_host in hashlib."""
    return root_from_digests_plain([leaf_hash(it) for it in items])


def root_from_digests_plain(digests) -> bytes:
    """root_from_digests_host in hashlib."""
    if isinstance(digests, (bytes, bytearray, memoryview)):
        flat = bytes(digests)
        digests = [flat[32 * i:32 * (i + 1)] for i in range(len(flat) // 32)]
    n = len(digests)
    if n == 0:
        return _final_hash(0, EMPTY_DIGEST)
    level = list(digests) + [EMPTY_DIGEST] * (_padded_size(n) - n)
    while len(level) > 1:
        level = [node_hash(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
    return _final_hash(n, level[0])


def root_from_repeated_digest(digest: bytes, n: int) -> bytes:
    """Root over n copies of one leaf digest in O(log n), byte-equal to
    root_from_digests_host(digest * n): each level is a run-length merge
    of at most a few distinct values (the digest, the zero padding and
    their boundary), not n hashes."""
    if n <= 0:
        return _final_hash(0, EMPTY_DIGEST)
    runs = [(digest, n)]
    pad = _padded_size(n) - n
    if pad:
        runs.append((EMPTY_DIGEST, pad))
    total = n + pad
    while total > 1:
        new_runs: list = []
        carry = None
        for d, c in runs:
            if carry is not None:
                new_runs.append((node_hash(carry, d), 1))
                carry = None
                c -= 1
            if c >= 2:
                new_runs.append((node_hash(d, d), c // 2))
            if c % 2:
                carry = d
        assert carry is None  # padded totals stay even at every level
        runs = []
        for d, c in new_runs:
            if runs and runs[-1][0] == d:
                runs[-1] = (d, runs[-1][1] + c)
            else:
                runs.append((d, c))
        total //= 2
    return _final_hash(n, runs[0][0])


def proof_plain(items: list, index: int):
    """proof_host in hashlib."""
    n = len(items)
    assert 0 <= index < n
    level = [leaf_hash(it) for it in items] + \
        [EMPTY_DIGEST] * (_padded_size(n) - n)
    aunts = []
    idx = index
    while len(level) > 1:
        aunts.append(level[idx ^ 1])
        level = [node_hash(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
        idx //= 2
    return _final_hash(n, level[0]), aunts


def tree_proofs_plain(items: list):
    """tree_proofs_host in hashlib: the levels built once."""
    n = len(items)
    level = [leaf_hash(it) for it in items] + \
        [EMPTY_DIGEST] * (_padded_size(max(n, 1)) - n)
    levels = []
    while len(level) > 1:
        levels.append(level)
        level = [node_hash(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
    root = _final_hash(n, level[0] if level else EMPTY_DIGEST)
    proofs = []
    for index in range(n):
        idx = index
        aunts = []
        for lvl in levels:
            aunts.append(lvl[idx ^ 1])
            idx //= 2
        proofs.append(aunts)
    return root, proofs


_SHA_DEVICE_MIN = 512  # payloads below this never pay a device dispatch


def sha256_many_host(payloads: list, device=None, native_lib: bool = True
                     ) -> list:
    """One SHA-256 digest per payload, batched: the state tree's dirty
    waves. The JAX function's routes, thresholds and labels: a device
    batch through `ops/sha256.hash_fixed` when there are at least
    _SHA_DEVICE_MIN payloads of one length (`device` resolved as the
    other entry points resolve it: None is the card, and raises without
    one); else the native batch; else, with `native_lib=False`, hashlib.
    A failing device batch raises (the JAX function falls to the host)."""
    n = len(payloads)
    if n == 0:
        return []
    if n >= _SHA_DEVICE_MIN:
        length = len(payloads[0])
        if all(len(p) == length for p in payloads):
            out = _sha256_many_device(payloads, n, length,
                                      _device.resolve(device))
            if telemetry.enabled():
                _m_sha_batches.labels("device").inc()
            return out
    if native_lib and not native.disabled():
        out = native.sha256_batch([bytes(p) for p in payloads])
        if telemetry.enabled():
            _m_sha_batches.labels("native").inc()
        return out
    if telemetry.enabled():
        _m_sha_batches.labels("host").inc()
    sha = hashlib.sha256
    return [sha(p).digest() for p in payloads]


def _sha256_many_device(payloads, n: int, length: int, dev) -> list:
    """uint8[n, L] rows through ops.sha256.hash_fixed on `dev`."""
    rows = np.frombuffer(b"".join(payloads), np.uint8).reshape(n, length)
    out = sha256.hash_fixed(torch.from_numpy(rows.copy()).to(dev))
    raw = out.cpu().numpy().tobytes()
    return [raw[32 * i:32 * (i + 1)] for i in range(n)]


def verify_proof_host(root: bytes, total: int, index: int, item: bytes,
                      aunts: list) -> bool:
    if not (0 <= index < total) or \
            _padded_size(max(total, 1)) != 1 << len(aunts):
        return False
    h = leaf_hash(item)
    idx = index
    for aunt in aunts:
        h = node_hash(aunt, h) if idx & 1 else node_hash(h, aunt)
        idx //= 2
    return _final_hash(total, h) == root


# ---------------------------------------------------------------------------
# Device half (torch), level by level
# ---------------------------------------------------------------------------

def _prefixed(prefix: bytes, rows):
    """uint8 rows [..., L] with `prefix` put before each -> [..., p + L]."""
    pre = torch.tensor(list(prefix), dtype=torch.uint8, device=rows.device)
    return torch.cat([pre.expand(rows.shape[:-1] + (len(prefix),)), rows], -1)


def leaf_hash_device(items):
    """uint8[..., N, L] -> uint8[..., N, 32] (a fixed item length L)."""
    return sha256.hash_fixed(_prefixed(b"\x00", items))


def _level_up(digests):
    """uint8[..., M, 32] -> uint8[..., M // 2, 32]: one tree level."""
    m = digests.shape[-2]
    pairs = digests.reshape(digests.shape[:-2] + (m // 2, 64))
    return sha256.hash_fixed(_prefixed(b"\x01", pairs))


def root_from_digests(digests, n_leaves: int):
    """Device Merkle root: digests uint8[padded, 32] (padded to a power of
    two with zero rows past n_leaves) -> uint8[32], on their device."""
    level = digests
    while level.shape[-2] > 1:
        level = _level_up(level)
    return sha256.hash_fixed(
        _prefixed(b"\x02" + struct.pack("<Q", n_leaves), level[..., 0, :]))


def pad_digests(digests: np.ndarray) -> np.ndarray:
    """uint8[N, 32] -> uint8[padded, 32], zero rows appended."""
    n = digests.shape[0]
    m = _padded_size(max(n, 1))
    if m == n:
        return digests
    return np.concatenate(
        [digests, np.zeros((m - n, 32), np.uint8)], axis=0)


def root(items: list, device=None) -> bytes:
    """Merkle root of variable-length items: leaves hashed on the host
    (their lengths differ), the tree on `device`. The empty tree needs no
    tree and stays on the host."""
    dev = _device.resolve(device)
    n = len(items)
    if n == 0:
        return _final_hash(0, EMPTY_DIGEST)
    digests = np.frombuffer(b"".join(leaf_hash(it) for it in items),
                            np.uint8).reshape(n, 32).copy()
    out = root_from_digests(torch.from_numpy(pad_digests(digests)).to(dev), n)
    return out.cpu().numpy().tobytes()
