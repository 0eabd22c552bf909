"""The SHA-256 Merkle spec: a host half (hashlib) and a device half (torch).

Counterpart of `tendermint_tpu/ops/merkle.py`, byte for byte:

  leaf     = SHA256(0x00 || item)
  node     = SHA256(0x01 || left || right)
  pad leaf = 32 zero bytes
  tree     = leaves padded to the next power of two, perfect binary tree
  root     = SHA256(0x02 || uint64_le(n_leaves) || tree_root)

The host half is the JAX package's pure-Python branches (its native C++
tree builder gives the same bytes). Headers, commits, validator sets,
block data and part sets hash with it. The device half runs each tree
level as one batched `ops/sha256.hash_fixed` over [m, 65] rows; `root`
hashes the leaves on the host and the tree on the card.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.utils import device as _device

EMPTY_DIGEST = b"\x00" * 32


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
# Host half (hashlib)
# ---------------------------------------------------------------------------

def root_host(items: list) -> bytes:
    """Merkle root of raw items."""
    return root_from_digests_host([leaf_hash(it) for it in items])


def root_from_digests_host(digests) -> bytes:
    """Root over leaf digests: a list of 32-byte hashes or one flat
    bytes-like blob (length a multiple of 32)."""
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


def proof_host(items: list, index: int):
    """(root, aunts): the aunts leaf-up, 32 bytes each."""
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


def tree_proofs_host(items: list):
    """(root, [aunts of each item]): every proof from one tree build."""
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


def sha256_many_host(payloads: list) -> list:
    """One SHA-256 digest per payload."""
    sha = hashlib.sha256
    return [sha(p).digest() for p in payloads]


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
