"""Node store of the authenticated state tree: the port's copy of
`tendermint_tpu/statetree/store.py`.

Two node shapes and a version registry. The tree is a binary Patricia
trie (critbit) over sha256(key) bits, so a node never stores a full
path — an inner node stores only the BIT INDEX it splits on, and the
structure is a pure function of the key set: any insertion order, any
validator, bit-identical roots.

Persistence is node-level copy-on-write: a committed version's nodes
are NEVER mutated. A mutation copies the O(log n) path from root to
the touched leaf (`StateTree._own`), everything off-path is shared by
reference. The registry retains the last `retain` committed versions
so provers can serve reads at height h-1 (the version a certified
header at height h binds — see docs/state.md) while the working tree
marches ahead; snapshot iterators hold the version root and stay
consistent for free, even across eviction.

Hash spec (domain-separated, size-bound — mirrors ops/merkle's
convention so a truncation/extension forgery has no foothold):

    kh        = SHA256(key)                  (fixed-depth key space)
    leaf      = SHA256(0x00 || kh || SHA256(value))
    inner     = SHA256(0x01 || uint16_be(bit) || left || right)
    app_hash  = SHA256(0x02 || uint64_le(n_keys) || subtree_root)
    empty     = subtree_root of 32 zero bytes, n_keys = 0

The inner hash BINDS the split bit, so a verifier deriving directions
from its own key hash walks exactly the tree's structure — an
adversary has no freedom to reroute a proof path.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, Optional

from tendermint_tpu_torch import telemetry

EMPTY_SUBROOT = b"\x00" * 32

_m_nodes = telemetry.gauge(
    "statetree_nodes_total",
    "Live tree nodes in the working version (2n-1 for n keys)")
_m_dirty_leaves = telemetry.histogram(
    "statetree_dirty_leaves_per_commit",
    "Leaves rehashed per commit", buckets=telemetry.POW2_BUCKETS)
_m_refresh = telemetry.histogram(
    "statetree_root_refresh_seconds",
    "Dirty-subtree rehash + root recompute per commit")
_m_proof_bytes = telemetry.histogram(
    "statetree_proof_bytes",
    "Encoded state-proof size", buckets=telemetry.POW2_BUCKETS)


def leaf_hash(kh: bytes, vh: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + kh + vh).digest()


def inner_hash(bit: int, left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(
        b"\x01" + struct.pack(">H", bit) + left + right).digest()


def final_hash(n_keys: int, subtree_root: bytes) -> bytes:
    return hashlib.sha256(
        b"\x02" + struct.pack("<Q", n_keys) + subtree_root).digest()


class Leaf:
    """One key. `hash` is None while dirty (rehashed at commit)."""

    __slots__ = ("kh", "key", "value", "hash")

    def __init__(self, kh: bytes, key: bytes, value: bytes,
                 hash: Optional[bytes] = None):
        self.kh = kh
        self.key = key
        self.value = value
        self.hash = hash

    def copy(self) -> "Leaf":
        return Leaf(self.kh, self.key, self.value, self.hash)


class Inner:
    """Splits the key-hash space at `bit`: 0 goes left, 1 goes right.
    Both children always exist (a one-child inner collapses into its
    child on delete), so every inner has exactly two subtrees and the
    node count is 2n-1 for n keys."""

    __slots__ = ("bit", "left", "right", "hash")

    def __init__(self, bit: int, left, right,
                 hash: Optional[bytes] = None):
        self.bit = bit
        self.left = left
        self.right = right
        self.hash = hash

    def copy(self) -> "Inner":
        return Inner(self.bit, self.left, self.right, self.hash)


class Version:
    """One committed tree: immutable root + key count + app hash."""

    __slots__ = ("root", "n_keys", "app_hash")

    def __init__(self, root, n_keys: int, app_hash: bytes):
        self.root = root
        self.n_keys = n_keys
        self.app_hash = app_hash


class NodeStore:
    """The committed-version registry with a bounded retention window.

    `retain` bounds live memory: evicting a version drops the registry
    reference, and copy-on-write means only the nodes no OTHER retained
    version (or in-flight snapshot iterator) shares are actually freed
    — the delta per version is the dirty paths of one commit."""

    def __init__(self, retain: int = 8):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.retain = retain
        self._versions: Dict[int, Version] = {}

    def put(self, version: int, root, n_keys: int,
            app_hash: bytes) -> None:
        self._versions[version] = Version(root, n_keys, app_hash)
        while len(self._versions) > self.retain:
            self._versions.pop(next(iter(self._versions)))

    def get(self, version: int) -> Optional[Version]:
        return self._versions.get(version)

    def latest(self) -> Optional[int]:
        return max(self._versions) if self._versions else None

    def versions(self) -> list:
        return sorted(self._versions)

    def clear(self) -> None:
        self._versions.clear()
