"""StateTree, a persistent incrementally Merkleized kv tree: the port's
copy of `tendermint_tpu/statetree/tree.py`.

A binary Patricia trie (critbit) over sha256(key) bits. Structure is a
pure function of the key SET — not insertion order — because an inner
node exists exactly at the first bit where two present key hashes
diverge; every validator applying the same txs computes bit-identical
roots, which is what lets app_hash = tree root.

Why critbit over the reference's IAVL: no rotations (rebalancing is a
determinism hazard across replay orders — IAVL needs version-exact
rotation history), O(log n) expected depth for hashed keys with a hard
256 cap, and absence proofs come free (navigation for a missing key
deterministically terminates at SOME leaf whose different key hash
proves the miss — see proof.py).

Mutations touch O(log n) nodes via copy-on-write path copying; nodes
created since the last commit are mutated in place (`_own`), committed
nodes never are. A mutated node's `hash` is None until `commit()`
rehashes the dirty subtree bottom-up, batching each level's fixed-size
payloads through ops/merkle's sha256_many_host on the tree's device: a
wave of 512 or more payloads of one length is one device batch, the
rest one native batch (or hashlib, with `native_lib=False`). The tree
resolves its device when it is built, as the port's entry points do:
no device and no card raises.

Thread safety: one RLock serializes mutation/commit against reads, so
an RPC query thread can prove against a retained version while the
consensus thread builds the next block.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Iterator, Optional, Tuple

from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.statetree.proof import ProofError, StateProof
from tendermint_tpu_torch.statetree.store import (
    EMPTY_SUBROOT,
    Inner,
    Leaf,
    NodeStore,
    _m_dirty_leaves,
    _m_nodes,
    _m_refresh,
    final_hash,
)
from tendermint_tpu_torch.utils import device as _device
from tendermint_tpu_torch.utils import fail


def _bit(kh: bytes, i: int) -> int:
    """Bit i of a 32-byte hash, MSB-first (bit 0 = high bit of byte 0)."""
    return (kh[i >> 3] >> (7 - (i & 7))) & 1


def _first_diff_bit(a: bytes, b: bytes) -> int:
    for i in range(32):
        x = a[i] ^ b[i]
        if x:
            return (i << 3) + 8 - x.bit_length()
    raise ValueError("identical key hashes")


class StateTree:
    def __init__(self, retain: int = 8, device=None,
                 native_lib: bool = True):
        #: the device of the commit's device waves (None: the card)
        self.device = _device.resolve(device)
        self.native_lib = native_lib
        self._root = None
        self._n = 0
        self._lock = threading.RLock()
        # ids of nodes created since the last commit: safe to mutate in
        # place. Committed nodes are all OLDER live objects, so an id
        # here can only ever be reused by another node created inside
        # the same window — which is fresh by definition.
        self._fresh: set = set()
        self.store = NodeStore(retain)

    # ------------------------------------------------------- mutation

    def _own(self, node):
        if id(node) in self._fresh:
            return node
        c = node.copy()
        self._fresh.add(id(c))
        return c

    def _new(self, node):
        self._fresh.add(id(node))
        return node

    def set(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        kh = hashlib.sha256(key).digest()
        with self._lock:
            if self._root is None:
                self._root = self._new(Leaf(kh, key, value))
                self._n = 1
                return
            node = self._root
            while isinstance(node, Inner):
                node = node.right if _bit(kh, node.bit) else node.left
            if node.kh == kh:
                self._root = self._update(self._root, kh, value)
                return
            d = _first_diff_bit(kh, node.kh)
            self._root = self._splice(self._root, kh, key, value, d)
            self._n += 1

    def _update(self, node, kh: bytes, value: bytes):
        node = self._own(node)
        node.hash = None
        if isinstance(node, Leaf):
            node.value = value
            return node
        if _bit(kh, node.bit):
            node.right = self._update(node.right, kh, value)
        else:
            node.left = self._update(node.left, kh, value)
        return node

    def _splice(self, node, kh: bytes, key: bytes, value: bytes,
                d: int):
        # the new inner lands ABOVE the first node splitting past d —
        # all inners shallower than d agree with kh's navigation, and
        # no on-path inner splits at d itself (its subtree would then
        # contain keys differing from the found leaf before d).
        if isinstance(node, Leaf) or node.bit > d:
            leaf = self._new(Leaf(kh, key, value))
            if _bit(kh, d):
                return self._new(Inner(d, node, leaf))
            return self._new(Inner(d, leaf, node))
        node = self._own(node)
        node.hash = None
        if _bit(kh, node.bit):
            node.right = self._splice(node.right, kh, key, value, d)
        else:
            node.left = self._splice(node.left, kh, key, value, d)
        return node

    def delete(self, key: bytes) -> bool:
        key = bytes(key)
        kh = hashlib.sha256(key).digest()
        with self._lock:
            node = self._root
            while isinstance(node, Inner):
                node = node.right if _bit(kh, node.bit) else node.left
            if node is None or node.kh != kh:
                return False
            self._root = self._remove(self._root, kh)
            self._n -= 1
            return True

    def _remove(self, node, kh: bytes):
        if isinstance(node, Leaf):
            return None  # deleting the only key
        b = _bit(kh, node.bit)
        child = node.right if b else node.left
        if isinstance(child, Leaf) and child.kh == kh:
            # the inner collapses into the surviving sibling subtree,
            # which keeps its hash — only the path above dirties
            return node.left if b else node.right
        node = self._own(node)
        node.hash = None
        if b:
            node.right = self._remove(node.right, kh)
        else:
            node.left = self._remove(node.left, kh)
        return node

    # ---------------------------------------------------------- reads

    def get(self, key: bytes,
            version: Optional[int] = None) -> Optional[bytes]:
        kh = hashlib.sha256(bytes(key)).digest()
        with self._lock:
            root = self._root if version is None else \
                self._version(version).root
            node = root
            while isinstance(node, Inner):
                node = node.right if _bit(kh, node.bit) else node.left
            if node is not None and node.kh == kh:
                return node.value
            return None

    def __len__(self) -> int:
        return self._n

    def _version(self, version: int):
        v = self.store.get(version)
        if v is None:
            raise KeyError(
                f"version {version} not retained "
                f"(have {self.store.versions()})")
        return v

    def app_hash_at(self, version: int) -> bytes:
        with self._lock:
            return self._version(version).app_hash

    # --------------------------------------------------------- commit

    def commit(self, version: int) -> bytes:
        """Rehash the dirty subtree bottom-up and register `version`.
        Returns the new app_hash. O(dirty nodes), not O(state)."""
        with self._lock:
            fail.fail_point("statetree.before_root_flush")
            t0 = time.perf_counter()
            by_height: dict = {}
            if self._root is not None and self._root.hash is None:
                self._collect_dirty(self._root, by_height)
            leaves = by_height.get(0, ())
            if leaves:
                vhs = self._sha([lf.value for lf in leaves])
                payloads = [b"\x00" + lf.kh + vh
                            for lf, vh in zip(leaves, vhs)]
                for lf, h in zip(leaves, self._sha(payloads)):
                    lf.hash = h
            for height in sorted(k for k in by_height if k > 0):
                nodes = by_height[height]
                payloads = [b"\x01" + nd.bit.to_bytes(2, "big")
                            + nd.left.hash + nd.right.hash
                            for nd in nodes]
                for nd, h in zip(nodes, self._sha(payloads)):
                    nd.hash = h
            fail.fail_point("statetree.after_node_write")
            sub = self._root.hash if self._root is not None \
                else EMPTY_SUBROOT
            app_hash = final_hash(self._n, sub)
            self._fresh.clear()
            self.store.put(version, self._root, self._n, app_hash)
            _m_refresh.observe(time.perf_counter() - t0)
            _m_dirty_leaves.observe(len(leaves))
            _m_nodes.set(max(0, 2 * self._n - 1))
            return app_hash

    def _sha(self, payloads: list) -> list:
        return merkle.sha256_many_host(payloads, device=self.device,
                                       native_lib=self.native_lib)

    def _collect_dirty(self, node, by_height: dict) -> int:
        """Post-order: bucket dirty nodes by height-within-the-dirty-
        subtree so each bucket's payloads depend only on lower buckets
        (children hashed before parents) and batch as one wave."""
        if node.hash is not None:
            return -1
        if isinstance(node, Leaf):
            by_height.setdefault(0, []).append(node)
            return 0
        hl = self._collect_dirty(node.left, by_height)
        hr = self._collect_dirty(node.right, by_height)
        h = 1 + max(hl, hr, 0)
        by_height.setdefault(h, []).append(node)
        return h

    # --------------------------------------------------------- proofs

    def prove(self, key: bytes,
              version: int) -> Tuple[Optional[bytes], StateProof]:
        """(value | None, proof) at a committed version: an inclusion
        proof when the key is present, a divergent-leaf absence proof
        when it is not. O(log n) — the proof is the root-to-leaf path's
        sibling hashes."""
        key = bytes(key)
        kh = hashlib.sha256(key).digest()
        with self._lock:
            v = self._version(version)
            if v.root is None:
                return None, StateProof(kh, 0, [], present=False)
            steps = []
            node = v.root
            while isinstance(node, Inner):
                if node.hash is None:
                    raise ProofError("cannot prove against an "
                                     "uncommitted subtree")
                if _bit(kh, node.bit):
                    steps.append((node.bit, node.left.hash))
                    node = node.right
                else:
                    steps.append((node.bit, node.right.hash))
                    node = node.left
            if node.kh == kh:
                return node.value, StateProof(
                    kh, v.n_keys, steps, present=True)
            return None, StateProof(
                kh, v.n_keys, steps, present=False,
                other_key_hash=node.kh,
                other_value_hash=hashlib.sha256(node.value).digest())

    # ------------------------------------------------------ iteration

    def items_at(self, version: int) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs of a committed version in key-hash
        order — the deterministic snapshot stream. Lazy: holds only a
        root reference plus an O(depth) stack, and copy-on-write keeps
        the iteration consistent even while later blocks commit or the
        version is evicted mid-stream."""
        with self._lock:
            root = self._version(version).root
        stack = [root] if root is not None else []
        while stack:
            node = stack.pop()
            if isinstance(node, Leaf):
                yield node.key, node.value
            else:
                stack.append(node.right)
                stack.append(node.left)
