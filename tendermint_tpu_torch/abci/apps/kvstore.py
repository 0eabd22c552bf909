"""KVStore app: the port's copy of `tendermint_tpu/abci/apps/kvstore.py`.

Txs are "key=value" (or opaque bytes stored under themselves). The app
hash is a Merkle root over N_BUCKETS bucket digests; a bucket digest
commits to an additive accumulator (sum of its keys' pair digests mod
2^256, plus the key count), so a key change is O(1) and a commit is
O(changed keys + dirty buckets).

`use_native=True` (the default, as in the JAX package) keeps the store
and the accumulators in the C++ kv core (`csrc/kvcore.cpp` through
`native.kv()`): a block of plain txs is one `deliver_batch` call that
returns `UniformDeliverResults`, and the commit is one C++ call. A block
that holds a `val:` tx or an empty tx takes the per-tx Python route
(deliver_tx, the core's `set_one` for its kv txs), the reference's own
rule. `route_stats()` counts the blocks of each route. `use_native=False`
is the pure Python route, byte for byte; both give the same app hash.

TM_CUDA_STATE_TREE=on (the JAX package's TM_TPU_STATE_TREE) swaps the
commit backend for the authenticated state tree (statetree/): app_hash
becomes a critbit Merkle root, `query(prove=True)` returns per-key
inclusion or absence proofs bound to it, and snapshot items stream from
the committed version's nodes. The tree is the store, so the native kv
core is off; its commit hashes its dirty waves on the app's `device`
(None: the card; the node passes its own). The two backends give
different app hashes by design: every validator of a chain must agree
on the knob.

Validator-change txs: `val:<pubkey_hex>/<power>` queues a validator
update returned from EndBlock; power 0 removes the validator. The app
tracks the active set (seeded from InitChain, advanced by its own
accepted updates) and rejects, at DeliverTx, the removal of an unknown
validator and a removal that would empty the set, so an invalid update
never reaches EndBlock. The guard is always on in the port.
"""

from __future__ import annotations

import hashlib
import threading
import zlib

from tendermint_tpu_torch import native
from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.types import (
    ResultCheckTx, ResultDeliverTx, ResultEndBlock, ResultInfo,
    ResultQuery, UniformDeliverResults, ValidatorUpdate,
)
from tendermint_tpu_torch.ops import merkle

N_BUCKETS = 256   # app-hash buckets; a power of two
# digest of an empty bucket (leaf hash of no pairs)
_EMPTY_BUCKET = hashlib.sha256(b"\x00").digest()

# blocks delivered by the C++ core (`native`), by the per-tx route of a
# native app (`per_tx`: a val: or empty tx in the block) and by a pure app
_route_lock = threading.Lock()
_routes = {"native": 0, "per_tx": 0, "pure": 0}


def _count_route(route: str) -> None:
    with _route_lock:
        _routes[route] += 1


def route_stats() -> dict:
    """Blocks (deliver_tx_batch calls with txs) a route took, since the
    process started."""
    with _route_lock:
        return dict(_routes)


class _NativeStoreView:
    """Read-only Mapping facade over the native kv core, so that callers
    (query, info, tests reading `app.store.get` or `dict(app.store)`) see
    the dict-like surface of the pure app."""

    def __init__(self, mod, core):
        self._mod = mod
        self._core = core

    def get(self, k, default=None):
        v = self._mod.get(self._core, k)
        return default if v is None else v

    def __getitem__(self, k):
        v = self._mod.get(self._core, k)
        if v is None:
            raise KeyError(k)
        return v

    def __contains__(self, k):
        return self._mod.get(self._core, k) is not None

    def __len__(self):
        return self._mod.size(self._core)

    def __bool__(self):
        return len(self) > 0

    def items(self):
        return self._mod.items(self._core)

    def keys(self):
        return [k for k, _ in self.items()]

    def __iter__(self):
        return iter(self.keys())


class _TreeStoreView:
    """Mapping facade over a StateTree, so that every caller of
    `app.store` (deliver_tx writes, query and info reads, tests reading
    dict(app.store)) sees the dict-like surface of the other two cores.
    Reads hit the working tree (the pre-commit state, as the dict path);
    versioned and proven reads go through the tree itself."""

    def __init__(self, tree):
        self._tree = tree

    def get(self, k, default=None):
        v = self._tree.get(k)
        return default if v is None else v

    def __getitem__(self, k):
        v = self._tree.get(k)
        if v is None:
            raise KeyError(k)
        return v

    def __setitem__(self, k, v):
        self._tree.set(k, v)

    def __delitem__(self, k):
        if not self._tree.delete(k):
            raise KeyError(k)

    def __contains__(self, k):
        return self._tree.get(k) is not None

    def __len__(self):
        return len(self._tree)

    def __bool__(self):
        return len(self._tree) > 0

    def items(self):
        # live iteration: walk the working root under the tree lock
        with self._tree._lock:
            stack = [self._tree._root] if self._tree._root is not None \
                else []
            out = []
            while stack:
                node = stack.pop()
                if hasattr(node, "key"):
                    out.append((node.key, node.value))
                else:
                    stack.append(node.right)
                    stack.append(node.left)
            return out

    def keys(self):
        return [k for k, _ in self.items()]

    def __iter__(self):
        return iter(self.keys())


class KVStoreApp(BaseApplication):
    def __init__(self, use_native: bool = True, device=None):
        # the commit backend: TM_CUDA_STATE_TREE=on swaps the bucketed
        # accumulator for the authenticated state tree, hashing on
        # `device`; the tree is the store, so no C++ kv core
        from tendermint_tpu_torch.utils import knobs
        self._tree = None
        if knobs.knob_bool("TM_CUDA_STATE_TREE"):
            from tendermint_tpu_torch.statetree import StateTree
            self._tree = StateTree(device=device)
            use_native = False
        # the C++ core holds the store, the accumulators and the commit;
        # the Python fields below serve the pure route (use_native=False
        # or TM_CUDA_NO_NATIVE)
        self._kvmod = native.kv() if use_native and not native.disabled() \
            else None
        if self._kvmod is not None:
            self._core = self._kvmod.kv_new()
            self.store = _NativeStoreView(self._kvmod, self._core)
        elif self._tree is not None:
            self._core = None
            self.store = _TreeStoreView(self._tree)
        else:
            self._core = None
            self.store: dict[bytes, bytes] = {}
        self.height = 0
        self.app_hash = b""
        self.tx_count = 0
        # incremental app-hash state (see commit()): keys spread over
        # fixed buckets, each an additive accumulator (sum of pair
        # digests mod 2^256) and a key count
        self._bucket_acc: list[int] = [0] * N_BUCKETS
        self._bucket_count: list[int] = [0] * N_BUCKETS
        # flat digest buffer, bucket b at [32b:32b+32]
        self._bucket_digest = bytearray(_EMPTY_BUCKET * N_BUCKETS)
        self._pair_digest: dict[bytes, bytes] = {}
        self._dirty: set[bytes] = set()
        self._val_updates: list[ValidatorUpdate] = []
        # pubkey -> power of the active set as the app knows it: seeded
        # by init_chain, advanced at once by its own accepted updates
        # (several val txs in one block see each other's effects)
        self._validators: dict[bytes, int] = {}
        self._val_seeded = False

    def init_chain(self, validators, chain_id: str = "",
                   app_state=None) -> None:
        self._validators = {v.pubkey: v.power for v in validators}
        self._val_seeded = True

    def info(self) -> ResultInfo:
        return ResultInfo(data=f"kvstore:{len(self.store)}",
                          version="1",
                          last_block_height=self.height,
                          last_block_app_hash=self.app_hash)

    def check_tx(self, tx: bytes) -> ResultCheckTx:
        if not tx:
            return ResultCheckTx(code=1, log="empty tx")
        return ResultCheckTx()

    def deliver_tx(self, tx: bytes) -> ResultDeliverTx:
        if not tx:
            return ResultDeliverTx(code=1, log="empty tx")
        if tx.startswith(b"val:"):
            return self._deliver_val(tx)
        if b"=" in tx:
            k, _, v = tx.partition(b"=")
        else:
            k = v = tx
        if self._core is not None:
            self._kvmod.set_one(self._core, k, v)
        else:
            self.store[k] = v
            if self._tree is None:
                self._dirty.add(k)
        self.tx_count += 1
        return ResultDeliverTx(tags={"app.key": k.decode("utf-8", "replace")})

    def _deliver_val(self, tx: bytes) -> ResultDeliverTx:
        try:
            pk_hex, _, power = tx[4:].partition(b"/")
            update = ValidatorUpdate(bytes.fromhex(pk_hex.decode()),
                                     int(power))
            if len(update.pubkey) != 32 or update.power < 0:
                raise ValueError(tx)
        except (ValueError, UnicodeDecodeError):
            return ResultDeliverTx(code=1, log=f"bad val tx {tx!r}")
        if update.power == 0:
            if update.pubkey not in self._validators:
                return ResultDeliverTx(
                    code=2, log="cannot remove unknown validator "
                    f"{pk_hex.decode()[:16]}")
            # "would empty the set" needs the full picture: an unseeded
            # app (no InitChain) cannot tell the last validator from the
            # last one it happens to know about
            if self._val_seeded and len(self._validators) == 1:
                return ResultDeliverTx(
                    code=3, log="validator set would be empty")
            self._validators.pop(update.pubkey, None)
        else:
            self._validators[update.pubkey] = update.power
        self._val_updates.append(update)
        self.tx_count += 1
        return ResultDeliverTx(tags={"val": pk_hex.decode()[:16]})

    def deliver_tx_batch(self, txs):
        """A block of txs, one result each. On the native core, a block
        of plain kv txs is one C++ call returning the lazy
        UniformDeliverResults; an empty or `val:` tx sends the whole
        block through the per-tx route (the core scans before it
        mutates, so nothing is applied twice)."""
        if self._core is not None and txs:
            out = self._kvmod.deliver_batch(self._core, txs)
            if isinstance(out, tuple):
                n, packed = out
                self.tx_count += len(txs)
                _count_route("native")
                return UniformDeliverResults(None, packed=packed, n=n)
        if txs:
            _count_route("pure" if self._core is None else "per_tx")
        return [self.deliver_tx(tx) for tx in txs]

    def commit(self) -> bytes:
        # App hash = Merkle root over N_BUCKETS bucket digests; a bucket
        # digest commits to its additive accumulator (sum of pair digests
        # mod 2^256) and key count. O(changed keys) per commit.
        self.height += 1
        if self._tree is not None:
            # rehash the dirty subtree and register version `height`,
            # the app_hash a header at height + 1 carries (provers
            # serve reads against the retained versions)
            self.app_hash = self._tree.commit(self.height)
            return self.app_hash
        if self._core is not None:
            self.app_hash = self._kvmod.commit(self._core)
            return self.app_hash
        if self._dirty:
            sha = hashlib.sha256
            pd = self._pair_digest
            acc, cnt = self._bucket_acc, self._bucket_count
            dirty_buckets = set()
            for k in self._dirty:
                b = zlib.crc32(k) & (N_BUCKETS - 1)
                dirty_buckets.add(b)
                old = pd.get(k)
                v = self.store.get(k)
                if v is None:
                    if old is not None:
                        del pd[k]
                        acc[b] -= int.from_bytes(old, "little")
                        cnt[b] -= 1
                else:
                    # pair digest: sha(len k|k|len v|v), cached per key
                    d = sha(len(k).to_bytes(4, "little") + k
                            + len(v).to_bytes(4, "little") + v).digest()
                    if old is not None:
                        acc[b] -= int.from_bytes(old, "little")
                    else:
                        cnt[b] += 1
                    acc[b] += int.from_bytes(d, "little")
                    pd[k] = d
            self._dirty.clear()
            for b in dirty_buckets:
                if cnt[b] == 0:
                    d = _EMPTY_BUCKET
                else:
                    d = sha(b"\x00"
                            + (acc[b] % (1 << 256)).to_bytes(32, "little")
                            + cnt[b].to_bytes(8, "little")).digest()
                self._bucket_digest[32 * b:32 * b + 32] = d
        if not self.store:
            self.app_hash = b"\x00" * 32
        else:
            self.app_hash = merkle.root_from_digests_host(
                self._bucket_digest)
        return self.app_hash

    def end_block(self, height: int) -> ResultEndBlock:
        updates, self._val_updates = self._val_updates, []
        return ResultEndBlock(validator_updates=updates)

    # -- state-sync snapshot surface ------------------------------------------

    def snapshot_items(self):
        """The complete kv state in a deterministic order, so two nodes
        at the same height publish byte-identical snapshot payloads. The
        bucket cores sort by key (a copy); the tree streams from the
        committed version's nodes in key-hash order, and copy-on-write
        keeps the stream consistent while later blocks commit."""
        if self._tree is not None:
            return self._tree.items_at(self.height)
        return sorted(self.store.items())

    def restore_items(self, items, height: int, validators=None) -> bytes:
        """Install a snapshot's kv state wholesale: reset every structure,
        replay the pairs through the normal set path, and compute the app
        hash with commit() (the height lands on exactly `height`). The
        caller checks the hash against the snapshot state's app_hash."""
        if self._tree is not None:
            # a fresh tree on the same device; commit() registers version
            # `height`, so proofs work at once after a state-sync join. A
            # bucket-mode snapshot recomputes to another app_hash here,
            # and the caller's check refuses it
            from tendermint_tpu_torch.statetree import StateTree
            self._tree = StateTree(device=self._tree.device)
            self.store = _TreeStoreView(self._tree)
            for k, v in items:
                self.store[bytes(k)] = bytes(v)
            return self._restored(height, validators)
        if self._core is not None:
            self._core = self._kvmod.kv_new()
            self.store = _NativeStoreView(self._kvmod, self._core)
            for k, v in items:
                self._kvmod.set_one(self._core, bytes(k), bytes(v))
            return self._restored(height, validators)
        self.store = {}
        self._bucket_acc = [0] * N_BUCKETS
        self._bucket_count = [0] * N_BUCKETS
        self._bucket_digest = bytearray(_EMPTY_BUCKET * N_BUCKETS)
        self._pair_digest = {}
        self._dirty = set()
        for k, v in items:
            self.store[bytes(k)] = bytes(v)
            self._dirty.add(bytes(k))
        return self._restored(height, validators)

    def _restored(self, height: int, validators) -> bytes:
        if validators is not None:
            self._validators = {bytes(pk): int(power)
                                for pk, power in validators}
            self._val_seeded = True
        self._val_updates = []
        self.height = height - 1
        return self.commit()  # height -> `height`, app_hash recomputed

    def query(self, path: str, data: bytes, height: int,
              prove: bool) -> ResultQuery:
        if self._tree is not None and (prove or height):
            # a versioned (and optionally proven) read of a committed
            # version, height 0 the latest. The proof binds (key, value or
            # absence) to that version's app_hash, which the header at
            # height + 1 carries and a lite client can certify
            version = int(height) if height else self.height
            try:
                if prove:
                    value, pf = self._tree.prove(data, version)
                else:
                    value, pf = self._tree.get(data, version), None
            except KeyError as e:
                return ResultQuery(code=1, key=data, height=version,
                                   log=str(e))
            proof_bytes = b""
            if pf is not None:
                from tendermint_tpu_torch.statetree import proof_to_bytes
                proof_bytes = proof_to_bytes(pf)
            return ResultQuery(
                key=data, value=value or b"", proof=proof_bytes,
                height=version,
                log="exists" if value is not None else "does not exist")
        value = self.store.get(data, b"")
        return ResultQuery(key=data, value=value, height=self.height,
                           log="exists" if value else "does not exist")
