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

Validator-change txs: `val:<pubkey_hex>/<power>` queues a validator
update returned from EndBlock; power 0 removes the validator. The app
tracks the active set (seeded from InitChain, advanced by its own
accepted updates) and rejects, at DeliverTx, the removal of an unknown
validator and a removal that would empty the set, so an invalid update
never reaches EndBlock. The guard is always on in the port.

Not ported yet: the authenticated state tree (`_TreeStoreView`).
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


class KVStoreApp(BaseApplication):
    def __init__(self, use_native: bool = True):
        # the C++ core holds the store, the accumulators and the commit;
        # the Python fields below serve the pure route
        self._kvmod = native.kv() if use_native else None
        if self._kvmod is not None:
            self._core = self._kvmod.kv_new()
            self.store = _NativeStoreView(self._kvmod, self._core)
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
        """The complete kv state sorted by key, so two nodes at the same
        height publish byte-identical snapshot payloads."""
        return sorted(self.store.items())

    def restore_items(self, items, height: int, validators=None) -> bytes:
        """Install a snapshot's kv state wholesale: reset every structure,
        replay the pairs through the normal set path, and compute the app
        hash with commit() (the height lands on exactly `height`). The
        caller checks the hash against the snapshot state's app_hash."""
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
        value = self.store.get(data, b"")
        return ResultQuery(key=data, value=value, height=self.height,
                           log="exists" if value else "does not exist")
