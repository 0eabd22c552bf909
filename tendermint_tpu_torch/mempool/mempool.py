"""Mempool — validity-checked tx queue feeding block proposals: the
port's copy of `tendermint_tpu/mempool/mempool.py` (mempool/mempool.go).

Txs enter through `check_tx` (validated by the app over the dedicated
mempool ABCI connection), live in a CList, are reaped by the proposer,
and are removed + rechecked on `update` after each commit. The proxy
mutex is held by the BlockExecutor around app Commit + update
(state/execution.go:125-156) so no CheckTx can interleave.

A bounded FIFO cache dedups txs (mempool/mempool.go txCache); the
optional tx WAL holds the still-PENDING txs (length-prefixed): `update`
rewrites it after every commit so committed txs never replay, and
startup replays the survivors through CheckTx.

The txs-available notification fires OUTSIDE the proxy mutex: the hook
calls into the consensus state machine, which itself takes the proxy
mutex during commit (mempool/mempool.go:100-105).

The JAX package's metric families (`mempool_*`), its queue probe
(`mempool.txs`) and the SLO plane's `checktx` stamps are fed where the
JAX mempool feeds them.
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.abci.types import ResultCheckTx
from tendermint_tpu_torch.mempool.clist import CList
from tendermint_tpu_torch.telemetry import queues as queue_obs
from tendermint_tpu_torch.telemetry import slo as slo_obs

_m_size = telemetry.gauge(
    "mempool_size", "Pending transactions in the mempool")
_m_added = telemetry.counter(
    "mempool_txs_added_total", "Transactions accepted by CheckTx")
_m_rejected = telemetry.counter(
    "mempool_txs_rejected_total",
    "Transactions rejected at admission, by reason", ("reason",))
_m_removed = telemetry.counter(
    "mempool_txs_removed_total",
    "Transactions removed after admission, by reason", ("reason",))


@dataclass
class MempoolTx:
    """One accepted tx (mempool/mempool.go memTx): `height` is the chain
    height at acceptance time."""
    counter: int
    height: int
    tx: bytes


class TxCache:
    """Bounded FIFO dedup set (mempool/mempool.go:cacheSize=100000)."""

    def __init__(self, size: int = 100_000):
        self.size = size
        self._map: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = threading.Lock()

    def push(self, tx: bytes) -> bool:
        """False if already present."""
        with self._lock:
            if tx in self._map:
                return False
            if len(self._map) >= self.size:
                self._map.popitem(last=False)
            self._map[tx] = None
            return True

    def remove(self, tx: bytes) -> None:
        with self._lock:
            self._map.pop(tx, None)

    def reset(self) -> None:
        with self._lock:
            self._map.clear()


class TxAlreadyInCache(Exception):
    pass


class MempoolFull(Exception):
    def __init__(self, size: int, max_size: int):
        super().__init__(f"mempool is full: {size} >= {max_size}")


def _frame(tx: bytes) -> bytes:
    return struct.pack(">I", len(tx)) + tx


class Mempool:
    def __init__(self, app_conn, config=None, height: int = 0,
                 wal_dir: Optional[str] = None):
        self.app_conn = app_conn
        cfg = config
        self.recheck = getattr(cfg, "recheck", True)
        self.max_size = getattr(cfg, "size", 100_000)
        self.cache = TxCache(getattr(cfg, "cache_size", 100_000))
        self.txs = CList()
        self._tx_elements: dict = {}  # tx bytes -> CElement
        # sha256(tx) -> tx for every PENDING tx, kept in lockstep with
        # _tx_elements: O(1) lookups by hash
        self._by_hash: dict = {}
        self.height = height
        self.counter = 0
        self.proxy_mtx = threading.RLock()  # the reference's proxyMtx
        self.notified_txs_available = False
        self.txs_available_hook: Optional[Callable[[], None]] = None
        # queue observatory: the pending-tx queue against its admission
        # bound — the "mempool full" backpressure the RPC front door
        # reports one rejection at a time becomes a saturation gauge
        self._queue_probe = queue_obs.register(
            "mempool.txs", self, depth=lambda m: len(m.txs),
            capacity=self.max_size)
        self._wal_file = None
        self._wal_path = None
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)
            self._wal_path = os.path.join(wal_dir, "wal")
            self._replay_wal(self._wal_path)
            self._wal_file = open(self._wal_path, "ab")

    # ----------------------------------------------------------------- locking

    def lock(self) -> None:
        self.proxy_mtx.acquire()

    def unlock(self) -> None:
        self.proxy_mtx.release()

    def size(self) -> int:
        return len(self.txs)

    def flush(self) -> None:
        """Drop every pending tx and the cache (mempool/mempool.go Flush)."""
        with self.proxy_mtx:
            self.cache.reset()
            self.txs.clear()
            self._tx_elements.clear()
            self._by_hash.clear()
            _m_size.set(0)

    def close(self) -> None:
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None

    # --------------------------------------------------------------------- wal

    def _replay_wal(self, path: str) -> None:
        """Re-run CheckTx for every tx recorded before the crash. Truncated
        tails (torn final write) are dropped silently."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 4 <= len(data):
            (n,) = struct.unpack_from(">I", data, pos)
            if pos + 4 + n > len(data):
                break
            tx = data[pos + 4:pos + 4 + n]
            pos += 4 + n
            try:
                self.check_tx(tx, _from_wal=True)
            except (TxAlreadyInCache, MempoolFull):
                pass

    def _rewrite_wal(self) -> None:
        """Persist exactly the pending txs (atomic replace). Called from
        update() so committed txs can never replay after a crash."""
        if self._wal_path is None:
            return
        tmp = self._wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for el in self.txs:
                f.write(_frame(el.value.tx))
            f.flush()
            os.fsync(f.fileno())
        if self._wal_file is not None:
            self._wal_file.close()
        os.replace(tmp, self._wal_path)
        self._wal_file = open(self._wal_path, "ab")

    # ----------------------------------------------------------------- checktx

    def _admit(self, tx: bytes) -> None:
        self.counter += 1
        self._tx_elements[tx] = self.txs.push_back(
            MempoolTx(self.counter, self.height, tx))
        self._by_hash[hashlib.sha256(tx).digest()] = tx

    def check_tx(self, tx: bytes, _from_wal: bool = False) -> ResultCheckTx:
        """Validate via app CheckTx; append to the queue on OK
        (mempool/mempool.go:200-235). Raises TxAlreadyInCache on dup,
        MempoolFull at capacity."""
        notify = False
        with self.proxy_mtx:
            if self.size() >= self.max_size:
                _m_rejected.labels("full").inc()
                raise MempoolFull(self.size(), self.max_size)
            # a tx can still be pending after its cache entry was evicted;
            # re-admitting it would orphan the original CList element
            if tx in self._tx_elements:
                self.cache.push(tx)
                _m_rejected.labels("duplicate").inc()
                raise TxAlreadyInCache(tx.hex())
            if not self.cache.push(tx):
                _m_rejected.labels("duplicate").inc()
                raise TxAlreadyInCache(tx.hex())
            if self._wal_file is not None and not _from_wal:
                self._wal_file.write(_frame(tx))
                self._wal_file.flush()
            res = self.app_conn.check_tx(tx)
            if res.ok:
                self._admit(tx)
                if telemetry.enabled():
                    _m_added.inc()
                    _m_size.set(len(self.txs))
                notify = self._mark_txs_available()
            else:
                # ineligible tx: forget it so a future (valid) resubmit works
                self.cache.remove(tx)
                _m_rejected.labels("invalid").inc()
        if notify:
            self.txs_available_hook()
        if res.ok:
            # SLO plane: CheckTx-accept stamp for sampled txs (outside
            # proxy_mtx — the tracker has its own lock)
            slo_obs.mark(tx, "checktx")
        return res

    def check_tx_batch(self, txs: List[bytes]) -> List[ResultCheckTx]:
        """Admit a whole batch under ONE proxy_mtx acquisition with ONE
        tx-WAL append. Per-tx outcomes come back as ResultCheckTx values
        aligned with `txs` (code 0 = admitted; duplicates and a full
        mempool report non-zero codes instead of raising, so one bad tx
        cannot poison the batch)."""
        out: List[ResultCheckTx] = []
        notify = False
        wal_buf: List[bytes] = []
        with self.proxy_mtx:
            for tx in txs:
                if self.size() >= self.max_size:
                    _m_rejected.labels("full").inc()
                    out.append(ResultCheckTx(
                        code=1, log=f"mempool is full: {self.size()}"))
                    continue
                if tx in self._tx_elements:
                    self.cache.push(tx)
                    _m_rejected.labels("duplicate").inc()
                    out.append(ResultCheckTx(code=1,
                                             log="tx already in cache"))
                    continue
                if not self.cache.push(tx):
                    _m_rejected.labels("duplicate").inc()
                    out.append(ResultCheckTx(code=1,
                                             log="tx already in cache"))
                    continue
                res = self.app_conn.check_tx(tx)
                if res.ok:
                    wal_buf.append(tx)
                    self._admit(tx)
                    _m_added.inc()
                else:
                    self.cache.remove(tx)
                    _m_rejected.labels("invalid").inc()
                out.append(res)
            if wal_buf:
                if self._wal_file is not None:
                    self._wal_file.write(b"".join(map(_frame, wal_buf)))
                    self._wal_file.flush()
                if telemetry.enabled():
                    _m_size.set(len(self.txs))
                notify = self._mark_txs_available()
        if notify:
            self.txs_available_hook()
        slo_obs.mark_many(wal_buf, "checktx")
        return out

    def _mark_txs_available(self) -> bool:
        """Arm the once-per-height notification; the CALLER fires the hook
        after releasing proxy_mtx (see module docstring)."""
        if self.size() > 0 and not self.notified_txs_available and \
                self.txs_available_hook is not None:
            self.notified_txs_available = True
            return True
        return False

    # -------------------------------------------------------------- reap/update

    def get_by_hash(self, tx_hash: bytes) -> Optional[bytes]:
        """O(1) pending-tx lookup by sha256(tx)."""
        with self.proxy_mtx:
            return self._by_hash.get(tx_hash)

    def pending_hashes(self) -> List[bytes]:
        """Snapshot of every pending tx's sha256 (insertion order)."""
        with self.proxy_mtx:
            return list(self._by_hash.keys())

    def reap(self, max_txs: int = -1) -> List[bytes]:
        """Up to max_txs pending txs in order (-1 = all)
        (mempool/mempool.go:331)."""
        with self.proxy_mtx:
            out = []
            for el in self.txs:
                if 0 <= max_txs <= len(out):
                    break
                out.append(el.value.tx)
            return out

    def _drop(self, tx: bytes) -> bool:
        el = self._tx_elements.pop(tx, None)
        if el is None:
            return False
        self.txs.remove(el)
        self._by_hash.pop(hashlib.sha256(tx).digest(), None)
        return True

    def drop_committed(self, txs: List[bytes]) -> int:
        """Drop txs a stored block already committed (and cache them),
        then rewrite the tx WAL; returns how many were pending. The node
        calls it with its last stored block's txs after the WAL replay: a
        crash between that block's save and its update() leaves them in
        the WAL (a fault of the reference, which proposes them again)."""
        with self.proxy_mtx:
            n = 0
            for tx in txs:
                n += self._drop(tx)
                self.cache.push(tx)
            if n:
                self._rewrite_wal()
            return n

    def update(self, height: int, txs: List[bytes]) -> None:
        """Remove committed txs, then recheck the remainder against the
        post-commit app state (mempool/mempool.go:362). The caller (the
        BlockExecutor, on the consensus thread) holds the lock, so firing
        the hook inline here cannot deadlock — submit() on one's own
        thread only enqueues."""
        self.height = height
        self.notified_txs_available = False
        for tx in txs:
            if self._drop(tx):
                _m_removed.labels("committed").inc()
            # committed txs go into the cache, also those this node never
            # held (a block from a peer): re-submission, or gossip that
            # arrives after the commit, is a dup and cannot be committed
            # twice (the JAX package caches only txs it admitted)
            self.cache.push(tx)
        if self.recheck and len(self.txs) > 0:
            self._recheck_txs()
        if telemetry.enabled():
            _m_size.set(len(self.txs))
        self._rewrite_wal()
        if self._mark_txs_available():
            self.txs_available_hook()

    def _recheck_txs(self) -> None:
        """Re-run CheckTx for every remaining tx; drop newly-invalid ones
        (mempool/mempool.go resCbRecheck)."""
        for el in list(self.txs):
            tx = el.value.tx
            if not self.app_conn.check_tx(tx).ok:
                self._drop(tx)
                self.cache.remove(tx)
                _m_removed.labels("recheck").inc()
