"""Transaction indexing: the port's copy of `tendermint_tpu/state/txindex.py`
(state/txindex/): KV indexer with per-tag keys and
range queries, a null fallback, and the IndexerService that feeds off the
event bus's EventTx stream (state/txindex/indexer_service.go:14)."""

from __future__ import annotations

import hashlib
import json
import queue
import threading
from typing import List, Optional

from tendermint_tpu_torch.types.events import Query

_HASH_PREFIX = b"txhash/"
_TAG_PREFIX = b"txtag/"


def _esc(s: str) -> str:
    """Escape the key separator in app-supplied tag names/values so a
    '/' inside a value cannot shift the tag/value/height/index fields."""
    return s.replace("%", "%25").replace("/", "%2F")


def _unesc(s: str) -> str:
    return s.replace("%2F", "/").replace("%25", "%")


class NullTxIndexer:
    """state/txindex/null — indexing disabled."""

    def add_batch(self, entries: List[dict]) -> None:
        pass

    def get(self, tx_hash: bytes) -> Optional[dict]:
        return None

    def search(self, query: str) -> List[dict]:
        return []


class KVTxIndexer:
    """state/txindex/kv: index by hash always; by configured tags (or all)
    for tx_search."""

    def __init__(self, db, index_tags: Optional[List[str]] = None,
                 index_all_tags: bool = False):
        self.db = db
        self.index_tags = set(index_tags or [])
        self.index_all_tags = index_all_tags

    def _should_index(self, tag: str) -> bool:
        return self.index_all_tags or tag in self.index_tags

    def add_batch(self, entries: List[dict]) -> None:
        """entries: {height, index, tx: bytes, result: obj, tags: dict}."""
        pairs = []
        for e in entries:
            tx_hash = hashlib.sha256(e["tx"]).digest()
            record = json.dumps({
                "height": e["height"], "index": e["index"],
                "tx": e["tx"].hex(), "result": e.get("result"),
                "tags": {k: str(v) for k, v in (e.get("tags") or {}).items()},
            }, sort_keys=True).encode()
            pairs.append((_HASH_PREFIX + tx_hash.hex().encode(), record))
            for tag, val in (e.get("tags") or {}).items():
                if not self._should_index(tag):
                    continue
                key = _TAG_PREFIX + (
                    f"{_esc(tag)}/{_esc(_orderable(val))}/"
                    f"{e['height']:016d}/{e['index']:08d}").encode()
                pairs.append((key, tx_hash.hex().encode()))
            # always range-queryable by height (reserved tag tx.height)
            hkey = _TAG_PREFIX + (
                f"tx.height/{_orderable(e['height'])}/"
                f"{e['height']:016d}/{e['index']:08d}").encode()
            pairs.append((hkey, tx_hash.hex().encode()))
        self.db.set_batch(pairs)

    def get(self, tx_hash: bytes) -> Optional[dict]:
        raw = self.db.get(_HASH_PREFIX + tx_hash.hex().encode())
        if raw is None:
            return None
        o = json.loads(raw)
        o["tx"] = bytes.fromhex(o["tx"])
        o["hash"] = tx_hash
        return o

    def search(self, query: str) -> List[dict]:
        """AND-composed conditions; `tx.hash = X` short-circuits to a
        point lookup, everything else scans tag keys with range support
        (state/txindex/kv/kv.go:120)."""
        q = Query(query)
        # point lookup
        for key, op, val in q.conds:
            if key == "tx.hash" and op == "=":
                one = self.get(bytes.fromhex(val))
                return [one] if one is not None else []
        result_hashes: Optional[set] = None
        for key, op, val in q.conds:
            matches = self._match_condition(key, op, val)
            result_hashes = matches if result_hashes is None \
                else result_hashes & matches
        out = []
        for h in sorted(result_hashes or ()):
            rec = self.get(bytes.fromhex(h))
            if rec is not None:
                out.append(rec)
        out.sort(key=lambda r: (r["height"], r["index"]))
        return out

    def _match_condition(self, tag: str, op: str, val: str) -> set:
        hashes = set()
        prefix = _TAG_PREFIX + f"{_esc(tag)}/".encode()
        for key, stored in self.db.iterate(prefix):
            tag_val = _unesc(key[len(prefix):].split(b"/")[0].decode())
            if _cmp(tag_val, op, val):
                hashes.add(stored.decode())
        return hashes


def _orderable(v) -> str:
    """Numeric values zero-padded so lexicographic order = numeric."""
    try:
        return f"{int(v):016d}"
    except (ValueError, TypeError):
        return str(v)


def _cmp(stored: str, op: str, want: str) -> bool:
    try:
        a, b = int(stored), int(want)
    except (ValueError, TypeError):
        a, b = str(stored), str(want)
    if op == "=":
        return a == b
    if op == "!=":
        return a != b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == "CONTAINS":
        return str(want) in str(stored)
    return False


class IndexerService:
    """Subscribes to EventTx and feeds the indexer
    (state/txindex/indexer_service.go)."""

    def __init__(self, indexer, event_bus):
        self.indexer = indexer
        self.event_bus = event_bus
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.sub = self.event_bus.subscribe(
            "tx_index", "tm.event = 'Tx'", capacity=65536)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tx-indexer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.event_bus.unsubscribe_all("tx_index")

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.sub.get(timeout=0.5)
            except queue.Empty:
                continue
            d = item.data
            result = d["result"]
            self.indexer.add_batch([{
                "height": d["height"], "index": d["index"], "tx": d["tx"],
                "result": result.to_obj() if hasattr(result, "to_obj")
                          else result,
                "tags": {**(getattr(result, "tags", None) or {}),
                         "tx.height": d["height"]},
            }])
