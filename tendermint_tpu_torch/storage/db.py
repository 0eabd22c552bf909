"""Key-value store abstraction: the port's copy of
`tendermint_tpu/storage/db.py`.

The interface is the reference's (the tmlibs/db shape); the backends are
an in-memory ordered dict (tests, ephemeral nodes) and SQLite (stdlib,
crash-safe). Keys and values are opaque bytes; prefix iteration is
ordered lexicographically, matching LevelDB semantics. `StagedDB` is the
write-staging view that group commit (`pipeline.GroupCommit`) flushes as
one batch.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator, Optional, Protocol, Sequence


class KVStore(Protocol):
    def get(self, key: bytes) -> Optional[bytes]: ...
    def set(self, key: bytes, value: bytes) -> None: ...
    def set_batch(self, pairs: Sequence[tuple[bytes, bytes]]) -> None: ...
    def delete(self, key: bytes) -> None: ...
    def delete_batch(self, keys: Sequence[bytes]) -> None: ...
    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]: ...
    def compact(self) -> None: ...
    def close(self) -> None: ...


def _prefix_upper_bound(prefix: bytes) -> Optional[bytes]:
    """Smallest key greater than every key starting with prefix, or None
    when the prefix is all 0xff (unbounded above)."""
    trimmed = prefix.rstrip(b"\xff")
    if not trimmed:
        return None
    return trimmed[:-1] + bytes([trimmed[-1] + 1])


class MemDB:
    """Ordered in-memory KV store."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._d.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._d[bytes(key)] = bytes(value)

    def set_batch(self, pairs: Sequence[tuple[bytes, bytes]]) -> None:
        with self._lock:
            for k, v in pairs:
                self._d[bytes(k)] = bytes(v)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._d.pop(key, None)

    def delete_batch(self, keys: Sequence[bytes]) -> None:
        with self._lock:
            for k in keys:
                self._d.pop(k, None)

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        with self._lock:
            items = sorted((k, v) for k, v in self._d.items()
                           if k.startswith(prefix))
        yield from items

    def compact(self) -> None:
        pass

    def close(self) -> None:
        pass


class SQLiteDB:
    """Crash-safe KV store on a single sqlite file (WAL journal mode)."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._all_cons: list[sqlite3.Connection] = []
        self._cons_lock = threading.Lock()
        con = self._con()
        con.execute("CREATE TABLE IF NOT EXISTS kv"
                    " (k BLOB PRIMARY KEY, v BLOB NOT NULL)")
        con.commit()

    def _con(self) -> sqlite3.Connection:
        con = getattr(self._local, "con", None)
        if con is None:
            con = sqlite3.connect(self.path)
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            self._local.con = con
            with self._cons_lock:
                self._all_cons.append(con)
        return con

    def get(self, key: bytes) -> Optional[bytes]:
        row = self._con().execute(
            "SELECT v FROM kv WHERE k=?", (key,)).fetchone()
        return None if row is None else row[0]

    def set(self, key: bytes, value: bytes) -> None:
        con = self._con()
        con.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                    (bytes(key), bytes(value)))
        con.commit()

    def set_batch(self, pairs: Sequence[tuple[bytes, bytes]]) -> None:
        con = self._con()
        con.executemany("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                        [(bytes(k), bytes(v)) for k, v in pairs])
        con.commit()

    def delete(self, key: bytes) -> None:
        con = self._con()
        con.execute("DELETE FROM kv WHERE k=?", (key,))
        con.commit()

    def delete_batch(self, keys: Sequence[bytes]) -> None:
        """One transaction for a whole range of deletions — the pruning
        hot path sends one of these per height window instead of a
        commit per row."""
        con = self._con()
        con.executemany("DELETE FROM kv WHERE k=?",
                        [(bytes(k),) for k in keys])
        con.commit()

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        hi = _prefix_upper_bound(prefix) if prefix else None
        if prefix and hi is not None:
            cur = self._con().execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                (prefix, hi))
        elif prefix:  # all-0xff prefix: unbounded above
            cur = self._con().execute(
                "SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (prefix,))
        else:
            cur = self._con().execute("SELECT k, v FROM kv ORDER BY k")
        yield from cur

    def compact(self) -> None:
        """Reclaim the space deleted rows leave behind — sqlite keeps
        freed pages in the file until a VACUUM rewrites it. Called by
        the pruner after a range delete; safe at any quiescent point
        (VACUUM cannot run inside a transaction, and every write here
        commits immediately)."""
        self._con().execute("VACUUM")

    def close(self) -> None:
        # close EVERY thread's connection, not just the caller's —
        # sqlite3 connections are safe to close from another thread as
        # long as no statement is executing
        with self._cons_lock:
            cons, self._all_cons = self._all_cons, []
        for con in cons:
            try:
                con.close()
            except sqlite3.ProgrammingError:
                pass
        self._local.con = None


class StagedDB:
    """Write-staging view over a KVStore, the group-commit substrate
    (pipeline.py). set/set_batch/delete collect into an in-memory
    overlay; get/iterate read their own writes (a staged deletion
    shadows the inner row); nothing touches the inner store until
    flush_into_inner() applies the whole overlay as one set_batch and
    one delete_batch.

    Single writer: the consensus drain loop is the only staging writer.
    Readers of the inner store (RPC, gossip catchup) miss rows not yet
    flushed, as they would mid-save without group commit."""

    def __init__(self, inner: KVStore):
        self.inner = inner
        self.staged: dict[bytes, Optional[bytes]] = {}  # None = deleted

    def get(self, key: bytes) -> Optional[bytes]:
        k = bytes(key)
        if k in self.staged:
            return self.staged[k]
        return self.inner.get(k)

    def set(self, key: bytes, value: bytes) -> None:
        self.staged[bytes(key)] = bytes(value)

    def set_batch(self, pairs: Sequence[tuple[bytes, bytes]]) -> None:
        for k, v in pairs:
            self.staged[bytes(k)] = bytes(v)

    def delete(self, key: bytes) -> None:
        self.staged[bytes(key)] = None

    def delete_batch(self, keys: Sequence[bytes]) -> None:
        for k in keys:
            self.staged[bytes(k)] = None

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        over = {k: v for k, v in self.staged.items() if k.startswith(prefix)}
        for k, v in self.inner.iterate(prefix):
            if k not in over:  # a staged value or deletion shadows it
                over[k] = v
        for k in sorted(over):
            if over[k] is not None:
                yield k, over[k]

    def compact(self) -> None:
        pass  # a view; compaction belongs to the inner store

    def close(self) -> None:
        pass  # a view; the inner store's owner closes it

    def flush_into_inner(self) -> None:
        """Apply the overlay to the inner store (one set_batch of the
        staged writes, then one delete_batch of the staged deletions) and
        clear it."""
        sets = [(k, v) for k, v in self.staged.items() if v is not None]
        dels = [k for k, v in self.staged.items() if v is None]
        if sets:
            self.inner.set_batch(sets)
        if dels:
            self.inner.delete_batch(dels)
        self.staged.clear()


def open_db(path: Optional[str]) -> KVStore:
    """None/'' or ':memory:' -> MemDB; otherwise SQLite at path."""
    if not path or path == ":memory:":
        return MemDB()
    return SQLiteDB(path)
