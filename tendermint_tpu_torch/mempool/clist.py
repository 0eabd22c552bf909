"""CList — a concurrent doubly-linked list with blocking iteration: the
port's copy of `tendermint_tpu/mempool/clist.py`.

Capability parity with tmlibs/clist (the structure under the reference's
mempool, mempool/mempool.go:65 and mempool/reactor.go:104): elements are
stable handles that survive removal of their neighbours, and a reader can
park on `front_wait` / `CElement.next_wait` until an element appears —
that is what lets each per-peer broadcast routine walk the tx list at its
own pace while the mempool mutates it concurrently.

Implemented with one Condition guarding structural mutation; handles keep
`removed` tombstones so an iterator holding a detached element can still
reach the live suffix of the list.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterator, Optional


class CElement:
    __slots__ = ("value", "_list", "_prev", "_next", "removed")

    def __init__(self, value: Any, list_: "CList"):
        self.value = value
        self._list = list_
        self._prev: Optional[CElement] = None
        self._next: Optional[CElement] = None
        self.removed = False

    def next(self) -> Optional["CElement"]:
        with self._list._cond:
            return self._next

    def next_wait(self, timeout: Optional[float] = None) -> Optional["CElement"]:
        """Block until this element has a successor, this element is
        removed (then return the successor it had, possibly None), or the
        timeout lapses."""
        with self._list._cond:
            while self._next is None and not self.removed:
                if not self._list._cond.wait(timeout=timeout):
                    return self._next
            return self._next

    def prev(self) -> Optional["CElement"]:
        with self._list._cond:
            return self._prev


class CList:
    def __init__(self):
        self._cond = threading.Condition()
        self._head: Optional[CElement] = None
        self._tail: Optional[CElement] = None
        self._len = 0
        # monotonically bumped on every push; lets waiters detect activity
        self._wakeups = 0

    def __len__(self) -> int:
        with self._cond:
            return self._len

    def front(self) -> Optional[CElement]:
        with self._cond:
            return self._head

    def front_wait(self, timeout: Optional[float] = None) -> Optional[CElement]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._head is None:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            return self._head

    def back(self) -> Optional[CElement]:
        with self._cond:
            return self._tail

    def push_back(self, value: Any) -> CElement:
        el = CElement(value, self)
        with self._cond:
            el._prev = self._tail
            if self._tail is not None:
                self._tail._next = el
            else:
                self._head = el
            self._tail = el
            self._len += 1
            self._wakeups += 1
            self._cond.notify_all()
        return el

    def remove(self, el: CElement) -> Any:
        with self._cond:
            if el.removed:
                return el.value
            prev, nxt = el._prev, el._next
            if prev is not None:
                prev._next = nxt
            else:
                self._head = nxt
            if nxt is not None:
                nxt._prev = prev
            else:
                self._tail = prev
            el.removed = True
            # keep el._next so a parked iterator can continue from here
            el._prev = None
            self._len -= 1
            self._cond.notify_all()
            return el.value

    def clear(self) -> None:
        with self._cond:
            el = self._head
            while el is not None:
                el.removed = True
                nxt = el._next
                el._prev = None
                el = nxt
            self._head = self._tail = None
            self._len = 0
            self._cond.notify_all()

    def __iter__(self) -> Iterator[CElement]:
        """Snapshot-free iteration over live elements (mutation-safe)."""
        el = self.front()
        while el is not None:
            if not el.removed:
                yield el
            el = el.next()
