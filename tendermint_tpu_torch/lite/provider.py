"""FullCommit providers: where a light client stores and fetches certified
checkpoints.

Counterpart of `MemProvider` and `CacheProvider` in
`tendermint_tpu/lite/provider.py`. The file and RPC providers come in a
later slice.
"""

from __future__ import annotations

import threading
from typing import Optional

from tendermint_tpu_torch.lite.types import FullCommit


class MemProvider:
    def __init__(self):
        self._lock = threading.Lock()
        self._by_height: dict = {}

    def store_commit(self, fc: FullCommit) -> None:
        with self._lock:
            self._by_height[fc.height] = fc

    def get_by_height(self, h: int) -> Optional[FullCommit]:
        """The commit at the largest stored height <= h."""
        with self._lock:
            candidates = [hh for hh in self._by_height if hh <= h]
            if not candidates:
                return None
            return self._by_height[max(candidates)]

    def latest_commit(self) -> Optional[FullCommit]:
        with self._lock:
            if not self._by_height:
                return None
            return self._by_height[max(self._by_height)]


class CacheProvider:
    """Layered read-through: the best answer of any provider is stored in
    all of them."""

    def __init__(self, *providers):
        self.providers = list(providers)

    def store_commit(self, fc: FullCommit) -> None:
        for p in self.providers:
            p.store_commit(fc)

    def get_by_height(self, h: int) -> Optional[FullCommit]:
        best = None
        for p in self.providers:
            fc = p.get_by_height(h)
            if fc is not None and (best is None or fc.height > best.height):
                best = fc
                if fc.height == h:
                    break
        if best is not None:
            self.store_commit(best)
        return best

    def latest_commit(self) -> Optional[FullCommit]:
        best = None
        for p in self.providers:
            fc = p.latest_commit()
            if fc is not None and (best is None or fc.height > best.height):
                best = fc
        return best
