"""FullCommit providers: where a light client stores and fetches certified
checkpoints.

Counterpart of `tendermint_tpu/lite/provider.py`: MemProvider, FileProvider
(one JSON file a height, byte-equal to the JAX package's, so that each
package reads the other's directory), HTTPProvider (commits and validator
sets over a node's JSON-RPC) and CacheProvider.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

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


class FileProvider:
    """lite/files/provider.go: one JSON file per height."""

    def __init__(self, dir_: str):
        self.dir = dir_
        os.makedirs(dir_, exist_ok=True)

    def _path(self, h: int) -> str:
        return os.path.join(self.dir, f"{h:012d}.fc.json")

    def store_commit(self, fc: FullCommit) -> None:
        tmp = self._path(fc.height) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(fc.to_obj(), f)
        os.replace(tmp, self._path(fc.height))

    def _heights(self) -> List[int]:
        return sorted(int(name.split(".")[0])
                      for name in os.listdir(self.dir)
                      if name.endswith(".fc.json"))

    def get_by_height(self, h: int) -> Optional[FullCommit]:
        eligible = [hh for hh in self._heights() if hh <= h]
        if not eligible:
            return None
        with open(self._path(max(eligible))) as f:
            return FullCommit.from_obj(json.load(f))

    def latest_commit(self) -> Optional[FullCommit]:
        hs = self._heights()
        return self.get_by_height(hs[-1]) if hs else None


class HTTPProvider:
    """lite/client/provider.go: commits and validator sets fetched from a
    node's RPC (the port's JSONRPCClient, or any client with `call`). An
    RPC that fails reads as "no commit" (None), as in the JAX package."""

    def __init__(self, rpc_client):
        self.rpc = rpc_client

    def store_commit(self, fc: FullCommit) -> None:
        pass  # a read-only source

    def get_by_height(self, h: int) -> Optional[FullCommit]:
        from tendermint_tpu_torch.lite.types import SignedHeader
        from tendermint_tpu_torch.types.block import Commit, Header
        from tendermint_tpu_torch.types.validator_set import ValidatorSet
        try:
            c = self.rpc.call("commit", height=h)
            v = self.rpc.call("validators", height=h)
        except Exception:
            return None
        if c.get("commit") is None:
            return None
        header = Header.from_obj(c["header"])
        commit = Commit.from_obj(c["commit"])
        # the commit's precommits carry the canonical BlockID
        bid = next((pc.block_id for pc in commit.precommits
                    if pc is not None), None)
        if bid is None:
            return None
        return FullCommit(
            SignedHeader(header, commit, bid),
            ValidatorSet.from_obj(v["validators"]))

    def latest_commit(self) -> Optional[FullCommit]:
        try:
            st = self.rpc.call("status")
        except Exception:
            return None
        h = st.get("latest_block_height", 0)
        return self.get_by_height(h) if h else None


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
