"""AddrBook — bucketed peer-address manager: the port's copy of
`tendermint_tpu/p2p/pex/addrbook.py` (p2p/pex/addrbook.go).

btcd-style design kept: addresses live in hashed "new" buckets until
proven (MarkGood moves them to "old" buckets); bucket choice is keyed on
the address group (/16) and the source peer's group so one peer cannot
fill the book; PickAddress biases between new/old; the book persists to
JSON."""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.p2p.netaddress import NetAddress

NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
MAX_PER_BUCKET = 64
NEW_BUCKETS_PER_ADDRESS = 4
MAX_SELECTION = 250
SELECTION_PERCENT = 23


class KnownAddress:
    """p2p/pex/known_address.go."""

    def __init__(self, addr: NetAddress, src: Optional[NetAddress] = None):
        self.addr = addr
        self.src = src or addr
        self.attempts = 0
        self.last_attempt = 0.0
        self.last_success = 0.0
        self.bucket_type = "new"
        self.buckets: List[int] = []

    def is_old(self) -> bool:
        return self.bucket_type == "old"

    def mark_attempt(self) -> None:
        self.attempts += 1
        self.last_attempt = time.time()

    def mark_good(self) -> None:
        self.attempts = 0
        self.last_attempt = time.time()
        self.last_success = self.last_attempt

    def is_bad(self) -> bool:
        """Eviction heuristic (known_address.go isBad, simplified): too
        many failed attempts and never succeeded."""
        return self.attempts >= 3 and self.last_success == 0

    def to_obj(self):
        return {"addr": self.addr.to_obj(), "src": self.src.to_obj(),
                "attempts": self.attempts, "last_attempt": self.last_attempt,
                "last_success": self.last_success,
                "bucket_type": self.bucket_type, "buckets": self.buckets}

    @classmethod
    def from_obj(cls, o):
        ka = cls(NetAddress.from_obj(o["addr"]), NetAddress.from_obj(o["src"]))
        ka.attempts = o["attempts"]
        ka.last_attempt = o["last_attempt"]
        ka.last_success = o["last_success"]
        ka.bucket_type = o["bucket_type"]
        ka.buckets = list(o["buckets"])
        return ka


def _group(addr: NetAddress) -> str:
    """/16 group key for bucketing."""
    parts = addr.ip.split(".")
    if len(parts) == 4:
        return ".".join(parts[:2])
    return addr.ip


class AddrBook:
    def __init__(self, path: Optional[str] = None, strict: bool = True,
                 key: Optional[bytes] = None):
        self.path = path
        self.strict = strict  # only routable addrs (addr_book_strict)
        self.key = key or os.urandom(24)  # bucket-hash key
        self._lock = threading.Lock()
        self._addrs: Dict[str, KnownAddress] = {}      # id or ip:port -> ka
        self._new: List[Dict[str, KnownAddress]] = [
            {} for _ in range(NEW_BUCKET_COUNT)]
        self._old: List[Dict[str, KnownAddress]] = [
            {} for _ in range(OLD_BUCKET_COUNT)]
        self._our_addrs: set = set()
        if path and os.path.exists(path):
            self.load(path)

    # ---------------------------------------------------------------- helpers

    def _addr_key(self, addr: NetAddress) -> str:
        return addr.id or f"{addr.ip}:{addr.port}"

    def _new_bucket_index(self, addr: NetAddress, src: NetAddress) -> int:
        data = self.key + _group(addr).encode() + _group(src).encode()
        return int.from_bytes(hashlib.sha256(data).digest()[:8], "big") \
            % NEW_BUCKET_COUNT

    def _old_bucket_index(self, addr: NetAddress) -> int:
        data = self.key + self._addr_key(addr).encode()
        return int.from_bytes(hashlib.sha256(data).digest()[:8], "big") \
            % OLD_BUCKET_COUNT

    # ----------------------------------------------------------------- public

    def add_our_address(self, addr: NetAddress) -> None:
        with self._lock:
            self._our_addrs.add(self._addr_key(addr))

    def is_our_address(self, addr: NetAddress) -> bool:
        with self._lock:
            return self._addr_key(addr) in self._our_addrs

    def add_address(self, addr: NetAddress, src: NetAddress) -> bool:
        """addrbook.go AddAddress: into a hashed new bucket; False if
        rejected (ours, non-routable under strict, already old)."""
        with self._lock:
            key = self._addr_key(addr)
            if key in self._our_addrs:
                return False
            if self.strict and not addr.routable():
                return False
            ka = self._addrs.get(key)
            if ka is not None:
                if ka.is_old():
                    return False
                if len(ka.buckets) >= NEW_BUCKETS_PER_ADDRESS:
                    return False
            else:
                ka = KnownAddress(addr, src)
                self._addrs[key] = ka
            b = self._new_bucket_index(addr, src)
            if b in ka.buckets:
                return False
            if len(self._new[b]) >= MAX_PER_BUCKET:
                self._expire_new_bucket(b)
            self._new[b][key] = ka
            ka.buckets.append(b)
            return True

    def _expire_new_bucket(self, b: int) -> None:
        """Evict the worst entry of a full new bucket."""
        bucket = self._new[b]
        victim_key = None
        for k, ka in bucket.items():
            if ka.is_bad():
                victim_key = k
                break
        if victim_key is None:  # oldest attempt time
            victim_key = min(bucket, key=lambda k: bucket[k].last_attempt)
        ka = bucket.pop(victim_key)
        ka.buckets.remove(b)
        if not ka.buckets:
            self._addrs.pop(victim_key, None)

    def remove_address(self, addr: NetAddress) -> None:
        with self._lock:
            self._remove_locked(self._addr_key(addr))

    def _remove_locked(self, key: str) -> None:
        ka = self._addrs.pop(key, None)
        if ka is None:
            return
        table = self._old if ka.is_old() else self._new
        for b in ka.buckets:
            table[b].pop(key, None)

    def mark_attempt(self, addr: NetAddress) -> None:
        with self._lock:
            ka = self._addrs.get(self._addr_key(addr))
            if ka:
                ka.mark_attempt()

    def mark_good(self, addr: NetAddress) -> None:
        """Promote to an old bucket (addrbook.go:227)."""
        with self._lock:
            key = self._addr_key(addr)
            ka = self._addrs.get(key)
            if ka is None:
                return
            ka.mark_good()
            if ka.is_old():
                return
            for b in ka.buckets:
                self._new[b].pop(key, None)
            ka.buckets = []
            ka.bucket_type = "old"
            b = self._old_bucket_index(addr)
            if len(self._old[b]) >= MAX_PER_BUCKET:
                # displace the worst old entry back to new
                worst_key = min(self._old[b],
                                key=lambda k: self._old[b][k].last_success)
                worst = self._old[b].pop(worst_key)
                worst.bucket_type = "new"
                worst.buckets = []
                nb = self._new_bucket_index(worst.addr, worst.src)
                self._new[nb][worst_key] = worst
                worst.buckets.append(nb)
            self._old[b][key] = ka
            ka.buckets.append(b)

    def mark_bad(self, addr: NetAddress) -> None:
        self.remove_address(addr)

    def pick_address(self, new_bias_pct: int = 30) -> Optional[NetAddress]:
        """Random address, biased new-vs-old (addrbook.go:177-182)."""
        with self._lock:
            n_new = sum(len(b) for b in self._new)
            n_old = sum(len(b) for b in self._old)
            if n_new + n_old == 0:
                return None
            bias = max(0, min(100, new_bias_pct))
            pick_old = n_old > 0 and (
                n_new == 0 or random.randrange(100) >= bias)
            table = self._old if pick_old else self._new
            candidates = [ka for bucket in table for ka in bucket.values()]
            if not candidates:
                return None
            return random.choice(candidates).addr

    def get_selection(self) -> List[NetAddress]:
        """Random subset for a PEX response (addrbook.go:259)."""
        with self._lock:
            all_addrs = [ka.addr for ka in self._addrs.values()]
        n = min(MAX_SELECTION,
                max(1, len(all_addrs) * SELECTION_PERCENT // 100)) \
            if all_addrs else 0
        return random.sample(all_addrs, n) if n else []

    def has(self, addr: NetAddress) -> bool:
        with self._lock:
            return self._addr_key(addr) in self._addrs

    def size(self) -> int:
        with self._lock:
            return len(self._addrs)

    def need_more_addrs(self) -> bool:
        return self.size() < 1000

    # ------------------------------------------------------------ persistence

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            return
        with self._lock:
            obj = {"key": self.key.hex(),
                   "addrs": [ka.to_obj() for ka in self._addrs.values()]}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            obj = json.load(f)
        with self._lock:
            self.key = bytes.fromhex(obj["key"])
            for ka_obj in obj["addrs"]:
                ka = KnownAddress.from_obj(ka_obj)
                key = self._addr_key(ka.addr)
                self._addrs[key] = ka
                table = self._old if ka.is_old() else self._new
                for b in ka.buckets:
                    table[b][key] = ka
