"""A plain Tendermint v0.16 light client, one header at a time: the
tests' copy of `portbench/reference/lite.py`, with the hashing it needs
written out here, so that the tests rest on neither package nor the
benchmark. tests/test_torch_lite_sync.py holds the port's
`InquiringCertifier.certify_range` and the sequential `certify` of both
packages against it.

It decodes the RPC replies (the `commit` and `validators` JSON of each
height), recomputes each header's hash and its validator set's hash, and
applies v0.16's rules in integers:

- a header signed by the trusted set (same set hash) passes VerifyCommit:
  every present precommit valid, and more than 2/3 of the set's power
  on the header's block;
- a header signed by another set first passes VerifyCommitAny against
  the trusted set (lite/dynamic_certifier.go Update): among the votes
  for the block, those of validators the trusted set knows (by address,
  each once) must be valid and carry more than 2/3 of the trusted set's
  power, and more than 2/3 of the new set's power, crediting new power
  only where the new set's validator at the vote's index has the same
  key (v0.16's index rule, kept). Then trust moves to the new set at
  that height, and VerifyCommit runs under it.

A refused update across one height fails with "cannot bridge trust";
across more, the client trusts the provider's header at the midpoint of
the gap first, as the port's InquiringCertifier does. The failures carry
the port's exception class and message.

A signature is valid unless `forged` names it: a set of (height, commit
index) whose signatures the chain's builder changed.
"""

from __future__ import annotations

import hashlib
import json
import struct
from types import SimpleNamespace


def _cdumps(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode()


def _merkle_root(items: list) -> bytes:
    """SHA-256 leaves (0x00) padded with zero digests to a power of two,
    inner nodes (0x01), then SHA256(0x02 || uint64_le(n) || root)."""
    level = [hashlib.sha256(b"\x00" + it).digest() for it in items]
    n = len(level)
    m = 1
    while m < n:
        m *= 2
    level += [b"\x00" * 32] * (m - n)
    while len(level) > 1:
        level = [hashlib.sha256(b"\x01" + level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
    root = level[0] if level else b"\x00" * 32
    return hashlib.sha256(b"\x02" + struct.pack("<Q", n) + root).digest()


tmhash = SimpleNamespace(
    address=lambda pk: hashlib.sha256(pk).digest()[:20],
    valset_hash=lambda vals: _merkle_root(
        [_cdumps({"pubkey": pk.hex(), "voting_power": p}) for pk, p in vals]),
    header_hash=lambda o: _merkle_root([_cdumps({k: o[k]})
                                        for k in sorted(o)]),
    cdumps=_cdumps, merkle_root=_merkle_root)

PRECOMMIT = 2


class Failure(Exception):
    """A header refused: `cls` and `msg` are the program's exception
    class name and message."""

    def __init__(self, cls: str, msg: str):
        super().__init__(msg)
        self.cls, self.msg = cls, msg


def _cert(msg: str) -> Failure:
    return Failure("CertificationError", msg)


class Header:
    """One height decoded from its two replies."""

    __slots__ = ("height", "obj", "block_id", "precommits", "vals", "index",
                 "hash", "total")

    def __init__(self, commit_reply: dict, validators_reply: dict):
        self.obj = commit_reply["header"]
        self.height = self.obj["height"]
        self.precommits = commit_reply["commit"]["precommits"]
        self.block_id = next(pc["block_id"] for pc in self.precommits
                             if pc is not None)
        vals = sorted(((bytes.fromhex(v["pubkey"]), v["voting_power"])
                       for v in validators_reply["validators"]["validators"]),
                      key=lambda v: tmhash.address(v[0]))
        self.vals = vals
        self.index = {tmhash.address(pk): i for i, (pk, _) in enumerate(vals)}
        if len(self.index) != len(vals):
            raise Failure("ValueError", "duplicate validator address")
        self.hash = tmhash.valset_hash(vals)
        self.total = sum(p for _, p in vals)


def decode(replies, h: int):
    """The header at h, or None where the replies hold no commit there
    (the program's HTTPProvider answers None)."""
    pair = replies(h)
    if pair is None:
        return None
    c = json.loads(pair[0])
    if c.get("commit") is None or not any(
            pc is not None for pc in c["commit"]["precommits"]):
        return None
    return Header(c, json.loads(pair[1]))


class Client:
    """Trust: a validator set (`vals`, `index`, `hash`, `total`) and the
    height of the last update; `stored` the heights the client's store
    holds."""

    def __init__(self, chain_id: str, trusted: Header, replies, forged):
        self.chain_id = chain_id
        self.replies = replies
        self.forged = forged
        self.trusted = trusted
        self.last = trusted.height
        self.stored = {trusted.height: trusted}
        self.transitions = 0
        self.certified = 0

    def _valid(self, h: int, idx: int) -> bool:
        return (h, idx) not in self.forged

    def _validate_basic(self, hd: Header) -> None:
        o = hd.obj
        if o["chain_id"] != self.chain_id:
            raise _cert(f"wrong chain id {o['chain_id']!r} "
                        f"(want {self.chain_id!r})")
        if bytes.fromhex(o["validators_hash"]) != hd.hash:
            raise _cert("validator set does not match header's "
                        "validators_hash")
        own = tmhash.header_hash(o) if o["validators_hash"] else b""
        if bytes.fromhex(hd.block_id["hash"]) != own:
            raise _cert("commit is not for this header")

    def _commit_height_round(self, hd: Header) -> tuple:
        first = next(pc for pc in hd.precommits if pc is not None)
        return first["height"], first["round"]

    def _update_ok(self, hd: Header) -> bool:
        """v0.16 Update: True when trust may move to hd's set."""
        try:
            self._validate_basic(hd)
        except Failure:
            return False
        if hd.height <= self.last:
            return False
        if len(hd.vals) != len(hd.precommits):
            return False
        c_height, round_ = self._commit_height_round(hd)
        if c_height != hd.height:
            return False
        t = self.trusted
        counted = []
        seen = set()
        for idx, pc in enumerate(hd.precommits):
            if pc is None:
                continue
            if pc["type"] != PRECOMMIT or pc["height"] != hd.height \
                    or pc["round"] != round_:
                return False
            if pc["block_id"] != hd.block_id:
                continue
            oi = t.index.get(bytes.fromhex(pc["validator_address"]))
            if oi is None or oi in seen:
                continue
            seen.add(oi)
            counted.append((idx, oi))
        old = new = 0
        for idx, oi in counted:
            if not self._valid(hd.height, idx):
                return False
            pk, power = t.vals[oi]
            old += power
            if hd.vals[idx][0] == pk:
                new += hd.vals[idx][1]
        return old * 3 > t.total * 2 and new * 3 > hd.total * 2

    def _trust(self, hd: Header) -> None:
        self.trusted, self.last = hd, hd.height
        self.stored[hd.height] = hd

    def _provider_get(self, h: int):
        """The program's CacheProvider(MemProvider(), source) read: the
        higher of the store's best at or below h and the source's h,
        stored."""
        below = [k for k in self.stored if k <= h]
        best = self.stored[max(below)] if below else None
        if best is None or best.height != h:
            hd = decode(self.replies, h)
            if hd is not None and (best is None or hd.height > best.height):
                best = hd
        if best is not None:
            self.stored[best.height] = best
        return best

    def _update_to(self, hd: Header, depth: int) -> None:
        if depth > 64:
            raise _cert("bisection too deep")
        if self._update_ok(hd):
            self._trust(hd)
            return
        lo, hi = self.last, hd.height
        if hi - lo <= 1:
            raise _cert(f"cannot bridge trust from {lo} to {hi}")
        mid_h = (lo + hi) // 2
        mid = self._provider_get(mid_h)
        if mid is None:
            raise _cert(f"provider has no commit <= {mid_h}")
        if mid.height <= lo:
            raise _cert(f"cannot bridge trust: no commits in ({lo}, {mid_h}]")
        self._update_to(mid, depth + 1)
        self._update_to(hd, depth + 1)

    def _static(self, hd: Header) -> None:
        """v0.16 VerifyCommit under the trusted set."""
        t = self.trusted
        if len(t.vals) != len(hd.precommits):
            raise _cert(f"commit size {len(hd.precommits)} != valset size "
                        f"{len(t.vals)}")
        c_height, round_ = self._commit_height_round(hd)
        if hd.height != c_height:
            raise _cert("commit height mismatch")
        for pc in hd.precommits:
            if pc is None:
                continue
            if pc["type"] != PRECOMMIT:
                raise _cert("commit contains non-precommit")
            if pc["height"] != hd.height or pc["round"] != round_:
                raise _cert("commit vote height/round mismatch")
        power = 0
        for idx, pc in enumerate(hd.precommits):
            if pc is None:
                continue
            if not self._valid(hd.height, idx):
                raise _cert("invalid signature in commit")
            if pc["block_id"] == hd.block_id:
                power += t.vals[idx][1]
        if not power * 3 > t.total * 2:
            raise _cert(f"insufficient voting power: {power}/{t.total}")

    def certify(self, hd: Header) -> None:
        if hd.hash != self.trusted.hash:
            self._update_to(hd, 0)
            self.transitions += 1
        else:
            self._validate_basic(hd)
        self._static(hd)
        self.stored[hd.height] = hd
        self.certified += 1


def sync(chain_id: str, replies, trusted_height: int, lo: int, hi: int,
         forged=frozenset()) -> dict:
    """A client trusted at `trusted_height` certifies lo..hi in order, up
    to the first failure. `replies(h)` gives (commit reply bytes,
    validators reply bytes) or None. Returns the trusted height and set
    hash, the transitions crossed, the headers certified, the stored
    heights, and the failure (class, message) and its height or None."""
    client = Client(chain_id, decode(replies, trusted_height), replies,
                    forged)
    error = at = None
    for h in range(lo, hi + 1):
        try:
            hd = decode(replies, h)
            if hd is None or hd.height != h:
                raise _cert(f"provider has no commit at height {h}")
            client.certify(hd)
        except Failure as f:
            error, at = (f.cls, f.msg), h
            break
    return {"height": client.last, "valset_hash": client.trusted.hash,
            "transitions": client.transitions,
            "certified": client.certified,
            "stored": sorted(client.stored), "error": error, "at": at}
