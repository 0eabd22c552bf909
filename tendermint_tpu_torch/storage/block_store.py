"""BlockStore: per-height persistence of blocks, parts and commits; the
port's copy of `tendermint_tpu/storage/block_store.py`.

Behavior parity with the reference block store (blockchain/store.go:33-268):
per height it saves a BlockMeta, every Part, the block's LastCommit (under
H-1) and the SeenCommit; LoadBlock reassembles the block from its parts.
Keys mirror the reference's `H:`/`P:h:i`/`C:`/`SC:` scheme. `bootstrap`
(a state-sync restore's frontier without blocks below it) and `prune`
(windowed deletes behind a retain height, with the `prune.mid_range`
fail point) are the recovery plane's (storage/snapshot.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.storage.db import KVStore
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.block import Block, BlockID, Commit, Header
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.utils import fail

_HEIGHT_KEY = b"BS:height"
_BASE_KEY = b"BS:base"       # first retained height (pruning floor + 0)


def _meta_key(h: int) -> bytes:
    return b"BS:H:%020d" % h


def _part_key(h: int, i: int) -> bytes:
    return b"BS:P:%020d:%08d" % (h, i)


def _commit_key(h: int) -> bytes:
    return b"BS:C:%020d" % h


def _seen_commit_key(h: int) -> bytes:
    return b"BS:SC:%020d" % h


# Parts are stored RAW, not as hex-JSON: a part is up to 64 KiB of block
# bytes, and hex-JSON doubles the stored size and burns an encode/decode
# per part in the sync hot loop (the reference stores go-wire binary,
# blockchain/store.go:167-200). Layout (format byte 0x01):
#   0x01 | u32le index | u8 n_proof | n_proof * 32B aunts | payload
# Rows written by the earlier hex-JSON format start with '{' and are
# still readable; any other leading byte fails loudly.
_PART_FMT = 0x01
_PART_HDR = 6


def _pack_part(part: Part) -> bytes:
    assert len(part.proof) < 256
    return (bytes([_PART_FMT]) + part.index.to_bytes(4, "little")
            + bytes([len(part.proof)]) + b"".join(part.proof)
            + part.payload)


def _unpack_part(raw: bytes) -> Part:
    if raw[:1] == b"{":  # legacy hex-JSON row
        return Part.from_obj(encoding.cloads(raw))
    if raw[0] != _PART_FMT:
        raise ValueError(f"unknown block-part format 0x{raw[0]:02x}")
    index = int.from_bytes(raw[1:5], "little")
    n = raw[5]
    off = _PART_HDR + 32 * n
    proof = [raw[_PART_HDR + 32 * i:_PART_HDR + 32 * (i + 1)]
             for i in range(n)]
    return Part(index, raw[off:], proof)


@dataclass
class BlockMeta:
    """Summary row for a stored block (blockchain/store.go BlockMeta)."""
    block_id: BlockID
    header: Header

    def to_obj(self):
        return {"block_id": self.block_id.to_obj(),
                "header": self.header.to_obj()}

    @classmethod
    def from_obj(cls, o) -> "BlockMeta":
        return cls(BlockID.from_obj(o["block_id"]),
                   Header.from_obj(o["header"]))


class BlockStore:
    def __init__(self, db: KVStore):
        self.db = db

    def height(self) -> int:
        raw = self.db.get(_HEIGHT_KEY)
        return 0 if raw is None else int(raw)

    def base(self) -> int:
        """First height whose block is retained (blocks below were
        pruned, or — after a state-sync bootstrap — never stored).
        1 on an unpruned store.

        SELF-HEALING against a torn prune: each prune window's deletes
        commit strictly BEFORE the base row advances, so a crash
        mid-range can leave the row pointing at already-deleted
        heights. Scan forward to the first retained block and repair
        the row (bounded by one prune window per crash)."""
        raw = self.db.get(_BASE_KEY)
        b = 1 if raw is None else int(raw)
        h = self.height()
        healed = b
        while healed <= h and self.db.get(_meta_key(healed)) is None:
            healed += 1
        if healed != b:
            self.db.set(_BASE_KEY, b"%d" % healed)
        return healed

    def bootstrap(self, height: int, seen_commit: Commit) -> None:
        """State-sync bootstrap: adopt `height` as the store frontier
        WITHOUT any blocks below it. Stores the snapshot height's seen
        commit (consensus `_reconstruct_last_commit` needs it at the
        fast-sync handoff) and sets base = height + 1 — the first block
        this store will ever hold is the snapshot's successor. One
        atomic batch; idempotent, so a torn state-sync apply can simply
        re-run it."""
        if self.height() > height:
            raise ValueError(
                f"bootstrap at {height} behind existing store height "
                f"{self.height()}")
        self.db.set_batch([
            (_seen_commit_key(height), seen_commit.to_bytes()),
            (_commit_key(height), seen_commit.to_bytes()),
            (_BASE_KEY, b"%d" % (height + 1)),
            (_HEIGHT_KEY, b"%d" % height),
        ])

    def prune(self, retain_height: int, window: int = 256) -> int:
        """Delete blocks below `retain_height` (meta, parts, commits,
        seen commits), one delete_batch per `window` heights — group
        commit for the delete path. The base row advances AFTER each
        window's deletes commit, so a crash mid-range leaves only
        already-deleted rows below base: the next prune re-issues
        idempotent deletes. Returns the number of heights pruned.
        Callers enforce the floor policy (snapshot / evidence / peer
        frontiers) — this is the mechanism only."""
        base = self.base()
        retain_height = min(retain_height, self.height())
        if retain_height <= base:
            return 0
        pruned = 0
        for lo in range(base, retain_height, window):
            hi = min(lo + window, retain_height)
            keys = []
            for h in range(lo, hi):
                meta = self.load_block_meta(h)
                n_parts = meta.block_id.parts.total if meta else 0
                keys.append(_meta_key(h))
                keys.extend(_part_key(h, i) for i in range(n_parts))
                keys.append(_commit_key(h))
                keys.append(_seen_commit_key(h))
            self.db.delete_batch(keys)
            fail.fail_point("prune.mid_range")
            self.db.set(_BASE_KEY, b"%d" % hi)
            pruned += hi - lo
        return pruned

    def save_block(self, block: Block, part_set: PartSet,
                   seen_commit: Commit) -> None:
        """Persist block at its height (blockchain/store.go:167-200).

        Stores the meta, all parts, block.last_commit under height-1, and
        the freshly-seen commit under height. Height advances last so a
        crash mid-save is recovered by overwriting on replay.
        """
        h = block.header.height
        if h != self.height() + 1:
            raise ValueError(f"save_block: expected height "
                             f"{self.height() + 1}, got {h}")
        if not part_set.is_complete():
            raise ValueError("save_block: part set is not complete")
        meta = BlockMeta(BlockID(block.hash(), part_set.header()),
                         block.header)
        pairs = [(_meta_key(h), encoding.cdumps(meta.to_obj()))]
        for i in range(part_set.total):
            part = part_set.get_part(i)
            pairs.append((_part_key(h, i), _pack_part(part)))
        if block.last_commit is not None:
            # cached canonical bytes: the same commit object is stored
            # twice across adjacent heights (seen_commit at h, then
            # last_commit inside block h+1)
            pairs.append((_commit_key(h - 1), block.last_commit.to_bytes()))
        pairs.append((_seen_commit_key(h), seen_commit.to_bytes()))
        pairs.append((_HEIGHT_KEY, b"%d" % h))
        self.db.set_batch(pairs)  # one transaction: atomic + one commit

    def load_block_meta(self, h: int) -> Optional[BlockMeta]:
        raw = self.db.get(_meta_key(h))
        return None if raw is None else BlockMeta.from_obj(encoding.cloads(raw))

    def load_block_part(self, h: int, i: int) -> Optional[Part]:
        raw = self.db.get(_part_key(h, i))
        return None if raw is None else _unpack_part(raw)

    def load_block(self, h: int) -> Optional[Block]:
        """Reassemble the block from its parts (blockchain/store.go:70-90)."""
        meta = self.load_block_meta(h)
        if meta is None:
            return None
        buf = bytearray()
        for i in range(meta.block_id.parts.total):
            part = self.load_block_part(h, i)
            if part is None:
                raise LookupError(f"block {h} part {i} missing")
            buf += part.payload
        return Block.from_bytes(bytes(buf))

    def load_block_commit(self, h: int) -> Optional[Commit]:
        """The canonical commit for height h (stored with block h+1)."""
        raw = self.db.get(_commit_key(h))
        return None if raw is None else Commit.from_obj(encoding.cloads(raw))

    def load_seen_commit(self, h: int) -> Optional[Commit]:
        """Locally-seen commit for h — may differ in round from canonical."""
        raw = self.db.get(_seen_commit_key(h))
        return None if raw is None else Commit.from_obj(encoding.cloads(raw))
