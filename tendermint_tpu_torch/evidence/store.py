"""EvidenceStore — persisted byzantine-behaviour evidence: the port's copy
of `tendermint_tpu/evidence/store.py`.

Key layout mirrors evidence/store.go:45-66: a `lookup/` record per
evidence (the source of truth, carrying priority + committed flag), an
`outqueue/` index ordered by priority for gossip, and a `pending/` index
of not-yet-committed evidence for block inclusion.
"""

from __future__ import annotations

import json
from typing import List, Optional

from tendermint_tpu_torch.types.evidence import evidence_from_obj, evidence_to_obj

_LOOKUP = b"evidence-lookup/"
_OUTQUEUE = b"evidence-outqueue/"
_PENDING = b"evidence-pending/"


def _key_suffix(ev) -> bytes:
    return b"%016d/%s" % (ev.height(), ev.hash().hex().encode())


_MAX_PRIORITY = 10**19 - 1  # > Tendermint's max total voting power (~1.15e18)


def _priority_suffix(priority: int, ev) -> bytes:
    # inverted + zero-padded so lexicographic iteration = descending priority
    inv = _MAX_PRIORITY - min(max(priority, 0), _MAX_PRIORITY)
    return b"%019d/%s" % (inv, _key_suffix(ev))


class EvidenceInfo:
    def __init__(self, evidence, priority: int, committed: bool):
        self.evidence = evidence
        self.priority = priority
        self.committed = committed

    def to_bytes(self) -> bytes:
        return json.dumps({"evidence": evidence_to_obj(self.evidence),
                           "priority": self.priority,
                           "committed": self.committed},
                          sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "EvidenceInfo":
        o = json.loads(b)
        return cls(evidence_from_obj(o["evidence"]), o["priority"],
                   o["committed"])


class EvidenceStore:
    def __init__(self, db):
        self.db = db

    def add_new_evidence(self, ev, priority: int) -> bool:
        """False if already stored (evidence/store.go:128)."""
        if self.db.get(_LOOKUP + _key_suffix(ev)) is not None:
            return False
        info = EvidenceInfo(ev, priority, committed=False).to_bytes()
        self.db.set_batch([
            (_LOOKUP + _key_suffix(ev), info),
            (_OUTQUEUE + _priority_suffix(priority, ev), info),
            (_PENDING + _key_suffix(ev), info),
        ])
        return True

    def get_info(self, height: int, hash_: bytes) -> Optional[EvidenceInfo]:
        b = self.db.get(_LOOKUP + b"%016d/%s" % (height, hash_.hex().encode()))
        return EvidenceInfo.from_bytes(b) if b is not None else None

    def pending_evidence(self) -> List:
        return [EvidenceInfo.from_bytes(v).evidence
                for _, v in self.db.iterate(_PENDING)]

    def priority_evidence(self) -> List:
        """Uncommitted evidence, highest priority first (the gossip order,
        evidence/store.go outqueue)."""
        return [EvidenceInfo.from_bytes(v).evidence
                for _, v in self.db.iterate(_OUTQUEUE)]

    def mark_evidence_as_committed(self, ev) -> None:
        """evidence/store.go:163: drop from both queues, flip the flag."""
        info = self.get_info(ev.height(), ev.hash())
        if info is None:
            info = EvidenceInfo(ev, 0, committed=True)
        self.db.delete(_PENDING + _key_suffix(ev))
        self.db.delete(_OUTQUEUE + _priority_suffix(info.priority, ev))
        info.committed = True
        self.db.set(_LOOKUP + _key_suffix(ev), info.to_bytes())

    def is_committed(self, ev) -> bool:
        info = self.get_info(ev.height(), ev.hash())
        return info is not None and info.committed
