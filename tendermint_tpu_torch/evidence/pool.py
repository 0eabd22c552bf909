"""EvidencePool — verifies, prioritizes and tracks byzantine evidence: the
port's copy of `tendermint_tpu/evidence/pool.py`.

evidence/pool.go behavior: `add_evidence` verifies against the current
state (age window + historical-valset membership, state/validation.go:90),
stores with priority = accused validator's power, and queues the evidence
for the gossip reactor. `update(block)` marks included evidence committed
and refreshes the pool's view of state.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

from tendermint_tpu_torch.evidence.store import EvidenceStore
from tendermint_tpu_torch.state.validation import verify_evidence


class EvidencePool:
    def __init__(self, store: EvidenceStore, state, state_store=None,
                 verifier=None):
        self.store = store
        self.state = state          # refreshed on every update()
        self.state_store = state_store
        self.verifier = verifier
        self._lock = threading.Lock()
        # unbounded: the reactor drains it (evidence/pool.go evidenceChan)
        self.evidence_queue: "queue.Queue" = queue.Queue()

    def pending_evidence(self) -> List:
        return self.store.pending_evidence()

    def priority_evidence(self) -> List:
        return self.store.priority_evidence()

    def add_evidence(self, ev) -> None:
        """Verify + store + enqueue for gossip (evidence/pool.go:87).
        Raises BlockValidationError on invalid evidence; silently ignores
        duplicates and already-committed evidence (after a block commits
        evidence, honest peers' in-flight broadcasts of it are a normal
        race, not misbehavior)."""
        with self._lock:
            if self.store.is_committed(ev):
                return
            val = verify_evidence(self.state, ev, self.state_store,
                                  verifier=self.verifier)
            priority = val.voting_power if val is not None else 0
            if not self.store.add_new_evidence(ev, priority):
                return  # already pending
            self.evidence_queue.put(ev)

    def update(self, block, state=None) -> None:
        """Mark evidence committed in `block`; advance state view
        (evidence/pool.go:71)."""
        with self._lock:
            if state is not None:
                self.state = state
            for ev in block.evidence.evidence:
                self.store.mark_evidence_as_committed(ev)

    def drain(self, timeout: Optional[float] = None) -> Optional[object]:
        """Next evidence for gossip, or None on timeout."""
        try:
            return self.evidence_queue.get(timeout=timeout)
        except queue.Empty:
            return None
