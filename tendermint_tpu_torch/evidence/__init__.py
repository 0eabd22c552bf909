"""The evidence pool: the port's copy of `tendermint_tpu/evidence/`.

  store.py  persisted evidence: lookup, priority queue, pending index
  pool.py   verification on the node's verifier, priority, commit marks

The evidence reactor waits for the p2p slice.
"""

from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.store import EvidenceInfo, EvidenceStore

__all__ = ["EvidencePool", "EvidenceInfo", "EvidenceStore"]
