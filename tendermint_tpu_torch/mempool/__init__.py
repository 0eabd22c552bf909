"""The mempool: the port's copy of `tendermint_tpu/mempool/`.

  clist.py    the concurrent list the pending txs live in
  mempool.py  CheckTx admission, reap, update with recheck, the tx WAL

The mempool reactor waits for the p2p slice.
"""

from tendermint_tpu_torch.mempool.clist import CElement, CList
from tendermint_tpu_torch.mempool.mempool import (
    Mempool,
    MempoolFull,
    MempoolTx,
    TxAlreadyInCache,
    TxCache,
)

__all__ = ["CElement", "CList", "Mempool", "MempoolFull", "MempoolTx",
           "TxAlreadyInCache", "TxCache"]
