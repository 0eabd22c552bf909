"""Fast sync: the port's copy of `tendermint_tpu/blockchain/`.

  pool.py     BlockPool, the block downloader with per-peer strikes
  reactor.py  BlockchainReactor and its window engine (one verify_async
              a window of up to VERIFY_WINDOW blocks)
  builder.py  ChainBuilder, a chain of signed blocks for a syncing node
"""

from tendermint_tpu_torch.blockchain.pool import BlockPool, BpPeer
from tendermint_tpu_torch.blockchain.reactor import (
    BLOCKCHAIN_CHANNEL,
    BlockchainReactor,
)

__all__ = ["BLOCKCHAIN_CHANNEL", "BlockPool", "BlockchainReactor", "BpPeer"]
