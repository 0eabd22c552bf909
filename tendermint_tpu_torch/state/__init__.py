"""Replicated-state bookkeeping and block execution: the port's copy of
`tendermint_tpu/state/`.

  state.py       the State value type and the genesis state
  execution.py   BlockExecutor, the only mutation path
  validation.py  block-vs-state checks, the LastCommit on the
                 BatchVerifier

  txindex.py     KVTxIndexer, NullTxIndexer and the IndexerService that
                 feeds them from the event bus
"""

from tendermint_tpu_torch.state.state import State, make_genesis_state
