"""Consensus — the Tendermint BFT state machine: the port's copy of
`tendermint_tpu/consensus/` (reference consensus/ pkg).

  rstate.py         round steps, RoundState, HeightVoteSet (consensus/types/)
  ticker.py         single-timer timeout scheduler        (consensus/ticker.go)
  state.py          ConsensusState event loop             (consensus/state.go)
  replay.py         WAL catchup replay + ABCI handshake   (consensus/replay.go)
  wal_generator.py  a WAL of N committed heights

ConsensusState is an explicitly-stepped deterministic machine: inputs
(messages, timeouts) are handled on one thread, effects (gossip
messages, scheduled timeouts, committed blocks) leave through injectable
sinks. The same handle() path serves live operation, WAL replay and
tests. The reactor and the compact-gossip plane wait for the p2p slice.
"""

from tendermint_tpu_torch.consensus.rstate import (
    HeightVoteSet, RoundState, Step,
)
from tendermint_tpu_torch.consensus.ticker import (TimeoutInfo, TimeoutTicker,
                                                   MockTicker)
from tendermint_tpu_torch.consensus.state import ConsensusState
