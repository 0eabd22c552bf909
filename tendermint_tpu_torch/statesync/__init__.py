"""State sync: snapshot discovery, transfer and restore over p2p; the
port's copy of `tendermint_tpu/statesync/`.

  reactor.py   StateSyncReactor (channel 0x60): advertises and serves
               local snapshots, and on a joining node fetches the best
               offered snapshot chunk by chunk from several peers,
               verifies everything, and bootstraps the stores so that
               fast sync only replays the tail.
"""

from tendermint_tpu_torch.statesync.reactor import (
    STATESYNC_CHANNEL,
    StateSyncReactor,
    apply_restore,
    resume_pending_restore,
)
