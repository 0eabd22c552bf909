"""Persistence: the port's copy of the stores of `tendermint_tpu/storage/`.

  db.py           key-value store abstraction: MemDB and SQLiteDB, and
                  the write-staging view StagedDB (group commit)
  block_store.py  per-height blocks, parts and commits
  state_store.py  state and historical validator sets / params, ABCI
                  responses
  wal.py          the consensus write-ahead log (CRC frames, ENDHEIGHT
                  markers, torn-tail repair, rotation)
  snapshot.py     chunked state snapshots, retention and the pruning
                  floor (the recovery plane)
"""

from tendermint_tpu_torch.storage.db import (KVStore, MemDB, SQLiteDB,
                                             StagedDB, open_db)
from tendermint_tpu_torch.storage.block_store import BlockMeta, BlockStore
from tendermint_tpu_torch.storage.state_store import StateStore
from tendermint_tpu_torch.storage.snapshot import (SnapshotManager,
                                                   SnapshotStore)
from tendermint_tpu_torch.storage.wal import (WAL, NilWAL, WALCorruptionError,
                                          WALMessage)
