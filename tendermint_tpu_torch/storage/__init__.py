"""Persistence: the port's copy of the stores of `tendermint_tpu/storage/`.

  db.py           key-value store abstraction: MemDB and SQLiteDB
  block_store.py  per-height blocks, parts and commits
  state_store.py  state and historical validator sets / params, ABCI
                  responses
  wal.py          the consensus write-ahead log (CRC frames, ENDHEIGHT
                  markers, torn-tail repair, rotation)

Snapshots and StagedDB wait for later slices.
"""

from tendermint_tpu_torch.storage.db import KVStore, MemDB, SQLiteDB, open_db
from tendermint_tpu_torch.storage.block_store import BlockMeta, BlockStore
from tendermint_tpu_torch.storage.state_store import StateStore
from tendermint_tpu_torch.storage.wal import (WAL, NilWAL, WALCorruptionError,
                                          WALMessage)
