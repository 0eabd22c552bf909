"""Standalone WAL generator: the port's copy of `tendermint_tpu/consensus/
wal_generator.py` (consensus/wal_generator.go:31 WALWithNBlocks).

Builds a consensus WAL covering N committed heights without any
networking: a single-validator ConsensusState drives itself with a
MockTicker while writing a real CRC-framed WAL.
"""

from __future__ import annotations

import os


def wal_with_n_blocks(n_blocks: int, wal_path: str,
                      seed: bytes = b"\x17" * 32,
                      chain_id: str = "wal-gen", verifier=None):
    """Run one validator to height n_blocks writing `wal_path`; its
    signatures are checked on `verifier` (None: the port's default
    verifier, which needs a card).

    Returns (gen_doc, state, block_store) so callers can replay the WAL
    against matching stores."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.abci.types import ValidatorUpdate
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.consensus.ticker import MockTicker
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage import BlockStore, MemDB, StateStore
    from tendermint_tpu_torch.storage.wal import WAL
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    from tendermint_tpu_torch.types.keys import PrivKey
    from tendermint_tpu_torch.types.priv_validator import (LocalSigner,
                                                           PrivValidator)

    key = PrivKey.generate(seed)
    gen = GenesisDoc(chain_id=chain_id, genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    state_store = StateStore(MemDB())
    block_store = BlockStore(MemDB())
    state = state_store.load_or_genesis(gen)
    conns = AppConns(local_client_creator(KVStoreApp()))
    conns.consensus.init_chain(
        [ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen.chain_id)
    exec_ = BlockExecutor(state_store, conns.consensus, verifier=verifier)

    os.makedirs(os.path.dirname(wal_path) or ".", exist_ok=True)
    wal = WAL(wal_path)
    cs = ConsensusState(test_config().consensus, state, exec_, block_store,
                        priv_validator=PrivValidator(LocalSigner(key)),
                        wal=wal, ticker_factory=MockTicker)
    cs.start()
    for _ in range(60 * n_blocks):
        if cs.state.last_block_height >= n_blocks:
            break
        cs.ticker.fire_next()
    cs.stop()
    if cs.state.last_block_height < n_blocks:
        raise RuntimeError(
            f"WAL generator stalled at height {cs.state.last_block_height}")
    return gen, cs.state, block_store
