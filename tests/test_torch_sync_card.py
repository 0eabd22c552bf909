"""A fast sync through the port alone, as chip_smoke.py's sync phase drives
it at 64 validators and 5,000-tx blocks on the card.

The port's ChainBuilder builds and signs a chain (sign_batch_async, the
r*B kernel on the card); a fresh node receives every block by its wire
bytes (Block.from_bytes) from an instant in-process peer and syncs it
through BlockchainReactor._sync_window: one verify_async a window, the
previous window applied while the next one verifies. The synced state,
every stored block and seen commit must equal the chain builder's. On
the CPU at 4 validators; the test marked `cuda` runs 64 validators over
two windows on the card, where it needs no jax:
`python -m pytest --noconftest -m cuda tests/test_torch_sync_card.py`.
"""

import pytest
import torch

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.abci.types import ValidatorUpdate
from tendermint_tpu_torch.blockchain import BlockchainReactor
from tendermint_tpu_torch.blockchain.builder import ChainBuilder
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage import BlockStore, MemDB, StateStore
from tendermint_tpu_torch.types.block import Block

torch.set_num_threads(1)


def sync_chain(n_vals, n_txs, n_blocks, window, device, verifier):
    """Build n_blocks and a sentinel, sync them; returns the cache routes
    of each window's dispatch."""
    b = ChainBuilder(n_vals, n_txs, device=device)
    blocks = b.build(n_blocks)
    final = b.state
    blocks += b.build(1)
    wire = [Block.from_bytes(x.to_bytes()) for x in blocks]

    ss, bs = StateStore(MemDB()), BlockStore(MemDB())
    state = ss.load_or_genesis(b.gen)
    conns = AppConns(local_client_creator(KVStoreApp()))
    conns.consensus.init_chain(
        [ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], b.gen.chain_id)
    exe = BlockExecutor(ss, conns.consensus, verifier=verifier)
    r = BlockchainReactor(state, exe, bs, fast_sync=True,
                          verify_window=window)

    def send_request(peer_id, height):
        r.pool.add_block(peer_id, wire[height - 1], 1)
        return True

    r.pool.send_request = send_request
    r.pool.max_pending_per_peer = 1 << 20
    r.pool.set_peer_height("peer", len(wire))
    r.pool.make_next_requests()
    routes = []
    try:
        while r.state.last_block_height < n_blocks:
            before = ted.predecomp_stats()
            progress = r._sync_window()
            after = ted.predecomp_stats()
            routes.append({k: after[k] - before[k]
                           for k in ("full", "fill", "hit")})
            if not progress:
                r.pool.make_next_requests()
    finally:
        r.stop()
    assert r._resolver is None
    assert r.state.equals(final) and ss.load().equals(final)
    assert bs.height() == n_blocks
    for h in range(1, n_blocks + 1):
        assert bs.load_block_meta(h).block_id.hash == blocks[h - 1].hash()
        assert bs.load_block(h).to_bytes() == blocks[h - 1].to_bytes()
        assert bs.load_seen_commit(h).to_bytes() == \
            blocks[h].last_commit.to_bytes()
    return routes


def test_sync_on_cpu():
    sync_chain(4, 10, 3, 2, "cpu", tverifier.BatchVerifier("python"))


@pytest.mark.cuda
def test_cuda_two_window_sync_routes_and_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    with ted._predecomp_lock:       # a cold cache: full, then fill
        ted._predecomp.clear()
        ted._predecomp_seen.clear()
    before = dict(ladder.launches)
    routes = sync_chain(64, 200, 32, 16, "cuda",
                        tverifier.BatchVerifier("auto"))
    after = ladder.launches
    dispatched = [rt for rt in routes if any(rt.values())]
    assert dispatched == [{"full": 1, "fill": 0, "hit": 0},
                          {"full": 0, "fill": 1, "hit": 0}]
    assert after["sign_rb"] - before["sign_rb"] == 33
    assert after["verify"] - before["verify"] == 1
    assert after["verify_pre"] - before["verify_pre"] == 1
