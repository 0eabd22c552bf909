"""A snapshot restore through the port alone, as chip_smoke.py's recovery
phase drives it on the card.

The port's ChainBuilder builds and signs a chain (the r*B kernel on the
card), each block saved with its commit; a snapshot is taken from the
builder's app at a height, and apply_restore installs it into fresh
stores and a fresh app: the light verify of the snapshot's commit goes
through the given BatchVerifier. The restored State, app hash, the
bootstrapped store's base and the pin must be the builder's. On the CPU
at 4 validators; the test marked `cuda` restores a 64-validator
snapshot from a cold predecompression cache on the card (B1), where it
needs no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_statesync_card.py`.
"""

import pytest
import torch

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.blockchain.builder import ChainBuilder
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.statesync import apply_restore
from tendermint_tpu_torch.storage import (BlockStore, MemDB, SnapshotStore,
                                          StateStore)
from tendermint_tpu_torch.storage.snapshot import build_payload
from tendermint_tpu_torch.types import encoding

torch.set_num_threads(1)


def restore_chain(tmp_path, n_vals, n_txs, snap_at, device, verifier):
    b = ChainBuilder(n_vals, n_txs, device=device)
    src = SnapshotStore(str(tmp_path / "src"))
    bs = BlockStore(MemDB())
    for h in range(1, snap_at + 1):
        block = b.build(1)[0]
        bs.save_block(block, block.make_part_set(b.part_size), b.last_commit)
    manifest = src.take(snap_at, build_payload(
        b.state, b.last_commit, b.app.snapshot_items()), chunk_size=4096)
    fresh_bs, fresh_ss = BlockStore(MemDB()), StateStore(MemDB())
    fresh_ss.load_or_genesis(b.gen)
    app = KVStoreApp()
    local = SnapshotStore(str(tmp_path / "local"))
    state = apply_restore(src, manifest, fresh_bs, fresh_ss, local, app,
                          b.gen.chain_id, verifier=verifier)
    assert encoding.cdumps(state.to_obj()) == \
        encoding.cdumps(b.state.to_obj())
    assert fresh_ss.load().equals(b.state)
    assert app.app_hash == b.state.app_hash and app.height == snap_at
    assert fresh_bs.height() == snap_at and fresh_bs.base() == snap_at + 1
    assert fresh_bs.load_seen_commit(snap_at).to_bytes() == \
        bs.load_seen_commit(snap_at).to_bytes()
    assert fresh_ss.load_snapshot_pin(snap_at) == manifest
    assert local.list_heights() == [snap_at] and src.list_heights() == []
    return manifest


def test_restore_on_cpu(tmp_path):
    m = restore_chain(tmp_path, 4, 20, 5, "cpu",
                      tverifier.BatchVerifier("python"))
    assert len(m["chunks"]) > 1


@pytest.mark.cuda
def test_cuda_restore_verifies_on_b1(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    with ted._predecomp_lock:       # a cold cache: the full route, B1
        ted._predecomp.clear()
        ted._predecomp_seen.clear()
    before = dict(ladder.launches)
    verifier = tverifier.BatchVerifier("cuda")
    try:
        restore_chain(tmp_path, 64, 200, 6, "cuda", verifier)
    finally:
        verifier.close()
    after = ladder.launches
    assert after["sign_rb"] - before["sign_rb"] == 6
    assert after["verify"] - before["verify"] >= 1
