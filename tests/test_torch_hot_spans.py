"""The causal plane's spans inside the hot path: the verifier's stages,
the fast-sync window engine and the vote set.

With the plane on, a batch verify on the key-cache route records one
`verify.prep`, `verify.rows`, `verify.upload`, `verify.launch`,
`verify.wait` and `verify.dispatch` a chunk or call; a fast sync records
`sync.collect` and `sync.wait` once a window and `sync.save` and
`block.decode` once a block; one `HeightVoteSet.add_votes` records one
`votes.check` and one `votes.count`. Every span starts on
`utils/clock.wall_ns`, the clock a device trace's events share. With the
plane off, the same calls record nothing.

The test marked `cuda` measures that shared clock on the card: each
`verify.launch` starts at most 1 ms before torch.profiler's verify kernel
of that launch. It needs no jax:
`python -m pytest --noconftest -m cuda -s tests/test_torch_hot_spans.py`.
"""

import dataclasses
import hashlib

import pytest
import torch

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.abci.types import ValidatorUpdate
from tendermint_tpu_torch.blockchain import BlockchainReactor
from tendermint_tpu_torch.blockchain.builder import ChainBuilder
from tendermint_tpu_torch.consensus.rstate import HeightVoteSet
from tendermint_tpu_torch.models.verifier import BatchVerifier
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage import BlockStore, MemDB, StateStore
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.types.block import Block, BlockID, PartSetHeader
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote, VoteType
from tendermint_tpu_torch.utils import clock

torch.set_num_threads(1)

PIN_NS = 1_700_000_000_123_456_789
VERIFY_SPANS = ("verify.prep", "verify.rows", "verify.upload",
                "verify.launch", "verify.wait", "verify.dispatch")


@pytest.fixture
def plane(monkeypatch):
    """The causal plane on and empty, its wall clock pinned; off, empty
    and unpinned again after."""
    monkeypatch.delenv("TM_CUDA_TRACE", raising=False)
    causal.configure("on")
    causal.clear()
    clock.set_wall_source(lambda: PIN_NS)
    try:
        yield
    finally:
        clock.set_wall_source(None)
        causal.configure("off")
        causal.clear()


@pytest.fixture
def plane_off(monkeypatch):
    monkeypatch.delenv("TM_CUDA_TRACE", raising=False)
    causal.configure("off")
    causal.clear()
    yield
    causal.clear()


def _spans(name=None):
    return [e for e in causal.dump()["spans"]
            if name is None or e["n"] == name]


def _items(n, tag=b"hot"):
    out = []
    for i in range(n):
        k = PrivKey.generate(hashlib.sha256(tag + b"/%d" % i).digest())
        msg = b"precommit %d" % i
        out.append((k.pubkey.ed25519, msg, k.sign(msg)))
    return out


def _warm(v, items):
    """Verify `items` until the key cache holds their rows (full ->
    fill): the next verify of them takes the hit route."""
    for _ in range(2):
        v.verify(items)


def test_verifier_records_each_stage_once_on_the_wall_clock(plane):
    v = BatchVerifier("cuda", device="cpu", coalesce="off")
    items = _items(64)
    items[5] = (items[5][0], items[5][1], items[6][2])
    _warm(v, items)
    causal.clear()
    out = v.verify(items)
    assert list(out) == [i != 5 for i in range(64)]
    spans = _spans()
    assert sorted(e["n"] for e in spans) == sorted(VERIFY_SPANS)
    for e in spans:
        assert e["t"] == PIN_NS, e          # the pinned source came back
        assert e["h"] == -1 and e["a"]["n"] == 64, e
        assert e["d"] >= 0
    by = {e["n"]: e["a"] for e in spans}
    assert by["verify.rows"]["outcome"] == "hit"
    assert by["verify.launch"]["kernel"] == "verify_pre"
    # five host arrays a chunk: the two key rows, ok, R, s and h
    assert by["verify.upload"]["bytes"] == 64 * (32 * 5 + 1)


def _chain(n_blocks):
    b = ChainBuilder(4, 10, device="cpu")
    blocks = b.build(n_blocks) + b.build(1)
    return b, [x.to_bytes() for x in blocks]


def _fast_sync(b, raw, n_blocks, window):
    """Decode the chain's wire bytes and fast-sync them from an instant
    peer through _sync_window; returns the synced state's height."""
    wire = [Block.from_bytes(x) for x in raw]
    ss, bs = StateStore(MemDB()), BlockStore(MemDB())
    state = ss.load_or_genesis(b.gen)
    conns = AppConns(local_client_creator(KVStoreApp()))
    conns.consensus.init_chain(
        [ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], b.gen.chain_id)
    exe = BlockExecutor(ss, conns.consensus,
                        verifier=BatchVerifier("python"))
    r = BlockchainReactor(state, exe, bs, fast_sync=True,
                          verify_window=window)

    def send_request(peer_id, height):
        r.pool.add_block(peer_id, wire[height - 1], 1)
        return True

    r.pool.send_request = send_request
    r.pool.max_pending_per_peer = 1 << 20
    r.pool.set_peer_height("peer", len(wire))
    r.pool.make_next_requests()
    try:
        while r.state.last_block_height < n_blocks:
            if not r._sync_window():
                r.pool.make_next_requests()
    finally:
        r.stop()
    return r.state.last_block_height


def test_fast_sync_records_windows_and_blocks(plane_off):
    n = 5
    b, raw = _chain(n)
    causal.configure("on")
    causal.clear()
    clock.set_wall_source(lambda: PIN_NS)
    try:
        assert _fast_sync(b, raw, n, window=2) == n
        spans = _spans()
    finally:
        clock.set_wall_source(None)
        causal.configure("off")
    assert all(e["t"] == PIN_NS for e in spans)
    dec = [e for e in spans if e["n"] == "block.decode"]
    assert [e["h"] for e in dec] == list(range(1, n + 2))
    assert [e["a"]["bytes"] for e in dec] == [len(x) for x in raw]
    assert [e["h"] for e in spans if e["n"] == "sync.save"] == \
        list(range(1, n + 1))
    assert [e["h"] for e in spans if e["n"] == "apply"] == \
        list(range(1, n + 1))
    collect = [e for e in spans if e["n"] == "sync.collect"]
    wait = [e for e in spans if e["n"] == "sync.wait"]
    # a window of 2 blocks: each collected window is waited on once
    assert len(collect) == len(wait) >= 3
    assert [(e["h"], e["a"]["blocks"]) for e in collect] == \
        [(e["h"], e["a"]["blocks"]) for e in wait]
    assert sum(e["a"]["blocks"] for e in collect) == n
    assert all(e["a"]["sigs"] == 4 * e["a"]["blocks"] for e in collect)


def _votes(n, height, round_, type_):
    keys = [PrivKey.generate(hashlib.sha256(b"vote/%d" % i).digest())
            for i in range(n)]
    by_pk = {k.pubkey.ed25519: k for k in keys}
    vs = ValidatorSet([Validator(k.pubkey.ed25519, 10) for k in keys])
    bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
    votes = []
    for i, val in enumerate(vs.validators):
        v = Vote(val.address, i, height, round_, 1_000 + i, type_, bid)
        sig = by_pk[val.pubkey].sign(v.sign_bytes("hot-chain"))
        votes.append(dataclasses.replace(v, signature=sig))
    return vs, votes


def test_add_votes_records_one_check_and_one_count(plane):
    vs, votes = _votes(6, 7, 2, VoteType.PREVOTE)
    hvs = HeightVoteSet("hot-chain", 7, vs,
                        verifier=BatchVerifier("python"))
    results, errors = hvs.add_votes(2, VoteType.PREVOTE, votes)
    assert results == [True] * 6 and errors == []
    check, count = _spans("votes.check"), _spans("votes.count")
    assert len(check) == len(count) == 1
    assert (check[0]["h"], check[0]["r"], check[0]["a"]) == \
        (7, 2, {"n": 6, "type": VoteType.PREVOTE})
    assert (count[0]["h"], count[0]["r"], count[0]["a"]) == (7, 2, {"n": 6})
    assert check[0]["t"] == count[0]["t"] == PIN_NS


def test_plane_off_leaves_the_ring_empty(plane_off):
    v = BatchVerifier("cuda", device="cpu", coalesce="off")
    items = _items(64)
    _warm(v, items)
    assert all(v.verify(items))
    n = 3
    b, raw = _chain(n)
    assert _fast_sync(b, raw, n, window=2) == n
    vs, votes = _votes(4, 3, 0, VoteType.PRECOMMIT)
    HeightVoteSet("hot-chain", 3, vs, verifier=v).add_votes(
        0, VoteType.PRECOMMIT, votes)
    assert causal.dump()["spans"] == []


def _profiled_launches(v, items, reps):
    """(verify.launch starts, verify kernels' starts) in ns over `reps`
    resolved verify calls under torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            v.verify(items)
        torch.cuda.synchronize()
    kernels = sorted(e.start_ns()
                     for e in prof.profiler.kineto_results.events()
                     if "CUDA" in str(e.device_type())
                     and "ladder_kernel" in e.name())
    launches = sorted(e["t"] for e in _spans("verify.launch"))
    return launches, kernels


@pytest.mark.cuda
def test_cuda_launch_span_starts_within_1ms_before_its_kernel(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    monkeypatch.delenv("TM_CUDA_TRACE", raising=False)
    v = BatchVerifier("cuda", coalesce="off")
    items = _items(256, b"card")
    causal.configure("off")
    _warm(v, items)
    v.verify(items)
    causal.configure("on")
    causal.clear()
    try:
        launches, kernels = _profiled_launches(v, items, reps=20)
    finally:
        causal.configure("off")
        causal.clear()
    assert len(launches) == len(kernels) == 20
    offsets_us = [(k - t) / 1e3 for t, k in zip(launches, kernels)]
    print("verify.launch -> kernel start, us:",
          ", ".join(f"{x:.1f}" for x in offsets_us))
    assert all(0 <= x <= 1000 for x in offsets_us), offsets_us
