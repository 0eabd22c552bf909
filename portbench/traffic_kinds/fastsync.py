"""Traffic kind `fastsync`: fresh nodes fast-sync a chain, one after
another, through the program's window engine.

Set-up makes the chain of `blocks` blocks of `txs` txs (and a sentinel
block that carries the last commit) from the seed (`portbench/gen/
chain.py`) and warms up: one node syncs the first `warm_blocks` blocks,
so that the key cache goes full -> fill -> hit and the verify windows
take the shapes of the window's (a full window of `verify_window - 1`
commits, then one as short as the chain's last). In the window, a node is what a joining node builds: block
and state stores on SQLite in a home of its own under the run's TMPDIR,
the kvstore app on the local client after InitChain, a BlockExecutor on
the verifier a node builds, and a BlockchainReactor at the
configuration's verify window. Its peer is in the process and answers a
request at once (message delay 0) with the block's bytes, which the node
decodes (`Block.from_bytes`). The harness calls `_sync_window` in a loop
with `pool.make_next_requests()` between calls, as the reactor's own
routine does. At the top of the chain the next fresh node starts.

`blocks_per_s` counts the blocks that the nodes applied inside the
window (the reactor's `after_apply` hook stamps each), over the window's
seconds. The window holds whole node syncs: no node starts after
`seconds`, and the window closes when the last node started has reached
the top. A node applies nothing for its first seconds (it decodes the
blocks its peer sends and verifies its first window before it applies
one), so a window cut at a fixed time would count whole steps of 512
blocks and miss a change of speed smaller than that step; a window of
whole syncs counts every change. It lasts `seconds` plus at most one
node's sync (10.6 s for 512 blocks of 5,000 txs, on an H100 80GB HBM3
at 700 W). After the window every node's state is held against the
chain's (height, last block id, app hash, results hash, validators,
total txs) and, once its stores are closed and opened again from its
home, the state and the blocks and seen commits that reached the disk
against the chain's; then, for each range of `forge_at`, a fresh node syncs a copy
of the chain in which one block of the range (drawn from the seed)
carries a changed signature byte in its last commit, and must halt below
it and stop the peer: the ranges put one forgery in each half of the
first verify window, so that a verify that skips either half shows. Each node's home
is removed after it is checked.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import time
from types import SimpleNamespace

from portbench.frozen import tmhash
from portbench.gen.chain import Chain
from portbench.reference import ed25519 as ref
from portbench.traffic_kinds import common

SPANS = [("verifier", "verify_async", "dispatch", True),
         ("ops.ed25519", "prep_items", "prep", False),
         ("ops.ed25519", "_predecomp_rows", "rows", False),
         ("ops.ed25519", "_upload", "upload", False),
         ("blockchain.reactor.BlockchainReactor", "_collect_window",
          "collect", False),
         ("state.execution.BlockExecutor", "apply_block", "apply", False),
         ("storage.BlockStore", "save_block", "save", False),
         ("types.block.Block", "from_bytes", "decode", False)]




class _Switch:
    """The switch members the reactor calls; records the stopped peers."""

    def __init__(self, reactor):
        self.reactor, self.stopped, self.peers = reactor, [], {}

    def broadcast_obj(self, ch, obj) -> None:
        pass

    def stop_peer_for_error(self, peer, err) -> None:
        self.stopped.append((peer.id, str(err)))
        self.peers.pop(peer.id, None)
        self.reactor.remove_peer(peer, err)


def _node(ctx, wire: list, stamps: list | None):
    """A fresh node whose one peer serves `wire`; `stamps` gets the
    perf_counter time of each applied block."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.abci.types import ValidatorUpdate
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage import BlockStore, StateStore, open_db
    from tendermint_tpu_torch.types.block import Block
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    chain = ctx.state["chain"]
    home = tempfile.mkdtemp(prefix="portbench-node-")
    gen = GenesisDoc(chain_id=chain.chain_id,
                     genesis_time_ns=chain.genesis_time_ns,
                     validators=[GenesisValidator(pk, p)
                                 for pk, p in chain.vals])
    ss = StateStore(open_db(os.path.join(home, "state.db")))
    bs = BlockStore(open_db(os.path.join(home, "blockstore.db")))
    state = ss.load_or_genesis(gen)
    conns = AppConns(local_client_creator(KVStoreApp()))
    conns.consensus.init_chain(
        [ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen.chain_id)
    exe = BlockExecutor(ss, conns.consensus, verifier=ctx.state["verifier"])
    after = (lambda st: stamps.append(time.perf_counter())) \
        if stamps is not None else None
    reactor = BlockchainReactor(state, exe, bs, fast_sync=True,
                                verify_window=ctx.config["verify_window"],
                                after_apply=after)
    sw = reactor.switch = _Switch(reactor)
    sw.peers["peer"] = SimpleNamespace(id="peer")
    pool = reactor.pool

    def send_request(peer_id, height):
        if peer_id not in sw.peers:
            return False
        pool.add_block(peer_id, Block.from_bytes(wire[height - 1]), 1)
        return True

    pool.send_request = send_request
    pool.max_pending_per_peer = 1 << 20
    pool.set_peer_height("peer", len(wire))
    return SimpleNamespace(home=home, reactor=reactor, ss=ss, bs=bs,
                           switch=sw, final=None)


def _sync(node, top: int) -> None:
    """_sync_window in a loop until the node applied `top` blocks or
    nothing moves twice running."""
    r = node.reactor
    r.pool.make_next_requests()
    idle = 0
    while r.state.last_block_height < top and idle < 2:
        if r._sync_window():
            idle = 0
        else:
            idle += 1
            r.pool.make_next_requests()


def _fields(st, stored: int) -> dict:
    """What the check compares of a node's state, with its store's top."""
    return {"height": st.last_block_height,
            "block_id": (st.last_block_id.hash, st.last_block_id.parts.total,
                         st.last_block_id.parts.hash),
            "app_hash": st.app_hash, "results_hash": st.last_results_hash,
            "validators_hash": st.validators.hash(),
            "total_txs": st.last_block_total_tx,
            "stored": stored}


def _summary(node) -> dict:
    return _fields(node.reactor.state, node.bs.height())


def _close(node) -> None:
    node.reactor.stop()
    for store in (node.ss, node.bs):
        store.db.close()


def setup(ctx) -> None:
    t = ctx.traffic
    chain = Chain(ctx.config, ctx.seed, t["blocks"], t["txs"])
    ctx.state["chain"] = chain
    ctx.mark("inputs")
    ctx.state["verifier"] = common.node_verifier(ctx)
    ctx.mark("verifier")
    warm = _node(ctx, chain.wire[:t["warm_blocks"] + 1], None)
    _sync(warm, t["warm_blocks"])
    _close(warm)
    shutil.rmtree(warm.home, ignore_errors=True)
    ctx.mark("warm-up")


def window(ctx, seconds: float) -> None:
    """Fresh nodes sync the chain one after another; the window closes
    when the first node to finish at or after `seconds` has finished,
    so that it holds whole node syncs (see the module's docstring)."""
    chain = ctx.state["chain"]
    stamps: list = []
    nodes = []
    before = common.counters()
    t0 = time.perf_counter()
    failed = 0
    while time.perf_counter() - t0 < seconds:
        node = _node(ctx, chain.wire, stamps)
        nodes.append(node)
        try:
            _sync(node, chain.blocks)
        except Exception as e:          # a sync that raises is a failure
            node.error = repr(e)
            failed += 1
            break
        finally:
            node.final = _summary(node)
            node.reactor.stop()
        if node.final["height"] < chain.blocks:
            break                        # stuck: the check says why
    t_end = time.perf_counter()
    after = common.counters()
    applied = sum(n.final["height"] for n in nodes)
    ctx.state["nodes"] = nodes
    ctx.state["window_s"] = t_end - t0
    ctx.window_stats.update({
        "blocks_per_s": len(stamps) / (t_end - t0),
        "attempted": applied, "failed": failed,
        "sigs_dispatched": applied * len(chain.vals), "new_keys": 0,
        **common.delta(before, after)})


def release(ctx) -> None:
    ctx.state.pop("verifier", None)


def _check_node(chain, node, heights, commits) -> tuple:
    """(state fields off the chain's, in the node's final state and in
    the state its store holds; stored block ids off at every height,
    seen commits off at `commits`, whole blocks off at `heights`). The
    node's stores are closed first and read back from its home: what is
    compared is what reached the disk."""
    from tendermint_tpu_torch.storage import BlockStore, StateStore, open_db
    _close(node)
    ss = StateStore(open_db(os.path.join(node.home, "state.db")))
    bs = BlockStore(open_db(os.path.join(node.home, "blockstore.db")))
    try:
        f = node.final
        h = f["height"]
        want = {"height": h, "stored": h,
                "block_id": chain.block_id.get(h, tmhash.ZERO_BLOCK_ID),
                "app_hash": chain.app_hash.get(h, b""),
                "results_hash": chain.results_hash.get(h, b""),
                "validators_hash": chain.valset_hash,
                "total_txs": chain.total_txs.get(h, 0)}
        saved = ss.load()
        disk = _fields(saved, bs.height()) if saved is not None else {}
        state_off = sum(1 for k in want if f[k] != want[k]) \
            + sum(1 for k in want if disk.get(k) != want[k])
        store_off = 0
        for k in range(1, h + 1):
            meta = bs.load_block_meta(k)
            bid = chain.block_id[k]
            if meta is None or (meta.block_id.hash, meta.block_id.parts.total,
                                meta.block_id.parts.hash) != bid:
                store_off += 1
        for k in commits:
            if k > h:
                continue
            seen = bs.load_seen_commit(k)
            if seen is None or seen.to_bytes() != chain.seen_commit[k]:
                store_off += 1
        for k in heights:
            blk = bs.load_block(k) if k <= h else None
            if k <= h and (blk is None or blk.to_bytes() != chain.wire[k - 1]):
                store_off += 1
    finally:
        ss.db.close()
        bs.db.close()
    return state_off, store_off


def _forged_wire(chain, at: int, r: random.Random) -> list:
    obj = json.loads(chain.wire[at - 1])
    pc = obj["last_commit"]["precommits"][r.randrange(len(chain.vals))]
    sig = bytearray.fromhex(pc["signature"])
    sig[r.randrange(64)] ^= 1 + r.randrange(255)
    pc["signature"] = sig.hex()
    wire = list(chain.wire)
    wire[at - 1] = tmhash.cdumps(obj)
    return wire


def check(ctx) -> list:
    chain = ctx.state["chain"]
    nodes = ctx.state["nodes"]
    r = random.Random(repr((ctx.seed, "check")))
    state_off = store_off = 0
    for node in nodes:
        heights = [r.randrange(1, chain.blocks + 1) for _ in range(4)]
        commits = {1, chain.blocks} | {r.randrange(1, chain.blocks + 1)
                                       for _ in range(62)}
        a, b = _check_node(chain, node, heights, sorted(commits))
        state_off += a
        store_off += b
        shutil.rmtree(node.home, ignore_errors=True)
    unfinished = sum(1 for n in nodes if n.final["height"] != chain.blocks)
    # forged side chains: in each, block `at` carries a changed signature
    # in its last commit; a fresh node must halt below it and stop the
    # peer. One forgery lies in each half of the first verify window.
    ctx.state["verifier"] = common.node_verifier(ctx)
    forged = []
    halt_off = 0
    for lo, hi in ctx.traffic["forge_at"]:
        at = r.randrange(lo, hi + 1)
        node = _node(ctx, _forged_wire(chain, at, r), None)
        try:
            _sync(node, chain.blocks)
        finally:
            node.reactor.stop()
        halted = node.reactor.state.last_block_height
        stopped = [p for p, _ in node.switch.stopped]
        _close(node)
        shutil.rmtree(node.home, ignore_errors=True)
        forged.append((at, halted, stopped))
        halt_off += abs(halted - (at - 2)) + (stopped != ["peer"])
    # the commits' signatures are OpenSSL's: a sample against the reference
    sample_off = 0
    for k in sorted({r.randrange(1, chain.blocks + 1) for _ in range(8)}):
        c = json.loads(chain.seen_commit[k])
        v = c["precommits"][r.randrange(len(chain.vals))]
        pk = chain.vals[v["validator_index"]][0]
        bid = chain.block_id[k]
        msg = tmhash.vote_sign_bytes(chain.chain_id, bid, k, 0,
                                     v["timestamp_ns"], v["type"])
        if not ref.verify(pk, msg, bytes.fromhex(v["signature"])):
            sample_off += 1
    ctx.state["forged"] = forged
    return [("node_state_fields_off", state_off, 0),
            ("stored_blocks_or_commits_off", store_off, 0),
            ("nodes_stopped_below_top", unfinished, 0),
            ("forged_commit_halts_off", halt_off, 0),
            ("sampled_signatures_off_reference", sample_off, 0)]


def report(ctx) -> list:
    nodes = ctx.state["nodes"]
    return [f"fastsync: a window of {ctx.state['window_s']:.3f} s, "
            f"{len(nodes)} nodes, heights "
            f"{[n.final['height'] for n in nodes]}, "
            f"{ctx.window_stats['failed']} failed; forged side chains "
            f"(block, halted at, peers stopped): {ctx.state['forged']}"]
