"""BlockchainReactor, fast sync on channel 0x40: the port's copy of
`tendermint_tpu/blockchain/reactor.py` (blockchain/reactor.go).

Downloads the chain from peers via the BlockPool, validates each block N
against block N+1's LastCommit, stores + applies it, and hands off to the
consensus reactor when caught up (:216-302).

The hot path: instead of one VerifyCommit per block
(blockchain/reactor.go:286 — V signatures per block, serial), the sync
loop drains a WINDOW of completed consecutive blocks, pools every
signature from every window commit into ONE BatchVerifier call (one
device dispatch), then stores/applies the verified blocks in order. With
V validators and a window of W blocks that is one batch of V*W sigs —
the flagship fast-sync throughput workload (BASELINE.json config 4).

It is a p2p `Reactor` on BLOCKCHAIN_CHANNEL; its `switch` is the p2p
Switch, or any object with `peers.get`, `broadcast_obj` and
`stop_peer_for_error` (the in-process tests' stub). A peer is any object
with `id` and `try_send_obj(channel, obj)`.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from tendermint_tpu_torch.blockchain.pool import BlockPool
from tendermint_tpu_torch.models.verifier import VerifierError, default_verifier
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.state.execution import ApplyBlockError
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.block import Block, BlockID

logger = logging.getLogger(__name__)

BLOCKCHAIN_CHANNEL = 0x40
SYNC_TICK_S = 0.05                # trySyncTicker (blockchain/reactor.go)
STATUS_UPDATE_INTERVAL_S = 10.0
SWITCH_TO_CONSENSUS_INTERVAL_S = 1.0
MAX_SYNC_RETRIES = 5              # consecutive transient sync-loop errors
#                                   tolerated before stopping LOUDLY
SYNC_RETRY_BACKOFF_S = 0.5
NO_PEER_GRACE_S = 45.0            # a node EXPECTING peers (persistent
#                                   peers configured) keeps waiting this
#                                   long through a no-peer window before
#                                   concluding it is caught up — dial +
#                                   redial cycles live inside it
REDIAL_INTERVAL_S = 5.0
MAX_REDIALS = 3
VERIFY_WINDOW = 256               # blocks batched per device dispatch
#                                   (the JAX package's value); the window
#                                   only ever drains what the pool has,
#                                   so the cap is free when fewer blocks
#                                   are downloaded


def _wait(per_block, fut):
    """A dispatched window's verdicts, the time the sync loop blocks on
    them under one `sync.wait` span."""
    with causal.span("sync.wait", per_block[0][0].header.height,
                     blocks=len(per_block)):
        return fut.result()


class BlockchainReactor(Reactor):
    def __init__(self, state, block_exec, block_store, fast_sync: bool,
                 consensus_reactor=None, verify_window: int = VERIFY_WINDOW,
                 gate=None, expect_peers: bool = False, redial=None,
                 after_apply=None):
        """`gate`: an optional threading.Event the sync loop waits on
        before requesting anything — the state-sync restore holds it
        until the stores are bootstrapped (or the restore fell back).
        `expect_peers`/`redial`: the bounded-redial discipline — a node
        with configured peers does NOT conclude "caught up" in a
        no-peer window; it redials (bounded) and keeps waiting through
        NO_PEER_GRACE_S. `after_apply(state)`: recovery-plane hook run
        after each applied block (snapshot manager)."""
        super().__init__("blockchain")
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.fast_sync = fast_sync
        self.consensus_reactor = consensus_reactor
        self.verify_window = verify_window
        self.gate = gate
        self.expect_peers = expect_peers
        self.redial = redial
        self.after_apply = after_apply
        self.pool = BlockPool(
            start_height=block_store.height() + 1,
            send_request=self._send_block_request,
            on_peer_error=self._stop_peer)
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.synced = not fast_sync
        self.sync_error: Optional[Exception] = None
        self._peer_heights: dict = {}   # served peers' reported heights
        #                                 (the pruner's catch-up floor)
        self._ph_lock = threading.Lock()
        self._redials = 0
        self._last_redial = 0.0
        self._no_peer_since: Optional[float] = None
        # one window in flight on the device while its predecessor
        # applies on the host: (per_block, result_future, valset_hash,
        # part_size) — see _sync_window. The resolver thread only waits
        # on the verifier's event and reads its pinned buffers: no
        # device work runs on it (it would run on that thread's default
        # stream, not the verifier's).
        self._pending_window = None
        self._resolver: Optional[ThreadPoolExecutor] = None

    # ------------------------------------------------------------- lifecycle

    def get_channels(self):
        return [ChannelDescriptor(BLOCKCHAIN_CHANNEL, priority=10,
                                  send_queue_capacity=1000)]

    def start(self) -> None:
        if self.fast_sync:
            self._thread = threading.Thread(
                target=self._pool_routine, daemon=True, name="tm-fastsync")
            self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        if self._resolver is not None:
            self._resolver.shutdown(wait=False)
            self._resolver = None
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
            self._thread = None

    # ----------------------------------------------------------------- peers

    def add_peer(self, peer) -> None:
        """Tell new peers our height; ask theirs (reactor.go AddPeer)."""
        peer.try_send_obj(BLOCKCHAIN_CHANNEL, {
            "type": "status_response", "height": self.block_store.height()})
        peer.try_send_obj(BLOCKCHAIN_CHANNEL, {"type": "status_request"})

    def remove_peer(self, peer, reason) -> None:
        self.pool.remove_peer(peer.id)
        with self._ph_lock:
            self._peer_heights.pop(peer.id, None)

    def min_peer_height(self) -> int:
        """Lowest chain height any connected peer last reported — the
        pruner must keep blocks above it so lagging peers can still
        catch up from us. Returns a very large value with no peers (no
        constraint)."""
        with self._ph_lock:
            if not self._peer_heights:
                return 1 << 62
            return min(self._peer_heights.values())

    def adopt_restored(self, state) -> None:
        """A state-sync restore bootstrapped the stores: adopt the
        restored state as the sync base and fast-forward the pool."""
        self.state = state
        self.pool.reset_height(state.last_block_height + 1)
        logger.info("fast-sync resuming above restored snapshot at %d",
                    state.last_block_height)

    def _stop_peer(self, peer_id: str, reason: str) -> None:
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            self.switch.stop_peer_for_error(peer, RuntimeError(reason))

    def _send_block_request(self, peer_id: str, height: int) -> bool:
        if self.switch is None:
            return False
        peer = self.switch.peers.get(peer_id)
        if peer is None:
            return False
        return peer.try_send_obj(BLOCKCHAIN_CHANNEL, {
            "type": "block_request", "height": height})

    # -------------------------------------------------------------- receive

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        msg = encoding.cloads(msg_bytes)
        t = msg.get("type")
        if t == "block_request":
            self._respond_to_block_request(peer, msg["height"])
        elif t == "block_response":
            block = Block.from_obj(msg["block"])
            if not self.pool.add_block(peer.id, block, len(msg_bytes)):
                pass  # unsolicited; ignore (reference ignores too)
        elif t == "no_block_response":
            pass
        elif t == "status_request":
            peer.try_send_obj(BLOCKCHAIN_CHANNEL, {
                "type": "status_response",
                "height": self.block_store.height()})
        elif t == "status_response":
            self.pool.set_peer_height(peer.id, msg["height"])
            with self._ph_lock:
                self._peer_heights[peer.id] = max(
                    self._peer_heights.get(peer.id, 0), msg["height"])
        else:
            self._stop_peer(peer.id, f"unknown blockchain msg {t!r}")

    def _respond_to_block_request(self, peer, height: int) -> None:
        """reactor.go:149 respondToPeer."""
        block = self.block_store.load_block(height)
        if block is None:
            peer.try_send_obj(BLOCKCHAIN_CHANNEL, {
                "type": "no_block_response", "height": height})
            return
        peer.try_send_obj(BLOCKCHAIN_CHANNEL, {
            "type": "block_response", "block": block.to_obj()})

    # ------------------------------------------------------------ sync loop

    def _pool_routine(self) -> None:
        """reactor.go:216 poolRoutine: request scheduling + SYNC_LOOP +
        periodic status broadcasts + caught-up handoff, with the failure
        discipline: transient errors retry (bounded), fatal
        store/apply divergence still stops LOUDLY, and a node expecting
        peers rides out no-peer windows with bounded redials instead of
        prematurely declaring itself caught up."""
        if self.gate is not None:
            # state sync holds the gate until the stores are
            # bootstrapped (or the restore falls back to block sync)
            while not self._stopped and not self.gate.wait(timeout=0.2):
                pass
            if self._stopped:
                return
        last_status = 0.0
        last_switch_check = 0.0
        retries = 0
        while not self._stopped and self.fast_sync:
            now = time.monotonic()
            try:
                self.pool.retry_stale_requests()
                if now - last_status > STATUS_UPDATE_INTERVAL_S:
                    self.broadcast_status_request()
                    last_status = now
                if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL_S:
                    last_switch_check = now
                    if self._may_switch(now) and self.pool.is_caught_up():
                        self._switch_to_consensus()
                        return
                if self._sync_window():
                    retries = 0
                else:
                    time.sleep(SYNC_TICK_S)
            except (ApplyBlockError, VerifierError) as e:
                # store/apply divergence is unrecoverable mid-sync (the
                # reference panics here, consensus/state.go:1214-1220),
                # and so is a device that fails a verify: stop LOUDLY
                # instead of silently retrying forever
                self.sync_error = e
                self.fast_sync = False
                raise
            except Exception as e:
                # anything else (a torn peer conn mid-window, a
                # transient store hiccup) gets a bounded retry: drop
                # the in-flight window and re-collect from the pool
                retries += 1
                self._pending_window = None
                if retries > MAX_SYNC_RETRIES:
                    self.sync_error = e
                    self.fast_sync = False
                    raise
                logger.error("fast-sync loop error; retrying (attempt %d): %r",
                             retries, e)
                time.sleep(SYNC_RETRY_BACKOFF_S * retries)

    def _may_switch(self, now: float) -> bool:
        """Gate premature consensus handoff: with peers connected the
        pool's own frontier check decides; in a no-peer window a node
        that EXPECTS peers first rides out NO_PEER_GRACE_S, redialing
        its configured peers a bounded number of times."""
        if self.pool.num_peers() > 0:
            self._no_peer_since = None
            self._redials = 0
            return True
        if not self.expect_peers:
            return True
        if self._no_peer_since is None:
            self._no_peer_since = now
        if self.redial is not None and self._redials < MAX_REDIALS and \
                now - self._last_redial > REDIAL_INTERVAL_S:
            self._redials += 1
            self._last_redial = now
            logger.info("fast-sync has no peers: redialing (attempt %d)",
                        self._redials)
            try:
                self.redial()
            except Exception as e:
                logger.error("redial failed: %r", e)
        return now - self._no_peer_since >= NO_PEER_GRACE_S

    def broadcast_status_request(self) -> None:
        if self.switch is not None:
            self.switch.broadcast_obj(BLOCKCHAIN_CHANNEL,
                                      {"type": "status_request"})

    # -------------------------------------------- batched verify + apply

    def _parts_and_id(self, block) -> tuple:
        """(part_set, block_id) — built ONCE per block; part-set
        construction (serialize + split + merkle) is the CPU cost of the
        sync hot loop."""
        parts = block.make_part_set(
            self.state.consensus_params.block_gossip.block_part_size_bytes)
        return parts, BlockID(block.hash(), parts.header())

    def _verifier(self):
        verifier = self.block_exec.verifier
        return verifier if verifier is not None else default_verifier()

    def _collect_window(self, skip: int):
        """Build (per_block, items) for the window starting `skip` blocks
        past the pool height, verified OPTIMISTICALLY against the current
        valset. Returns None when fewer than 2 consecutive blocks are
        ready there."""
        blocks = self.pool.peek_window(self.verify_window, skip=skip)
        if len(blocks) < 2:
            return None
        with causal.span("sync.collect", blocks[0].header.height,
                         blocks=len(blocks) - 1) as sp:
            out = self._collect(blocks)
            sp.note(sigs=len(out[1]))
        return out

    def _collect(self, blocks) -> tuple:
        chain_id = self.state.chain_id
        batch_valset = self.state.validators
        part_size = \
            self.state.consensus_params.block_gossip.block_part_size_bytes
        all_items = []
        per_block = []  # (block, parts, block_id, commit, power|None, lo, n)
        for i in range(len(blocks) - 1):
            block, commit = blocks[i], blocks[i + 1].last_commit
            parts, block_id = self._parts_and_id(block)
            try:
                items, item_power = batch_valset.commit_verification_items(
                    chain_id, block_id, block.header.height, commit)
            except ValueError:
                # not necessarily a bad peer: the valset may change inside
                # the window; such blocks re-verify against the updated
                # set in the apply loop
                per_block.append((block, parts, block_id, commit,
                                  None, 0, 0))
                continue
            per_block.append((block, parts, block_id, commit, item_power,
                              len(all_items), len(items)))
            all_items.extend(items)
        return per_block, all_items, batch_valset.hash(), part_size

    def _apply_window(self, per_block, ok, batch_valset_hash,
                      part_size) -> int:
        """Store + apply one verified window in order; returns how many
        blocks were applied (< len(per_block) when a bad block stopped
        the window)."""
        chain_id = self.state.chain_id
        verifier = self._verifier()
        applied = 0
        for block, parts, block_id, commit, item_power, lo, n in per_block:
            if block.header.height != self.block_store.height() + 1:
                # the window no longer lines up with the store (a
                # predecessor window was cut short): discard the rest
                return applied
            ps_now = (self.state.consensus_params
                      .block_gossip.block_part_size_bytes)
            rebuilt = False
            if ps_now != part_size:
                # consensus params changed inside the pipeline window:
                # the pre-built part set used the stale size — rebuild,
                # and DISCARD the batched results too (their
                # for-this-block flags were computed against the old
                # block_id and would zero out the counted power)
                parts, block_id = self._parts_and_id(block)
                rebuilt = True
            vs_now = self.state.validators
            try:
                if not rebuilt and item_power is not None and \
                        vs_now.hash() == batch_valset_hash:
                    vs_now.check_commit_results(ok[lo:lo + n], item_power)
                else:
                    # valset changed since collection (or collect
                    # failed): verify against the set that actually
                    # signed
                    vs_now.verify_commit(chain_id, block_id,
                                         block.header.height, commit,
                                         verifier=verifier)
            except ValueError:
                self._punish_bad_window(block.header.height)
                return applied
            # seen-commit = the commit FOR this block (= next block's
            # LastCommit), matching the reference's SaveBlock(first,
            # firstParts, second.LastCommit)
            with causal.span("sync.save", block.header.height):
                self.block_store.save_block(block, parts, commit)
            # trust_last_commit: this block's own LastCommit was already
            # batch-verified when its predecessor went through this loop.
            # (apply_block never mutates its input state — no copy.)
            self.state = self.block_exec.apply_block(
                self.state, block_id, block, trust_last_commit=True)
            self.pool.pop_request()
            applied += 1
            if self.after_apply is not None:
                # recovery plane: interval snapshots and pruning fire on
                # the sync path too (the app sits at exactly this height
                # until the next iteration applies)
                self.after_apply(self.state)
        return applied

    def _sync_window(self) -> bool:
        """PIPELINED window sync: collect window k and dispatch its ONE
        batched signature verification to the device WITHOUT blocking,
        then apply the previously-dispatched window k-1 while the device
        works — device compute and the host's store/apply path overlap
        instead of serializing.

        A window held in flight covers blocks [height+applied ...]; its
        collection valset is the one BEFORE the pending window applies.
        If an apply changes the valset, the stale batch results are
        discarded per block by the hash check in _apply_window and those
        blocks re-verify against the live set. Returns True on progress.
        """
        pending = self._pending_window
        skip = 0 if pending is None else max(0, len(pending[0]))
        collected = self._collect_window(skip)

        if collected is None:
            # nothing new to dispatch: drain the in-flight window if any
            self._pending_window = None
            if pending is not None:
                per_block, fut, vs_hash, psz = pending
                return self._apply_window(per_block, _wait(per_block, fut),
                                          vs_hash, psz) > 0
            return False

        per_block, all_items, vs_hash, psz = collected
        resolve = self._verifier().verify_async(all_items)
        # snapshot: stop() nulls self._resolver from another thread; and
        # never (re)create the executor once stopped
        resolver = self._resolver
        if resolver is None:
            if self._stopped:
                return False
            resolver = self._resolver = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tm-fastsync-resolve")
        try:
            fut = resolver.submit(resolve)
        except RuntimeError:  # shutdown raced the submit
            return False
        self._pending_window = (per_block, fut, vs_hash, psz)
        progress = False
        if pending is not None:
            prev_blocks, prev_fut, prev_hash, prev_psz = pending
            applied = self._apply_window(prev_blocks,
                                         _wait(prev_blocks, prev_fut),
                                         prev_hash, prev_psz)
            progress = applied > 0
            if applied < len(prev_blocks):
                # the window was cut short (bad block -> punish + redo):
                # the in-flight successor sits past a gap of re-requested
                # heights and may hold blocks from the punished peer —
                # drop it and re-collect once the pool recovers
                self._pending_window = None
        return progress or self._pending_window is not None

    def _punish_bad_window(self, height: int) -> None:
        for peer_id in self.pool.redo_request(height):
            self._stop_peer(peer_id, f"bad block/commit at height {height}")

    # ----------------------------------------------------------- handoff

    def _switch_to_consensus(self) -> None:
        """reactor.go:263 SwitchToConsensus."""
        self.fast_sync = False
        self.synced = True
        if self.consensus_reactor is not None:
            self.consensus_reactor.switch_to_consensus(self.state)
