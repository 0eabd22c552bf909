"""Crash recovery: the port's copy of `tendermint_tpu/consensus/replay.py`
(consensus/replay.go).

Two independent mechanisms, exactly as in the reference:

(a) WAL catchup replay (:93-156): on ConsensusState start, find the
    `#ENDHEIGHT h-1` marker and re-feed every later message through the
    normal handle path (replay_mode suppresses re-broadcast/re-sign
    side effects; the priv validator's last-sign state suppresses
    double-signing).

(b) ABCI Handshake (:211-324): on node start, compare app height
    (Info) with store/state heights and replay stored blocks into the
    app — the full permutation matrix: fresh app (InitChain + replay
    all), app one behind (replay last block), app caught up but state
    behind (ApplyBlock from store), app ahead (fatal).

The local-snapshot seam of the recovery plane: a Handshaker given the
node's snapshot store and app rebuilds an app that sits below a pruned
or state-sync-bootstrapped block store's base from the newest pinned
local snapshot (storage/snapshot.restore_app_locally), then replays only
the blocks above it.
"""

from __future__ import annotations

from typing import Optional

from tendermint_tpu_torch.abci.types import ValidatorUpdate
from tendermint_tpu_torch.state.execution import (
    ABCIResponses, BlockExecutor, exec_block_on_app, update_state,
)
from tendermint_tpu_torch.state.state import State


class HandshakeError(Exception):
    pass


def wal_tail_for(wal, height: int) -> Optional[list]:
    """The WAL messages to re-feed for a node whose state is at
    `height`: everything after `#ENDHEIGHT height`. None = nothing to
    replay (fresh chain). Raises ValueError when the marker is missing
    for a height the state claims to have committed.

    Marker absent at genesis: fresh WALs write `#ENDHEIGHT 0` on
    creation, but a log recorded before that rule (or whose marker frame
    was torn away) may still hold height-1 messages — and a node at
    state-height 0 has never committed, so such a log IS height 1's
    tail. Replay it all rather than strand the validator's own signed
    votes. Guard: any `endheight > 0` marker proves the log spans
    committed heights the state has lost (e.g. a wiped state DB) — that
    inconsistency must surface, not be replayed into genesis state."""
    tail = wal.messages_after_end_height(height)
    if tail is not None:
        # marker found; but the tail itself must not span FURTHER
        # committed heights — that means the state store is behind the
        # WAL (wiped/rolled back), and replaying those heights silently
        # would double-execute them. The reference's catchupReplay
        # errors the same way ("WAL should not contain #ENDHEIGHT",
        # consensus/replay.go).
        for m in tail:
            if m.msg.get("type") == "endheight" and \
                    m.msg.get("height", 0) > height:
                raise ValueError(
                    f"WAL contains #ENDHEIGHT {m.msg['height']} past "
                    f"state height {height} (state store behind WAL?) "
                    "— refusing replay")
        return tail  # may be [] — marker found, clean shutdown
    if height != 0:
        raise ValueError(f"WAL has no #ENDHEIGHT for {height}")
    msgs = wal.all_messages()
    if not msgs:
        return None
    for m in msgs:
        if m.msg.get("type") == "endheight" and m.msg.get("height", 0) > 0:
            raise ValueError(
                "WAL spans committed heights but state is at 0 "
                "(state store wiped?) — refusing genesis replay")
    return msgs


def replay_messages(cs, tail, before_submit=None, after_submit=None) -> int:
    """Feed WAL messages through the state machine's normal handle path
    with replay-mode side effects suppressed. ONE definition shared by
    node-start catchup and the `replay[_console]` CLI so the debug tool
    can never drift from real node recovery. `before_submit(msg)` (the
    console's pause hook) may return False to stop early;
    `after_submit(msg)` is the console's progress print. Returns the
    number of messages submitted."""
    cs.replay_mode = True
    try:
        n = 0
        for m in tail:
            msg = dict(m.msg)
            peer = msg.pop("peer", "")
            if msg.get("type") in ("round_state", "endheight"):
                continue
            if before_submit is not None and before_submit(msg) is False:
                break
            cs.submit(msg, peer_id=peer)
            n += 1
            if after_submit is not None:
                after_submit(msg)
        return n
    finally:
        cs.replay_mode = False


def catchup_replay(cs, wal) -> int:
    """Replay WAL messages after ENDHEIGHT(height-1) into ConsensusState.
    Returns number of messages replayed."""
    height = cs.state.last_block_height
    tail = wal_tail_for(wal, height)
    if tail is None:
        return 0  # fresh chain, nothing to replay
    return replay_messages(cs, tail)


class Handshaker:
    def __init__(self, state_store, block_store, gen_doc, verifier=None,
                 snapshot_store=None, app=None):
        """`verifier` is the BatchVerifier the replayed final block's
        apply_block checks its commit on (None: the port's default
        verifier, which needs a card). `snapshot_store` / `app`: the
        local-snapshot seam. A pruned store (or one bootstrapped by state
        sync) no longer holds every block an in-memory app needs for
        replay; the handshake then rebuilds the app from the newest
        pinned local snapshot and replays only the blocks above it."""
        self.state_store = state_store
        self.block_store = block_store
        self.gen_doc = gen_doc
        self.verifier = verifier
        self.snapshot_store = snapshot_store
        self.app = app
        self.n_blocks = 0

    def handshake(self, app_conns) -> State:
        """consensus/replay.go:211 — sync the app with the stores; returns
        the resulting State."""
        info = app_conns.query.info()
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        state = self.state_store.load_or_genesis(self.gen_doc)
        state = self.replay_blocks(state, app_conns, app_height, app_hash)
        return state

    def replay_blocks(self, state: State, app_conns, app_height: int,
                      app_hash: bytes) -> State:
        """consensus/replay.go:243-324 case analysis."""
        store_height = self.block_store.height()
        state_height = state.last_block_height

        if app_height < 0 or app_height > store_height:
            raise HandshakeError(
                f"app height {app_height} ahead of store {store_height}; "
                "app state was not persisted with the chain")
        if store_height < state_height or \
                store_height > state_height + 1:
            raise HandshakeError(
                f"store height {store_height} inconsistent with state "
                f"height {state_height}")

        if app_height == 0:
            # fresh app: InitChain with genesis validators
            app_conns.consensus.init_chain(
                [ValidatorUpdate(v.pubkey, v.voting_power)
                 for v in state.validators.validators],
                self.gen_doc.chain_id, self.gen_doc.app_state)
            app_hash = self.gen_doc.app_hash

        if store_height == 0:
            return state

        # recovery plane: blocks below the store's base were pruned (or
        # never stored — a state-sync bootstrap). An app behind the
        # base cannot be replayed forward from blocks; rebuild it from
        # the newest pinned local snapshot, then replay only the tail.
        base = self.block_store.base() \
            if hasattr(self.block_store, "base") else 1
        if app_height + 1 < base:
            restored = None
            if self.snapshot_store is not None:
                from tendermint_tpu_torch.storage.snapshot import (
                    restore_app_locally)
                restored = restore_app_locally(
                    self.snapshot_store, self.state_store, self.app,
                    store_height)
            if restored is None or restored[0] + 1 < base:
                raise HandshakeError(
                    f"app at {app_height} needs blocks from "
                    f"{app_height + 1} but the store was pruned to base "
                    f"{base} and no usable local snapshot covers the "
                    "gap")
            app_height, app_hash = restored
            self.n_blocks += 1  # the snapshot restore counts as one step

        if store_height == state_height:
            # consensus committed + applied the block but the app may have
            # missed heights (crash before Commit): replay app-side only
            state.app_hash = self._replay_into_app(
                state, app_conns, app_height, store_height,
                mutate_state=False)
            return state

        # store_height == state_height + 1: block saved, ApplyBlock missed
        if app_height == store_height:
            # app has the block but the state doesn't: replay state update
            # from saved ABCI responses without re-executing
            resp_obj = self.state_store.load_abci_responses(store_height)
            if resp_obj is None:
                raise HandshakeError(
                    f"missing ABCI responses for height {store_height}")
            block = self.block_store.load_block(store_height)
            meta = self.block_store.load_block_meta(store_height)
            responses = ABCIResponses.from_obj(resp_obj)
            new_state = update_state(state, meta.block_id, block, responses)
            new_state.app_hash = app_hash
            self.state_store.save(new_state)
            self.n_blocks += 1
            return new_state

        # app is behind too: replay the final block fully via ApplyBlock
        self._replay_into_app(state, app_conns, app_height,
                              store_height - 1, mutate_state=False)
        block = self.block_store.load_block(store_height)
        meta = self.block_store.load_block_meta(store_height)
        block_exec = BlockExecutor(self.state_store, app_conns.consensus,
                                   verifier=self.verifier)
        new_state = block_exec.apply_block(state.copy(), meta.block_id, block)
        self.n_blocks += 1
        return new_state

    def _replay_into_app(self, state: State, app_conns, app_height: int,
                         final_height: int, mutate_state: bool) -> bytes:
        """Replay stored blocks (app_height, final_height] into the app
        only (ExecCommitBlock path, state/execution.go:368)."""
        app_hash = state.app_hash
        for h in range(app_height + 1, final_height + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise HandshakeError(f"missing stored block {h}")
            exec_block_on_app(app_conns.consensus, block)
            app_hash = app_conns.consensus.commit()
            self.n_blocks += 1
        return app_hash
