"""ConsensusReactor — gossips the BFT state machine over p2p: the port's
copy of `tendermint_tpu/consensus/reactor.py` (consensus/reactor.go).

Four channels: STATE (round-step + has-vote + maj23 announcements), DATA
(proposals + block parts), VOTE, and VOTE_SET_BITS (:24-27). Each peer
gets a PeerState mirror (:828) plus two gossip routines — data and votes
(:137-156) — that push whatever the peer provably lacks; vote/part
bitmaps in the PeerState prevent re-sending. On the thread plane each
routine is a thread; when the switch runs on a ReactorLoop each is one
of the loop's tasks running the same pass body, woken by the same
_GossipWake edges and by its connection's drain, with the same 100 ms
idle backstop.

Unlike the reference's goroutine/channel fabric, the state machine itself
is the deterministic submit()-loop in ConsensusState; this reactor is
pure I/O around it: peer messages feed cs.submit(), and the gossip
threads read RoundState snapshots under the state machine's lock.

Compact block relay and vote aggregation follow the ConsensusState's
config (`compact`, `vote_agg`) under TM_CUDA_COMPACT / TM_CUDA_VOTE_AGG
(`compact.compact_on` / `voteagg_on`). With the causal plane on, outgoing
state, data and vote envelopes carry the trace stamp (`causal.stamp`)
and `receive` takes it off first (`causal.take`), as in the JAX reactor;
off, the envelopes are untouched.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Optional

from tendermint_tpu_torch.consensus import compact
from tendermint_tpu_torch.consensus.replay import catchup_replay
from tendermint_tpu_torch.models.verifier import default_verifier
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.block import Block, BlockID
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.proposal import Heartbeat
from tendermint_tpu_torch.types.vote import VoteType

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

GOSSIP_SLEEP_S = 0.1
# ^ idle BACKSTOP for the event-driven gossip loops (configurable via
# gossip_sleep_s / peer_gossip_sleep_ms): matches the reference's
# peerGossipSleepDuration (config.go:445, 100 ms). The per-peer wake
# Event makes the common case latency-free; the backstop catches any
# missed edge.


class _GossipWake(threading.Event):
    """A threading.Event that also calls its listeners on set(): the loop
    plane's gossip tasks park on the loop, not on the event, so a wake
    reaches them through their thread-safe ``Task.wake``."""

    def __init__(self):
        super().__init__()
        self.listeners: list = []

    def set(self) -> None:
        super().set()
        for cb in list(self.listeners):
            cb()


class PeerRoundState:
    """What we know the peer knows (consensus/reactor.go:828 PeerState)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.height = 0
        self.round = -1
        self.step = 0
        self.proposal = False
        self.proposal_parts_total = 0
        self.proposal_parts: set = set()      # part indices the peer has
        self.proposal_pol_round = -1
        self.last_commit_round = -1
        # compact-plane capabilities the peer advertised at handshake
        # (NodeInfo.other): (supports compact relay, supports vote agg).
        # Set once in add_peer; senders gate the new wire shapes on it,
        # so a legacy peer only ever sees legacy messages.
        self.caps = (False, False)
        # (height, round, type) -> set of validator indices known to peer
        self.votes_known: Dict[tuple, set] = {}
        # wake signal for this peer's gossip threads: set whenever our
        # own state gains something sendable OR the peer's state
        # changes; the gossip loops park on it instead of polling. On the
        # loop plane the same signal wakes the cooperative tasks.
        self.wake = _GossipWake()

    def apply_new_round_step(self, msg: dict) -> None:
        with self.lock:
            prev_height, prev_round = self.height, self.round
            self.height = msg["height"]
            self.round = msg["round"]
            self.step = msg["step"]
            self.last_commit_round = msg.get("last_commit_round", -1)
            if self.height != prev_height or self.round != prev_round:
                self.proposal = False
                self.proposal_parts = set()
                self.proposal_parts_total = 0
                self.proposal_pol_round = -1
            if self.height != prev_height:
                # drop ALL vote knowledge on a height change (the
                # reference re-allocates fresh bitmaps in
                # ApplyNewRoundStepMessage). Keeping marks for the new
                # height wedged rejoining nodes: while a peer
                # fast-syncs, its consensus reactor DROPS every gossiped
                # vote, but our send path had already marked them known
                # — once the peer announced the snapshot/sync frontier
                # height, the commit votes it needed were never resent
                # and it sat in PREVOTE forever. Starting from zero
                # costs at most one duplicate commit's worth of votes
                # (VoteSet dedups); the peer's own has_vote
                # announcements rebuild the map immediately.
                self.votes_known = {}
        # set AFTER the state write: a waiter that consumed the wake
        # and re-scanned before the write would otherwise see stale
        # state and park through the whole idle backstop
        self.wake.set()

    def set_has_vote(self, height: int, round_: int, type_: int,
                     index: int) -> None:
        with self.lock:
            self.votes_known.setdefault((height, round_, type_),
                                        set()).add(index)

    def forget_height(self, height: int) -> None:
        """Self-healing for catchup gossip: marks recorded while the
        peer was fast-syncing (its reactor drops every vote/part on
        the floor) are lies. When the peer sits at `height` with
        nothing left to send, forget what we think it has and resend —
        VoteSet/PartSet dedup the genuine duplicates."""
        with self.lock:
            self.votes_known = {k: v for k, v in self.votes_known.items()
                                if k[0] != height}
            self.proposal_parts = set()

    def known_votes(self, height: int, round_: int, type_: int) -> set:
        with self.lock:
            return set(self.votes_known.get((height, round_, type_), set()))

    def set_has_proposal(self, total: int) -> None:
        with self.lock:
            self.proposal = True
            self.proposal_parts_total = total

    def set_has_part(self, index: int) -> None:
        with self.lock:
            self.proposal_parts.add(index)

    def snapshot(self) -> tuple:
        with self.lock:
            return (self.height, self.round, self.step, self.proposal,
                    set(self.proposal_parts), self.last_commit_round)


class ConsensusReactor(Reactor):
    def __init__(self, consensus_state, fast_sync: bool = False,
                 gossip_sleep_s: float = GOSSIP_SLEEP_S):
        super().__init__("consensus")
        self.cs = consensus_state
        self.fast_sync = fast_sync   # gossip paused until SwitchToConsensus
        self.gossip_sleep_s = gossip_sleep_s
        self.peer_states: Dict[str, PeerRoundState] = {}
        self._peer_threads: Dict[str, list] = {}
        self._lock = threading.Lock()
        self._stopped = False
        # verified heartbeats already published, keyed (validator, height,
        # round, sequence); cleared on height change, hard-capped. Bounds
        # replay spam: each distinct valid heartbeat verifies + publishes
        # at most once. _hb_lock is held across check->verify->publish so
        # two peers delivering the same heartbeat can't double-publish.
        self._hb_seen: set = set()
        self._hb_seen_height = 0
        self._hb_lock = threading.Lock()
        # compact consensus gossip (consensus/compact.py): read once at
        # construction — a reactor never switches wire shapes mid-height.
        # Both off = legacy wire byte-for-byte.
        self._compact = compact.compact_on(consensus_state.config)
        self._voteagg = compact.voteagg_on(consensus_state.config)
        self.compact_stats = compact.CompactStats()
        # peers that failed the compact plane (nack/timeout/bogus data):
        # exponential backoff, during which both directions fall back to
        # full part gossip with that peer
        self._strikes = compact.StrikeLedger()
        self._compact_lock = threading.Lock()
        # sender side: peer_id -> {key, deadline, done} for an
        # unacknowledged compact proposal (parts held back until ack,
        # nack, or deadline)                       guarded_by _compact_lock
        self._compact_sent: Dict[str, dict] = {}
        # cached compact message body per (height, round) — built once,
        # sent to every capable peer               guarded_by cs._lock
        self._compact_built: Optional[dict] = None
        # receiver side: the single in-flight reconstruction
        #                                          guarded_by _compact_lock
        self._compact_rx: Optional[dict] = None

    def get_channels(self):
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=5,
                              send_queue_capacity=100),
            ChannelDescriptor(DATA_CHANNEL, priority=10,
                              send_queue_capacity=100),
            ChannelDescriptor(VOTE_CHANNEL, priority=5,
                              send_queue_capacity=100),
            ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=2),
        ]

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.cs.broadcast_hooks.append(self._on_internal_broadcast)
        if not self.fast_sync:
            self.cs.start()

    def stop(self) -> None:
        self._stopped = True
        self.cs.stop()

    def switch_to_consensus(self, state) -> None:
        """Fast-sync complete: adopt the synced state and start the
        machine (consensus/reactor.go:85 SwitchToConsensus). WAL catchup
        replay runs HERE, after the state reset — the reference's
        ConsensusState.OnStart does the same; replaying earlier would be
        wiped by _update_to_state."""
        self.cs.state = state
        self.cs._update_to_state(state, initial=True)
        if self.cs.state.last_block_height > 0:
            self.cs._reconstruct_last_commit()
        self.fast_sync = False
        try:
            catchup_replay(self.cs, self.cs.wal)
        except ValueError as e:
            # fast-sync routinely advances past the WAL's last marker —
            # benign, but log it so a genuinely lost marker is visible
            self.cs.logger.info("WAL catchup replay skipped", err=str(e))
        # announce ourselves: peers held back gossip while our PeerState
        # was unknown; this round-step kicks it off
        if self.switch is not None:
            self.switch.broadcast_obj(STATE_CHANNEL,
                                      self._our_round_step_msg())
        self.cs.start()

    # ----------------------------------------------------------------- peers

    def add_peer(self, peer) -> None:
        ps = PeerRoundState()
        ps.caps = compact.peer_capabilities(peer)
        with self._lock:
            self.peer_states[peer.id] = ps
        peer.set("consensus_peer_state", ps)
        # announce our current step so the peer can place us — but NOT
        # while fast-syncing: advertising a height would invite vote
        # gossip that our receive() drops while the sender marks it known
        # (consensus/reactor.go AddPeer gates on conR.FastSync())
        if not self.fast_sync:
            peer.try_send_obj(STATE_CHANNEL, self._our_round_step_msg())
        loop = getattr(self.switch, "loop", None) \
            if self.switch is not None else None
        if loop is not None:
            self._add_peer_tasks(loop, peer, ps)
            return
        threads = []
        for fn, name in ((self._gossip_data_routine, "data"),
                         (self._gossip_votes_routine, "votes")):
            t = threading.Thread(target=fn, args=(peer, ps), daemon=True,
                                 name=f"gossip-{name}-{peer.id[:8]}")
            t.start()
            threads.append(t)
        with self._lock:
            self._peer_threads[peer.id] = threads

    def _add_peer_tasks(self, loop, peer, ps: PeerRoundState) -> None:
        """The loop plane's gossip: the data and votes passes as two of
        the loop's tasks, woken by the peer's _GossipWake and by its
        connection's drain (which replaces the blocking send the thread
        routines relied on for backpressure)."""
        st = {"idle": 0}

        def data_task():
            if not self._peer_alive(peer):
                return "stop"
            if self.fast_sync:
                return self.gossip_sleep_s
            ps.wake.clear()
            return 0.0 if self._gossip_data_pass(peer, ps) \
                else self.gossip_sleep_s

        def votes_task():
            if not self._peer_alive(peer):
                return "stop"
            if self.fast_sync:
                return self.gossip_sleep_s
            ps.wake.clear()
            return 0.0 if self._gossip_votes_pass(peer, ps, st) \
                else self.gossip_sleep_s

        tasks = [loop.spawn(data_task, owner="consensus",
                            name=f"gossip-data-{peer.id[:8]}"),
                 loop.spawn(votes_task, owner="consensus",
                            name=f"gossip-votes-{peer.id[:8]}")]
        for t in tasks:
            ps.wake.listeners.append(t.wake)
            getattr(peer.mconn, "drain_listeners", []).append(t.wake)
        with self._lock:
            self._peer_threads[peer.id] = tasks

    def remove_peer(self, peer, reason) -> None:
        with self._compact_lock:
            self._compact_sent.pop(peer.id, None)
        self._strikes.forget(peer.id)
        with self._lock:
            self.peer_states.pop(peer.id, None)
            entries = self._peer_threads.pop(peer.id, None)
        # the gossip threads exit via _peer_alive; the loop's tasks would
        # stay parked (no wake reaches a removed peer): stop them
        for t in entries or ():
            if not isinstance(t, threading.Thread):
                t.stop()

    def _our_round_step_msg(self) -> dict:
        rs = self.cs.rs
        return {"type": "new_round_step", "height": rs.height,
                "round": rs.round, "step": int(rs.step),
                "last_commit_round":
                    rs.last_commit.round if rs.last_commit else -1}

    # -------------------------------------------------------------- receive

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        msg = encoding.cloads(msg_bytes)
        t = msg.get("type")
        # strip the causal trace stamp FIRST: the state machine (and its
        # WAL) must see exactly the untraced message shape, and the
        # receive-side link span it records is the clock-alignment
        # sample the timeline merge aligns node clocks with
        causal.take(msg, t or "")
        ps: Optional[PeerRoundState] = self.peer_states.get(peer.id)
        if ps is None:
            return

        if ch_id == STATE_CHANNEL:
            if t == "new_round_step":
                ps.apply_new_round_step(msg)
            elif t == "has_vote":
                ps.set_has_vote(msg["height"], msg["round"],
                                msg["vote_type"], msg["index"])
            elif t == "commit_step":
                ps.set_has_proposal(msg["parts_total"])
            elif t == "heartbeat":
                # liveness signal from a validator waiting for txs:
                # verify it really is that validator before surfacing on
                # the event bus (the reference publishes
                # EventProposalHeartbeat); no state-machine input
                if self.cs.event_bus is None:
                    return
                try:
                    hb = Heartbeat.from_obj(msg["heartbeat"])
                except (KeyError, ValueError, TypeError):
                    return  # malformed: drop
                rs = self.cs.rs
                # freshness BEFORE the (ms-scale) signature check: a
                # replayed validly-signed old heartbeat must not
                # re-verify in a loop on the peer receive thread. The
                # round/sequence windows also bound the dedup-set keys
                # an attacker (even a current validator) can mint.
                # round window: anything at or above our round (a node
                # lagging the network by several rounds under timeout
                # skew must still surface peers' heartbeats — the
                # reference publishes any received heartbeat), bounded
                # above so one validator's mintable dedup-key space
                # (16 rounds x 512 sequences = 8192) never exceeds the
                # seen-set clear threshold below — overflow-triggered
                # clears would re-admit replays
                if hb.height != rs.height or \
                        not rs.round <= hb.round <= rs.round + 15 or \
                        not 0 <= hb.sequence < 512:
                    return  # stale/implausible: drop
                hb_key = (hb.validator_address, hb.height, hb.round,
                          hb.sequence)
                # one critical section across check->verify->publish:
                # two peers delivering the same heartbeat concurrently
                # must not both verify + publish. Serializing heartbeat
                # verification is fine — it's a low-rate liveness signal.
                with self._hb_lock:
                    if self._hb_seen_height != hb.height or \
                            len(self._hb_seen) > 8192:
                        self._hb_seen.clear()
                        self._hb_seen_height = hb.height
                    if hb_key in self._hb_seen:
                        return  # already verified + published once
                    idx, val = rs.validators.get_by_address(
                        hb.validator_address)
                    if val is None or idx != hb.validator_index:
                        return  # not a current validator: drop
                    # verifier boundary, not scalar PubKey.verify: on the
                    # card a heartbeat verifies on the kernels too
                    verifier = self.cs.block_exec.verifier or \
                        default_verifier()
                    if not verifier.verify_one(
                            val.pubkey,
                            hb.sign_bytes(self.cs.state.chain_id),
                            hb.signature):
                        return  # forged: drop
                    # record only VERIFIED heartbeats so a forgery can't
                    # squat the key and block the real one
                    self._hb_seen.add(hb_key)
                    self.cs.event_bus.publish(
                        "ProposalHeartbeat", {"heartbeat": hb.to_obj(),
                                              "peer": peer.id})
            elif t == "vote_set_maj23":
                # peer claims +2/3 for a block: record + reply with our bits
                if self.fast_sync:
                    return
                if msg.get("vote_type") not in (VoteType.PREVOTE,
                                                VoteType.PRECOMMIT):
                    return  # malformed: ignore rather than KeyError-drop
                bid = BlockID.from_obj(msg["block_id"])
                bits = None
                bad_claim = None
                with self.cs._lock:
                    rs = self.cs.rs
                    if rs.height == msg["height"] and rs.votes is not None:
                        try:
                            rs.votes.set_peer_maj23(
                                msg["round"], msg["vote_type"], peer.id, bid)
                        except ValueError as e:
                            # conflicting maj23 claim from the same
                            # peer: the reference stops the peer and
                            # sends NO VoteSetBits reply
                            # (consensus/reactor.go:208-212)
                            bad_claim = e
                        else:
                            vs = (rs.votes.prevotes(msg["round"])
                                  if msg["vote_type"] == VoteType.PREVOTE
                                  else rs.votes.precommits(msg["round"]))
                            # reply shows which votes we have FOR the
                            # claimed block id (BitArrayByBlockID,
                            # consensus/reactor.go:216-222)
                            bits = [i for i, b in enumerate(
                                vs.bit_array_by_block_id(bid))
                                if b] if vs else []
                if bad_claim is not None:
                    self.cs.logger.info("bad maj23 claim", peer=peer.id,
                                        err=str(bad_claim))
                    if self.switch is not None:
                        self.switch.stop_peer_for_error(peer, bad_claim)
                    return
                if bits is not None:  # only answer for our current height
                    peer.try_send_obj(VOTE_SET_BITS_CHANNEL, {
                        "type": "vote_set_bits", "height": msg["height"],
                        "round": msg["round"],
                        "vote_type": msg["vote_type"],
                        "block_id": msg["block_id"], "indices": bits})

        elif ch_id == DATA_CHANNEL:
            if self.fast_sync:
                return
            if t == "proposal":
                ps.set_has_proposal(
                    msg["proposal"]["block_parts_header"]["total"])
                self.cs.submit({"type": "proposal",
                                "proposal": msg["proposal"]}, peer.id)
            elif t == "block_part":
                ps.set_has_part(msg["part"]["index"])
                self.cs.submit({"type": "block_part",
                                "height": msg["height"],
                                "round": msg.get("round", -1),
                                "part": msg["part"]}, peer.id)
            elif t == "compact_block" and self._compact:
                self._on_compact_block(peer, ps, msg)
            elif t == "tx_fetch" and self._compact:
                self._on_tx_fetch(peer, msg)
            elif t == "tx_fetch_reply" and self._compact:
                self._on_tx_fetch_reply(peer, msg)
            elif t == "compact_ack" and self._compact:
                self._on_compact_ack(peer, ps, msg)
            # relay promptly: other peers' data-gossip threads may now
            # have a new proposal/part to forward (multi-hop nets would
            # otherwise wait on the idle backstop per hop)
            if t == "proposal" and self._compact:
                # a stashed reconstruction may have been waiting for
                # exactly this proposal to validate against
                self._compact_retry()
            self._wake_all_gossip()

        elif ch_id == VOTE_CHANNEL:
            if self.fast_sync:
                return
            if t == "vote":
                v = msg["vote"]
                ps.set_has_vote(v["height"], v["round"], v["type"],
                                v["validator_index"])
                self.cs.submit({"type": "vote", "vote": v}, peer.id)
            elif t == "vote_agg" and self._voteagg:
                votes = msg.get("votes")
                if not isinstance(votes, list) or \
                        not 0 < len(votes) <= compact.MAX_AGG_VOTES:
                    return  # malformed/oversized aggregate: drop
                for v in votes:
                    ps.set_has_vote(v["height"], v["round"], v["type"],
                                    v["validator_index"])
                self.cs.submit({"type": "vote_agg", "votes": votes},
                               peer.id)

        elif ch_id == VOTE_SET_BITS_CHANNEL:
            if t == "vote_set_bits":
                for i in msg.get("indices", []):
                    ps.set_has_vote(msg["height"], msg["round"],
                                    msg["vote_type"], i)

    # ---------------------------------------------- internal event broadcast

    def _wake_all_gossip(self) -> None:
        # tmlint: allow(taint): wake-signal fan-out is idempotent and carries no data; visit order cannot reach wire bytes
        for ps in list(self.peer_states.values()):
            ps.wake.set()

    def _on_internal_broadcast(self, msg: dict) -> None:
        """Hook on ConsensusState._broadcast: announce step changes and
        vote possession; data/votes flow through the gossip threads —
        woken here, since a local step/vote/proposal change is exactly
        when they may have something new to send."""
        self._wake_all_gossip()
        if self.switch is None:
            return
        t = msg.get("type")
        if t == "new_round_step":
            self.switch.broadcast_obj(STATE_CHANNEL, causal.stamp({
                "type": "new_round_step", "height": msg["height"],
                "round": msg["round"], "step": msg["step"],
                "last_commit_round": msg.get("last_commit_round", -1)},
                msg["height"], msg["round"]))
        elif t == "has_vote":
            self.switch.broadcast_obj(STATE_CHANNEL, causal.stamp({
                "type": "has_vote", "height": msg["height"],
                "round": msg["round"], "vote_type": msg["vote_type"],
                "index": msg["index"]}, msg["height"], msg["round"]))
        elif t == "heartbeat":
            # proposal heartbeat while waiting for txs
            # (consensus/reactor.go ProposalHeartbeatMessage)
            self.switch.broadcast_obj(STATE_CHANNEL, {
                "type": "heartbeat", "heartbeat": msg["heartbeat"]})

    # -------------------------------------------------------- gossip: data

    def _peer_alive(self, peer) -> bool:
        return (not self._stopped and peer.running and
                peer.id in self.peer_states)

    def _gossip_data_routine(self, peer, ps: PeerRoundState) -> None:
        """consensus/reactor.go:466 gossipDataRoutine."""
        while self._peer_alive(peer):
            if self.fast_sync:
                ps.wake.wait(self.gossip_sleep_s)
                ps.wake.clear()
                continue
            if not self._gossip_data_pass(peer, ps):
                # park until something changes (local state or peer
                # state), with the reference's 100 ms idle backstop
                # (consensus/reactor.go peerGossipSleepDuration)
                ps.wake.wait(self.gossip_sleep_s)
                ps.wake.clear()

    def _gossip_data_pass(self, peer, ps: PeerRoundState) -> bool:
        """One pass of the data-gossip body: send at most one proposal,
        compact proposal, or block part the peer provably lacks. True
        when sent."""
        sent = False
        catchup_height = 0
        now = time.monotonic()
        if self._compact:
            # receiver-side reconstruction deadline: ANY peer's data
            # pass may expire it (the 100ms idle backstop bounds the
            # check latency), after which full parts flow as before
            self._compact_rx_tick(now)
        with self.cs._lock:
            rs = self.cs.rs
            p_height, p_round, _, p_has_proposal, p_parts, _ = \
                ps.snapshot()
            proposal_msg = None
            part_msg = None
            compact_msg = None
            if rs.height == p_height:
                # 1) the proposal itself
                if rs.proposal is not None and not p_has_proposal and \
                        rs.proposal.round == p_round:
                    proposal_msg = {"type": "proposal",
                                    "proposal": rs.proposal.to_obj()}
                # 2) block parts the peer lacks — short-circuit when the
                # peer is provably complete (the full-bitarray re-scan
                # sat in the gossip hot loop at 128 validators)
                elif rs.proposal_block_parts is not None and \
                        len(p_parts) < rs.proposal_block_parts.total:
                    parts = rs.proposal_block_parts
                    mode = "parts"
                    if self._compact and ps.caps[0]:
                        mode, compact_msg = self._compact_tx_phase(
                            peer, ps, rs, now)
                    # high-bandwidth mode: parts keep streaming while
                    # an offer is outstanding ("wait") — the ack marks
                    # them known and stops the stream, so a compact
                    # miss never costs latency, only a few spare parts
                    if mode != "send":
                        for i in range(parts.total):
                            if i not in p_parts and \
                                    parts.get_part(i) is not None:
                                part_msg = {
                                    "type": "block_part",
                                    "height": rs.height,
                                    "round": rs.round,
                                    "part": parts.get_part(i).to_obj()}
                                break
            elif 0 < p_height < rs.height:
                catchup_height = p_height
        if compact_msg is not None:
            causal.stamp(compact_msg, compact_msg["height"],
                         compact_msg["round"])
            if peer.send(DATA_CHANNEL, encoding.cdumps(compact_msg)):
                self.compact_stats.compact_sent()
                return True
            # send failed: clear the pending entry so parts flow
            with self._compact_lock:
                self._compact_sent.pop(peer.id, None)
            return False
        if catchup_height:
            # catchup: serve parts of the block they're finishing —
            # store reads stay OUTSIDE the state machine's lock (the
            # store is independently thread-safe; holding cs._lock
            # across db I/O would stall vote/proposal processing)
            meta = self.cs.block_store.load_block_meta(catchup_height)
            # same has_all short-circuit as the current-height scan
            if meta is not None and \
                    len(p_parts) < meta.block_id.parts.total:
                for i in range(meta.block_id.parts.total):
                    if i not in p_parts:
                        part = self.cs.block_store.load_block_part(
                            catchup_height, i)
                        if part is None:
                            break
                        part_msg = {
                            "type": "block_part",
                            "height": catchup_height, "round": -1,
                            "part": part.to_obj()}
                        break
        if proposal_msg is not None:
            p = proposal_msg["proposal"]
            causal.stamp(proposal_msg, p["height"], p["round"])
            if peer.send(DATA_CHANNEL, encoding.cdumps(proposal_msg)):
                ps.set_has_proposal(
                    proposal_msg["proposal"]["block_parts_header"]
                    ["total"])
                sent = True
        elif part_msg is not None:
            causal.stamp(part_msg, part_msg["height"],
                         part_msg["round"])
            if peer.send(DATA_CHANNEL, encoding.cdumps(part_msg)):
                ps.set_has_part(part_msg["part"]["index"])
                sent = True
        return sent

    # ------------------------------------------------ compact block relay

    def _compact_tx_phase(self, peer, ps: PeerRoundState, rs,
                          now: float):
        """Sender-side compact decision for one data pass (called under
        cs._lock, peer known to lack parts). Returns (mode, msg):
        ("send", compact_msg) to offer the compact proposal, ("wait",
        None) while an offer is outstanding, ("parts", None) to fall
        back to full part gossip."""
        key = (rs.height, rs.round)
        with self._compact_lock:
            ent = self._compact_sent.get(peer.id)
            if ent is not None and ent["key"] == key:
                if ent.get("done"):
                    return "parts", None
                if now < ent["deadline"]:
                    return "wait", None
                # no ack inside the deadline: strike (backoff future
                # compact offers to this peer) and ship parts
                ent["done"] = True
                self._strikes.strike(peer.id, now, "timeout")
                return "parts", None
            if self._strikes.in_backoff(peer.id, now):
                return "parts", None
            if rs.proposal is None or rs.proposal_block is None:
                # nothing compact to offer (we don't hold the full
                # block yet) — parts flow as they arrive
                return "parts", None
            msg = self._build_compact_locked(rs)
            if msg is None:
                return "parts", None
            self._compact_sent[peer.id] = {
                "key": key,
                "deadline": now + compact.COMPACT_DEADLINE_S}
            return "send", msg

    def _build_compact_locked(self, rs) -> Optional[dict]:
        """The compact message body for the current proposal, built
        once per (height, round) and cached (under cs._lock). Carries
        everything a receiver cannot get from its mempool: header,
        evidence, last commit, the salted short id per tx, and the
        salt (derived from the proposal signature — unpredictable
        before signing, identical for every receiver)."""
        key = (rs.height, rs.round)
        c = self._compact_built
        if c is None or c["key"] != key:
            block = rs.proposal_block
            obj = block.to_obj()
            salt = compact.proposal_salt(rs.proposal.signature)
            c = {"key": key, "msg": {
                "type": "compact_block",
                "height": rs.height, "round": rs.round,
                "salt": salt.hex(),
                "short_ids": [s.hex() for s in compact.short_ids_for(
                    salt, block.data.txs)],
                "header": obj["header"],
                "evidence": obj["evidence"],
                "last_commit": obj["last_commit"]}}
            self._compact_built = c
        return dict(c["msg"])

    def _on_compact_block(self, peer, ps: PeerRoundState,
                          msg: dict) -> None:
        """Receiver side: resolve the short-id list against the
        mempool, fetch what's missing, rebuild the block onto the
        canonical PartSet, and feed the parts through cs.submit — the
        state machine (and its WAL) sees exactly the legacy block_part
        shape. Any failure nacks, which makes the sender fall back to
        full part gossip."""
        now = time.monotonic()
        try:
            key = (int(msg["height"]), int(msg["round"]))
            salt = bytes.fromhex(msg["salt"])
            short_ids = [bytes.fromhex(s) for s in msg["short_ids"]]
            header = msg["header"]
            evidence = msg["evidence"]
            last_commit = msg["last_commit"]
        except (KeyError, ValueError, TypeError):
            self._strikes.strike(peer.id, now, "malformed")
            self._compact_nack(peer, msg, "failed")
            return
        if self._strikes.in_backoff(peer.id, now):
            self.compact_stats.compact_received("backoff")
            self._compact_nack(peer, msg, "backoff")
            return
        with self.cs._lock:
            rs = self.cs.rs
            if key != (rs.height, rs.round):
                self.compact_stats.compact_received("stale")
                self._compact_nack(peer, msg, "stale")
                return
            if rs.proposal_block is not None:
                # already have the full block (compact from another
                # peer, or parts won the race): ack so the sender
                # marks every part known and stops streaming them
                self.compact_stats.compact_received("dup")
                self._compact_mark_sender(ps, rs)
                self._compact_ack(peer, key, True)
                return
            part_size = (self.cs.state.consensus_params
                         .block_gossip.block_part_size_bytes)
        rx = {"key": key, "peer": peer.id, "salt": salt,
              "short_ids": short_ids, "header": header,
              "evidence": evidence, "last_commit": last_commit,
              "resolved": {}, "fetching": False, "fetched": False,
              "part_size": part_size,
              "deadline": now + compact.COMPACT_DEADLINE_S,
              "ackers": [peer]}
        with self._compact_lock:
            cur = self._compact_rx
            if cur is not None and cur["key"] == key:
                # second sender for the same proposal: remember to ack
                # it too when the in-flight reconstruction lands
                cur["ackers"].append(peer)
                self.compact_stats.compact_received("dup")
                return
            self._compact_rx = rx
        if cur is not None:
            # a reconstruction for an older round was still in flight:
            # the round check above proves it stale — release its
            # offerers benignly (their parts flow regardless)
            for p in cur["ackers"]:
                self._compact_ack(p, cur["key"], False, "stale")
        self.compact_stats.compact_received("accepted")
        self._compact_try_resolve(rx)

    def _compact_try_resolve(self, rx: dict) -> None:
        """Match every short id against the mempool's hash index; fetch
        missing txs from the compact sender (bounded) or finish."""
        mp = getattr(self.cs, "mempool", None)
        index: Dict[bytes, bytes] = {}
        if mp is not None and hasattr(mp, "pending_hashes"):
            salt = rx["salt"]
            for h in mp.pending_hashes():
                index[compact.short_id(salt, h)] = h
        txs: list = []
        missing: list = []
        for i, sid in enumerate(rx["short_ids"]):
            tx = rx["resolved"].get(i)
            if tx is None:
                full = index.get(sid)
                tx = mp.get_by_hash(full) if (
                    full is not None and hasattr(mp, "get_by_hash")) \
                    else None
            if tx is None:
                missing.append(i)
                txs.append(None)
            else:
                rx["resolved"][i] = tx
                txs.append(tx)
        if not missing:
            self._compact_finish(rx, txs)
            return
        if len(missing) > compact.MAX_FETCH or rx["fetching"]:
            # mempool too cold to win on bytes, or the one bounded
            # fetch round already ran: fall back to part gossip
            self._compact_fail_rx(rx, strike_peer="")
            return
        rx["fetching"] = True
        rx["fetched"] = True
        # a fetch round trip (serve ~MAX_FETCH txs under the sender's
        # consensus lock) legitimately outlives the base window on a
        # loaded host — extend; the parts race on in parallel either way
        rx["deadline"] = max(
            rx["deadline"],
            time.monotonic() + compact.FETCH_DEADLINE_S)
        self.compact_stats.fetch_request(len(missing))
        rx["ackers"][0].try_send_obj(DATA_CHANNEL, {
            "type": "tx_fetch", "height": rx["key"][0],
            "round": rx["key"][1], "indices": missing})

    def _compact_finish(self, rx: dict, txs: list) -> None:
        """All txs resolved: rebuild the block, split it onto the
        canonical PartSet, verify it against the signed proposal's
        part-set header, and submit the parts as plain block_part
        inputs — bit-identical to the wire path by construction."""
        height, round_ = rx["key"]
        try:
            block = Block.from_obj({
                "header": rx["header"], "data": {
                    "txs": [t.hex() for t in txs]},
                "evidence": rx["evidence"],
                "last_commit": rx["last_commit"]})
            data = block.to_bytes()
            parts = PartSet.from_data(data, rx["part_size"])
        except Exception:
            self._compact_fail_rx(rx, strike_peer=rx["peer"],
                                  reason="bad_block")
            return
        with self.cs._lock:
            rs = self.cs.rs
            if (rs.height, rs.round) != rx["key"]:
                self._compact_clear_rx(rx)
                return
            if rs.proposal is None:
                # can't validate against the signed part-set header
                # yet — hold until the proposal arrives or the
                # deadline nacks (checked from the data passes)
                return
            ok = parts.has_header(rs.proposal.block_parts_header)
        if not ok:
            # txs that hash right but a part set that doesn't match
            # the signed proposal: short-id collision or a lying
            # sender — either way parts are the truth
            self._compact_fail_rx(rx, strike_peer=rx["peer"],
                                  reason="mismatch")
            return
        with causal.span("block.reconstruct", height, round_,
                         parts=parts.total, txs=len(txs),
                         fetched=int(rx["fetched"])):
            for i in range(parts.total):
                self.cs.submit({"type": "block_part", "height": height,
                                "round": round_,
                                "part": parts.get_part(i).to_obj()},
                               rx["peer"])
        self.compact_stats.reconstructed("fetched" if rx["fetched"] else "hit")
        with self.cs._lock:
            rs = self.cs.rs
            for p in rx["ackers"]:
                sender_ps = self.peer_states.get(p.id)
                if sender_ps is not None:
                    self._compact_mark_sender(sender_ps, rs, rx["key"])
        for p in rx["ackers"]:
            self._compact_ack(p, rx["key"], True)
        self._compact_clear_rx(rx)
        self._wake_all_gossip()

    def _compact_mark_sender(self, ps: PeerRoundState, rs,
                             key=None) -> bool:
        """A peer that offered us a compact proposal provably holds the
        full block: mark every part known so our data pass never
        echoes parts back (called under cs._lock)."""
        if key is not None and (rs.height, rs.round) != key:
            return False
        parts = rs.proposal_block_parts
        if parts is None and rs.proposal is not None:
            total = rs.proposal.block_parts_header.total
        elif parts is not None:
            total = parts.total
        else:
            return False
        ps.set_has_proposal(total)
        for i in range(total):
            ps.set_has_part(i)
        return True

    def _compact_fail_rx(self, rx: dict, strike_peer: str = "",
                         reason: str = "fallback") -> None:
        if strike_peer:
            self._strikes.strike(strike_peer, time.monotonic(), reason)
        self.compact_stats.reconstructed("fallback")
        for p in rx["ackers"]:
            self._compact_ack(p, rx["key"], False, "failed")
        self._compact_clear_rx(rx)
        self._wake_all_gossip()

    def _compact_clear_rx(self, rx: dict) -> None:
        with self._compact_lock:
            if self._compact_rx is rx:
                self._compact_rx = None

    def _compact_rx_tick(self, now: float) -> None:
        """Expire a stuck reconstruction (fetch never answered, or the
        proposal never arrived): nack every offerer so their parts
        flow, and strike the peer we fetched from if a fetch was
        outstanding."""
        with self._compact_lock:
            rx = self._compact_rx
        if rx is None or now < rx["deadline"]:
            return
        strike = rx["peer"] if rx["fetching"] else ""
        self._compact_fail_rx(rx, strike_peer=strike,
                              reason="fetch_timeout")

    def _compact_retry(self) -> None:
        """A proposal just arrived: a reconstruction stashed waiting to
        validate against it can complete now."""
        with self._compact_lock:
            rx = self._compact_rx
        if rx is None:
            return
        if all(i in rx["resolved"] for i in range(len(rx["short_ids"]))):
            self._compact_finish(
                rx, [rx["resolved"][i]
                     for i in range(len(rx["short_ids"]))])
        else:
            self._compact_try_resolve(rx)

    def _compact_nack(self, peer, msg: dict,
                      reason: str = "failed") -> None:
        try:
            key = (int(msg.get("height", 0)), int(msg.get("round", -1)))
        except (ValueError, TypeError):
            return
        self._compact_ack(peer, key, False, reason)

    def _compact_ack(self, peer, key: tuple, ok: bool,
                     reason: str = "") -> None:
        peer.try_send_obj(DATA_CHANNEL, {
            "type": "compact_ack", "height": key[0], "round": key[1],
            "ok": bool(ok), "reason": reason})

    def _on_tx_fetch(self, peer, msg: dict) -> None:
        """Serve missing txs of the current proposal to a peer that is
        reconstructing it from our compact offer. Bounded by MAX_FETCH;
        anything we cannot serve simply times out on the requester's
        side (its deadline nacks and our parts flow)."""
        indices = msg.get("indices")
        if not isinstance(indices, list) or \
                not 0 < len(indices) <= compact.MAX_FETCH:
            return
        with self._compact_lock:
            # the peer is actively reconstructing our offer: give its
            # ack the same extended window the fetch round trip needs
            ent = self._compact_sent.get(peer.id)
            if ent is not None and not ent.get("done"):
                ent["deadline"] = max(
                    ent["deadline"],
                    time.monotonic() + compact.FETCH_DEADLINE_S)
        out = None
        with self.cs._lock:
            rs = self.cs.rs
            block = rs.proposal_block
            if block is not None and msg.get("height") == rs.height:
                n = len(block.data.txs)
                out = [[i, block.data.txs[i].hex()] for i in indices
                       if isinstance(i, int) and 0 <= i < n]
        if out:
            peer.try_send_obj(DATA_CHANNEL, {
                "type": "tx_fetch_reply", "height": msg["height"],
                "round": msg.get("round", -1), "txs": out})
            self.compact_stats.fetch_served_txs(len(out))

    def _on_tx_fetch_reply(self, peer, msg: dict) -> None:
        """Fetched txs landed: verify each against its salted short id
        (a wrong tx here is a lying sender, not a race) and finish."""
        with self._compact_lock:
            rx = self._compact_rx
        if rx is None or rx["peer"] != peer.id:
            return
        if rx["key"] != (msg.get("height"), msg.get("round")):
            return
        txs_in = msg.get("txs")
        if not isinstance(txs_in, list) or \
                len(txs_in) > compact.MAX_FETCH:
            return
        for item in txs_in:
            try:
                i, tx_hex = item
                i = int(i)
                tx = bytes.fromhex(tx_hex)
            except (ValueError, TypeError):
                continue
            if not 0 <= i < len(rx["short_ids"]):
                continue
            sid = compact.short_id(
                rx["salt"], hashlib.sha256(tx).digest())
            if sid != rx["short_ids"][i]:
                # advertised one tx, served another: strike + fallback
                self._compact_fail_rx(rx, strike_peer=peer.id,
                                      reason="bogus_tx")
                return
            rx["resolved"][i] = tx
        if all(i in rx["resolved"]
               for i in range(len(rx["short_ids"]))):
            self._compact_finish(
                rx, [rx["resolved"][i]
                     for i in range(len(rx["short_ids"]))])

    def _on_compact_ack(self, peer, ps: PeerRoundState,
                        msg: dict) -> None:
        """Sender side: ok=True means the peer rebuilt the full block —
        mark every part known and stop streaming; ok=False means the
        offer went nowhere — parts keep flowing, and only a FAULT nack
        (reconstruction actually failed there) strikes. Benign nacks
        (stale round, receiver backing off or busy) are routine at
        round edges; striking on them cascades into mutual backoff."""
        key = (msg.get("height"), msg.get("round"))
        now = time.monotonic()
        with self._compact_lock:
            ent = self._compact_sent.get(peer.id)
            if ent is None or ent["key"] != key:
                return
            ent["done"] = True
        if msg.get("ok"):
            with self.cs._lock:
                rs = self.cs.rs
                if (rs.height, rs.round) == key and \
                        rs.proposal_block_parts is not None:
                    total = rs.proposal_block_parts.total
                    ps.set_has_proposal(total)
                    for i in range(total):
                        ps.set_has_part(i)
        elif msg.get("reason") not in compact.BENIGN_NACKS:
            self._strikes.strike(peer.id, now, "nack")
        ps.wake.set()

    # -------------------------------------------------------- gossip: votes

    def _gossip_votes_routine(self, peer, ps: PeerRoundState) -> None:
        """consensus/reactor.go:604 gossipVotesRoutine."""
        st = {"idle": 0}   # iterations a peer sat with nothing sendable
        #                    — triggers the mark/announce self-heal
        while self._peer_alive(peer):
            if self.fast_sync:
                ps.wake.wait(self.gossip_sleep_s)
                ps.wake.clear()
                continue
            if not self._gossip_votes_pass(peer, ps, st):
                ps.wake.wait(self.gossip_sleep_s)
                ps.wake.clear()

    def _gossip_votes_pass(self, peer, ps: PeerRoundState,
                           st: dict) -> bool:
        """One pass of the vote-gossip body: send at most one vote the
        peer provably lacks; after ~2s of consecutive idle passes run
        the self-heal (forget catchup marks / re-announce round step).
        True when a vote was sent."""
        votes = None   # list of vote dicts for one (height, round, type)
        catchup_height = 0
        # aggregate only toward peers that advertised voteagg/1; a limit
        # of 1 keeps the single-vote legacy shape byte-for-byte
        limit = compact.MAX_AGG_VOTES \
            if self._voteagg and ps.caps[1] else 1
        with self.cs._lock:
            rs = self.cs.rs
            p_height, p_round, p_step, *_ , p_last_commit_round = \
                (*ps.snapshot(),)
            if p_height == rs.height and rs.votes is not None:
                votes = self._pick_votes_for(
                    ps, rs.votes.prevotes(p_round), rs.height, p_round,
                    VoteType.PREVOTE, limit) or self._pick_votes_for(
                    ps, rs.votes.precommits(p_round), rs.height,
                    p_round, VoteType.PRECOMMIT, limit)
                if votes is None and p_round >= 0 and \
                        p_round != rs.round:
                    # also our current round's votes (peer may be behind)
                    votes = self._pick_votes_for(
                        ps, rs.votes.prevotes(rs.round), rs.height,
                        rs.round, VoteType.PREVOTE, limit) or \
                        self._pick_votes_for(
                            ps, rs.votes.precommits(rs.round),
                            rs.height, rs.round, VoteType.PRECOMMIT,
                            limit)
            elif p_height + 1 == rs.height and rs.last_commit is not None:
                # peer finishing our previous height: last-commit votes
                votes = self._pick_votes_for(
                    ps, rs.last_commit, p_height, rs.last_commit.round,
                    VoteType.PRECOMMIT, limit)
            elif 0 < p_height < rs.height:
                catchup_height = p_height
        if votes is None and catchup_height:
            # deep catchup: precommits from the stored seen commit —
            # db read outside the state machine's lock
            commit = self.cs.block_store.load_seen_commit(catchup_height)
            if commit is not None:
                known = ps.known_votes(catchup_height, commit.round(),
                                       VoteType.PRECOMMIT)
                picked = []
                for i, pc in enumerate(commit.precommits):
                    if pc is not None and i not in known:
                        picked.append(pc.to_obj())
                        if len(picked) >= limit:
                            break
                votes = picked or None
        if votes:
            v0 = votes[0]
            if len(votes) == 1:
                vote_msg = {"type": "vote", "vote": v0}
            else:
                vote_msg = {"type": "vote_agg", "votes": votes}
                self.compact_stats.agg(len(votes))
            causal.stamp(vote_msg, v0["height"], v0["round"])
            if peer.send(VOTE_CHANNEL, encoding.cdumps(vote_msg)):
                for v in votes:
                    ps.set_has_vote(v["height"], v["round"], v["type"],
                                    v["validator_index"])
            st["idle"] = 0
            return True
        # nothing sendable this pass: after ~2s of consecutive
        # idling, self-heal. Two shapes, one threshold:
        # - catchup peer: our marks may predate its fast-sync
        #   handoff (votes we "sent" were dropped unprocessed) —
        #   forget the height's marks and resend.
        # - otherwise: re-announce our NewRoundStep. The add_peer
        #   announcement is a try_send into a just-built conn and
        #   the receive side drops messages arriving before its
        #   peer state registers, so either end of the connect
        #   race can eat it — leaving the PEER's view of us blank
        #   at (0, -1) while our view of it looks fine. The side
        #   with the stale view cannot know it; the side with
        #   NOTHING TO SEND re-announcing is what breaks the
        #   genesis wedge (both halves idle forever otherwise).
        #   Idempotent, one ~60-byte STATE message per idle peer
        #   per threshold.
        st["idle"] += 1
        if st["idle"] * self.gossip_sleep_s >= 2.0:
            st["idle"] = 0
            if catchup_height:
                ps.forget_height(catchup_height)
                return True  # marks reset: rescan immediately
            peer.try_send_obj(STATE_CHANNEL,
                              self._our_round_step_msg())
        return False

    def _pick_votes_for(self, ps: PeerRoundState, vote_set, height: int,
                        round_: int, type_: int,
                        limit: int = 1) -> Optional[list]:
        """Up to `limit` votes in `vote_set` the peer doesn't have, as
        wire dicts (same scan order as the pre-aggregation single-vote
        pick; limit=1 reproduces it exactly). None when empty-handed so
        the `or` chains read unchanged."""
        if vote_set is None:
            return None
        known = ps.known_votes(height, round_, type_)
        picked = []
        for i, v in enumerate(vote_set.votes):
            if v is not None and i not in known:
                picked.append(v.to_obj())
                if len(picked) >= limit:
                    break
        return picked or None
