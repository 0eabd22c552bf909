"""ConsensusState — the Tendermint BFT algorithm: the port's copy of
`tendermint_tpu/consensus/state.py` (consensus/state.go).

Semantics of the reference's state machine (transitions enterNewRound
:651, enterPropose :745, enterPrevote :882, enterPrecommit :970,
enterCommit :1085, finalizeCommit :1153, addVote :1340), with a
deterministic single-threaded core instead of goroutines + channels:

- every input is a plain dict message (WAL-serializable by construction)
- inputs enter through submit(); one FIFO drains under a re-entrant lock,
  so internally-generated messages (our own proposal/parts/votes) are
  processed in order by the same loop — the reference's internalMsgQueue
- effects leave through sinks: `broadcast(msg)` (reactor hook), the event
  bus, scheduled timeouts, and committed blocks via the BlockExecutor

This shape makes WAL replay literally `for msg in tail: submit(msg)` and
lets tests drive rounds deterministically with a MockTicker.

Every signature check (the proposal, each vote through HeightVoteSet and
VoteSet, the last commit and evidence in validate_block) goes through
the BlockExecutor's verifier: on the card, B1/B2 for a "cuda" verifier.

With the pipeline on (pipeline.resolve(): config.base.pipeline "auto",
the default) a height runs the JAX package's default path: the proposer
builds its part set natively and gossips each part as it is made
(streaming), precomputes the next height's proposal on a `cs-precompute`
worker while the commit timeout runs (used only when it matches the
fresh reap, commit and evidence exactly), and finalizes with group
commit (`_finalize_commit_pipelined`). "off" is the serial path. The
commit-critical fail points (utils/fail.py) sit on both paths.

The observability planes sit where the JAX state machine has them: the
`consensus_*` families and the Chrome-trace step events, the causal
points and spans (`_cpoint`, `_cspan`; never during replay), the SLO
plane's `propose` stamps, and the `transition.digest` point when the
executor carries a divergence recorder (`_point_transition_digest`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

from tendermint_tpu_torch import pipeline, telemetry
from tendermint_tpu_torch.config import ConsensusConfig
from tendermint_tpu_torch.models.verifier import VerifierError
from tendermint_tpu_torch.consensus import compact
from tendermint_tpu_torch.consensus.rstate import (HeightVoteSet, RoundState,
                                                   Step)
from tendermint_tpu_torch.consensus.ticker import TimeoutInfo, TimeoutTicker
from tendermint_tpu_torch.state.execution import (ApplyBlockError,
                                                  BlockExecutor,
                                                  MockEvidencePool,
                                                  MockMempool)
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.validation import BlockValidationError
from tendermint_tpu_torch.storage.block_store import BlockStore
from tendermint_tpu_torch.storage.wal import NilWAL
from tendermint_tpu_torch.types.block import (Block, BlockID, Commit,
                                              EvidenceData, PartSetHeader)
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal
from tendermint_tpu_torch.types.vote import Vote, VoteType
from tendermint_tpu_torch.types.vote_set import ConflictingVoteError, VoteSet
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.telemetry import slo as slo_plane
from tendermint_tpu_torch.utils import clock, fail
from tendermint_tpu_torch.utils.log import get_logger

# The consensus timeline the block-rate numbers decompose into: where
# heights/rounds sit now, how long rounds take end to end, and how often
# each step fires.
_m_height = telemetry.gauge(
    "consensus_height", "Current consensus height")
_m_round = telemetry.gauge(
    "consensus_round", "Current consensus round within the height")
_m_steps = telemetry.counter(
    "consensus_steps_total", "Step transitions by step name", ("step",))
_m_round_dur = telemetry.histogram(
    "consensus_round_duration_seconds",
    "enterNewRound -> enterCommit wall time per committed round")
_m_commits = telemetry.counter(
    "consensus_commits_total", "Blocks finalized by this node")
_m_block_txs = telemetry.histogram(
    "consensus_block_txs", "Transactions per finalized block",
    buckets=telemetry.POW2_BUCKETS)


class ConsensusFailure(Exception):
    """Unrecoverable consensus fault (reference panics / kills process)."""


class ConsensusState:
    def __init__(self, config: ConsensusConfig, state: State,
                 block_exec: BlockExecutor, block_store,
                 mempool=None, evidence_pool=None,
                 priv_validator=None, wal=None, event_bus=None,
                 ticker_factory=TimeoutTicker):
        self.config = config
        self.state = state             # last committed State
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool if mempool is not None else MockMempool()
        self.evidence_pool = (evidence_pool if evidence_pool is not None
                              else MockEvidencePool())
        self.priv_validator = priv_validator
        self.wal = wal if wal is not None else NilWAL()
        self.event_bus = event_bus
        self.replay_mode = False
        # the reactors log through it as the JAX package's do
        # (`cs.logger.info(msg, **fields)`)
        self.logger = get_logger(__name__)

        self.rs = RoundState(height=state.last_block_height + 1)

        self.broadcast_hooks: List[Callable[[dict], None]] = []
        self.decided_hook: Optional[Callable[[Block], None]] = None
        # recovery plane: called with the post-apply State after each
        # finalized height, while the app sits at exactly that height,
        # and after the height's group flush (node.py wires the snapshot
        # manager here). A hook's failure is logged, never raised.
        self.post_commit_hooks: List[Callable[[State], None]] = []

        self._lock = threading.RLock()
        self._queue: deque = deque()
        self.fatal_error = None
        self._processing = False
        self._stopped = False
        # the pipelined hot path, resolved once so that a state machine
        # never switches modes mid-height; off = the serial path
        self._pipeline = pipeline.resolve()
        # the causal and SLO planes, resolved once the same way: off =
        # no per-height span recording, untouched broadcast envelopes,
        # and no per-block stamp calls
        self._trace = causal.enabled()
        self._slo = slo_plane.enabled()
        self._pre_lock = threading.Lock()
        # next-proposal precompute handoff (worker -> propose step)
        self._precomputed = None  #: guarded_by _pre_lock
        # a height's stage seconds for the overlap ratio (consensus
        # thread only: reset a height, read at finalize)
        self._overlap_s = 0.0
        self._serial_s = 0.0
        # telemetry timeline anchors (perf_counter stamps): when the
        # current round began, and the still-open step interval the next
        # _new_step closes as one Chrome-trace complete event
        self._round_t0 = 0.0
        self._step_open = None  # (step_name, height, round, t0)

        self.ticker = ticker_factory(self._on_timeout_fire)

        if state.last_block_height > 0:
            self._reconstruct_last_commit()
        self._update_to_state(state, initial=True)

    # ------------------------------------------------------------------ input

    def submit(self, msg: dict, peer_id: str = "") -> None:
        """Feed one input (peer message, own message, or timeout). Safe to
        call from any thread; processing happens inline on the caller that
        finds the queue idle — the single-writer discipline of the
        reference's receiveRoutine (consensus/state.go:509-557)."""
        with self._lock:
            if self._stopped:
                return  # late ticker/gossip input after shutdown
            self._queue.append((msg, peer_id))
            if self._processing:
                return
            self._processing = True
            try:
                while self._queue:
                    m, p = self._queue.popleft()
                    if not self.replay_mode:
                        wal_obj = dict(m)
                        if p:
                            wal_obj["peer"] = p
                        self.wal.save(wal_obj, time_ns=clock.now_ns())
                    try:
                        self._handle(m, p)
                    except (ConsensusFailure, AssertionError,
                            ApplyBlockError, VerifierError) as e:
                        # unrecoverable: HALT this state machine (the
                        # reference's receiveRoutine panics the whole
                        # process), record why, and propagate to the
                        # driving thread. Without _stopped the next
                        # input would re-execute the decided block on
                        # the app — double DeliverTx side effects.
                        self._stopped = True
                        self.fatal_error = e
                        self._log(f"CONSENSUS FAILURE, halting: {e!r}")
                        raise
                    except Exception as e:
                        self._log(f"error handling {m.get('type')}: {e!r}")
            finally:
                self._processing = False

    def start(self) -> None:
        """Schedule round 0 of the current height (OnStart tail)."""
        self._schedule_round0()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        self.ticker.stop()
        self.wal.flush()

    def _on_timeout_fire(self, ti: TimeoutInfo) -> None:
        self.submit({"type": "timeout", "ti": ti.to_obj()})

    def _enqueue_own(self, msg: dict) -> None:
        """Append one of our OWN messages (proposal/part/vote) from inside
        the drain loop — the still-running drain persists it to the WAL
        and handles it in order. Asserting _processing keeps the
        single-writer discipline honest: a caller outside the loop would
        silently skip WAL persistence and must use submit() instead."""
        assert self._processing, "outside the drain loop: use submit()"
        self._queue.append((msg, ""))

    # -------------------------------------------------------------- messaging

    def _handle(self, msg: dict, peer_id: str) -> None:
        t = msg.get("type")
        if t == "proposal":
            self._set_proposal(Proposal.from_obj(msg["proposal"]))
        elif t == "block_part":
            try:
                self._add_proposal_block_part(
                    msg["height"], Part.from_obj(msg["part"]))
            except ValueError:
                if msg.get("round") == self.rs.round:
                    raise
        elif t == "vote":
            self._try_add_vote(Vote.from_obj(msg["vote"]), peer_id)
        elif t == "vote_agg":
            # aggregated vote gossip: understood whatever the sender's
            # settings, so a WAL that holds it always replays
            self._try_add_votes(
                [Vote.from_obj(v) for v in msg.get("votes", [])], peer_id)
        elif t == "timeout":
            self._handle_timeout(TimeoutInfo.from_obj(msg["ti"]))
        elif t == "txs_available":
            self._enter_propose(self.rs.height, 0)
        else:
            self._log(f"unknown message type {t!r}")

    def _broadcast(self, msg: dict) -> None:
        if self.replay_mode:
            return
        for hook in self.broadcast_hooks:
            hook(msg)

    def _log(self, s: str) -> None:
        self.logger.error(s, height=self.rs.height, round=self.rs.round,
                          step=self.rs.step.name)

    def _cpoint(self, name: str, height: int, round_: int = -1,
                **args) -> None:
        """One causal timeline point — never during replay (a replayed
        step is not new cluster progress; the live run already recorded
        it, and a catchup replay would re-stamp old heights with NOW)."""
        if self._trace and not self.replay_mode:
            causal.point(name, height, round_, **args)

    def _cspan(self, name: str, height: int, round_: int = -1, **args):
        if self._trace and not self.replay_mode:
            return causal.span(name, height, round_, **args)
        return causal.null_span()

    def _point_transition_digest(self, height: int, round_: int) -> None:
        """Stamp the height's transition digest on the causal timeline
        when the divergence recorder is on — a cross-node trace diff
        then localizes a fork to its first divergent height."""
        rec = getattr(self.block_exec, "divergence", None)
        if rec is not None:
            digest = rec.digest_at(height)
            if digest is not None:
                self._cpoint("transition.digest", height, round_,
                             digest=digest[:16])

    def _note_commit(self, height: int, block) -> None:
        """The commit's families, trace instant and causal points."""
        rs = self.rs
        if telemetry.enabled() and not self.replay_mode:
            _m_commits.inc()
            _m_block_txs.observe(len(block.data.txs))
            telemetry.instant("cs:finalize_commit", height=height,
                              round=rs.commit_round,
                              txs=len(block.data.txs))
        self._cpoint("commit", height, rs.commit_round,
                     txs=len(block.data.txs))
        self._point_transition_digest(height, rs.commit_round)

    def _publish(self, event: str, extra: Optional[dict] = None) -> None:
        if self.event_bus is not None and not self.replay_mode:
            obj = self.rs.round_state_event_obj()
            obj.update(extra or {})
            self.event_bus.publish(event, obj)

    # -------------------------------------------------------------- lifecycle

    def _reconstruct_last_commit(self) -> None:
        """Rebuild LastCommit VoteSet from the stored SeenCommit
        (consensus/state.go reconstructLastCommit)."""
        seen = self.block_store.load_seen_commit(self.state.last_block_height)
        if seen is None:
            raise ConsensusFailure(
                f"no seen commit for height {self.state.last_block_height}")
        vs = VoteSet(self.state.chain_id, self.state.last_block_height,
                     seen.round(), VoteType.PRECOMMIT,
                     self.state.last_validators,
                     verifier=self.block_exec.verifier)
        for pc in seen.precommits:
            if pc is not None:
                vs.add_vote(pc)
        if not vs.has_two_thirds_majority():
            raise ConsensusFailure("reconstructed last commit lacks +2/3")
        self.rs.last_commit = vs

    def _update_to_state(self, state: State, initial: bool = False) -> None:
        """consensus/state.go updateToState: move to NewHeight step of
        state.last_block_height+1."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height and not initial and \
                rs.height != state.last_block_height:
            raise ConsensusFailure(
                f"updateToState expected height {rs.height}, "
                f"state has {state.last_block_height}")

        last_precommits = None
        if rs.commit_round > -1 and rs.votes is not None:
            pc = rs.votes.precommits(rs.commit_round)
            if pc is None or not pc.has_two_thirds_majority():
                raise ConsensusFailure(
                    "updateToState: last precommits lack +2/3")
            last_precommits = pc

        height = state.last_block_height + 1
        rs.height = height
        rs.round = 0
        rs.step = Step.NEW_HEIGHT
        if rs.commit_time_ns:
            rs.start_time_ns = rs.commit_time_ns + int(
                self.config.commit_timeout_s() * 1e9)
        else:
            rs.start_time_ns = clock.now_ns() + int(
                self.config.commit_timeout_s() * 1e9)
        rs.validators = state.validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = 0
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, state.validators,
                                 verifier=self.block_exec.verifier)
        rs.commit_round = -1
        if last_precommits is not None:
            rs.last_commit = last_precommits
        rs.last_validators = state.last_validators
        self.state = state
        self._overlap_s = 0.0   # a height's stage accounting restarts
        self._serial_s = 0.0
        self._new_step()

    def _new_step(self) -> None:
        # replayed steps (WAL catchup/handshake) are not new consensus
        # progress — they must not inflate counters or the timeline
        if telemetry.enabled() and not self.replay_mode:
            now = time.perf_counter()
            if self._step_open is not None:
                name, h, r, t0 = self._step_open
                telemetry.TRACER.complete(
                    f"cs:{name}", t0, now, height=h, round=r)
            rs = self.rs
            self._step_open = (rs.step.name, rs.height, rs.round, now)
            _m_steps.labels(rs.step.name).inc()
            _m_height.set(rs.height)
            _m_round.set(rs.round)
        if not self.replay_mode:
            self.wal.save({"type": "round_state",
                           **self.rs.round_state_event_obj()})
        self._publish("NewRoundStep")
        self._broadcast({"type": "new_round_step",
                         **self.rs.round_state_event_obj(),
                         "seconds_since_start_time": 0,
                         "last_commit_round":
                             self.rs.last_commit.round
                             if self.rs.last_commit else -1})

    def _schedule_round0(self) -> None:
        sleep_s = max(0.0, (self.rs.start_time_ns - clock.now_ns()) / 1e9)
        self._schedule_timeout(sleep_s, self.rs.height, 0, Step.NEW_HEIGHT)

    def _schedule_timeout(self, duration_s: float, height: int, round_: int,
                          step: Step) -> None:
        self.ticker.schedule(TimeoutInfo(duration_s, height, round_, step))

    # --------------------------------------------------------------- timeouts

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or \
                (ti.round == rs.round and ti.step < rs.step):
            return  # stale tock
        if ti.step == Step.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == Step.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == Step.PROPOSE:
            self._publish("TimeoutPropose")
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == Step.PREVOTE_WAIT:
            self._publish("TimeoutWait")
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == Step.PRECOMMIT_WAIT:
            self._publish("TimeoutWait")
            self._enter_new_round(ti.height, ti.round + 1)
        else:
            raise ConsensusFailure(f"invalid timeout step {ti.step}")

    # ------------------------------------------------------------ transitions

    def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step != Step.NEW_HEIGHT):
            return
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_accum(round_ - rs.round)
        rs.round = round_
        rs.step = Step.NEW_ROUND
        self._round_t0 = time.perf_counter()
        self._cpoint("height.begin", height, round_)
        rs.validators = validators
        if round_ != 0:
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # room for round-skip votes
        self._publish("NewRound")

        wait_for_txs = (not self.config.create_empty_blocks and round_ == 0
                        and not self._need_proof_block(height))
        if wait_for_txs:
            self._send_proposal_heartbeat(height, round_)
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval,
                    height, round_, Step.NEW_ROUND)
        else:
            self._enter_propose(height, round_)

    def _send_proposal_heartbeat(self, height: int, round_: int) -> None:
        """Signed liveness signal while waiting for transactions
        (consensus/state.go:696,713 proposalHeartbeat), one per
        (height, round) wait entry, as the JAX package sends it."""
        if self.priv_validator is None:
            return
        rs = self.rs
        addr = self.priv_validator.address
        idx, _ = rs.validators.get_by_address(addr)
        if idx < 0:
            return
        hb = Heartbeat(addr, idx, height, round_, sequence=0)
        try:
            self.priv_validator.sign_heartbeat(self.state.chain_id, hb)
        except Exception as e:
            self._log(f"error signing heartbeat: {e!r}")
            return
        self._publish("ProposalHeartbeat", {"heartbeat": hb.to_obj()})
        self._broadcast({"type": "heartbeat", "heartbeat": hb.to_obj()})

    def _need_proof_block(self, height: int) -> bool:
        if height == 1:
            return True
        meta = self.block_store.load_block_meta(height - 1)
        return meta is None or self.state.app_hash != meta.header.app_hash

    def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= Step.PROPOSE):
            return
        if rs.step == Step.NEW_HEIGHT:
            # txs_available shortcut: propose entered straight from the
            # NewHeight wait, bypassing _enter_new_round — this IS the
            # height's work starting
            self._cpoint("height.begin", height, round_)
        try:
            self._schedule_timeout(self.config.propose_timeout_s(round_),
                                   height, round_, Step.PROPOSE)
            if self.priv_validator is None:
                return
            addr = self.priv_validator.address
            if not rs.validators.has_address(addr):
                return
            if rs.validators.proposer().address == addr:
                with self._cspan("propose", height, round_):
                    self._decide_proposal(height, round_)
        finally:
            rs.round = round_
            rs.step = Step.PROPOSE
            self._new_step()
            if self._is_proposal_complete():
                self._enter_prevote(height, rs.round)

    def _decide_proposal(self, height: int, round_: int) -> None:
        rs = self.rs
        parts_iter = None
        if rs.locked_block is not None:
            block, parts = rs.locked_block, rs.locked_block_parts
        else:
            made = self._create_proposal_block()
            if made is None:
                return
            block, parts, parts_iter = made

        pol = rs.votes.pol_info()
        pol_round = pol.round if pol else -1
        pol_block_id = pol.block_id if pol else BlockID()
        proposal = Proposal(height, round_, parts.header(), pol_round,
                            pol_block_id, timestamp_ns=clock.now_ns())
        try:
            self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception as e:
            if not self.replay_mode:
                self._log(f"error signing proposal: {e!r}")
            return
        if self._slo and not self.replay_mode:
            # SLO proposal-inclusion stamp (proposer side; receivers
            # stamp when their part set completes — first wins)
            slo_plane.mark_many(block.data.txs, "propose", height)
        # own proposal + parts ride the same queue as peer messages
        proposal_msg = {"type": "proposal", "proposal": proposal.to_obj()}
        self._enqueue_own(proposal_msg)
        if parts_iter is not None:
            # streaming gossip (pipeline on): the proposal ships first
            # (peers must be able to place the parts), then each part is
            # enqueued and broadcast as it is made
            self._broadcast(proposal_msg)
            with pipeline.stage_timer("gossip") as t:
                for part in parts_iter:
                    part_msg = {"type": "block_part", "height": height,
                                "round": round_, "part": part.to_obj()}
                    self._enqueue_own(part_msg)
                    self._broadcast(part_msg)
            self._serial_s += t.seconds
            return
        # serial path: the part messages are built once for both loops
        part_msgs = [{"type": "block_part", "height": height,
                      "round": round_, "part": parts.get_part(i).to_obj()}
                     for i in range(parts.total)]
        for part_msg in part_msgs:
            self._enqueue_own(part_msg)
        self._broadcast(proposal_msg)
        for part_msg in part_msgs:
            self._broadcast(part_msg)

    def _create_proposal_block(self):
        """consensus/state.go:854 createProposalBlock. Returns
        (block, parts, parts_iter), or None without a commit for the last
        block: parts_iter is a streaming part iterator when the pipeline
        built the set lazily (consume it fully before using `parts` as a
        full set), else None."""
        rs = self.rs
        if rs.height == 1:
            commit = Commit()
        elif rs.last_commit is not None and \
                rs.last_commit.has_two_thirds_majority():
            commit = rs.last_commit.make_commit()
        else:
            self._log("cannot propose: no commit for previous block")
            return None
        txs = self.mempool.reap(self.config.max_block_size_txs)
        evidence = self.evidence_pool.pending_evidence()
        part_size = \
            self.state.consensus_params.block_gossip.block_part_size_bytes
        if self._pipeline:
            pre = self._take_precomputed(rs.height, txs, commit, evidence,
                                         part_size)
            if pre is not None:
                return pre
        block = self.state.make_block(rs.height, txs, commit,
                                      time_ns=clock.now_ns(),
                                      evidence=evidence)
        if not self._pipeline:
            return block, block.make_part_set(part_size), None
        with pipeline.stage_timer("serialize") as t_ser:
            data = block.to_bytes()
        with pipeline.stage_timer("partset") as t_ps:
            parts, parts_iter = PartSet.from_data_streaming(data, part_size)
        self._serial_s += t_ser.seconds + t_ps.seconds
        return block, parts, parts_iter

    # ------------------------------------------------- pipeline: precompute

    def _kick_precompute(self) -> None:
        """While the committed height waits out the commit timeout, build
        the next height's proposal block and part set on a worker
        thread. _create_proposal_block uses it only when the fresh
        mempool reap, commit and evidence still match exactly (anything
        changed: discarded, the serial build runs). Kicked only when this
        node proposes round 0 of the next height."""
        if self.priv_validator is None or self.replay_mode:
            return
        rs = self.rs
        if rs.validators.proposer().address != self.priv_validator.address:
            return
        height, state = rs.height, self.state
        if height == 1:
            commit = Commit()
        elif rs.last_commit is not None and \
                rs.last_commit.has_two_thirds_majority():
            # the commit is taken on the consensus thread: the VoteSet
            # may gain late precommits while the worker runs (the
            # propose-time compare catches that and discards)
            commit = rs.last_commit.make_commit()
        else:
            return
        part_size = \
            state.consensus_params.block_gossip.block_part_size_bytes
        max_txs = self.config.max_block_size_txs

        def work():
            try:
                t0 = time.perf_counter()
                txs = self.mempool.reap(max_txs)
                evidence = self.evidence_pool.pending_evidence()
                block = state.make_block(height, txs, commit,
                                         time_ns=clock.now_ns(),
                                         evidence=evidence)
                parts = PartSet.from_data(block.to_bytes(), part_size)
                seconds = time.perf_counter() - t0
                pipeline.observe_stage("precompute", seconds)
                with self._pre_lock:
                    cur = self._precomputed
                    # a slow worker of an earlier height must not replace
                    # a fresher handoff
                    if cur is None or cur["height"] <= height:
                        self._precomputed = {
                            "height": height, "state": state,
                            "part_size": part_size, "block": block,
                            "parts": parts, "seconds": seconds}
            except Exception:
                pipeline.note_precompute("failed")

        threading.Thread(target=work, daemon=True,
                         name="cs-precompute").start()

    def _take_precomputed(self, height: int, txs, commit, evidence,
                          part_size: int):
        """The precomputed (block, parts, None) when it matches exactly
        what the serial build would make now; else None (and the stale
        entry is dropped). The block's header time is the worker's
        stamp, carried verbatim in the gossiped block."""
        with self._pre_lock:
            pre, self._precomputed = self._precomputed, None
        if pre is None:
            return None
        block = pre["block"]
        if (pre["height"] != height or pre["state"] is not self.state
                or pre["part_size"] != part_size
                or block.data.txs != list(txs)
                or block.last_commit.to_bytes() != commit.to_bytes()
                or block.evidence.to_obj()
                != EvidenceData(list(evidence or [])).to_obj()):
            pipeline.note_precompute("discarded")
            return None
        pipeline.note_precompute("used")
        self._overlap_s += pre["seconds"]
        return block, pre["parts"], None

    def _is_proposal_complete(self) -> bool:
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        pv = rs.votes.prevotes(rs.proposal.pol_round)
        return pv is not None and pv.has_two_thirds_majority()

    def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= Step.PREVOTE):
            return
        if self._is_proposal_complete():
            self._publish("CompleteProposal")
        self._do_prevote(height, round_)
        rs.round = round_
        rs.step = Step.PREVOTE
        self._new_step()

    def _do_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.locked_block is not None:
            self._sign_add_vote(VoteType.PREVOTE, rs.locked_block.hash(),
                                rs.locked_block_parts.header())
            return
        if rs.proposal_block is None:
            self._sign_add_vote(VoteType.PREVOTE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except BlockValidationError as e:
            self._log(f"prevote nil: invalid proposal block: {e}")
            self._sign_add_vote(VoteType.PREVOTE, b"", PartSetHeader())
            return
        self._sign_add_vote(VoteType.PREVOTE, rs.proposal_block.hash(),
                            rs.proposal_block_parts.header())

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= Step.PREVOTE_WAIT):
            return
        pv = rs.votes.prevotes(round_)
        if pv is None or not pv.has_two_thirds_any():
            raise ConsensusFailure(
                f"enterPrevoteWait({height}/{round_}) without any +2/3")
        rs.round = round_
        rs.step = Step.PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(self.config.prevote_timeout_s(round_),
                               height, round_, Step.PREVOTE_WAIT)

    def _enter_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= Step.PRECOMMIT):
            return

        def done():
            rs.round = round_
            rs.step = Step.PRECOMMIT
            self._new_step()

        pv = rs.votes.prevotes(round_)
        maj = pv.two_thirds_majority() if pv is not None else None

        if maj is None:
            # no polka: precommit nil
            self._sign_add_vote(VoteType.PRECOMMIT, b"", PartSetHeader())
            done()
            return

        self._publish("Polka")
        if not maj.is_zero():
            self._cpoint("quorum.prevote", height, round_)

        if maj.is_zero():
            # +2/3 prevoted nil: unlock and precommit nil
            if rs.locked_block is not None:
                rs.locked_round = 0
                rs.locked_block = None
                rs.locked_block_parts = None
                self._publish("Unlock")
            self._sign_add_vote(VoteType.PRECOMMIT, b"", PartSetHeader())
            done()
            return

        if rs.locked_block is not None and \
                rs.locked_block.hash() == maj.hash:
            # relock
            rs.locked_round = round_
            self._publish("Relock")
            self._sign_add_vote(VoteType.PRECOMMIT, maj.hash, maj.parts)
            done()
            return

        if rs.proposal_block is not None and \
                rs.proposal_block.hash() == maj.hash:
            # lock the proposal block
            try:
                self.block_exec.validate_block(self.state, rs.proposal_block)
            except BlockValidationError as e:
                raise ConsensusFailure(
                    f"+2/3 prevoted an invalid block: {e}") from e
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            self._publish("Lock")
            self._sign_add_vote(VoteType.PRECOMMIT, maj.hash, maj.parts)
            done()
            return

        # polka for a block we don't have: unlock, fetch it, precommit nil
        rs.locked_round = 0
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or \
                not rs.proposal_block_parts.has_header(maj.parts):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet.from_header(maj.parts)
        self._publish("Unlock")
        self._sign_add_vote(VoteType.PRECOMMIT, b"", PartSetHeader())
        done()

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= Step.PRECOMMIT_WAIT):
            return
        pc = rs.votes.precommits(round_)
        if pc is None or not pc.has_two_thirds_any():
            raise ConsensusFailure(
                f"enterPrecommitWait({height}/{round_}) without any +2/3")
        rs.round = round_
        rs.step = Step.PRECOMMIT_WAIT
        self._new_step()
        self._schedule_timeout(self.config.precommit_timeout_s(round_),
                               height, round_, Step.PRECOMMIT_WAIT)

    def _enter_commit(self, height: int, commit_round: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step >= Step.COMMIT:
            return
        pc = rs.votes.precommits(commit_round)
        maj = pc.two_thirds_majority() if pc is not None else None
        if maj is None:
            raise ConsensusFailure("enterCommit expects +2/3 precommits")
        self._cpoint("quorum.precommit", height, commit_round)

        if rs.locked_block is not None and rs.locked_block.hash() == maj.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or rs.proposal_block.hash() != maj.hash:
            if rs.proposal_block_parts is None or \
                    not rs.proposal_block_parts.has_header(maj.parts):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet.from_header(maj.parts)

        rs.step = Step.COMMIT
        rs.commit_round = commit_round
        rs.commit_time_ns = clock.now_ns()
        if telemetry.enabled() and self._round_t0 and not self.replay_mode:
            _m_round_dur.observe(time.perf_counter() - self._round_t0)
        self._new_step()
        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height:
            raise ConsensusFailure("tryFinalizeCommit height mismatch")
        pc = rs.votes.precommits(rs.commit_round)
        maj = pc.two_thirds_majority() if pc is not None else None
        if maj is None or maj.is_zero():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != maj.hash:
            return  # don't have the block yet
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step != Step.COMMIT:
            return
        pc = rs.votes.precommits(rs.commit_round)
        maj = pc.two_thirds_majority()
        block, parts = rs.proposal_block, rs.proposal_block_parts
        if not parts.has_header(maj.parts):
            raise ConsensusFailure("parts header != commit header")
        if block.hash() != maj.hash:
            raise ConsensusFailure("block hash != commit hash")
        try:
            self.block_exec.validate_block(self.state, block)
        except BlockValidationError as e:
            raise ConsensusFailure(f"+2/3 committed invalid block: {e}") from e

        if self._pipeline:
            self._finalize_commit_pipelined(height, block, parts, pc)
            return
        fail.fail_point("consensus.before_save_block")
        if self.block_store.height() < block.header.height:
            with self._cspan("flush", height):
                self.block_store.save_block(block, parts, pc.make_commit())

        fail.fail_point("consensus.before_wal_end_height")
        # ENDHEIGHT marks the WAL before ApplyBlock: if we crash between
        # the two, handshake replay redoes ApplyBlock (consensus/replay.go)
        with self._cspan("wal.fsync", height):
            self.wal.save_end_height(height)
        fail.fail_point("consensus.after_wal_end_height")

        block_id = BlockID(block.hash(), parts.header())
        new_state = self.block_exec.apply_block(
            self.state.copy(), block_id, block)
        fail.fail_point("consensus.after_apply_block")

        if self.decided_hook is not None:
            self.decided_hook(block)
        self._run_post_commit_hooks(new_state)
        self._note_commit(height, block)

        self._update_to_state(new_state)
        self._schedule_round0()

    def _run_post_commit_hooks(self, new_state) -> None:
        for hook in self.post_commit_hooks:
            try:
                hook(new_state)
            except Exception as e:
                # a simulated crash at a snapshot fail point is a
                # BaseException and passes through
                self.logger.error("post-commit hook failed",
                                  height=new_state.last_block_height,
                                  err=repr(e))

    def _finalize_commit_pipelined(self, height: int, block, parts,
                                   pc) -> None:
        """Group-commit finalize (pipeline on): every store write of the
        height (save_block, save_abci_responses, save_state) is staged
        into one GroupCommit and flushed as one batch a db after
        ApplyBlock, then the height's one WAL fsync (the ENDHEIGHT
        marker). Crash ordering:

        - before the flush: nothing of height H is on disk; the WAL tail
          after ENDHEIGHT(H-1) holds every input of H, so catchup replay
          decides and commits it again.
        - between the flush and ENDHEIGHT: the stores hold H, the WAL
          has no marker for it; catchup finds no tail and is skipped,
          and the node proposes H+1.
        - mid-flush: the block db commits before the state db
          (registration order), so a torn flush leaves store_height ==
          state_height + 1, the handshake's replay-forward case.

        Events fire only after the flush (GroupCommit.after_flush)."""
        fail.fail_point("consensus.before_save_block")
        group = pipeline.GroupCommit()
        if self.block_store.height() < block.header.height:
            # staged first: the block db flushes before the state db
            BlockStore(group.staged(self.block_store.db)).save_block(
                block, parts, pc.make_commit())

        block_id = BlockID(block.hash(), parts.header())
        with pipeline.stage_timer("apply") as t_apply:
            # pre_validated: _finalize_commit just validated this exact
            # (state, block) pair; the commit is not verified twice
            new_state = self.block_exec.apply_block(
                self.state.copy(), block_id, block, group=group,
                pre_validated=True)
        fail.fail_point("consensus.before_group_flush")
        with pipeline.stage_timer("persist") as t_persist:
            with self._cspan("flush", height):
                group.flush()
            fail.fail_point("consensus.after_group_flush")
            fail.fail_point("consensus.before_wal_end_height")
            with self._cspan("wal.fsync", height):
                self.wal.save_end_height(height)  # the height's one fsync
        fail.fail_point("consensus.after_wal_end_height")
        fail.fail_point("consensus.after_apply_block")
        self._serial_s += t_apply.seconds + t_persist.seconds

        if self.decided_hook is not None:
            self.decided_hook(block)
        self._run_post_commit_hooks(new_state)
        if not self.replay_mode:
            pipeline.observe_overlap(self._overlap_s,
                                     self._overlap_s + self._serial_s)
        self._note_commit(height, block)

        self._update_to_state(new_state)
        self._kick_precompute()
        self._schedule_round0()

    # ------------------------------------------------------------- proposals

    def _set_proposal(self, proposal: Proposal) -> None:
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if rs.step >= Step.COMMIT:
            return
        if proposal.pol_round != -1 and not \
                (0 <= proposal.pol_round < proposal.round):
            raise ValueError("invalid proposal POL round")
        proposer = rs.validators.proposer()
        if not self.block_exec.verifier.verify_one(
                proposer.pubkey, proposal.sign_bytes(self.state.chain_id),
                proposal.signature):
            raise ValueError("invalid proposal signature")
        self._cpoint("proposal.recv", proposal.height, proposal.round)
        rs.proposal = proposal
        if rs.proposal_block_parts is None or \
                not rs.proposal_block_parts.has_header(
                    proposal.block_parts_header):
            rs.proposal_block_parts = PartSet.from_header(
                proposal.block_parts_header)

    def _add_proposal_block_part(self, height: int, part: Part) -> None:
        rs = self.rs
        if rs.height != height:
            return
        if rs.proposal_block_parts is None:
            return
        added = rs.proposal_block_parts.add_part(part)
        if added and self._trace:
            if rs.proposal_block_parts.count == 1:
                self._cpoint("part.first", height, rs.round)
            if rs.proposal_block_parts.is_complete():
                self._cpoint("block.full", height, rs.round,
                             parts=rs.proposal_block_parts.total)
        if added and rs.proposal_block_parts.is_complete():
            block = Block.from_bytes(rs.proposal_block_parts.get_data())
            rs.proposal_block = block
            if self._slo and not self.replay_mode:
                slo_plane.mark_many(block.data.txs, "propose", height)
            if rs.step == Step.PROPOSE and self._is_proposal_complete():
                self._enter_prevote(height, rs.round)
            elif rs.step == Step.COMMIT:
                self._try_finalize_commit(height)

    # ------------------------------------------------------------------ votes

    def _try_add_vote(self, vote: Vote, peer_id: str) -> None:
        try:
            self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            self._file_duplicate_vote_evidence(vote, e)
        except ValueError as e:
            self._log(f"bad vote from {peer_id!r}: {e}")

    def _file_duplicate_vote_evidence(self, vote: Vote,
                                      e: ConflictingVoteError) -> None:
        if self.priv_validator is not None and \
                vote.validator_address == self.priv_validator.address:
            self._log("conflicting vote from ourselves!")
            return
        ev = DuplicateVoteEvidence(
            pubkey=self._pubkey_of(vote.validator_address),
            vote_a=e.existing, vote_b=e.new)
        self.evidence_pool.add_evidence(ev)

    def _pubkey_of(self, addr: bytes) -> bytes:
        _, val = self.rs.validators.get_by_address(addr)
        return val.pubkey if val is not None else b""

    def _add_vote(self, vote: Vote, peer_id: str) -> None:
        rs = self.rs

        # precommit straggler for the previous height (during NewHeight wait)
        if vote.height + 1 == rs.height:
            if not (rs.step == Step.NEW_HEIGHT and
                    vote.type == VoteType.PRECOMMIT):
                return
            if rs.last_commit is None:
                return
            try:
                added_lc = rs.last_commit.add_vote(vote)
            except ConflictingVoteError as e:
                # same (added, err) pairing as the current-height path:
                # a counted conflicting straggler must still publish
                self._file_duplicate_vote_evidence(vote, e)
                added_lc = e.added
            if added_lc:
                self._publish_vote(vote)
                if self.config.skip_timeout_commit and \
                        rs.last_commit.has_all():
                    # zero-duration timeout, NOT a direct call: the next
                    # height must start from the input queue, or a fast
                    # chain would run forever inside one submit()
                    self._schedule_timeout(0.0, rs.height, 0, Step.NEW_HEIGHT)
            return

        if vote.height != rs.height:
            return  # height mismatch: ignore

        try:
            added = rs.votes.add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            # The reference's AddVote returns (added, err) TOGETHER: a
            # conflicting vote for a peer-claimed maj23 block is counted
            # AND reported. File the evidence here, then — when it was
            # counted — fall through to the normal quorum-driven
            # transitions below.
            self._file_duplicate_vote_evidence(vote, e)
            if not e.added:
                return
            added = True
        if not added:
            return
        self._publish_vote(vote)
        self._post_add_vote(vote)

    def _post_add_vote(self, vote: Vote) -> None:
        """Quorum-driven transitions after a vote of the CURRENT height
        was counted — shared by the scalar add path above and the
        aggregated bulk path (_try_add_votes), which runs these per
        applied vote so a quorum formed mid-batch acts immediately."""
        rs = self.rs
        height = rs.height

        if vote.type == VoteType.PREVOTE:
            prevotes = rs.votes.prevotes(vote.round)
            # unlock on a newer polka for a different block
            if rs.locked_block is not None and \
                    rs.locked_round < vote.round <= rs.round:
                maj = prevotes.two_thirds_majority()
                if maj is not None and rs.locked_block.hash() != maj.hash:
                    rs.locked_round = 0
                    rs.locked_block = None
                    rs.locked_block_parts = None
                    self._publish("Unlock")
            if rs.round <= vote.round and prevotes.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
                if prevotes.has_two_thirds_majority():
                    self._enter_precommit(height, vote.round)
                else:
                    self._enter_prevote(height, vote.round)
                    self._enter_prevote_wait(height, vote.round)
            elif rs.proposal is not None and \
                    0 <= rs.proposal.pol_round == vote.round:
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)

        elif vote.type == VoteType.PRECOMMIT:
            precommits = rs.votes.precommits(vote.round)
            maj = precommits.two_thirds_majority()
            if maj is not None:
                if maj.is_zero():
                    self._enter_new_round(height, vote.round + 1)
                else:
                    self._enter_new_round(height, vote.round)
                    self._enter_precommit(height, vote.round)
                    self._enter_commit(height, vote.round)
                    if self.config.skip_timeout_commit and \
                            precommits.has_all():
                        # see straggler path above: schedule, don't recurse
                        self._schedule_timeout(
                            0.0, self.rs.height, 0, Step.NEW_HEIGHT)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
                self._enter_precommit(height, vote.round)
                self._enter_precommit_wait(height, vote.round)

    def _try_add_votes(self, votes: List[Vote], peer_id: str) -> None:
        """Aggregated vote ingestion (vote_agg): current-height votes are
        grouped by (round, type) and each group feeds
        HeightVoteSet.add_votes — VoteSet.add_votes_batch underneath, ONE
        verifier dispatch per group instead of one per vote. Stragglers
        and off-height votes take the scalar path, which already
        classifies them. A commit triggered by an early vote in the batch
        advances rs.height mid-loop; remaining groups then re-enter
        through the scalar path, where votes for the just-committed
        height are reclassified as last-commit stragglers instead of
        corrupting the new height's sets."""
        if not votes:
            return
        if len(votes) == 1:
            self._try_add_vote(votes[0], peer_id)
            return
        h0 = self.rs.height
        groups: dict = {}
        rest: List[Vote] = []
        for v in votes:
            if v is not None and v.height == h0:
                groups.setdefault((v.round, v.type), []).append(v)
            else:
                rest.append(v)
        for v in rest:
            self._try_add_vote(v, peer_id)
        for (round_, type_), group in groups.items():
            if self.rs.height != h0 or len(group) == 1:
                for v in group:
                    self._try_add_vote(v, peer_id)
                continue
            with self._cspan("votes.agg", h0, round_,
                             votes=len(group), vtype=int(type_)):
                try:
                    results, errors = self.rs.votes.add_votes(
                        round_, type_, group, peer_id)
                except ValueError as e:
                    self._log(f"bad vote batch from {peer_id!r}: {e}")
                    continue
            compact.note_agg_applied(len(group))
            for pos, err in errors:
                if isinstance(err, ConflictingVoteError):
                    self._file_duplicate_vote_evidence(group[pos], err)
                else:
                    self._log(f"bad vote from {peer_id!r}: {err}")
            for v, added in zip(group, results):
                if not added:
                    continue
                self._publish_vote(v)
                if self.rs.height == h0:
                    # a transition fired by an earlier vote may have
                    # committed the height — stale post-processing
                    # against the NEW height's sets must not run
                    self._post_add_vote(v)

    def _publish_vote(self, vote: Vote) -> None:
        if self.event_bus is not None and not self.replay_mode:
            self.event_bus.publish_vote(vote)
        self._broadcast({"type": "has_vote", "height": vote.height,
                         "round": vote.round, "vote_type": vote.type,
                         "index": vote.validator_index})

    def _sign_add_vote(self, type_: int, hash_: bytes,
                       parts_header: PartSetHeader) -> None:
        rs = self.rs
        if self.priv_validator is None:
            return
        addr = self.priv_validator.address
        idx, _ = rs.validators.get_by_address(addr)
        if idx < 0:
            return
        vote = Vote(addr, idx, rs.height, rs.round,
                    clock.now_ns(), type_, BlockID(hash_, parts_header))
        try:
            self.priv_validator.sign_vote(self.state.chain_id, vote)
        except Exception as e:
            if not self.replay_mode:
                self._log(f"error signing vote: {e!r}")
            return
        self._enqueue_own({"type": "vote", "vote": vote.to_obj()})
        self._broadcast({"type": "vote", "vote": vote.to_obj()})
