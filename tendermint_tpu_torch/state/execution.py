"""BlockExecutor, the only path that mutates replicated state: the port's
copy of `tendermint_tpu/state/execution.py` (state/execution.go:21-382).

apply_block: validate → execute txs on the ABCI consensus connection →
save ABCI responses → update validator set / params from EndBlock →
Commit the app with the mempool locked → save state.
exec_commit_block is the stateless variant of handshake replay
(state/execution.go:368).

After the app commit and the state save, `fire_events` publishes the
block, its header and one Tx event a tx on the executor's event bus.
With a `group` (pipeline.GroupCommit, the pipelined finalize) the store
writes are staged into it and the events wait for its flush. The four
`execution.*` fail points (utils/fail.py) sit where the JAX package has
them.

`apply_block` runs inside the causal `apply` span; with TM_CUDA_DIVERGENCE
on, the executor carries a `DigestRecorder` (analysis/divergence.py) that
folds each applied height into the transition-digest stream, and
`fire_events` stamps the SLO plane's `commit` stage.
"""

from __future__ import annotations

from typing import List, Optional, Protocol

from tendermint_tpu_torch.abci.types import (ResultDeliverTx,
                                             UniformDeliverResults,
                                             ValidatorUpdate)
from tendermint_tpu_torch.models.verifier import default_verifier
from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.validation import validate_block
from tendermint_tpu_torch.storage.state_store import StateStore
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.block import Block, BlockID
from tendermint_tpu_torch.types.validator_set import Validator
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.telemetry import slo
from tendermint_tpu_torch.utils import fail


class Mempool(Protocol):
    """What consensus needs from a mempool (types/services.go:21)."""

    def lock(self) -> None: ...
    def unlock(self) -> None: ...
    def size(self) -> int: ...
    def check_tx(self, tx: bytes) -> object: ...
    def reap(self, max_txs: int) -> List[bytes]: ...
    def update(self, height: int, txs: List[bytes]) -> None: ...
    def flush(self) -> None: ...


class MockMempool:
    """No-op mempool (types/services.go:38)."""

    def lock(self) -> None: ...
    def unlock(self) -> None: ...
    def size(self) -> int: return 0
    def check_tx(self, tx: bytes) -> object: return None
    def reap(self, max_txs: int) -> List[bytes]: return []
    def update(self, height: int, txs: List[bytes]) -> None: ...
    def flush(self) -> None: ...


class EvidencePool(Protocol):
    """types/services.go:80."""

    def pending_evidence(self) -> List: ...
    def add_evidence(self, ev) -> None: ...
    def update(self, block: Block, state=None) -> None: ...


class MockEvidencePool:
    def pending_evidence(self) -> List: return []
    def add_evidence(self, ev) -> None: ...
    def update(self, block: Block, state=None) -> None: ...


def results_hash(results: List[ResultDeliverTx]) -> bytes:
    """Deterministic hash of (code, data) per tx → LastResultsHash
    (types/results.go:20-49). Uniform results (every leaf identical)
    hash one leaf and merkleize the repeated digest."""
    if getattr(results, "uniform", False) and len(results) > 0:
        leaf = encoding.cdumps({"code": results.code,
                                "data": results.data.hex()})
        return merkle.root_from_repeated_digest(
            merkle.leaf_hash(leaf), len(results))
    leaves = [encoding.cdumps({"code": r.code, "data": r.data.hex()})
              for r in results]
    return merkle.root_host(leaves)


class ABCIResponses:
    """Responses from one block's execution; persisted for replay without
    the app and the results hash (state/store.go:127)."""

    def __init__(self, deliver_txs: List[ResultDeliverTx],
                 end_block_obj: dict):
        self.deliver_txs = deliver_txs
        self.end_block_obj = end_block_obj

    def results_hash(self) -> bytes:
        return results_hash(self.deliver_txs)

    def to_obj(self):
        dt = self.deliver_txs
        if getattr(dt, "uniform", False):
            # the compact form: one template and the packed keys
            return {"deliver_txs_uniform": dt.to_compact_obj(),
                    "end_block": self.end_block_obj}
        return {"deliver_txs": [r.to_obj() for r in self.deliver_txs],
                "end_block": self.end_block_obj}

    @classmethod
    def from_obj(cls, o):
        if "deliver_txs_uniform" in o:
            return cls(UniformDeliverResults.from_compact_obj(
                o["deliver_txs_uniform"]), o["end_block"])
        return cls([ResultDeliverTx.from_obj(r) for r in o["deliver_txs"]],
                   o["end_block"])


def exec_block_on_app(app_conn, block: Block,
                      valset=None) -> ABCIResponses:
    """BeginBlock → batched DeliverTx → EndBlock
    (state/execution.go:163-241). Absent validators = those whose precommit
    is missing from LastCommit."""
    absent = []
    if valset is not None and block.last_commit.size() > 0:
        absent = [i for i, pc in enumerate(block.last_commit.precommits)
                  if pc is None]
    app_conn.begin_block(block.hash(), block.header.to_obj(),
                         absent_validators=absent)
    deliver_txs = app_conn.deliver_tx_batch(block.data.txs)
    end = app_conn.end_block(block.header.height)
    return ABCIResponses(deliver_txs, end.to_obj())


class ApplyBlockError(RuntimeError):
    """Unrecoverable failure applying a DECIDED block (the reference
    panics: consensus/state.go:1214-1220 / execution error paths)."""


class BlockExecutor:
    def __init__(self, state_store, app_conn_consensus,
                 mempool: Optional[Mempool] = None,
                 evidence_pool: Optional[EvidencePool] = None,
                 event_bus=None, verifier=None):
        """`verifier` None takes the port's `default_verifier()` (on the
        card; it raises where there is none)."""
        self.state_store = state_store
        self.app_conn = app_conn_consensus
        self.mempool = mempool or MockMempool()
        self.evidence_pool = evidence_pool or MockEvidencePool()
        self.event_bus = event_bus
        self.verifier = verifier if verifier is not None \
            else default_verifier()
        # transition-digest stream behind TM_CUDA_DIVERGENCE
        # (analysis/divergence.py); None keeps the hot path untouched
        from tendermint_tpu_torch.analysis import divergence
        self.divergence = divergence.maybe_recorder()

    def validate_block(self, state: State, block: Block,
                       trust_last_commit: bool = False) -> None:
        validate_block(state, block, state_store=self.state_store,
                       verifier=self.verifier,
                       trust_last_commit=trust_last_commit)

    def apply_block(self, state: State, block_id: BlockID,
                    block: Block, trust_last_commit: bool = False,
                    group=None, pre_validated: bool = False) -> State:
        """state/execution.go:71-119. Returns the new State; raises
        BlockValidationError on an invalid block. `trust_last_commit`:
        see validation.validate_block (fast sync's pre-verified path).

        `group` (a pipeline.GroupCommit) stages the height's store writes
        (save_abci_responses, save_state) into the group instead of
        committing each one (the caller flushes once after this
        returns), and defers the event fan-out to after that flush:
        subscribers never see a block the stores could still lose to a
        crash. The app Commit and mempool order are unchanged.

        `pre_validated=True` skips validation for a caller that just ran
        validate_block on the same (state, block) pair."""
        with causal.span("apply", block.header.height,
                         txs=len(block.data.txs)):
            return self._apply_block(state, block_id, block,
                                     trust_last_commit, group,
                                     pre_validated)

    def _apply_block(self, state, block_id, block, trust_last_commit,
                     group, pre_validated) -> State:
        if not pre_validated:
            self.validate_block(state, block,
                                trust_last_commit=trust_last_commit)
        responses = exec_block_on_app(self.app_conn, block,
                                      state.validators)
        fail.fail_point("execution.after_exec_block")
        state_store = self.state_store
        if group is not None and state_store is not None:
            state_store = StateStore(group.staged(self.state_store.db))
        if state_store is not None:
            state_store.save_abci_responses(
                block.header.height, responses.to_obj())
        fail.fail_point("execution.after_save_abci_responses")
        new_state = update_state(state, block_id, block, responses)

        # Commit app + update mempool under the mempool lock
        # (state/execution.go:125-156): no CheckTx may interleave
        # between app Commit and mempool.update.
        self.mempool.lock()
        try:
            app_hash = self.app_conn.commit()
            self.mempool.update(block.header.height, block.data.txs)
        finally:
            self.mempool.unlock()

        fail.fail_point("execution.after_app_commit")
        new_state.app_hash = app_hash
        if self.divergence is not None:
            self.divergence.record(block, responses, new_state)
        if state_store is not None:
            state_store.save(new_state)
        fail.fail_point("execution.after_save_state")
        self.evidence_pool.update(block, new_state)
        if self.event_bus is not None:
            if group is None:
                fire_events(self.event_bus, block, block_id, responses)
            else:
                bus = self.event_bus
                group.after_flush(
                    lambda: fire_events(bus, block, block_id, responses))
        return new_state

    def exec_commit_block(self, block: Block) -> bytes:
        """Execute + commit WITHOUT state updates — handshake replay
        (state/execution.go:368)."""
        exec_block_on_app(self.app_conn, block)
        return self.app_conn.commit()


def update_state(state: State, block_id: BlockID, block: Block,
                 responses: ABCIResponses) -> State:
    """state/execution.go:286-338: next State value (app_hash filled by
    caller after app Commit).

    An invalid app-supplied update (e.g. removing an unknown validator)
    raises ApplyBlockError: unrecoverable determinism loss for a DECIDED
    block, not a bad block or peer message (the reference panics on
    ApplyBlock errors).
    """
    h = block.header.height
    end = responses.end_block_obj

    validators = state.validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    updates = [ValidatorUpdate.from_obj(u)
               for u in end.get("validator_updates", [])]
    if updates:
        try:
            validators = validators.update_with_changes(
                [Validator(u.pubkey, u.power) for u in updates])
        except ValueError as e:
            raise ApplyBlockError(
                f"validator update failed at height {h}: {e}") from e
        last_height_vals_changed = h + 1

    params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    if end.get("consensus_param_updates"):
        params = params.update(end["consensus_param_updates"])
        params.validate()
        last_height_params_changed = h + 1

    validators.increment_accum(1)

    new_state = state.copy()
    new_state.last_block_height = h
    new_state.last_block_total_tx = \
        state.last_block_total_tx + block.header.num_txs
    new_state.last_block_id = block_id
    new_state.last_block_time_ns = block.header.time_ns
    # shared, not copied: published sets are immutable (see State.copy)
    new_state.last_validators = state.validators
    new_state.validators = validators
    new_state.last_height_validators_changed = last_height_vals_changed
    new_state.consensus_params = params
    new_state.last_height_consensus_params_changed = last_height_params_changed
    new_state.last_results_hash = responses.results_hash()
    return new_state


def fire_events(event_bus, block: Block, block_id: BlockID,
                responses: ABCIResponses) -> None:
    """state/execution.go:343: NewBlock + NewBlockHeader + one EventTx per
    tx with its DeliverTx result."""
    # SLO commit stamp at the moment the COMMITTED block's events fan
    # out: after the group flush in pipelined mode, after store writes
    # in serial — and strictly before the publish/deliver stamps the
    # per-tx events below produce, so every sampled tx's stage stamps
    # stay monotonic (mark_many short-circuits when nothing is tracked)
    slo.mark_many(block.data.txs, "commit", block.header.height)
    event_bus.publish_new_block(block, block_id)
    event_bus.publish_new_block_header(block.header)
    for i, tx in enumerate(block.data.txs):
        event_bus.publish_tx(block.header.height, i, tx,
                             responses.deliver_txs[i])
