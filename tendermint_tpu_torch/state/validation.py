"""Block-vs-state validation: the port's copy of
`tendermint_tpu/state/validation.py` (state/validation.go).

All header fields are checked against the current State; the block's
LastCommit is verified with ONE batched signature verification
(state/validation.go:69 → the VerifyCommit hot loop, here
ValidatorSet.verify_commit on the BatchVerifier); evidence is verified
against the historical validator set of its height.
"""

from __future__ import annotations

from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types.block import Block


class BlockValidationError(Exception):
    pass


class EvidenceTooOldError(BlockValidationError):
    """Evidence aged past the window — a normal gossip race, not an
    attack; peers relaying it are not punished."""
    pass


def validate_block(state: State, block: Block, state_store=None,
                   verifier=None, trust_last_commit: bool = False) -> None:
    """state/validation.go:15-122.

    trust_last_commit=True skips the LastCommit SIGNATURE check (structure
    is still checked) — fast-sync sets it because each commit was already
    batch-verified as block N+1's LastCommit before apply; re-verifying
    inside apply would double every device dispatch."""
    try:
        block.validate_basic()
    except ValueError as e:
        raise BlockValidationError(f"invalid block: {e}") from e
    h = block.header

    def check(cond: bool, what: str, want, got) -> None:
        if not cond:
            raise BlockValidationError(
                f"wrong {what}: expected {want!r}, got {got!r}")

    check(h.chain_id == state.chain_id, "chain_id", state.chain_id, h.chain_id)
    check(h.height == state.last_block_height + 1, "height",
          state.last_block_height + 1, h.height)
    check(h.last_block_id == state.last_block_id, "last_block_id",
          state.last_block_id, h.last_block_id)
    check(h.total_txs == state.last_block_total_tx + h.num_txs, "total_txs",
          state.last_block_total_tx + h.num_txs, h.total_txs)
    check(h.app_hash == state.app_hash, "app_hash",
          state.app_hash.hex(), h.app_hash.hex())
    check(h.last_results_hash == state.last_results_hash, "last_results_hash",
          state.last_results_hash.hex(), h.last_results_hash.hex())
    check(h.validators_hash == state.validators.hash(), "validators_hash",
          state.validators.hash().hex(), h.validators_hash.hex())
    check(h.consensus_hash == state.consensus_params.hash(), "consensus_hash",
          state.consensus_params.hash().hex(), h.consensus_hash.hex())

    # LastCommit: height 1 has none; otherwise +2/3 of LastValidators —
    # the batched signature hot path
    if h.height == 1:
        if block.last_commit.size() != 0:
            raise BlockValidationError("block 1 cannot have a last_commit")
    else:
        if block.last_commit.size() != len(state.last_validators):
            raise BlockValidationError(
                f"last_commit size {block.last_commit.size()} != "
                f"last validators {len(state.last_validators)}")
        if not trust_last_commit:
            try:
                state.last_validators.verify_commit(
                    state.chain_id, state.last_block_id,
                    state.last_block_height, block.last_commit,
                    verifier=verifier)
            except ValueError as e:
                raise BlockValidationError(
                    f"invalid last_commit: {e}") from e

    for ev in block.evidence.evidence:
        verify_evidence(state, ev, state_store, verifier=verifier)


def verify_evidence(state: State, evidence, state_store=None,
                    verifier=None):
    """state/validation.go:90-122: age window + the accused must have been
    a validator at the evidence height (historical valset lookup). Returns
    the accused Validator so callers can read voting power without a
    second valset load."""
    height = state.last_block_height + 1
    ev_height = evidence.height()
    max_age = state.consensus_params.evidence.max_age
    if ev_height < 1 or height - ev_height > max_age:
        raise EvidenceTooOldError(
            f"evidence from height {ev_height} is too old (block {height}, "
            f"max age {max_age})")
    if ev_height > height:
        raise BlockValidationError(
            f"evidence from future height {ev_height} (block {height})")
    if state_store is not None:
        try:
            valset = state_store.load_validators(ev_height)
        except Exception as e:
            raise BlockValidationError(
                f"no validator set stored for evidence height "
                f"{ev_height}: {e}") from e
    else:
        valset = state.validators
    _, val = valset.get_by_address(evidence.address())
    if val is None:
        raise BlockValidationError(
            f"address {evidence.address().hex()} was not a validator at "
            f"height {ev_height}")
    try:
        evidence.verify(state.chain_id, val.pubkey, verifier=verifier)
    except ValueError as e:
        raise BlockValidationError(f"invalid evidence: {e}") from e
    return val
