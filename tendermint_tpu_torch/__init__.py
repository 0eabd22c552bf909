"""tendermint_tpu_torch: the PyTorch and CUDA port of tendermint_tpu.

The JAX package `tendermint_tpu` is the reference; this package imports
nothing of it (nor jax), keeps its own copy of what it needs, and runs on
an NVIDIA H100. Its entry points run on the card unless the caller passes
`device="cpu"`, which runs the plain PyTorch versions of the kernels.

Slice 1 is batched Ed25519 commit verification:

  types/validator_set.ValidatorSet.verify_commit
    -> models/verifier.BatchVerifier
    -> ops/ed25519 (host prep, predecompression cache, routing)
    -> ops/ladder (plain versions + launchers)
    -> csrc/ladder.cu (the hand-written Hopper kernels)

Slice 2 is light-client chain certification:

  ops/ed25519.sign_batch_async (host nonces and finish)
    -> ops/ladder.sign_rb -> csrc/ladder.cu (the r*B kernel)
  lite/certifier.certify_chain -> BatchVerifier -> the verify kernels

Slice 7 is the block plane: a block built, split into a Merkle-proven
part set, rebuilt by a receiver, voted on through VoteSet (one
verify_async a batch of votes), committed, and its evidence checked;
and the SHA-256 / Merkle device plane in plain PyTorch.

Slice 8 is fast sync: a fresh node downloads a chain through the block
pool and the reactor's window engine, which verifies every commit
signature of a window in one verify_async and applies the previous
window (block store, validation, the kvstore app, state store) while
the card verifies.

  blockchain/reactor.BlockchainReactor._sync_window
    -> models/verifier.BatchVerifier.verify_async -> the verify kernels
    -> state/execution.BlockExecutor.apply_block -> abci/ kvstore app
    -> storage/ block and state stores

  ops/      field, curve, ladder, ed25519, merkle (host and device
            halves), sha256, kernel build
  csrc/     fe25519.cuh (arithmetic), ladder.cu (kernels), cpu_shim.cpp,
            prep.cpp (native host prep)
  types/    keys, encoding, vote, block (Block, Header, Data, Commit,
            EvidenceData, BlockID), part_set, vote_set, evidence,
            validator_set, params, genesis, proposal, priv_validator
  models/   verifier
  lite/     certifiers, providers, SignedHeader / FullCommit
  storage/  MemDB / SQLiteDB, BlockStore, StateStore
  state/    State, validation, BlockExecutor
  abci/     results, BaseApplication, LocalClient, AppConns, kvstore app
  blockchain/  BlockPool, BlockchainReactor, ChainBuilder
  p2p/      the flow-rate monitor
  utils/    ed25519_ref, ed25519_fast, secp256k1_ref, clock, device
  convert.py  the JAX package's tables and cache rows, and its blocks,
              votes, validator sets, genesis docs, chain states and
              kvstore apps by their objects
"""

__version__ = "0.1.0"
