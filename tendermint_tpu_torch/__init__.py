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

Slice 9 is consensus: four validators decide blocks over an in-process
relay (BASELINE config 1), each signature check on its BlockExecutor's
verifier, with the WAL, crash replay, the mempool, the evidence pool and
the event bus.

  consensus/testnet.Testnet -> consensus/state.ConsensusState
    -> consensus/rstate.HeightVoteSet -> types/vote_set.VoteSet
    -> models/verifier.BatchVerifier -> the fused verify kernel
    -> state/execution.BlockExecutor.apply_block (validate, the kvstore
       app, stores, mempool update, evidence pool, events)

Slice 10 is the p2p plane: config 1 over loopback TCP in one process
(`p2p/socknet.py`) on encrypted switches with the four reactors.

Slice 11 is the node as users run it: `cli.py` (`python -m
tendermint_tpu_torch.cli`) -> node.Node (stores, app conns local or over
the ABCI socket, handshake, mempool, evidence pool, executor, WAL,
consensus, the switch with the reactors, the trust store and PEX, the tx
indexer, the RPC server over HTTP and WebSocket); `procnet.ProcNet`
runs config 1 as OS processes from a `cli testnet` tree.

Slice 14 is the recovery plane: interval snapshots, retention and
pruning behind a safe floor, and state sync, by which a fresh node
joins by a verified snapshot and fast-syncs only the tail.

  statesync/reactor.StateSyncReactor (channel 0x60: offers, manifests,
  chunks) -> apply_restore -> storage/snapshot.light_verify_payload
    -> ValidatorSet.verify_commit -> BatchVerifier -> the verify kernels
    -> the kvstore app's restore_items, BlockStore / StateStore bootstrap

  ops/      field, curve, ladder, ed25519, merkle (host and device
            halves), sha256, kernel build
  csrc/     fe25519.cuh (arithmetic), ladder.cu (kernels), cpu_shim.cpp,
            prep.cpp (native host prep)
  types/    keys, encoding, vote, block (Block, Header, Data, Commit,
            EvidenceData, BlockID), part_set, vote_set, evidence,
            validator_set, params, genesis, proposal, priv_validator,
            events
  models/   verifier
  lite/     certifiers, providers, SignedHeader / FullCommit
  storage/  MemDB / SQLiteDB, BlockStore, StateStore, the consensus WAL,
            snapshots (SnapshotStore, SnapshotManager)
  statesync/  StateSyncReactor, apply_restore, resume_pending_restore
  state/    State, validation, BlockExecutor (and its event firing),
            the tx indexer
  abci/     results, BaseApplication, LocalClient, SocketClient,
            ABCIServer, AppConns, kvstore and counter apps
  consensus/  ConsensusState, HeightVoteSet, tickers, replay and the
            handshake, the WAL generator, the config-1 testnet
  mempool/  CList, TxCache, Mempool
  evidence/ EvidenceStore, EvidencePool
  blockchain/  BlockPool, BlockchainReactor, ChainBuilder
  p2p/      keys, addresses, node info, trust, peers, the switch, the
            links (p2p/conn), PEX (p2p/pex), the socket net
  rpc/      JSON-RPC server, route table and clients
  utils/    ed25519_ref, ed25519_fast, secp256k1_ref, clock, device, log
  config.py   the node's configuration tree and config.json
  node.py, cli.py, procnet.py   the node, its CLI, process nets
  convert.py  the JAX package's tables and cache rows, and its blocks,
              votes, validator sets, genesis docs, chain states and
              kvstore apps by their objects, and a node's files
"""

__version__ = "0.1.0"
