"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and power limit (nvidia-smi), then the build
   of the host prep extension (csrc/prep.cpp with g++ against the
   interpreter's Python.h: compiler, flags, include path, seconds, and
   the SHA-512 it hashes with) and of the CUDA kernels from csrc/ (nvcc),
   with its time and each kernel's registers, stack and spills from the
   ptxas report; the SM count and nvidia-smi's clocks.max.sm, which give
   the integer pipe's rate the kernels' bound is taken at. Beside the
   build nvcc compiles a standalone probe of one and of two chained field
   products; the difference of their SASS is printed as a diagnostic of
   the compiler's overhead: the IMAD issue slots it spends on a product,
   against the SLOTS_PER_MUL the product needs. Beside them one
   interpreter imports what the node processes import, into a bytecode
   cache under the build directory that every process the script starts
   reads (`_share_bytecode`).
2. kernels: a seeded batch of 1024 signatures with edge lanes (valid,
   tampered R / s / message, a pubkey off the curve, x = 0 with the sign
   bit set, y >= p, zero padding) and 256 small-order probe lanes
   (torsion and mixed-order keys, torsion R with s = 0, R with y = p ...
   p + 18, x = 0 with the sign bit and y = p - 1) through both verify
   kernels and their plain PyTorch versions on the card; verdicts must be
   bit-equal to each other and to the oracle. Then the lanes sweep: the
   edge rows tiled to 2048 (the 10k commit's padded tail), 8192 (the main
   path's chunk) and 32768 signatures, each launch timed, held to the
   oracle at every size and to the plain version at 2048 and 8192.
3. commit path: a 10,000-validator commit (seeded keys, signed with the
   port's table signer) through ValidatorSet.verify_commit ->
   BatchVerifier("auto") -> native prep -> CUDA kernels, three times: the
   predecompression cache must walk full -> fill -> hit, and every item
   must take the native prep (`prep_stats`). Then one more hit call,
   its wall split into stages read inside that call, at the functions
   the path itself calls (commit items, native prep, padding, cache-row
   assembly, the six uploads, the kernel launch, the rest of the
   dispatch, the resolver's wait and mask, the power check; the kernels'
   device time from their events), and the hashlib prep on the call's
   items, which must give the same bytes as its native prep. A commit
   with one flipped signature byte must raise "invalid signature in
   commit". Kernel launch counts are zeroed just before and read just
   after: the five calls launch B1 and B2 themselves.
4. mixed commit: the same commit with 16 validators (seeded places) on
   secp256k1 keys, from a cold cache: full -> fill -> hit over the
   Ed25519 chunks, the secp256k1 items verified on the host. Verdicts of
   a copy with four tampered items of each kind are held to the oracles
   (secp256k1_ref on every secp256k1 item, the Ed25519 oracle on the
   tampered ones and a seeded sample). A flipped byte in one secp256k1
   precommit, and the same precommit re-encoded with a non-minimal DER
   integer, must each raise "invalid signature in commit". Launch counts
   zeroed just before, read just after.
5. sign kernel: a seeded batch of 64 and of 1024 scalars with edge values (0, 1, 2,
   L - 1, 2^252, 2^252 - 1, and unreduced ones whose signed recoding
   carries out of the top window: L, L + 1, 2^255, 2^256 - 1, every
   nibble 8) through the r*B kernel (a fixed-base comb) and its plain
   version (the TPU kernel's windowed schedule) on the card; encodings
   must be byte-equal to each other and to the oracle. Then the same rows
   tiled to 4096, 16384 (the signing chunk) and 65536 scalars, each
   launch timed and held to both again; and at 16384 the kernel at one
   window, checked the same way: the one-window time is the floor of
   inverse and encode, the rest of the 64-window time is the 63 comb adds.
6. lite path: a light-client header chain at BASELINE.json config 5's
   width (64 validators of power 10; 4096 headers, the one cut), every
   commit signed through sign_batch_async (native nonce and finish
   phases, r*B on the sign kernel), a seeded sample held against the
   table signer, then certify_chain -> BatchVerifier("auto") -> native
   prep -> verify kernels, whose cache routes must be 1 full, 1 fill, 30
   hit. Launch counts are zeroed before the build and read after the
   certify. Three forgeries must then fail with the JAX package's
   messages: a flipped signature byte, a header changed after signing,
   another trusted set.
7. block height: one consensus height of the 10,000-validator chain of
   phase 3 through the port's block plane. Propose a block of 5,000 txs
   (BASELINE.json config 4's width), with phase 3's commit as its last
   commit and one duplicate-vote evidence: fill_header, its part set at
   ConsensusParams' 65536-byte parts and its block id. Gossip: a receiver
   adds every part through its proof, refuses one with a flipped payload
   byte, and rebuilds the block, whose hash and block id must equal the
   proposer's. Prevotes, then precommits: 10,000 of each signed with
   sign_batch_async (the sign kernel), fed with a flipped signature, a
   duplicate and a conflicting vote through one VoteSet.add_votes_batch,
   which must make one verify_async call that reaches the verify kernels
   and give the expected results and errors, and +2/3 for the block; the
   call's host stages are read inside it. make_commit, verify_commit on
   the card, and its hash in the next header. The evidence through a
   BatchVerifier("cuda") and the default verifier (its host loop at two
   signatures); a forged copy must raise on both. The device Merkle
   plane: merkle.root of the txs against Data.hash, and hash_fixed on a
   seeded uint8[65536, 64] batch against hashlib, each timed beside
   hashlib. Launch counts zeroed at the start of the phase, read at its
   end.
8. fast sync: BASELINE.json config 4's chain (64 validators of power 10,
   5,000 txs a block over 512 keys, ConsensusParams' 65536-byte parts,
   256-block windows), 544 blocks deep instead of 50,000 (the one cut).
   The port's ChainBuilder builds, signs (one sign_batch_async of 64
   a block, B3) and applies 545 blocks; every block is serialized and
   parsed back by Block.from_bytes for the syncing node. A fresh node
   (MemDB stores, the kvstore app, BatchVerifier("auto")) syncs them from
   an instant in-process peer through BlockchainReactor._sync_window from
   a cold predecompression cache: its dispatches must route full then fill
   (the first window's two chunks: B1, then B2) and hit after (B2); the
   synced state, every stored block hash and seen commit must equal the
   chain builder's. Each call's stages are read inside it (collect: part sets
   and ids, commit items; dispatch: native prep, uploads, launches; the
   wait in fut.result(); apply: the power check, save_block,
   validate_block and validate_basic, exec_block_on_app with deliver,
   results_hash, the persisted responses, app commit, state save), with
   the kernels' event ms and the device-busy share; `sync_apply_per_block`
   gives those apply stages a block. Every synced block must take the
   kvstore's native core (kvstore.route_stats), and `sync_native_record`
   (a record, not a check) times one synced block's txs on a fresh
   native and a fresh pure app, and its per-tx responses object through
   the codec and the specification path (equal bytes and hashes are
   required). Then a second node
   syncs 300 blocks from a peer whose block 201 carries a flipped
   signature byte in its last commit: the window must stop at 199 applied
   blocks, height 200 be re-requested, the peer stopped and the window in
   flight dropped; an honest peer then serves the rest and the node must
   reach the chain builder's state at 300. Launch counts zeroed before the
   build, read after the forgery. The sign kernel check of phase 5 also
   runs at 64 scalars, the chain builder's launch.
9. consensus: BASELINE.json config 1, four in-process validators (keys
   of seed bytes([i + 1]) * 32, power 10, the kvstore app, a real mempool,
   evidence pool and event bus each, MockTicker) over a full-mesh relay
   (consensus/testnet.Testnet), node 3 on SQLite stores and a file WAL,
   on the serial commit path (pipeline "off", as phase 10).
   Run A on BatchVerifier("cuda"): 40 heights, 1000 fresh txs fed to
   every mempool before each (check_tx_batch) on a clock stepped one
   second a height; a standby key joins by a val: tx at 10 and leaves at
   20; validator 1's key signs a second prevote at 25 (sent to nodes 0, 2
   and 3), whose evidence must be committed once; a prevote with a
   flipped signature byte reaches node 0 at 30 and must not count; node 3
   crashes after 35 and is rebuilt from its files (the handshake replays
   35 blocks into a fresh app, whose hash must equal the others', then
   the WAL's tail), and follows to 40; then the net drains the
   mempools. Every node must agree on block, app hash and State bytes at
   every height, and every fed tx be committed once. Each height's host
   stages are read inside the calls (reap, make_block, part set, signing,
   Block.from_bytes, Vote.from_obj, verify, the VoteSet add,
   validate_block, save_block, the WAL, apply_block with deliver,
   results_hash, the responses save, app commit, the mempool update and
   recheck, the state save, events); the kernels' event ms beside. Node
   0's last 64 dispatches (calls of its verifier's direct path: since
   the verifier coalesces by default, a merged dispatch on the
   coalescer's thread is one) are held to the plain versions on the
   same card tensors. Run B: the same schedule to 15 on BatchVerifier("auto")
   (the host loop at 1-4 signatures) must give run A's 15 block hashes.
   The schedule is consensus.testnet.run_schedule, the one the CPU tests
   drive. Every check runs on B1 (a batch of 1-4 pads to 8 lanes, below
   the predecompression cache's 64); B2 and B3 must not launch. Launch
   counts zeroed at the start of the phase, read after run A.
10. p2p: BASELINE.json config 1 over loopback TCP (p2p/socknet.py), every
   message between nodes on the port's p2p plane: four validators (keys
   of seed bytes([i + 1]) * 32, power 10, the kvstore app, real mempools,
   evidence pools and event buses, a real TimeoutTicker) with the four
   reactors on encrypted Switches (native burst AEAD, compact block relay
   and vote_agg on), each node dialling the ones built after it as
   persistent peers; bench_testnet.py run_socket's settings (propose 400
   ms + 100 a round, prevote and precommit 200 ms + 100, commit 100 ms,
   1000 txs a block, a mempool of 4000). Every node verifies on its own
   BatchVerifier("cuda"): the port's default verifier ("auto") would take
   its host loop for every call of this path (1-4 signatures, and the
   joiner's 64), and B1 and B2 would not run. A feeder keeps node 0's
   mempool at >= 2000 fresh txs; mempool gossip alone carries them. When
   node 0 commits 8, node 3's links are stopped and its handshakes
   refused; the other three commit 3 more heights alone (30 of 40 power),
   then node 3's handshakes are allowed again, and the persistent redial
   of its peers must bring it back and gossip catch it up. At 34 a fifth
   node (no validator) joins with fast_sync=True and verify_window 16
   blocks; it first downloads the 34 blocks its peers report, then syncs
   them in full windows (16 commits of 3-4 signatures, padded to the
   predecompression cache's 64 lanes: full on B1, then fill on B2),
   switches to consensus and follows; the download stands in for a long
   backlog, where the pool runs ahead of the sync. The feeder stops when
   node 0 commits 40, and the mempools drain. Every switch has a trust
   store, as the JAX node's has: a peer that scores one bad event (node
   3's dropped link) as the first event of a 30 s trust interval bans it
   for 60 s, and then node 3 comes back after the ban (printed as
   banned_by).
   Every node must agree on block hash and State bytes at every height it
   holds, every fed tx be committed once, every frame take the native
   burst AEAD, and node 0's last 64 dispatches equal the plain versions
   on the same card tensors. B1 and B2 must launch, B3 not (launch counts
   zeroed at the start of the phase, read at its end). Prints blocks/s
   and txs/s over heights 5-40, node 0's per-height medians (proposal to
   complete block, prevote and precommit quorum, verify calls, signatures
   a call and ms, apply, validate), frames sealed and opened, frames a
   burst, the AEAD's host us a frame in the net and alone, bytes a
   channel, compact offers, reconstructions, fetches and fallbacks, votes
   a vote_agg, node 3's redial and catch-up, the joiner's download and
   sync walls and blocks/s, and the kernels' event ms and the device-busy
   share in the run: every launch timed by events recorded around it in
   its launching host call (csrc/launch_timer.cpp), the busy share the
   union of those intervals over the phase's wall.
11. processes: BASELINE config 1 as four OS processes, as
   bench_testnet.py run_socket runs it (procnet.ProcNet): `python -m
   tendermint_tpu_torch.cli testnet` writes the tree (4 validators of
   power 10, kvstore, persistent peers, PEX on), each node's config.json
   takes run_socket's settings (propose 400 ms + 100 a round, prevote
   and precommit 200 ms + 100, commit 100 ms, 1000 txs a block, a
   mempool of 4000), verifier_backend "cuda" and the thread plane without
   coalescing (reactor "threads", verifier_coalesce "off", the plane of
   its runs before the event loop, so that they stay comparable) on the
   serial commit path (pipeline "off"; the native codec and kv core run
   in every phase), and
   four `cli node --p2p --no-fast-sync`
   processes start (each a fresh interpreter with its own
   CUDA context; the ladder library is phase 1's, same digest). Two
   feeder threads cast broadcast_tx_batch of 128 txs over the port's
   WSClient to nodes 0 and 1, backing off while num_unconfirmed_txs
   exceeds 3000, until node 0 commits 24. When node 0 commits 8, node 3
   is SIGKILLed by its pid and restarted from its home with fast sync:
   its handshake replays the stored blocks into a fresh app, it syncs
   the heights it missed, switches to consensus and must sign a later
   commit. Then every node must agree on block hash and app hash at
   every height (RPC block metas), no tx be committed twice, 16 seeded
   committed keys answer abci_query on every node, no node but the
   killed one exit early, every node process report B1 launches (node
   3's killed process in the line it printed at the last height it
   committed, every other process in its stop line), and the phase stay
   within 180 s. Prints `procnet` (blocks/s and txs/s over heights 4-20 from the
   block metas, boot seconds, bans from net_info), `procnet_restart`
   (node 3's handshake seconds and blocks from its start line, restart
   to RPC, sync and rejoin seconds, its sync routes), `procnet_kernels`
   (launches, routes, verify calls (submissions), dispatches, and the
   host ms of a dispatch and a call's wait for the verdicts, per
   process; launches summed over all five processes) and
   `procnet_device` (nvidia-smi's utilization.gpu over the feeders'
   window, a coarse figure).
12. the JAX node's default plane: first the coalescer on the card, one
   BatchVerifier("cuda") whose first dispatch is held on a gate while 8
   threads submit 64 single-signature calls (utils/vectors.edge_items'
   lanes and 8 forged ones); released, they must merge into ONE dispatch
   and ONE B1 launch, whose verdicts equal the plain version on the same
   card tensors, each caller's slice its oracle verdict and its own
   direct launch; then a merge whose launch fails must reach all its
   callers as VerifierError. Then phase 11's net and checks on reactor
   "auto" (one event loop a process) and verifier_coalesce "auto", still
   on the serial commit path (pipeline "off") (procnet_loop), with
   node 3 running through (phase 13 restarts it on this plane and
   load): 200 WebSocket subscribers of NewBlock on node 1
   (above the thread server's 100-connection cap), subscribed before
   the boot and read by one selector thread here, must each see every
   height 4-20 in order; a third feeder of 32 WebSocket connections to
   node 2 casts single broadcast_tx_sync calls (the front door's
   TxBatcher merges them), and every tx answered with code 0 must be
   committed exactly once (the mempools drain before the checks); every
   process's thread census (taken before it stops) must show one
   tm-reactor-loop thread and no mconn-, gossip- or mempool-bcast-
   thread; every process's coalescer must report submissions, and its
   counts account for every call (calls = direct calls + merged
   dispatches + fallback re-runs; the calls of the merges sum to the
   submissions). Prints `procnet_loop_coalescer_check`, `procnet_loop`,
   `procnet_loop_kernels` (as procnet_kernels,
   with merged dispatches, calls a merge (mean, maximum) and the loop
   thread's waits for verdicts), `procnet_loop_rpc` (the sync feeder's
   acknowledged and committed txs, node 2's batcher flushes and txs a
   flush, the subscribers' events and drops), `procnet_loop_threads`
   (census and the loop's ticks, callbacks, busy share and longest
   tick), `procnet_loop_device`, and `plane_ab` (phases 11 and 12 side
   by side, and a third run of the same net and load on the loop with
   coalescing off, `procnet_loop_off`, node 3 running through as well,
   which must pass phase 11's checks and launch B1 in every process:
   blocks/s,
   B1 launches a node, calls and host ms a call, the loop's busy share;
   a record, not a check).
13. the JAX node's default commit path (procnet_pipeline): phase 12's
   net, load and checks, with phase 11's SIGKILL and restart of node 3
   and its checks, and pipeline "auto", the node's default (the
   pipelined finalize with group commit, streaming part sets from
   tm_partset_build, the precomputed next proposal; the native codec and
   kv core). Every process must also show one group flush a height it
   committed in consensus (node 3's killed process within one of its
   last printed height; its restarted process between the heights after
   its sync and after its handshake), no failed precompute, every part
   set built natively and every block on the kv core; node 3's restart
   must find its block store at its state's height or one above. Prints
   `procnet_pipeline`, `procnet_pipeline_restart`,
   `procnet_pipeline_kernels`, `procnet_pipeline_commit_path` (each
   process's group flushes, stage ms, precompute outcomes, overlap
   ratio, part sets, codec calls and fallbacks, kvstore routes, B1
   launches), `procnet_pipeline_device` and `pipeline_ab` (phase 12's
   blocks/s beside this one's; a record). Then the crash sweep in this
   process (`procnet_pipeline_crash_sweep`): tests/test_fail_points.py's
   sweep on a single-validator node verifying on the card, crashed at
   each of the ten pipelined fail points that fire without the state
   tree, rebuilt from its files; app hash and every block equal to an
   uncrashed run's, B1 launched.
14. the recovery plane, four arms. `statesync_chain`: bench_sync.py's
   recorded shape (BENCH_sync.json) on the port's ChainBuilder, nothing
   imported from it: 1920 heights, 4 validators, 100 txs a block, every
   tx a new key, one B3 launch a block, and a snapshot at 1900 in 256 KiB
   chunks; two fresh nodes over in-process switches (bench_sync's 64 MB/s
   links), each verifying on BatchVerifier("cuda"): one restores the
   snapshot (StateSyncReactor: discovery, manifest, chunks, apply_restore
   with the light verify on B1) and fast-syncs the tail to 1919, the other
   fast-syncs from genesis. Both must reach 1919 with the source's State
   bytes and app hash, the restored store's base must be 1901 and its pin
   the source's manifest, and the restore must launch B1. Prints the
   build (chunks, bytes, seconds), each arm's seconds split into
   discovery, manifest, fetch, restore (assemble, verify, app install,
   stores) and tail, and the kernels' launches and event ms, timed in the
   launching host call. `statesync_wide`: a snapshot whose commit is phase
   3's 10,000-validator commit, restored by a fresh node from a cold
   predecompression cache (B1 at 10,000 lanes in the light verify); a copy
   with one flipped signature byte must be refused with "invalid
   signature in commit", poisoned, and leave every store as it was.
   `procnet_statesync`: phase 13's net, load (the two feeders, 200
   NewBlock subscribers on node 1, 32 broadcast_tx_sync connections to
   node 2) and defaults, with snapshots every 10 heights, 2 kept and 20
   heights retained on nodes 0-2 (evidence max_age 10 in the genesis);
   node 3 SIGKILLed at 8, wiped with `cli unsafe_reset_all` and
   restarted with --state-sync once nodes 0-2 pass 11; the feeders stop 5
   heights after node 3 signs again. Node 3 must restore a multiple of 10,
   sync the tail, sign again and agree with every node at every height
   above its restore (block metas read every second while the pruning
   nodes hold them); nodes 0-2 must end with both stores pruned above 1,
   never above their latest snapshot, at most 2 snapshots; every
   subscriber must see heights 4-20 in order, sampled fed and
   sync-acknowledged keys be answered by every node (node 0's pruned
   blocks can no longer be counted), one loop thread a process; node 3's
   restarted process must launch B1. Blocks/s over heights 4-20 from the
   watched metas. Prints the rejoin's stages (restart -> RPC -> restored -> synced ->
   signed) and every process's plane counts. `recovery_sweep`:
   tests/test_snapshot.py's crash sweep (snapshot.after_chunk,
   snapshot.before_publish, prune.mid_range) and tests/test_statesync.py's
   restore crashes (statesync.before_apply, statesync.after_restore, here
   inside a Node's start) on a single-validator node verifying on the
   card, each recovering to the uncrashed run's app hash and blocks.
   Launch counts zeroed at the start of each arm, read at its end.
15. the observability plane (`procnet_telemetry`): phase 13's net, on
   the JAX node's defaults with every plane on (base.trace, slo, prof
   and queue_watch on, TM_CUDA_DIVERGENCE=on, TM_CUDA_TRACE_STALL_S=3),
   with a WebSocket subscriber of Tx events on each fed node. At node 0's
   height 14 nodes 2 and 3 are SIGSTOPped for 6 s: /healthz on nodes 0
   and 1 must say stalled during the stop and ok after it, each must
   write one flight-recorder file of the episode, and the chain must
   resume. Before the nodes stop: GET /metrics on each node parses as
   Prometheus text, with the consensus height gauge at the node's
   height; the four causal timelines (dump_height_timeline) merge
   (clock offsets, the stage attribution of heights 4-20 with its
   coverage, verify.dispatch spans a height) and their transition
   digests agree at every height; /slo on each fed node has no
   out-of-order stamp and every sampled tx completed or counted dropped;
   /healthz is ok with its queue table; debug_profile dump has stacks.
   Each process's stop line must hold verifier families equal to its
   plain counts, one dispatch observation a call, B1 launched. B1 at
   the consensus shape (8 lanes) is timed alone with the launch timer
   for the dispatch-vs-kernel split. The divergence replay of seed 7
   runs in two children under PYTHONHASHSEED 1 and 2 on the card, and in
   this process on the card and on the CPU: three equal streams. A
   second run of the same net with telemetry and every plane off gives
   the overhead (blocks/s beside the first run's and phase 13's; not a
   check), and its stop lines' families must stay at zero.
16. the authenticated state tree fed over gRPC and read through `cli lite`
   (`procnet_statetree`): phase 13's net on the JAX node's defaults with
   TM_CUDA_STATE_TREE=on in every node (the kvstore's critbit tree, its
   dirty waves hashed through merkle.sha256_many_host on the node's card)
   and rpc.grpc_laddr on node 2. A burst of 1,200 txs over JSON-RPC to
   node 0 makes a block of 1,000 new keys (the largest wave, on the device
   route); then 8 BroadcastAPIClients send 6 unique txs each to node 2,
   every response committed with CheckTx and DeliverTx codes 0, a height
   and sha256(tx) as its hash. A `cli lite` process on the card reads
   node 0, trusting height 1 from a fresh home: commit, validators and
   block of every height and 8 fed txs with their Merkle proofs, each
   certified (B1 in that process). Every node must agree on block and app
   hash at every height, every fed tx be committed once, and a replay of
   the committed txs through a fresh StateTree on the CPU hashing every
   wave with hashlib must give every header's app hash. A SecureClient
   over a stub of node 0's RPC serving a header with a flipped byte, and
   a commit with a forged signature, must raise CertificationError. Node
   1's abci_query(prove=True) for 16 fed keys and one absent key is
   decoded with statetree.proof_from_bytes and verified against the app
   hash of the lite-certified header above its version; a flipped value
   must fail. Then in this process, with the tree on: a single-validator
   node on the card whose app sits behind ABCIGrpcServer, reached through
   grpc_client_creator, commits the app hashes of the same txs on the
   local client; and a node crashed at each statetree.* fail point
   recovers to the uncrashed run's app hash and still proves. Prints
   blocks/s (on the pure-Python kvstore, not comparable with phase 13's),
   StateTree.commit ms a height and merkle_sha_batches_total by route from
   each node's stop line, the largest wave timed on the device route, the
   native batch and hashlib with equal digests, and B1 launches a process.
17. the chaos plane (`chaos_*`, `wire_chaos`), with its own wall limit
   (CHAOS_WALL_S). A BatchVerifier("cuda") without coalescing is the
   default verifier for 17a-c (bench.py's pinning of the device route for
   its chaos arms), so every vote, commit and lite verify of the nets is a
   B1 launch of 8-32 lanes. 17a: chaos.runner.scale_spec(4) (link faults,
   the wan3 geo matrices, valset churn through val: txs, a crash at
   consensus.after_wal_end_height) at seed 42, target 8, settle 20 (once;
   twice before phase 18 needed the time): the run must give the JAX
   package's fault_log_sha256, 9 heights and 335 steps, no violation and
   the lite certifier at the top height.
   17b: ACCEPTANCE_SPEC (drop, delay, duplicate, reorder, a partition of
   node 0, node 2 crashed at consensus.before_save_block, node 1
   equivocating, node 3's clock at half rate) with TM_CUDA_LOCKCHECK=on:
   the JAX digest, 14 heights, 237 steps, no violation, every
   double-sign committed as evidence, node 2's crash at its point and its
   recovery in the trace, no lock-order cycle. 17c: scale_spec(32), the
   32-validator point of BENCH_chaos.json (target 4, settle 10): its
   digest, 9 heights, 291 steps, the certifier at 9 across 3 valset
   updates, a join, a leave and a stake change, no violation; prints the
   wall and blocks/s, verify calls and B1 launches, B1's summed event time
   (csrc/launch_timer.cpp) and its share of the wall, and the p50 of the
   causal ring's verify.dispatch spans (TM_CUDA_TRACE=on for this run:
   each Node sets the plane to its config's "off"). 17d: phase 13's four processes on
   the JAX defaults (verifier_backend "cuda") with chaos.wire's TCP fault
   proxy on every directed link under bench.py's WIRECHAOS_SPEC (25 ms
   steps: a 4 s partition of node 3, a 2 s stall of the 0<->1 link, two
   resets, frame drops, corruption and delays), PEX off, a handshake
   deadline of 5 s and bans of 6 s; a feeder casts batches to node 0
   (prefilled to 2,500 txs) and the proxy arms for a 19 s window
   (bench.py: 30 s; its last episode ends at 17 s), while bench.py's
   four hostile scripts run against node 0's own listener.
   The SocketInvariantMonitor must find no violation, every planned
   episode recover within 30 s, the plan digest equal the JAX one,
   handshake_stall and slow_handshake be closed by node 0,
   garbage_after_auth be banned and then readmitted, and every process
   launch B1. Prints blocks/s, recovery p50/max, the faults applied and
   B1 launches summed over the processes.
18. the shard plane and the edge serving plane (`shard_curve`,
   `edge_replicas`, `load_knee`), with its own wall limit (SERVE_WALL_S).
   18a: bench.py --shard-json's arms in this process: ShardSet(n) for n =
   1, 8 and 32 single-validator chains behind one front door, with a
   BatchVerifier("cuda") (coalescing "auto") as the process default that
   every shard shares, so that each merged dispatch is a B1 launch; two
   feeders cast 64-tx broadcast_tx_batch calls through the front door
   every 0.1 s, and a 3 s window (bench.py: 20 s) is read: blocks/s in
   all and a shard, coalescer submissions and merged dispatches (the
   coalesce factor), the mean verify batch, B1 and B2 launches by lanes
   and B1's summed event time (csrc/launch_timer.cpp) and share of the
   window. Checks: B1 launched inside every arm's window, certified reads
   of keys on two shards through CertifiedReader (every height from
   genesis, on B1), a forged commit refused with ReadProofError, each
   shard's app hashes replayed from its own blocks through a fresh
   kvstore bit-identical at every height, and the coalesce factor at 32
   shards above that at 1. 18b: a Deployment of 2 validators and 2
   keyless replicas (`cli node`, `cli replica`, --device cuda,
   verifier_backend "cuda", TM_CUDA_STATE_TREE=on, TM_CUDA_RPC_RATE=100
   on each replica), 400 primed keys, both replicas certifying the
   frontier; 250 certified reads/s (replica_read, its since_height
   following the chain where bench.py pins it at the arm's start, and
   proven abci_query) offered to one replica, then split across two, 3 s
   an arm (bench.py: 8 s): verified reads from each replica's tmcuda_edge_reads_total,
   p50/p95/p99, sheds, the seconds to serve an arm's backlog, and each
   process's B1 launches from its kernel line. Checks: a sample of replica-served reads verifies
   client-side from the genesis valset, a tampered value is refused, and
   a SIGKILLed replica is restarted by the supervisor and certifies the
   frontier again (its seconds printed). 18c: bench.py's knee sweep
   against a `cli shardset` process (2 chains, tree on): 1,500
   connections and 300 NewBlock subscribers of the open-loop fleet,
   offered 150 to 600 ops/s at 3 s a rate (bench.py: 150 to 4,800 at
   8 s; the rates past 600 cut for the script's time); the knee by
   find_knee(p99_slo_ms=1500), goodput and p99 a rate.
   Check: 150 ops/s is within find_knee's service level (goodput at
   least 0.85, p99 at most 1,500 ms), and every rate pushes events. The
   phase fails if it ends past its wall limit.
19. the device mesh (`mesh_commit`, `mesh_merkle`, `mesh_window`) over
   logical devices laid on the one card (TM_CUDA_MESH_FORCE_DEVICES=8).
   19a: phase 3's 10,000-validator commit with three signatures
   corrupted in R (BENCH_mesh.json's lanes 137, 4242, 9001) through
   BatchVerifier("cuda", mesh=m) for m = off, auto (unsharded on one
   card) and 2, 4, 8, each from a cold predecompression cache: a warm
   verify (B1), a counted one (B2 after the fill) and MESH_REPS timed
   ones (hits, median ms printed). Checks: verdicts equal to mesh off
   and to the host oracle (OpenSSL where `cryptography` loads), B1 + B2
   launches of the counted verify = shards x chunks, one
   mesh_dispatch_total{kind="verify"} a sharded chunk, the
   verifier_mesh_devices gauge, and mesh_shard_occupancy observed once
   a sharded chunk. 19b: root_host of the commit's 10,000 sign bytes
   through the mesh at 2, 4 and 8 (TM_CUDA_MESH=N), equal to root_plain
   and the native root, counted under merkle_roots_total{impl="mesh"},
   each beside the same call under "auto", which must take the native
   root (its ms printed); then parallel.mesh.verify_step at 2 on the same batch (2 shard
   launches, the tampered lanes rejected, its root equal). 19c: the
   first MESH_SYNC_BLOCKS blocks of phase 8's chain drained by a fresh
   node through a verifier node.build_verifier builds from
   base.verifier_mesh = "4", and by an unsharded one: equal store
   heights, app hashes and state bytes, the app hash the chain's own,
   mesh_devices 4, B1 or B2 launched, and a window dispatch of at
   least two BATCH_CHUNK chunks through the mesh, one of them padded.
20. the operator's env surface (`knobs_route`, `knobs_tools`). 20a: a
   KNOB_SIGS-validator commit of phase 3's keys with two tampered lanes
   (KNOB_TAMPER), its items verified through node.build_verifier of a
   default BaseConfig under each env in turn, from a cold
   predecompression cache: the defaults (100 <= 128: the host loop),
   TM_CUDA_AUTO_THRESHOLD=64 with TM_CUDA_COALESCE=off (two calls: the
   batch path, B1 then B2), TM_TPU_AUTO_THRESHOLD=64 alone (no effect in
   the port) and TM_CUDA_VERIFIER=python. Checks: every arm's verdicts
   equal the plain version's (the two tampered lanes refused); B1/B2
   launches (the ladder's counts and the launch timer's events, equal)
   in the threshold arm and in no other; no B3. Each arm's launches,
   walls and event ms are printed. 20b: phase 15's four timeline dumps,
   /slo snapshots (with sketches) and profiler dumps, written to files,
   through `python -m tendermint_tpu_torch.scripts.trace_merge`,
   `slo_report` and `profile_merge`: the Perfetto trace and the
   collapsed stacks byte-equal to the in-process merges of the same
   dumps, the SLO report's merged table equal to merge_snapshots'.
   `script_walls` then prints each phase's seconds and their total.
21. the kernel table as one JSON line (a `knobs` column of phase 20's
   launches), the card again, then the last line
   {"ok": true, "device": {...}}.

Any mismatch or exception ends the run with a non-zero code before the
last line. Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import hashlib
import json
import os
import random
import re
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter, defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from tendermint_tpu_torch import native
from tendermint_tpu_torch import pipeline as tpipeline
from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.apps import kvstore
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.abci.types import ValidatorUpdate
from tendermint_tpu_torch.blockchain import BlockchainReactor
from tendermint_tpu_torch.blockchain.reactor import VERIFY_WINDOW
from tendermint_tpu_torch.blockchain.builder import ChainBuilder
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.testnet import (FILE_NODE, MAX_BLOCK_TXS,
                                                    T0, Schedule, Testnet,
                                                    run_schedule, standby_key)
from tendermint_tpu_torch.lite import (CertificationError,
                                       ContinuousCertifier, FullCommit,
                                       SignedHeader, ValidatorsChangedError,
                                       certify_chain, default_window)
from tendermint_tpu_torch.mempool import Mempool
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import _build, ladder, merkle, sha256
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.state import execution as texec
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.storage import WAL, BlockStore, MemDB, StateStore
from tendermint_tpu_torch.types.block import (Block, BlockID, Commit, Data,
                                              EvidenceData, Header,
                                              PartSetHeader)
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.keys import PrivKey, Secp256k1PrivKey
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.types.priv_validator import PrivValidator
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote, VoteType
from tendermint_tpu_torch.types.vote_set import ConflictingVoteError, VoteSet
from tendermint_tpu_torch.utils import clock as tclock
from tendermint_tpu_torch.utils import fail as tfail
from tendermint_tpu_torch.utils import (ed25519_fast, ed25519_ref,
                                        secp256k1_ref, vectors)

SEED = 20261016
N_CHECK = 1024            # edge batch for kernel vs plain
N_PROBE = 256             # small-order probe lanes for kernel vs plain
N_TIME = 8192             # the main path's full chunk
N_VALIDATORS = 10_000     # BASELINE.json config 3
TIME_REPS = 5
CHAIN = "chip-smoke"
HEIGHT = 3
N_SIGN_CHECK = 1024       # edge scalars for the sign kernel vs plain
LITE_VALIDATORS = 64      # BASELINE.json config 5's width
LITE_HEADERS = 4096       # config 5 has 1M headers: the one cut
LITE_CHAIN = "chip-smoke-lite"
LITE_ROUTES = {"full": 1, "fill": 1, "hit": 30}
N_SECP = 16               # secp256k1 validators of the mixed commit
N_ORACLE_SAMPLE = 128     # untampered Ed25519 items held to the oracle
SWEEP = (2048, 8192, 32768)  # verify lanes timed; the first two also
PLAIN_CHECK = (2048, 8192)   # held to the plain version
SIGN_SWEEP = (4096, 16384, 65536)  # sign scalars timed; 16384 the chunk
BLOCK_TXS = 5000          # BASELINE.json config 4's block width
# the block's gossip parts: ConsensusParams' default, 65536 bytes
BLOCK_PART_SIZE = ConsensusParams().block_gossip.block_part_size_bytes
SHA_ROWS = 65536          # hash_fixed batch of 64-byte rows
SYNC_VALIDATORS = 64      # BASELINE.json config 4 (bench_fastsync.run_large)
SYNC_TXS = 5000
SYNC_KEY_SPACE = 512
SYNC_BLOCKS = 544         # config 4 syncs 50,000 blocks: the cut (two
#                           full 256-block windows and a tail: every
#                           cache route)
FORGE_BLOCKS = 300        # the forgery node's sync
FORGE_AT = 201            # its last commit carries a flipped signature byte
SYNC_WINDOW = VERIFY_WINDOW  # 256 blocks a window, as the reactor's default
# H100 SXM published HBM rate (NVIDIA data sheet), bytes/s
HBM_BYTES_S = 3.35e12
# 32-bit integer multiply-adds an SM issues per clock on sm_90 (CUDA C++
# Programming Guide, arithmetic instruction throughput): half the
# float32 rate. The field products run on this pipe.
IMAD_PER_SM_CLOCK = 64
# Issue slots of that pipe one field product of csrc/fe25519.cuh (fe_mul;
# a squaring is computed, and counted, as a product) needs: 100 signed
# 32x32->64 multiply-adds at two slots each (200), the 9 limbs of g used
# times 19 and the 5 odd limbs of f times 2 at one slot each (14), and
# the carry's fold of the top carry times 19, one wide multiply-add (2).
SLOTS_PER_MUL = 200 + 14 + 2
# one field product, and two chained: the difference of their SASS is
# what the compiler spends on a product (a diagnostic, not the bound)
PROBE_SRC = r"""
#include "fe25519.cuh"
using fe25519::fe;
extern "C" __global__ void probe_mul1(const fe *a, const fe *b, fe *o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = fe25519::fe_mul(a[i], b[i]);
}
extern "C" __global__ void probe_mul2(const fe *a, const fe *b, fe *o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = fe25519::fe_mul(fe25519::fe_mul(a[i], b[i]), b[i]);
}
"""

KERNELS = {
    "verify": {"name": "verify (B1, fused)",
               "replaces": "tendermint_tpu/ops/ladder_pallas.py:432"},
    "verify_pre": {"name": "verify_pre (B2, predecompressed)",
                   "replaces": "tendermint_tpu/ops/ladder_pallas.py:511"},
    "sign_rb": {"name": "sign_rb (B3, fixed-base r*B)",
                "replaces": "tendermint_tpu/ops/ladder_pallas.py:589"},
}
VERIFY_KERNELS = ("verify", "verify_pre")


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


_PTXAS_NAMES = {"ladder_kernelILb1": "verify", "ladder_kernelILb0": "verify_pre",
                "sign_rb_kernel": "sign_rb"}


def _ptxas(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel, from nvcc's
    -Xptxas -v report."""
    out: dict = {}
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln) or re.search(
            r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = next((v for k, v in _PTXAS_NAMES.items()
                        if k in m.group(1)), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def _start_probe(nvcc: str) -> tuple:
    """Start nvcc on the field-product probe; returns (process, cubin)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "fe_mul_probe.cu"
    src.write_text(PROBE_SRC)
    cubin = _build.BUILD_DIR / "fe_mul_probe.cubin"
    cmd = [nvcc, "-cubin", "-O3", "-gencode=arch=compute_90a,code=sm_90a",
           "-std=c++17", "-I", str(_build.CSRC), "-o", str(cubin), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), cubin


def _sass_counts(nvcc: str, cubin) -> dict:
    """{function: {opcode: count}} from cuobjdump -sass."""
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = counts.setdefault(m.group(1), {})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      ln)
        if m and fn is not None:
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    return counts


def _imad_slots(ops: dict) -> int:
    """Issue slots on the integer multiply-add pipe: a 32x32->64 wide
    multiply-add (IMAD.WIDE*) takes two, every other IMAD* one."""
    return sum(c * (2 if ".WIDE" in op else 1)
               for op, c in ops.items() if op.startswith("IMAD"))


def _timed_build(fn) -> tuple:
    """(fn's result, its seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


#: the modules a node, lite or replica process imports, compiled once
WARM_IMPORTS = ("torch", "tendermint_tpu_torch.cli",
                "tendermint_tpu_torch.node", "tendermint_tpu_torch.lite.proxy",
                "tendermint_tpu_torch.serving.edge",
                "tendermint_tpu_torch.serving.deploy")


def _share_bytecode() -> subprocess.Popen:
    """Let every process this script starts keep the bytecode it compiles
    under the build directory (PYTHONPYCACHEPREFIX, dropping
    PYTHONDONTWRITEBYTECODE for the children), and start one interpreter
    that imports WARM_IMPORTS to fill it. Without it every node process
    compiles torch's sources again: on the H100 host an import of torch
    took 8.5 s, and 4.6-5.2 s from the cache. Returns the warming
    process."""
    from tendermint_tpu_torch.procnet import child_env
    cache = _build.BUILD_DIR / "pycache"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(cache)
    return subprocess.Popen(
        [sys.executable, "-c", "import " + ", ".join(WARM_IMPORTS)],
        env=child_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)


def phase_build() -> tuple:
    """Build the kernels (and the probe beside them) and every host
    library the script and its node processes load, all at once: one
    nvcc for the kernels, one for the probe, one g++ for each host
    library, started together (each library under its own build lock).
    Returns (the integer rate the bounds are taken at, each kernel's
    ptxas report and blocks per SM)."""
    nvcc = _build.find_nvcc()
    probe, cubin = _start_probe(nvcc)
    builds = {"ladder": lambda: _build.ladder_lib(), "prep": native.build,
              "aead": native.aead_build, "hostops": native.hostops_build,
              "codec": native.codec_build, "kv": native.kv_build,
              "launch_timer": lambda: _build.launch_timer_lib()}
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = {k: pool.submit(_timed_build, fn) for k, fn in builds.items()}
        done = {k: f.result() for k, f in futs.items()}
    lib, build_s = done["ladder"]
    prep = {"compiler": shutil.which("g++"), "flags": native.prep_flags(),
            "include": native.python_include(),
            "library": done["prep"][0].name, "seconds": done["prep"][1],
            "sha512_impl": native.sha512_impl(),
            "host_builds_s": {k: round(v[1], 3) for k, v in done.items()
                              if k != "ladder"}}
    probe_log = probe.communicate()[0]
    require(probe.returncode == 0, f"the field-product probe failed to "
                                   f"build:\n{probe_log}")
    counts = _sass_counts(nvcc, cubin)
    one, two = counts["probe_mul1"], counts["probe_mul2"]
    slots = _imad_slots(two) - _imad_slots(one)
    instrs = sum(two.values()) - sum(one.values())
    require(slots > 0, f"no IMAD in the probe's SASS: {counts}")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = {"slots_per_mul": SLOTS_PER_MUL,
            "probe_imad_slots_per_mul": slots,
            "probe_instructions_per_mul": instrs,
            "probe_imad_opcodes_per_mul": {
                op: two.get(op, 0) - one.get(op, 0) for op in two
                if op.startswith("IMAD") and two.get(op, 0) != one.get(op, 0)},
            "sm_count": sms, "sm_clock_max_mhz": clock_mhz,
            "imad_slots_per_s": sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6}
    ptxas = _ptxas(_build.ladder_build_log())
    require(set(ptxas) == set(KERNELS), f"ptxas report incomplete: {ptxas}")
    for k, name in enumerate(KERNELS):
        ptxas[name]["blocks_per_sm"] = lib.tm_ladder_occupancy(k)
        require(ptxas[name]["blocks_per_sm"] > 0, f"occupancy of {name}")
    emit({"phase": "build", "seconds": round(build_s, 3), "ptxas": ptxas,
          "int_rate": rate, "prep": prep})
    return rate, ptxas


def _cuda_rows(batch, device):
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ("pk", "rb", "s", "h")}


def _kernel_and_plain(name, t):
    """Both callables of one kernel on the rows `t` (its inputs on the
    card): the wrapper that launches the kernel, and its plain version."""
    digs = (ladder.digits_from_bytes(t["s"]), ladder.digits_from_bytes(t["h"]))
    if name == "verify":
        return (lambda: ladder.verify(t["pk"], t["rb"], t["s"], t["h"]),
                lambda: ladder.verify_plain(t["pk"], t["rb"], *digs))
    dec = ted._decompress_to_bytes(t["pk"])
    return (lambda: ladder.verify_pre(*dec, t["rb"], t["s"], t["h"]),
            lambda: ladder.verify_pre_plain(*dec, t["rb"], *digs))


def _time_ms(fn, reps: int) -> tuple:
    """(ms per call over `reps` calls after one warm call, the output of
    the last call)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def _time_once_ms(fn) -> tuple:
    """(ms of one call, its output), by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _compare(name, got, want, expect, n, lanes) -> int:
    """Hold kernel verdicts against the plain version's (unless `want` is
    None) and the oracle's; returns the largest absolute difference from
    the plain version."""
    err = 0 if want is None else int((got.int() - want.int()).abs().max())
    agree = (want is None or bool(torch.equal(got, want))) and bool(
        (got.cpu().numpy() == expect).all())
    emit({"phase": "kernel_check", "kernel": name, "n": n, "lanes": lanes,
          "max_abs_err": err, "held_to_plain": want is not None,
          "equal_to_plain_and_oracle": agree})
    require(agree and err == 0,
            f"{name} disagrees with its plain version or the oracle at {n}")
    return err


# bytes one lane reads and writes: pk, R, s, h in and a verdict out; the
# cached (-A).x, A.y, ok, R, s, h in and a verdict out; r in and R out
LANE_BYTES = {"verify": 4 * 32 + 4, "verify_pre": 5 * 32 + 1 + 4,
              "sign_rb": 32 + 32}


def _muls_ms(muls: float, rate: dict) -> float:
    """ms that `muls` field products take at the integer pipe's rate."""
    return 1e3 * muls * rate["slots_per_mul"] / rate["imad_slots_per_s"]


def _bound(name: str, n: int, rate: dict,
           n_windows: int = ladder.N_WINDOWS) -> tuple:
    """(least ms the card could take for n lanes of a kernel, what bounds
    it): each input byte read once and each output byte written once at
    the HBM rate, against the launch's field products
    (`ladder.bound_field_muls`: for the sign kernel the least work of the
    batch, one inverse shared by all) of SLOTS_PER_MUL each at the
    integer multiply-add pipe's rate."""
    bytes_ms = 1e3 * n * LANE_BYTES[name] / HBM_BYTES_S
    ops_ms = _muls_ms(ladder.bound_field_muls(name, n, n_windows), rate)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _tiled(batch, n: int) -> tuple:
    """The rows of `batch` tiled to n lanes, and the oracle's verdicts."""
    reps = -(-n // len(batch["expect"]))
    rows = {k: np.ascontiguousarray(np.tile(batch[k], (reps, 1))[:n])
            for k in ("pk", "rb", "s", "h")}
    return rows, np.tile(batch["expect"], reps)[:n]


def phase_kernels(device, rate: dict) -> dict:
    batch = vectors.edge_batch(N_CHECK, seed=SEED)
    lanes = sorted(set(batch["kind"]))
    t = _cuda_rows(batch, device)
    results = {}
    for name in VERIFY_KERNELS:
        kernel, plain = _kernel_and_plain(name, t)
        got, want = kernel(), plain()
        results[name] = {"max_abs_err": _compare(
            name, got, want, batch["expect"], N_CHECK, lanes)}
    # the small-order and non-canonical lanes of vectors.probe_batch
    probe = vectors.probe_batch(N_PROBE, seed=SEED + 4)
    tp = _cuda_rows(probe, device)
    for name in VERIFY_KERNELS:
        kernel, plain = _kernel_and_plain(name, tp)
        err = _compare(name, kernel(), plain(), probe["expect"], N_PROBE,
                       sorted(set(probe["kind"])))
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    # the lanes sweep: the edge rows tiled to the main path's shapes
    # (2048 is the 10k commit's padded tail, 8192 the full chunk) and to
    # 32768, each launch timed
    require(ted._bucket(N_VALIDATORS % tverifier.BATCH_CHUNK) in SWEEP
            and N_TIME in PLAIN_CHECK, "the sweep misses a main-path shape")
    for name in VERIFY_KERNELS:
        err = results[name]["max_abs_err"]
        sweep = {}
        for n in SWEEP:
            rows, expect = _tiled(batch, n)
            kernel, plain = _kernel_and_plain(name, _cuda_rows(rows, device))
            ms, got = _time_ms(kernel, TIME_REPS)
            want = None
            if n in PLAIN_CHECK:
                # one timed call: the edge and probe checks above have
                # run the plain version already
                p_ms, want = _time_once_ms(plain)
                if n == N_TIME:
                    plain_ms = p_ms
            err = max(err, _compare(name, got, want, expect, n, lanes))
            bound_ms, _ = _bound(name, n, rate)
            sweep[n] = ms
            emit({"phase": "kernel_sweep", "kernel": name, "n": n, "ms": ms,
                  "us_per_signature": 1e3 * ms / n, "bound_ms": bound_ms})
        bound_ms, bound_by = _bound(name, N_TIME, rate)
        results[name] = {
            "max_abs_err": err, "ms": sweep[N_TIME], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / sweep[N_TIME], "n": N_TIME,
            "sweep_ms": sweep}
        emit({"phase": "kernel_time", "kernel": name, **results[name]})
    return results


def _seeds(n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [rng.bytes(32) for _ in range(n)]


def _keys(n: int, seed: int):
    """(a, prefix, pubkey) of the RFC 8032 seeds _seeds(n, seed)."""
    out = []
    for s in _seeds(n, seed):
        a, prefix = ed25519_ref.secret_expand(s)
        pub = ed25519_ref.point_compress(ed25519_fast._mul_base(a))
        out.append((a, prefix, pub))
    return out


def build_commit(keys, secp=None):
    """(valset, block_id, commit): every validator precommits for one
    block with its own timestamp, signed with the port's table signer;
    `secp` {index in keys: Secp256k1PrivKey} puts secp256k1 keys in
    those validators' places."""
    secp = secp or {}
    pubs = [secp[i].pubkey.secp256k1 if i in secp else pub
            for i, (_, _, pub) in enumerate(keys)]
    vs = ValidatorSet([Validator(p, 10 + i % 7) for i, p in enumerate(pubs)])
    by_pub = {p: secp.get(i, keys[i]) for i, p in enumerate(pubs)}
    bid = BlockID(b"\x5a" * 32, PartSetHeader(4, b"\xa5" * 32))
    votes = []
    for idx, val in enumerate(vs.validators):
        v = Vote(val.address, idx, HEIGHT, 0, 1_700_000_000_000 + idx,
                 VoteType.PRECOMMIT, bid)
        key = by_pub[val.pubkey]
        sb = v.sign_bytes(CHAIN)
        v.signature = key.sign(sb) if isinstance(key, Secp256k1PrivKey) \
            else ed25519_fast.sign_expanded(key[0], key[1], val.pubkey, sb)
        votes.append(v)
    return vs, bid, Commit(bid, votes)


def _time_launches(log: list):
    """Wrap the kernels' launcher so that every launch records CUDA events
    around itself on the current stream into `log` as (name, n, start,
    end). Returns the launcher it wrapped, for the caller to put back."""
    inner = ladder._launch

    def launch(name, fn_name, rows, n_windows, **kw):
        stream = torch.cuda.current_stream(rows[0].device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = inner(name, fn_name, rows, n_windows, **kw)
        end.record(stream)
        log.append((name, rows[0].shape[0], start, end))
        return out

    ladder._launch = launch
    return inner


def _kernel_ms(timed) -> dict:
    """Sum of the CUDA event times of the launches in `timed`, by kernel."""
    out: dict = {}
    for name, _, start, end in timed:
        end.synchronize()
        out[name] = out.get(name, 0.0) + start.elapsed_time(end)
    return out


def _route(before, after) -> dict:
    return {k: after[k] - before[k] for k in ("full", "fill", "hit")}


def _prep_delta(before) -> dict:
    after = ted.prep_stats()
    return {k: after[k] - before[k] for k in after}


def _zero_launches() -> None:
    for name in ladder.launches:
        ladder.launches[name] = 0


def _require_launched(launches: dict, kernels, path: str) -> None:
    require(all(launches[k] > 0 for k in kernels),
            f"a kernel of the {path} path never launched: {launches}")


def _verify_routes(phase: str, vs, bid, commit, n_ed: int, timer: list,
                   card: str) -> list:
    """verify_commit three times; the cache must walk full -> fill -> hit
    over the commit's Ed25519 chunks, and every item must take the
    native prep. Returns the walls in ms."""
    chunks = -(-n_ed // tverifier.BATCH_CHUNK)
    prep_before = ted.prep_stats()
    walls = []
    for call, route in enumerate(("full", "fill", "hit")):
        before = ted.predecomp_stats()
        mark = len(timer)
        t1 = time.perf_counter()
        vs.verify_commit(CHAIN, bid, HEIGHT, commit)
        wall = time.perf_counter() - t1
        walls.append(wall * 1e3)
        timed = timer[mark:]
        kernel_ms = sum(_kernel_ms(timed).values())
        got = _route(before, ted.predecomp_stats())
        emit({"phase": phase, "call": call, "route": got,
              "launches": [(nm, n) for nm, n, _, _ in timed],
              "wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
              "sigs_per_s": len(vs) / wall, "card": card})
        require(got == {"full": 0, "fill": 0, "hit": 0, route: chunks},
                f"{phase} call {call} took cache route {got}, want "
                f"{chunks} x {route}")
    prep = _prep_delta(prep_before)
    emit({"phase": "prep_route", "path": phase, **prep})
    require(prep["native"] == 3 * n_ed and prep["plain"] == 0,
            f"the {phase} calls did not all take the native prep: {prep}")
    return walls


def _restore(saved) -> None:
    for owner, name, fn in saved:
        if fn is None:              # a method of the instance's class
            delattr(owner, name)
        else:
            setattr(owner, name, fn)


def _patched(patches):
    """Install (owner, name, fn) patches; returns what to restore."""
    saved = [(owner, name, vars(owner).get(name)) for owner, name, _ in patches]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    return saved


def _hit_breakdown(vs, bid, commit, timer: list, card: str) -> None:
    """Where a steady-state (hit) call's wall goes, read inside one more
    real hit call of verify_commit: the functions at its stage boundaries
    are wrapped for that call so that each adds its host time to a stage
    (commit items, native prep, padding, cache-row assembly, uploads,
    kernel launch, the rest of the dispatch — the pinned copies and the
    event —, the resolver's wait and mask, the power check); the kernels'
    device time comes from their events. Then the hashlib prep on the
    call's own items, which must give the same bytes as its native prep."""
    verifier = tverifier.default_verifier()
    st = dict.fromkeys(("items_ms", "dispatch_ms", "host_prep_ms", "pad_ms",
                        "assembly_ms", "upload_ms", "launch_ms",
                        "resolve_ms", "check_ms"), 0.0)
    kept: dict = {}

    def timed(fn, stage):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                st[stage] += (time.perf_counter() - t0) * 1e3
        return call

    def prep_and_keep(items, prep=ted.prep_items):
        kept["items"], kept["prep"] = items, prep(items)
        return kept["prep"]

    def dispatch(items, verify_async=verifier.verify_async):
        return timed(verify_async(items), "resolve_ms")

    patches = [
        (vs, "commit_verification_items",
         timed(vs.commit_verification_items, "items_ms")),
        (vs, "check_commit_results",
         timed(vs.check_commit_results, "check_ms")),
        (verifier, "verify_async", timed(dispatch, "dispatch_ms")),
        (ted, "prep_items", timed(prep_and_keep, "host_prep_ms")),
        (ted, "_pad_to", timed(ted._pad_to, "pad_ms")),
        (ted, "_predecomp_rows", timed(ted._predecomp_rows, "assembly_ms")),
        (ted, "_upload", timed(ted._upload, "upload_ms")),
        (ladder, "verify_pre", timed(ladder.verify_pre, "launch_ms"))]
    route_before, prep_before, mark = (ted.predecomp_stats(),
                                       ted.prep_stats(), len(timer))
    saved = _patched(patches)
    try:
        t0 = time.perf_counter()
        vs.verify_commit(CHAIN, bid, HEIGHT, commit)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        _restore(saved)
    items = kept["items"]
    chunks = -(-len(items) // tverifier.BATCH_CHUNK)
    got = _route(route_before, ted.predecomp_stats())
    require(got == {"full": 0, "fill": 0, "hit": chunks},
            f"the breakdown's call took cache route {got}")
    require(_prep_delta(prep_before)["native"] == len(items),
            "the hit call's items did not take the native prep")
    t0 = time.perf_counter()
    plain = ted.prepare_batch_bytes_plain(*zip(*items))
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(np.array_equal(a, b) for a, b in zip(kept["prep"], plain))
    require(same, "native prep differs from the hashlib prep")
    # dispatch_ms holds the prep ... launch stages; the rest of it is the
    # pinned copies, the event and the chunk loop
    st["dispatch_rest_ms"] = st["dispatch_ms"] - sum(
        st[k] for k in ("host_prep_ms", "pad_ms", "assembly_ms", "upload_ms",
                        "launch_ms"))
    host_ms = sum(st[k] for k in ("items_ms", "dispatch_ms", "resolve_ms",
                                  "check_ms"))
    emit({"phase": "hit_breakdown", "wall_ms": wall, **st,
          "unattributed_ms": wall - host_ms,
          "kernel_ms": sum(_kernel_ms(timer[mark:]).values()),
          "plain_prep_ms": plain_ms, "prep_equal_to_plain": same,
          "sha512_impl": native.sha512_impl(), "card": card})


def _mixed_commit(keys) -> tuple:
    """(places, the commit of `keys` with N_SECP seeded validators on
    secp256k1 keys, its seconds, the seeded generator that drew them,
    for the tampered lanes)."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 5)
    places = sorted(int(i) for i in rng.choice(len(keys), N_SECP,
                                                replace=False))
    secp = {i: Secp256k1PrivKey.generate(rng.bytes(32)) for i in places}
    return places, build_commit(keys, secp), time.perf_counter() - t0, rng


def prepare_commits(n_validators: int = N_VALIDATORS) -> dict:
    """Phases 3 and 4's inputs: the keys, the commit and the mixed commit,
    with their seconds (main() makes them while the kernels build)."""
    t0 = time.perf_counter()
    keys = _keys(n_validators, SEED)
    commit_path = build_commit(keys)
    seconds = time.perf_counter() - t0
    return {"keys": keys, "commit_path": commit_path, "seconds": seconds,
            "mixed": _mixed_commit(keys)}


def phase_main(card: str, n_validators: int = N_VALIDATORS,
               prepared: dict = None) -> tuple:
    prepared = prepared or prepare_commits(n_validators)
    keys = prepared["keys"]
    vs, bid, commit = prepared["commit_path"]
    emit({"phase": "generate", "validators": n_validators,
          "seconds": round(prepared["seconds"], 3)})

    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    _verify_routes("verify_commit", vs, bid, commit, n_validators, timer,
                   card)
    _hit_breakdown(vs, bid, commit, timer, card)

    bad = Commit(bid, list(commit.precommits))
    k = n_validators // 3
    vote = copy.copy(bad.precommits[k])
    vote.signature = vote.signature[:20] + bytes([vote.signature[20] ^ 1]) + \
        vote.signature[21:]
    bad.precommits[k] = vote
    raised = None
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, bad)
    except ValueError as e:
        raised = str(e)
    emit({"phase": "tampered_commit", "raised": raised})
    require(raised == "invalid signature in commit",
            f"tampered commit: {raised!r}")
    launches = dict(ladder.launches)
    ladder._launch = inner
    _require_launched(launches, VERIFY_KERNELS, "commit")
    return launches, keys, (vs, bid, commit)


def _nonminimal_der(sig: bytes) -> bytes:
    """The same (r, s) with r's DER integer given one more leading zero
    byte: not DER, which OpenSSL rejects and secp256k1_ref.verify accepts."""
    r, s = secp256k1_ref._der_decode(sig)
    ri = secp256k1_ref._der_int(r)
    body = b"\x02" + bytes([ri[1] + 1]) + b"\x00" + ri[2:] + \
        secp256k1_ref._der_int(s)
    return b"\x30" + bytes([len(body)]) + body


def _flip(sig: bytes, i: int) -> bytes:
    return sig[:i] + bytes([sig[i] ^ 1]) + sig[i + 1:]


def _commit_raises(vs, bid, commit, k: int, sig: bytes):
    bad = Commit(bid, list(commit.precommits))
    vote = copy.copy(bad.precommits[k])
    vote.signature = sig
    bad.precommits[k] = vote
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, bad)
    except ValueError as e:
        return str(e)
    return None


@contextlib.contextmanager
def _secp_route(route: str):
    """Run the body with types/keys' secp256k1 route as named: "pure"
    hides `cryptography`'s EC bindings, "openssl" leaves them."""
    name = "cryptography.hazmat.primitives.asymmetric"
    saved = sys.modules.get(name, _secp_route)
    if route == "pure":
        sys.modules[name] = None
    try:
        require(route == ("openssl" if tkeys._ec() else "pure"),
                f"secp256k1 route {route} not in force")
        yield
    finally:
        if saved is _secp_route:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = saved


def phase_mixed(card: str, keys, mixed: tuple = None) -> dict:
    """The 10,000-validator commit with N_SECP validators (seeded places)
    on secp256k1 keys: through verify_commit from a cold cache (full ->
    fill -> hit: B1, then B2), the secp256k1 items verified on the host;
    verdicts on a batch with tampered items of both kinds held to the
    oracles; a flipped byte and a non-minimal DER re-encoding in one
    secp256k1 precommit must each raise."""
    places, (vs, bid, commit), seconds, rng = mixed or _mixed_commit(keys)
    emit({"phase": "mixed_generate", "validators": len(vs),
          "secp256k1": N_SECP, "places": places, "seconds": seconds})
    n_ed = len(vs) - N_SECP
    with ted._predecomp_lock:       # a cold cache: the path walks all routes
        ted._predecomp.clear()
        ted._predecomp_seen.clear()
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    walls = _verify_routes("mixed_commit", vs, bid, commit, n_ed, timer,
                           card)

    items, _ = vs.commit_verification_items(CHAIN, bid, HEIGHT, commit)
    secp_idx = [i for i, it in enumerate(items) if len(it[0]) == 33]
    ed_idx = [i for i, it in enumerate(items) if len(it[0]) == 32]
    require(len(secp_idx) == N_SECP and len(ed_idx) == n_ed,
            "the mixed commit's key kinds")
    bad = set(rng.choice(secp_idx, 4, replace=False).tolist()) | \
        set(rng.choice(ed_idx, 4, replace=False).tolist())
    items = [(p, m, _flip(sg, 10)) if i in bad else (p, m, sg)
             for i, (p, m, sg) in enumerate(items)]
    t0 = time.perf_counter()
    got = tverifier.default_verifier().verify(items)
    verify_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    expect = np.ones(len(items), np.bool_)
    for i in secp_idx:
        expect[i] = secp256k1_ref.verify(*items[i])
    secp_ms = (time.perf_counter() - t0) * 1e3
    sample = sorted(set(rng.choice(ed_idx, N_ORACLE_SAMPLE, replace=False)
                        .tolist()) | (bad & set(ed_idx)))
    for i in sample:
        expect[i] = ed25519_fast.verify(*items[i])
    agree = bool(np.array_equal(got, expect))
    emit({"phase": "mixed_verdicts", "items": len(items),
          "secp_route": "openssl" if tkeys._ec() else "pure",
          "tampered": sorted(bad), "rejected": int((~got).sum()),
          "oracle_sample": len(sample), "equal_to_oracles": agree,
          "verify_ms": verify_ms, "secp_oracle_ms": secp_ms, "card": card})
    require(agree and int((~got).sum()) == len(bad),
            "mixed-key verdicts differ from the oracles")

    k = next(j for j, v in enumerate(vs.validators) if len(v.pubkey) == 33)
    sig = commit.precommits[k].signature
    nonmin = _nonminimal_der(sig)
    require(secp256k1_ref.verify(vs.validators[k].pubkey,
                                 commit.precommits[k].sign_bytes(CHAIN),
                                 nonmin),
            "the pure parser should accept the non-minimal DER integer")
    # both secp256k1 routes of types/keys: OpenSSL where `cryptography`
    # imports, and the pure one (its EC bindings hidden) in any case
    routes = ["openssl", "pure"] if tkeys._ec() is not None else ["pure"]
    for route in routes:
        with _secp_route(route):
            for what, forged in (("flipped secp256k1 signature byte",
                                  _flip(sig, 12)),
                                 ("non-minimal DER integer", nonmin)):
                raised = _commit_raises(vs, bid, commit, k, forged)
                emit({"phase": "mixed_tampered", "secp_route": route,
                      "forgery": what, "raised": raised})
                require(raised == "invalid signature in commit",
                        f"mixed commit, {route} route, {what}: {raised!r}")
    launches = dict(ladder.launches)
    ladder._launch = inner
    _require_launched(launches, VERIFY_KERNELS, "mixed commit")
    emit({"phase": "mixed_commit_summary", "walls_ms": walls,
          "launches": launches, "card": card})
    return launches


def _sign_edge_scalars(n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    L = ed25519_ref.L
    edge = [0, 1, 2, L - 1, 1 << 252, (1 << 252) - 1,
            # unreduced: the comb's recoding carries out of window 63
            L, L + 1, 1 << 255, (1 << 256) - 1, int("88" * 32, 16)]
    return edge + [int.from_bytes(rng.bytes(32), "little") % L
                   for _ in range(n - len(edge))]


SIGN_LANES = ("r = 0, 1, 2, L-1, 2^252, 2^252-1, L, L+1, 2^255, 2^256-1, "
              "0x88..88, random < L")


def _rb_oracle(rs, n_windows: int) -> np.ndarray:
    """enc((r mod 16^n_windows) * B) of each r, by the reference."""
    m = 1 << 4 * n_windows
    return np.stack([np.frombuffer(ed25519_ref.point_compress(
        ed25519_ref.point_mul(r % m, ed25519_ref.BASE)), np.uint8)
        for r in rs])


def phase_sign_kernel(device, rate: dict) -> dict:
    """The r*B kernel against its plain version and the oracle on 1024
    edge scalars, then on those tiled to SIGN_SWEEP, each size timed;
    then at the signing chunk at one window, timed and checked."""
    rs = _sign_edge_scalars(N_SIGN_CHECK, SEED + 1)
    r_np = np.stack([np.frombuffer(r.to_bytes(32, "little"), np.uint8)
                     for r in rs])
    n_chunk = ted.SIGN_CHUNK
    require(n_chunk in SIGN_SWEEP, "the sign sweep misses the chunk")
    err, sweep, by_windows = 0, {}, {}
    full = ladder.N_WINDOWS
    # SYNC_VALIDATORS: the launch of the fast-sync chain's signing
    for n_windows, sizes in ((full, (SYNC_VALIDATORS, N_SIGN_CHECK)
                              + SIGN_SWEEP),
                             (1, (n_chunk,))):
        expect = _rb_oracle(rs, n_windows)
        for n in sizes:
            reps = -(-n // N_SIGN_CHECK)
            r = torch.from_numpy(np.ascontiguousarray(
                np.tile(r_np, (reps, 1))[:n])).to(device)
            digits = ladder.digits_from_bytes(r)
            ms, got = _time_ms(lambda: ladder.sign_rb(r, n_windows),
                               TIME_REPS)
            if n == n_chunk:
                p_ms, want = _time_once_ms(
                    lambda: ladder.sign_rb_plain(digits, n_windows))
                by_windows[n_windows] = ms
                if n_windows == full:
                    plain_ms = p_ms
            else:
                want = ladder.sign_rb_plain(digits, n_windows)
            e = int((got.int() - want.int()).abs().max())
            agree = bool(torch.equal(got, want)) and bool(
                (got.cpu().numpy() == np.tile(expect, (reps, 1))[:n]).all())
            emit({"phase": "kernel_check", "kernel": "sign_rb", "n": n,
                  "n_windows": n_windows, "lanes": SIGN_LANES,
                  "max_abs_err": e, "equal_to_plain_and_oracle": agree})
            require(agree and e == 0,
                    f"sign_rb disagrees with its plain version or the "
                    f"oracle at {n} scalars, {n_windows} windows")
            err = max(err, e)
            if n in SIGN_SWEEP:
                bound_ms, _ = _bound("sign_rb", n, rate, n_windows)
                if n_windows == full:
                    sweep[n] = ms
                emit({"phase": "kernel_sweep", "kernel": "sign_rb", "n": n,
                      "n_windows": n_windows, "ms": ms,
                      "us_per_scalar": 1e3 * ms / n, "bound_ms": bound_ms})
    # where the 64-window time goes: the one-window launch is one comb add,
    # the carry's add, the inverse and the encode; the rest is 63 adds
    adds_ms = by_windows[full] - by_windows[1]
    emit({"phase": "sign_windows", "n": n_chunk,
          "ms_by_windows": by_windows,
          "field_muls_by_windows": {w: ladder.field_muls("sign_rb", w)
                                    for w in by_windows},
          "floor_ms": by_windows[1], "adds_ms": adds_ms,
          "ms_per_window": adds_ms / (full - 1),
          "floor_share": by_windows[1] / by_windows[full]})
    bound_ms, bound_by = _bound("sign_rb", n_chunk, rate)
    # beside it, the bound on the TPU kernel's windowed schedule (the plain
    # version's), the yardstick of the kernel this one replaced
    windowed_ms = _muls_ms(
        n_chunk * ladder.field_muls("sign_rb_plain"), rate)
    res = {"max_abs_err": err, "ms": sweep[n_chunk], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / sweep[n_chunk],
           "bound_ms_windowed": windowed_ms,
           "share_of_windowed_bound": windowed_ms / sweep[n_chunk],
           "n": n_chunk, "sweep_ms": sweep}
    emit({"phase": "kernel_time", "kernel": "sign_rb", **res})
    return {"sign_rb": res}


def build_lite_chain(n_vals: int, n_headers: int):
    """(valset, FullCommits of heights 1..n_headers, a seeded sample of
    (seed, msg, sig), timings): every validator signs every header's
    precommit; the signatures come from sign_batch_async, dispatched
    before the vote objects are built and resolved after."""
    t0 = time.perf_counter()
    seeds = [(i + 1).to_bytes(32, "little") for i in range(n_vals)]
    keys = [PrivKey.generate(s) for s in seeds]
    valset = ValidatorSet([Validator(k.pubkey.ed25519, 10) for k in keys])
    order = {k.pubkey.address: i for i, k in enumerate(keys)}
    idx_of = [order[v.address] for v in valset.validators]
    vals = valset.validators
    vhash = valset.hash()
    headers, bids = [], []
    for h in range(1, n_headers + 1):
        header = Header(chain_id=LITE_CHAIN, height=h, time_ns=h,
                        validators_hash=vhash, app_hash=h.to_bytes(32, "big"))
        headers.append(header)
        bids.append(BlockID(header.hash(), PartSetHeader(1, b"\x22" * 32)))
    # v0.16 sign bytes carry no validator identity: one message a height
    msgs = [Vote(vals[0].address, 0, h, 0, h, VoteType.PRECOMMIT,
                 bids[h - 1]).sign_bytes(LITE_CHAIN)
            for h in range(1, n_headers + 1)]
    sig_seeds = [seeds[idx_of[j]] for _ in range(n_headers)
                 for j in range(n_vals)]
    sig_msgs = [m for m in msgs for _ in range(n_vals)]
    t1 = time.perf_counter()
    resolve = ted.sign_batch_async(sig_seeds, sig_msgs)
    t2 = time.perf_counter()
    fcs, votes = [], []
    for i, h in enumerate(range(1, n_headers + 1)):
        precommits = [Vote(v.address, j, h, 0, h, VoteType.PRECOMMIT,
                           bids[i]) for j, v in enumerate(vals)]
        votes.extend(precommits)
        fcs.append(FullCommit(SignedHeader(headers[i],
                                           Commit(bids[i], precommits),
                                           bids[i]), valset))
    t3 = time.perf_counter()
    sigs = resolve()
    t4 = time.perf_counter()
    for v, sig in zip(votes, sigs):
        v.signature = sig
    n_sigs = len(sigs)
    rng = np.random.RandomState(SEED + 2)
    sample = [(sig_seeds[i], sig_msgs[i], sigs[i])
              for i in rng.choice(n_sigs, 1024, replace=False)]
    times = {"headers_ms": (t1 - t0) * 1e3, "sign_dispatch_ms": (t2 - t1) * 1e3,
             "votes_ms": (t3 - t2) * 1e3, "sign_resolve_ms": (t4 - t3) * 1e3,
             "sign_wall_ms": ((t2 - t1) + (t4 - t3)) * 1e3,
             "build_s": time.perf_counter() - t0}
    return valset, fcs, sample, times


def _check_sample(sample) -> None:
    """Each sampled signature byte-equal to the table signer's."""
    expanded: dict = {}
    bad = 0
    for seed, msg, sig in sample:
        exp = expanded.get(seed)
        if exp is None:
            a, prefix = ed25519_ref.secret_expand(seed)
            exp = expanded[seed] = (a, prefix, ed25519_fast.public_key(seed))
        bad += ed25519_fast.sign_expanded(*exp, msg) != sig
    emit({"phase": "lite_sign_sample", "n": len(sample), "mismatched": bad})
    require(bad == 0, f"{bad} of {len(sample)} sampled signatures differ "
                      "from the table signer's")


def _expect_raise(what: str, fcs, trusted, cls, check) -> None:
    raised = None
    try:
        certify_chain(LITE_CHAIN, fcs, trusted=trusted)
    except CertificationError as e:
        raised = e
    msg = None if raised is None else f"{type(raised).__name__}: {raised}"
    emit({"phase": "lite_forgery", "forgery": what, "raised": msg})
    require(isinstance(raised, cls) and check(str(raised)),
            f"forgery {what!r}: {msg}")


def phase_lite(card: str) -> dict:
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    prep_before = ted.prep_stats()
    valset, fcs, sample, times = build_lite_chain(LITE_VALIDATORS,
                                                  LITE_HEADERS)
    n_sigs = LITE_VALIDATORS * LITE_HEADERS
    sign_prep = _prep_delta(prep_before)
    sign_ms = _kernel_ms(timer).get("sign_rb", 0.0)
    emit({"phase": "lite_build", "validators": LITE_VALIDATORS,
          "headers": LITE_HEADERS, "signatures": n_sigs, **times,
          "sign_kernel_ms": sign_ms,
          "sign_sigs_per_s": n_sigs / (times["sign_wall_ms"] / 1e3),
          "prep_route": sign_prep, "card": card})
    require(sign_prep["sign_native"] == n_sigs,
            f"the chain's signing did not take the native phases: "
            f"{sign_prep}")
    _check_sample(sample)

    mark = len(timer)
    before = ted.predecomp_stats()
    prep_before = ted.prep_stats()
    t0 = time.perf_counter()
    certify_chain(LITE_CHAIN, fcs, trusted=valset)
    wall = time.perf_counter() - t0
    routes = _route(before, ted.predecomp_stats())
    certify_prep = _prep_delta(prep_before)
    launches = dict(ladder.launches)
    kernel_ms = _kernel_ms(timer[mark:])
    emit({"phase": "lite_certify", "headers": LITE_HEADERS,
          "window": default_window(LITE_VALIDATORS), "route": routes,
          "wall_ms": wall * 1e3, "headers_per_s": LITE_HEADERS / wall,
          "sigs_per_s": n_sigs / wall, "kernel_ms": kernel_ms,
          "device_busy": sum(kernel_ms.values()) / (wall * 1e3),
          "launches": launches, "prep_route": certify_prep, "card": card})
    require(routes == LITE_ROUTES,
            f"certify_chain took cache routes {routes}, want {LITE_ROUTES}")
    require(certify_prep["native"] == n_sigs and certify_prep["plain"] == 0,
            f"certify_chain's items did not take the native prep: "
            f"{certify_prep}")
    _require_launched(launches, KERNELS, "lite")
    ladder._launch = inner

    rng = np.random.RandomState(SEED + 3)
    h_bad = int(rng.randint(1, LITE_HEADERS + 1))
    j_bad = int(rng.randint(LITE_VALIDATORS))
    fc = fcs[h_bad - 1]
    sh = fc.signed_header
    precommits = list(sh.commit.precommits)
    vote = copy.copy(precommits[j_bad])
    vote.signature = vote.signature[:40] + bytes([vote.signature[40] ^ 1]) \
        + vote.signature[41:]
    precommits[j_bad] = vote
    forged = list(fcs)
    forged[h_bad - 1] = FullCommit(SignedHeader(
        sh.header, Commit(sh.block_id, precommits), sh.block_id), valset)
    _expect_raise(f"flipped signature byte at height {h_bad}", forged,
                  valset, CertificationError,
                  lambda m: m == f"height {h_bad}: invalid signature in "
                                "commit")

    h_moved = int(rng.randint(1, LITE_HEADERS + 1))
    sh = fcs[h_moved - 1].signed_header
    header = copy.copy(sh.header)
    header.app_hash = b"\xee" * 32
    moved = list(fcs)
    moved[h_moved - 1] = FullCommit(SignedHeader(header, sh.commit,
                                                 sh.block_id), valset)
    _expect_raise(f"app_hash changed after signing at height {h_moved}",
                  moved, valset, CertificationError,
                  lambda m: m == "commit is not for this header")

    other = ValidatorSet([Validator(v.pubkey, v.voting_power + 1)
                          for v in valset.validators])
    _expect_raise("another trusted set", fcs, other, ValidatorsChangedError,
                  lambda m: m == "valset discontinuity at height 1")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: one consensus height through the block plane
# ---------------------------------------------------------------------------

def _ms() -> float:
    return time.perf_counter() * 1e3


def _launch_delta(before: dict) -> dict:
    return {k: ladder.launches[k] - before[k] for k in ladder.launches}


def _step_kernels(timer: list, mark: int) -> dict:
    """The kernels' event ms and launches of the launches logged since
    `mark`."""
    timed = timer[mark:]
    counts: dict = {}
    for name, _, _, _ in timed:
        counts[name] = counts.get(name, 0) + 1
    return {"kernel_ms": _kernel_ms(timed), "launches": counts}


def _block_evidence(vs, last_commit, key_of) -> DuplicateVoteEvidence:
    """A validator's precommit in the last commit, and its second
    precommit at that height and round for another block, signed with
    the table signer."""
    j = len(vs) // 2
    val = vs.validators[j]
    a, prefix, pub = key_of[val.pubkey]
    first = last_commit.precommits[j]
    second = Vote(val.address, j, first.height, first.round,
                  first.timestamp_ns + 1, VoteType.PRECOMMIT,
                  BlockID(b"\xe7" * 32, first.block_id.parts))
    second.signature = ed25519_fast.sign_expanded(
        a, prefix, pub, second.sign_bytes(CHAIN))
    return DuplicateVoteEvidence(val.pubkey, first, second)


def _step_propose(vs, last_commit, evidence, height, part_size, card):
    """Step 1: build and fill the block, its part set and its block id."""
    txs = [b"k%d.%d=v" % (height, i) for i in range(BLOCK_TXS)]
    t0 = _ms()
    header = Header(chain_id=CHAIN, height=height,
                    time_ns=1_700_000_000_000_000_000 + height,
                    num_txs=len(txs), total_txs=len(txs),
                    last_block_id=last_commit.block_id,
                    validators_hash=vs.hash(),
                    consensus_hash=ConsensusParams().hash(),
                    app_hash=b"\x0a" * 32)
    block = Block(header, Data(txs), EvidenceData([evidence]), last_commit)
    t1 = _ms()
    block.fill_header()
    t2 = _ms()
    data = block.to_bytes()
    t3 = _ms()
    ps = block.make_part_set(part_size)
    t4 = _ms()
    block_id = block.block_id(part_size)
    t5 = _ms()
    block.validate_basic()
    emit({"phase": "block_propose", "height": height, "txs": len(txs),
          "last_commit_precommits": last_commit.size(), "evidence": 1,
          "block_bytes": len(data), "part_size": part_size,
          "parts": ps.total, "wall_ms": t5 - t0,
          "stages_ms": {"header": t1 - t0, "fill_header": t2 - t1,
                        "to_bytes": t3 - t2, "part_set": t4 - t3,
                        "block_id": t5 - t4},
          "card": card})
    require(ps.total > 1 and block_id.parts == ps.header(),
            "the block's part set")
    return block, ps, block_id


def _step_gossip(block, ps, block_id, part_size, card) -> None:
    """Step 2: a receiver takes every part through its proof, refuses a
    part with a flipped payload byte, and rebuilds the block."""
    rx = PartSet.from_header(block_id.parts)
    good = ps.get_part(ps.total // 2)
    bad = Part(good.index, _flip(good.payload, 100), good.proof)
    t0 = _ms()
    refused = None
    try:
        rx.add_part(bad)
    except ValueError as e:
        refused = str(e)
    t1 = _ms()
    added = [rx.add_part(ps.get_part(i)) for i in range(ps.total)]
    t2 = _ms()
    got = Block.from_bytes(rx.get_data())
    t3 = _ms()
    same = got.hash() == block.hash() and got.block_id(part_size) == block_id
    t4 = _ms()
    emit({"phase": "block_gossip", "parts": ps.total, "refused": refused,
          "proofs_verified": sum(added), "equal_to_proposer": same,
          "wall_ms": t4 - t0,
          "stages_ms": {"tampered_part": t1 - t0, "add_parts": t2 - t1,
                        "from_bytes": t3 - t2, "hash_and_block_id": t4 - t3},
          "card": card})
    require(refused == "invalid part proof" and rx.bit_array()[good.index],
            f"the tampered part: {refused!r}")
    require(all(added) and rx.is_complete(), "a part's proof failed")
    require(same, "the received block's hash or block id differs")


def _add_batch_read(vset, votes, timer):
    """vset.add_votes_batch(votes), its host stages read inside the call
    by wrapping, for that call only, what it calls at their boundaries:
    the first Vote.sign_bytes ends the validation loop, the verifier's
    verify_async call ends the sign bytes and is the dispatch (native
    prep inside it), its resolver is the wait, and what follows the
    resolver is the _add_verified loop. Returns (results, errors, stats)."""
    verifier = tverifier.default_verifier()
    marks: dict = {}
    prep = {"ms": 0.0}
    calls: list = []
    sign_bytes = Vote.sign_bytes

    def first_sign_bytes(self, chain_id):
        if "sign_bytes" not in marks:
            marks["sign_bytes"] = _ms()
        return sign_bytes(self, chain_id)

    def timed_prep(items, fn=ted.prep_items):
        t0 = _ms()
        try:
            return fn(items)
        finally:
            prep["ms"] += _ms() - t0

    def dispatch(items, verify_async=verifier.verify_async):
        marks["dispatch"] = _ms()
        launched = dict(ladder.launches)
        res = verify_async(items)
        marks["dispatched"] = _ms()
        calls.append((len(items), _launch_delta(launched)))

        def resolve():
            marks["resolve"] = _ms()
            try:
                return res()
            finally:
                marks["resolved"] = _ms()
        return resolve

    mark = len(timer)
    route_before, prep_before = ted.predecomp_stats(), ted.prep_stats()
    saved = _patched([(Vote, "sign_bytes", first_sign_bytes),
                      (ted, "prep_items", timed_prep),
                      (verifier, "verify_async", dispatch)])
    try:
        t0 = _ms()
        results, errors = vset.add_votes_batch(votes)
        t1 = _ms()
    finally:
        _restore(saved)
    stages = {"validation": marks["sign_bytes"] - t0,
              "sign_bytes": marks["dispatch"] - marks["sign_bytes"],
              "dispatch": marks["dispatched"] - marks["dispatch"],
              "native_prep": prep["ms"],
              "resolve": marks["resolved"] - marks["resolve"],
              "add_verified": t1 - marks["resolved"]}
    stages["unattributed"] = (t1 - t0) - sum(
        v for k, v in stages.items() if k != "native_prep")
    kern = _step_kernels(timer, mark)
    stats = {"wall_ms": t1 - t0, "stages_ms": stages,
             "verify_async_calls": len(calls),
             "items": [n for n, _ in calls],
             "launches_in_call": [d for _, d in calls],
             "route": _route(route_before, ted.predecomp_stats()),
             "prep_route": _prep_delta(prep_before), **kern,
             "device_busy": sum(kern["kernel_ms"].values()) / (t1 - t0)}
    return results, errors, stats


def _step_votes(type_, vs, block_id, seed_of, height, timer, card):
    """Steps 3 and 4: sign one vote of each validator for the block (and
    a conflicting one of a third) with sign_batch_async, then feed them
    with a flipped signature and a duplicate through one add_votes_batch;
    returns the VoteSet."""
    n = len(vs)
    what = "prevotes" if type_ == VoteType.PREVOTE else "precommits"
    other = BlockID(b"\xc3" * 32, block_id.parts)
    votes = [Vote(v.address, i, height, 0, 1_800_000_000_000 + i, type_,
                  block_id) for i, v in enumerate(vs.validators)]
    k_bad, k_dup, k_conf = n // 5, n // 3, n // 2
    conflict = Vote(vs.validators[k_conf].address, k_conf, height, 0,
                    1_900_000_000_000, type_, other)
    signed = votes + [conflict]
    seeds = [seed_of[v.pubkey] for v in vs.validators] + \
        [seed_of[vs.validators[k_conf].pubkey]]
    mark = len(timer)
    prep_before = ted.prep_stats()
    t0 = _ms()
    msgs = [v.sign_bytes(CHAIN) for v in signed]
    t1 = _ms()
    resolve = ted.sign_batch_async(seeds, msgs)
    t2 = _ms()
    sigs = resolve()
    t3 = _ms()
    for v, sg in zip(signed, sigs):
        v.signature = sg
    sign = {"wall_ms": t3 - t0, "sign_bytes_ms": t1 - t0,
            "dispatch_ms": t2 - t1, "resolve_ms": t3 - t2,
            "signatures": len(sigs), "prep_route": _prep_delta(prep_before),
            **_step_kernels(timer, mark)}
    require(sign["prep_route"]["sign_native"] == len(sigs),
            f"the {what}' signing did not take the native phases")
    flipped = dataclasses.replace(
        votes[k_bad], signature=_flip(votes[k_bad].signature, 17))
    vset = VoteSet(CHAIN, height, 0, type_, vs)
    results, errors, stats = _add_batch_read(
        vset, votes + [flipped, votes[k_dup], conflict], timer)
    got_errors = [(p, type(e).__name__) for p, e in errors]
    maj = vset.two_thirds_majority()
    emit({"phase": f"block_{what}", "validators": n, "sign": sign,
          "add_votes_batch": stats, "errors": got_errors,
          "majority_for_block": maj == block_id, "card": card})
    off = [i for i, r in enumerate(results) if r != (i < n)]
    require(not off and len(results) == n + 3, f"{what}: results at {off}")
    require(got_errors == [(n, "ValueError"), (n + 2, "ConflictingVoteError")]
            and str(errors[0][1]) == f"invalid signature on {flipped}"
            and not errors[1][1].added, f"{what}: errors {got_errors}")
    require(maj == block_id and vset.has_two_thirds_majority(),
            f"{what}: no +2/3 for the block")
    require(stats["verify_async_calls"] == 1 and stats["items"] == [n + 3]
            and sum(stats["launches_in_call"][0][k]
                    for k in VERIFY_KERNELS) > 0,
            f"{what}: the batch did not reach the verify kernels in one call")
    require(stats["prep_route"]["native"] == n + 3,
            f"{what}: items off the native prep {stats['prep_route']}")
    return vset


def _step_commit(vset, vs, block_id, height, timer, card):
    """Step 4's end: make_commit, verify_commit on the card, and the
    commit's hash in the next block's header."""
    mark = len(timer)
    route_before = ted.predecomp_stats()
    t0 = _ms()
    commit = vset.make_commit()
    t1 = _ms()
    vs.verify_commit(CHAIN, block_id, height, commit)
    t2 = _ms()
    nxt = Block(Header(chain_id=CHAIN, height=height + 1,
                       last_block_id=block_id, validators_hash=vs.hash()),
                last_commit=commit)
    nxt.fill_header()
    t3 = _ms()
    kern = _step_kernels(timer, mark)
    emit({"phase": "block_commit", "precommits": sum(
              p is not None for p in commit.precommits),
          "make_commit_ms": t1 - t0, "verify_commit_ms": t2 - t1,
          "next_header_ms": t3 - t2,
          "route": _route(route_before, ted.predecomp_stats()), **kern,
          "device_busy": sum(kern["kernel_ms"].values()) / (t2 - t1),
          "card": card})
    require(sum(p is not None for p in commit.precommits) == len(vs),
            "make_commit lost a precommit")
    require(nxt.header.last_commit_hash == commit.hash(),
            "the next header's last_commit_hash")


def _step_evidence(evidence, timer, card) -> None:
    """Step 5: the evidence through a BatchVerifier("cuda") and the
    default verifier, whose "auto" takes its host loop at two signatures;
    a forged second vote must raise on both."""
    cuda_v = tverifier.BatchVerifier("cuda")
    auto_v = tverifier.default_verifier()
    auto_before = dict(auto_v.stats)
    forged = DuplicateVoteEvidence(
        evidence.pubkey, evidence.vote_a, dataclasses.replace(
            evidence.vote_b, signature=_flip(evidence.vote_b.signature, 33)))
    out = {}
    for route, verifier in (("cuda", cuda_v), ("auto", None)):
        mark = len(timer)
        t0 = _ms()
        evidence.verify(CHAIN, evidence.pubkey, verifier=verifier)
        t1 = _ms()
        raised = None
        try:
            forged.verify(CHAIN, forged.pubkey, verifier=verifier)
        except ValueError as e:
            raised = str(e)
        out[route] = {"verify_ms": t1 - t0, "forged_raised": raised,
                      **_step_kernels(timer, mark)}
    auto_sigs = auto_v.stats["sigs"] - auto_before["sigs"]
    auto_cuda = auto_v.stats["cuda_sigs"] - auto_before["cuda_sigs"]
    emit({"phase": "block_evidence", **out, "cuda_route_sigs":
          cuda_v.stats["cuda_sigs"], "auto_route_sigs": auto_sigs,
          "auto_batch_path_sigs": auto_cuda, "card": card})
    require(all(o["forged_raised"] == "invalid signature in evidence"
                for o in out.values()), f"the forged evidence: {out}")
    require(cuda_v.stats["cuda_sigs"] == 4 and auto_sigs == 4
            and auto_cuda == 0, "the evidence's verifier routes")


def _profiled_device_ms(fn):
    """Device time of the kernels `fn` launches, summed from
    torch.profiler's CUDA activity; None when it records none. The CPU
    activity is not recorded: its ~5,000 host events a call only
    lengthen the profiler's post-processing."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        total += us
    return total / 1e3 if total > 0 else None


def _step_merkle(block, device, card) -> None:
    """Step 6: the device Merkle root of the txs against Data.hash and
    hashlib, and hash_fixed on SHA_ROWS seeded 64-byte rows against
    hashlib; CUDA-event times (launch gaps included), the profiler's sum
    of kernel time for the tree's widest level and for hash_fixed, and
    the hashlib times beside them."""
    txs = block.data.txs
    n = len(txs)
    t0 = _ms()
    host_root = merkle.root_plain(txs)
    t1 = _ms()
    dev_root = merkle.root(txs)
    t2 = _ms()
    merkle.root(txs)
    t3 = _ms()
    digests = b"".join(merkle.leaf_hash(t) for t in txs)
    t4 = _ms()
    padded = torch.from_numpy(merkle.pad_digests(np.frombuffer(
        digests, np.uint8).reshape(n, 32).copy())).to(device)
    # one call, warm from the two roots above (~1.4 s a tree on the H100)
    tree_ms, tree_root = _time_once_ms(
        lambda: merkle.root_from_digests(padded, n))
    # the profiler's post-processing grows with the kernels it records
    # (~5,000 a level): it reads one level, the widest, not the tree
    level_ms, _ = _time_ms(lambda: merkle._level_up(padded), 3)
    t5 = _ms()
    level_busy_ms = _profiled_device_ms(lambda: merkle._level_up(padded))
    t6 = _ms()
    rows = np.random.RandomState(SEED + 6).randint(
        0, 256, (SHA_ROWS, 64), dtype=np.uint8)
    rows_dev = torch.from_numpy(rows).to(device)
    sha_ms, got = _time_ms(lambda: sha256.hash_fixed(rows_dev), 3)
    t7 = _ms()
    sha_busy_ms = _profiled_device_ms(lambda: sha256.hash_fixed(rows_dev))
    t8 = _ms()
    flat = rows.tobytes()
    want = [hashlib.sha256(flat[64 * i:64 * (i + 1)]).digest()
            for i in range(SHA_ROWS)]
    t9 = _ms()
    sha_equal = got.cpu().numpy().tobytes() == b"".join(want)
    t10 = _ms()
    native_root = merkle.root_host(txs)
    t11 = _ms()
    emit({"phase": "block_merkle", "leaves": n,
          "padded_leaves": padded.shape[0],
          "root_equal": dev_root == host_root == block.data.hash(),
          "root_wall_ms": t2 - t1, "root_wall_warm_ms": t3 - t2,
          "host_leaf_ms": t4 - t3, "device_tree_ms": tree_ms,
          "device_level_ms": level_ms, "device_level_kernel_ms": level_busy_ms,
          "hashlib_root_ms": t1 - t0, "native_root_ms": t11 - t10,
          "sha_rows": SHA_ROWS,
          "hash_fixed_ms": sha_ms, "hash_fixed_kernel_ms": sha_busy_ms,
          "hashlib_ms": t9 - t8, "hash_fixed_equal": sha_equal,
          "profiler_wall_ms": (t6 - t5) + (t8 - t7), "card": card})
    require(dev_root == host_root == native_root == block.data.hash()
            and tree_root.cpu().numpy().tobytes() == host_root,
            "the device Merkle root differs from the host's")
    require(sha_equal, "hash_fixed differs from hashlib")


def phase_block(card: str, keys, commit_path, device) -> dict:
    """One consensus height of phase 3's 10,000-validator chain: propose,
    gossip, prevotes, precommits and commit, evidence, device Merkle."""
    vs, _, last_commit = commit_path
    height = HEIGHT + 1
    part_size = BLOCK_PART_SIZE
    seeds = _seeds(len(keys), SEED)
    seed_of = {pub: s for (_, _, pub), s in zip(keys, seeds)}
    key_of = {k[2]: k for k in keys}
    evidence = _block_evidence(vs, last_commit, key_of)
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    t0 = _ms()
    block, ps, block_id = _step_propose(vs, last_commit, evidence, height,
                                        part_size, card)
    t1 = _ms()
    _step_gossip(block, ps, block_id, part_size, card)
    t2 = _ms()
    _step_votes(VoteType.PREVOTE, vs, block_id, seed_of, height, timer, card)
    t3 = _ms()
    vset = _step_votes(VoteType.PRECOMMIT, vs, block_id, seed_of, height,
                       timer, card)
    _step_commit(vset, vs, block_id, height, timer, card)
    t4 = _ms()
    _step_evidence(evidence, timer, card)
    t5 = _ms()
    _step_merkle(block, device, card)
    t6 = _ms()
    launches = dict(ladder.launches)
    ladder._launch = inner
    emit({"phase": "block_height_summary", "validators": len(vs),
          "walls_ms": {"propose": t1 - t0, "gossip": t2 - t1,
                       "prevotes": t3 - t2, "precommits_and_commit": t4 - t3,
                       "evidence": t5 - t4, "merkle": t6 - t5},
          "kernel_ms": _kernel_ms(timer), "launches": launches,
          "card": card})
    _require_launched(launches, KERNELS, "block height")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: fast sync of BASELINE config 4's chain through the window engine
# ---------------------------------------------------------------------------

class _TimedFuture:
    def __init__(self, fut, waits: list):
        self._fut, self._waits = fut, waits

    def result(self):
        t0 = time.perf_counter()
        try:
            return self._fut.result()
        finally:
            self._waits.append((time.perf_counter() - t0) * 1e3)


class _TimedResolver:
    """The reactor's one-thread resolver, installed for the phase so that
    the sync loop's wait in fut.result() is read."""

    def __init__(self, waits: list):
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tm-fastsync-resolve")
        self._waits = waits

    def submit(self, fn):
        return _TimedFuture(self._pool.submit(fn), self._waits)

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


def _sync_node(gen, verifier):
    """A fresh node: stores on MemDB, the kvstore app after init_chain, an
    executor on `verifier` and a fast-syncing reactor at VERIFY_WINDOW."""
    ss, bs = StateStore(MemDB()), BlockStore(MemDB())
    state = ss.load_or_genesis(gen)
    conns = AppConns(local_client_creator(KVStoreApp()))
    conns.consensus.init_chain(
        [ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen.chain_id)
    exe = BlockExecutor(ss, conns.consensus, verifier=verifier)
    reactor = BlockchainReactor(state, exe, bs, fast_sync=True,
                                verify_window=SYNC_WINDOW)
    return reactor, ss, bs, exe


def _instant_peers(reactor, served: dict) -> None:
    """bench_fastsync.sync_chain's in-process peers: a request for height
    h is answered at once from served[peer][h - 1]."""
    pool = reactor.pool

    def send_request(peer_id, height):
        pool.add_block(peer_id, served[peer_id][height - 1], 1)
        return True

    pool.send_request = send_request
    pool.max_pending_per_peer = 1 << 20
    for peer_id, blocks in served.items():
        pool.set_peer_height(peer_id, len(blocks))


SYNC_STAGES = ("collect_ms", "parts_ms", "items_ms", "dispatch_ms",
               "host_prep_ms", "upload_ms", "launch_ms", "wait_ms",
               "apply_ms", "check_ms", "verify_commit_ms", "save_block_ms",
               "validate_ms", "validate_basic_ms", "exec_ms", "deliver_ms",
               "results_hash_ms", "responses_obj_ms", "save_responses_ms",
               "app_commit_ms", "state_save_ms")


def _sync_patches(reactor, ss, bs, exe, st: dict, collected: list):
    """Wrap, for the phase only, the functions at the window engine's stage
    boundaries so that each adds its host time to a stage of `st`: collect
    (part sets and ids, commit items), dispatch (native prep, uploads,
    launches), apply (the batched power check, save_block, validate_block
    with validate_basic, exec_block_on_app with deliver, results_hash, the
    persisted responses, app commit, the state save)."""
    def timed(fn, stage):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                st[stage] += (time.perf_counter() - t0) * 1e3
        return call

    def collect(skip, inner=timed(reactor._collect_window, "collect_ms")):
        out = inner(skip)
        collected.append(0 if out is None else len(out[0]))
        return out

    verifier = exe.verifier
    app = exe.app_conn
    return [
        (reactor, "_collect_window", collect),
        (reactor, "_parts_and_id", timed(reactor._parts_and_id, "parts_ms")),
        (ValidatorSet, "commit_verification_items",
         timed(ValidatorSet.commit_verification_items, "items_ms")),
        (verifier, "verify_async", timed(verifier.verify_async,
                                         "dispatch_ms")),
        (ted, "prep_items", timed(ted.prep_items, "host_prep_ms")),
        (ted, "_upload", timed(ted._upload, "upload_ms")),
        (ladder, "verify", timed(ladder.verify, "launch_ms")),
        (ladder, "verify_pre", timed(ladder.verify_pre, "launch_ms")),
        (reactor, "_apply_window", timed(reactor._apply_window, "apply_ms")),
        (ValidatorSet, "check_commit_results",
         timed(ValidatorSet.check_commit_results, "check_ms")),
        (ValidatorSet, "verify_commit",
         timed(ValidatorSet.verify_commit, "verify_commit_ms")),
        (bs, "save_block", timed(bs.save_block, "save_block_ms")),
        (exe, "validate_block", timed(exe.validate_block, "validate_ms")),
        (Block, "validate_basic", timed(Block.validate_basic,
                                        "validate_basic_ms")),
        (texec, "exec_block_on_app", timed(texec.exec_block_on_app,
                                           "exec_ms")),
        (app, "deliver_tx_batch", timed(app.deliver_tx_batch, "deliver_ms")),
        (texec, "results_hash", timed(texec.results_hash,
                                      "results_hash_ms")),
        (texec.ABCIResponses, "to_obj", timed(texec.ABCIResponses.to_obj,
                                              "responses_obj_ms")),
        (ss, "save_abci_responses", timed(ss.save_abci_responses,
                                          "save_responses_ms")),
        (app, "commit", timed(app.commit, "app_commit_ms")),
        (ss, "save", timed(ss.save, "state_save_ms"))]


def _expected_routes(n_blocks: int, window: int, verifier) -> list:
    """The cache routes of each _sync_window call's dispatch from a cold
    cache. In chunk order: the first meets 64 unseen keys (full, B1), the
    second the same keys seen but not cached (fill, B2), every later one
    hits (B2). A window of at most `auto_threshold` signatures verifies
    on the host (no route); the last call only applies."""
    seq = iter(["full", "fill"] + ["hit"] * n_blocks * SYNC_VALIDATORS)
    out = []
    for lo in range(0, n_blocks, window):
        r = {"full": 0, "fill": 0, "hit": 0}
        sigs = min(window, n_blocks - lo) * SYNC_VALIDATORS
        if sigs <= verifier.auto_threshold:
            sigs = 0
        for _ in range(-(-sigs // tverifier.BATCH_CHUNK)):
            r[next(seq)] += 1
        out.append(r)
    return out + [{"full": 0, "fill": 0, "hit": 0}]


def _build_sync_chain(device, timer: list, card: str):
    """Step 1: the chain (SYNC_BLOCKS and a sentinel) built, signed on B3
    and applied by the port's builder, serialized, and parsed back by
    Block.from_bytes for the syncing node (the wire path)."""
    b = ChainBuilder(SYNC_VALIDATORS, SYNC_TXS, key_space=SYNC_KEY_SPACE,
                     device=device)
    times: dict = {}
    mark = len(timer)
    t0 = time.perf_counter()
    blocks = b.build(FORGE_BLOCKS, times)
    state_forge = b.state
    blocks += b.build(SYNC_BLOCKS - FORGE_BLOCKS, times)
    state_final = b.state
    blocks += b.build(1, times)
    t1 = time.perf_counter()
    wire = [blk.to_bytes() for blk in blocks]
    t2 = time.perf_counter()
    recv = [Block.from_bytes(raw) for raw in wire]
    t3 = time.perf_counter()
    sign = _step_kernels(timer, mark)
    emit({"phase": "sync_build", "blocks": len(blocks),
          "validators": SYNC_VALIDATORS, "txs_per_block": SYNC_TXS,
          "key_space": SYNC_KEY_SPACE, "build_ms": (t1 - t0) * 1e3,
          "blocks_per_s": len(blocks) / (t1 - t0), **times,
          "serialize_ms": (t2 - t1) * 1e3, "from_bytes_ms": (t3 - t2) * 1e3,
          "bytes_per_block": sum(map(len, wire)) / len(wire),
          "parts_per_block": blocks[1].make_part_set(b.part_size).total,
          "sign_launches": sign["launches"],
          "sign_kernel_ms": sign["kernel_ms"], "card": card})
    return b, blocks, wire, recv, state_forge, state_final


def _sync_step(gen, recv, blocks, state_final, verifier, timer, card):
    """Step 2: a fresh node syncs SYNC_BLOCKS through _sync_window from a
    cold predecompression cache, each call's stages read inside it."""
    with ted._predecomp_lock:       # the lite phase used the same 64 seeds
        ted._predecomp.clear()
        ted._predecomp_seen.clear()
    reactor, ss, bs, exe = _sync_node(gen, verifier)
    _instant_peers(reactor, {"peer": recv})
    waits: list = []
    reactor._resolver = _TimedResolver(waits)
    st = dict.fromkeys(SYNC_STAGES, 0.0)
    collected: list = []
    saved = _patched(_sync_patches(reactor, ss, bs, exe, st, collected))
    calls, marks = [], []
    kv_before = kvstore.route_stats()
    try:
        t0 = time.perf_counter()
        reactor.pool.make_next_requests()
        while reactor.state.last_block_height < SYNC_BLOCKS:
            require(len(calls) < 4 * SYNC_BLOCKS, "the sync stopped moving")
            for k in st:
                st[k] = 0.0
            n_waits, h0, mark = len(waits), reactor.state.last_block_height, \
                len(timer)
            before = ted.predecomp_stats()
            t1 = time.perf_counter()
            progress = reactor._sync_window()
            wall = (time.perf_counter() - t1) * 1e3
            st["wait_ms"] = sum(waits[n_waits:])
            calls.append({"call": len(calls), "wall_ms": wall,
                          "collected": collected[-1],
                          "applied": reactor.state.last_block_height - h0,
                          "route": _route(before, ted.predecomp_stats()),
                          **st})
            marks.append(mark)
            if not progress:
                reactor.pool.make_next_requests()
        wall_s = time.perf_counter() - t0
    finally:
        _restore(saved)
        reactor.stop()
    kv_routes = {k: v - kv_before[k] for k, v in kvstore.route_stats().items()}
    for c, mark, end in zip(calls, marks, marks[1:] + [len(timer)]):
        c.update(_step_kernels(timer[:end], mark))
    routes = [c["route"] for c in calls]
    kernel_ms = _kernel_ms(timer[marks[0]:])
    per_launch = [(name, n, s.elapsed_time(e))
                  for name, n, s, e in timer[marks[0]:]]
    emit({"phase": "sync", "blocks": SYNC_BLOCKS, "window":
          reactor.verify_window, "wall_ms": wall_s * 1e3,
          "blocks_per_s": SYNC_BLOCKS / wall_s,
          "verifies_per_s": SYNC_BLOCKS * SYNC_VALIDATORS / wall_s,
          "calls": calls, "kernel_ms": kernel_ms, "launches_ms": per_launch,
          "device_busy": sum(kernel_ms.values()) / (wall_s * 1e3),
          "verifier_stats": dict(verifier.stats), "card": card})
    applied = sum(c["applied"] for c in calls)
    emit({"phase": "sync_apply_per_block", "blocks": applied,
          "stages_ms_per_block": {
              k: sum(c[k] for c in calls) / max(1, applied) for k in
              ("apply_ms", "save_block_ms", "validate_ms",
               "validate_basic_ms", "exec_ms", "deliver_ms",
               "results_hash_ms", "responses_obj_ms", "save_responses_ms",
               "app_commit_ms", "state_save_ms")},
          "kvstore_routes": kv_routes, "card": card})
    want = _expected_routes(SYNC_BLOCKS, reactor.verify_window, verifier)
    require(routes == want, f"the windows took cache routes {routes}, "
                            f"want {want}")
    require(kv_routes == {"native": SYNC_BLOCKS, "per_tx": 0, "pure": 0},
            f"synced blocks off the kv core: {kv_routes}")
    _sync_native_record(blocks[SYNC_BLOCKS // 2], card)
    require(tenc.cdumps(reactor.state.to_obj())
            == tenc.cdumps(state_final.to_obj())
            and ss.load().equals(state_final),
            "the synced state differs from the chain builder's")
    require(bs.height() == SYNC_BLOCKS and all(
        bs.load_block_meta(h).block_id.hash == blocks[h - 1].hash()
        and bs.load_seen_commit(h).to_bytes()
        == blocks[h].last_commit.to_bytes()
        for h in range(1, SYNC_BLOCKS + 1)),
        "a stored block or seen commit differs from the chain builder's")
    return calls


def _sync_native_record(block, card) -> None:
    """A record, not a check: on one synced block's txs, the native app's
    deliver and commit against the pure app's (fresh apps), and the
    canonical JSON of its per-tx responses object through the codec
    against the specification path. The two must give equal bytes and
    hashes."""
    txs = block.data.txs
    t0 = _ms()
    nat = KVStoreApp()
    res_n = nat.deliver_tx_batch(txs)
    hash_n = nat.commit()
    t1 = _ms()
    pure = KVStoreApp(use_native=False)
    res_p = pure.deliver_tx_batch(txs)
    hash_p = pure.commit()
    t2 = _ms()
    obj = texec.ABCIResponses(res_p, {"validator_updates": [],
                                      "consensus_param_updates": None,
                                      "tags": {}}).to_obj()
    t3 = _ms()
    got = tenc.cdumps(obj)
    t4 = _ms()
    want = tenc._pure_cdumps(obj)
    t5 = _ms()
    emit({"phase": "sync_native_record", "height": block.header.height,
          "txs": len(txs), "responses_bytes": len(got),
          "codec_ms": t4 - t3, "pure_codec_ms": t5 - t4,
          "kv_native_deliver_commit_ms": t1 - t0,
          "kv_pure_deliver_commit_ms": t2 - t1,
          "note": "a record, not a check: host times of one block's txs "
          "on fresh apps and of its per-tx responses object", "card": card})
    require(got == want, "the codec's bytes differ from the specification")
    require(hash_n == hash_p
            and texec.results_hash(res_n) == texec.results_hash(res_p),
            "the kv core's app or results hash differs from the pure app's")


def _forge(raw: bytes) -> Block:
    """The block of `raw` with one byte flipped in one precommit signature
    of its last commit."""
    obj = tenc.cloads(raw)
    pc = obj["last_commit"]["precommits"][SYNC_VALIDATORS // 2]
    sig = bytearray.fromhex(pc["signature"])
    sig[17] ^= 1
    pc["signature"] = sig.hex()
    return Block.from_obj(obj)


class _SwitchStub:
    """The switch members the reactor calls; records the stopped peers."""

    def __init__(self, reactor):
        self.reactor, self.stopped = reactor, []
        self.peers = {}

    def broadcast_obj(self, ch, obj) -> None:
        pass

    def stop_peer_for_error(self, peer, err) -> None:
        self.stopped.append((peer.id, str(err)))
        self.peers.pop(peer.id, None)
        self.reactor.remove_peer(peer, err)


def _forgery_step(gen, wire, state_forge, verifier, card):
    """Step 3: a second fresh node syncs FORGE_BLOCKS from a peer whose
    block FORGE_AT carries a flipped signature in its last commit: the
    window must be cut before FORGE_AT - 1, that height re-requested, the
    peer stopped and the window in flight dropped; an honest peer then
    serves the rest and the node reaches FORGE_BLOCKS with the honest
    state."""
    honest = [Block.from_bytes(raw) for raw in wire[:FORGE_BLOCKS + 1]]
    forged = list(honest)
    forged[FORGE_AT - 1] = _forge(wire[FORGE_AT - 1])
    reactor, ss, bs, exe = _sync_node(gen, verifier)
    sw = reactor.switch = _SwitchStub(reactor)
    sw.peers["forger"] = SimpleNamespace(id="forger")
    served = {"forger": forged}
    _instant_peers(reactor, served)
    redo, redone = reactor.pool.redo_request, []
    reactor.pool.redo_request = lambda h: redone.append(h) or redo(h)
    cut = None
    t0 = time.perf_counter()
    try:
        reactor.pool.make_next_requests()
        for _ in range(100):
            if reactor.state.last_block_height >= FORGE_BLOCKS:
                break
            progress = reactor._sync_window()
            if redone and cut is None:
                cut = {"applied": reactor.state.last_block_height,
                       "pending_dropped": reactor._pending_window is None,
                       "redo": list(redone), "stopped": list(sw.stopped)}
                served["honest"] = honest
                sw.peers["honest"] = SimpleNamespace(id="honest")
                reactor.pool.set_peer_height("honest", len(honest))
            if not progress:
                reactor.pool.make_next_requests()
    finally:
        reactor.stop()
    wall = (time.perf_counter() - t0) * 1e3
    emit({"phase": "sync_forgery", "forged_at": FORGE_AT, "cut": cut,
          "height": reactor.state.last_block_height, "wall_ms": wall,
          "card": card})
    want = {"applied": FORGE_AT - 2, "pending_dropped": True,
            "redo": [FORGE_AT - 1],
            "stopped": [("forger",
                         f"bad block/commit at height {FORGE_AT - 1}")]}
    require(cut == want, f"the forged block: {cut}, want {want}")
    require(reactor.state.equals(state_forge)
            and bs.load_block(FORGE_AT).to_bytes() == wire[FORGE_AT - 1],
            "the node did not reach the honest state after the forgery")


def phase_sync(card: str, device) -> tuple:
    """Fast sync of BASELINE.json config 4's chain (64 validators, 5,000-tx
    blocks, 256-block windows), SYNC_BLOCKS deep: build and sign it on the
    card, sync a fresh node through the window engine, then a forged
    commit signature that must cut a window. Returns the launches and
    (genesis, the first MESH_SYNC_BLOCKS + 1 blocks' bytes) for phase
    19's drain."""
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    b, blocks, wire, recv, state_forge, state_final = _build_sync_chain(
        device, timer, card)
    verifier = tverifier.BatchVerifier("auto", device=device)
    _sync_step(b.gen, recv, blocks, state_final, verifier, timer, card)
    _forgery_step(b.gen, wire, state_forge, verifier, card)
    launches = dict(ladder.launches)
    ladder._launch = inner
    emit({"phase": "sync_summary", "launches": launches,
          "kernel_ms": _kernel_ms(timer), "card": card})
    _require_launched(launches, KERNELS, "fast sync")
    return launches, (b.gen, wire[:MESH_SYNC_BLOCKS + 1])


def phase_sync_registry_ab(card: str, device) -> dict:
    """Not part of main(): phase 8's chain built once, then synced by a
    fresh node four times with the metric registry off, on, on, off (the
    registry's cost on the in-process fast-sync path, one call)."""
    from tendermint_tpu_torch import telemetry
    timer: list = []
    inner = _time_launches(timer)
    b, blocks, wire, recv, state_forge, state_final = _build_sync_chain(
        device, timer, card)
    verifier = tverifier.BatchVerifier("auto", device=device)
    out = []
    try:
        for on in (False, True, True, False):
            telemetry.set_enabled(on)
            calls = _sync_step(b.gen, recv, blocks, state_final, verifier,
                               timer, card)
            wall_s = sum(c["wall_ms"] for c in calls) / 1e3
            out.append({"registry": on, "blocks_per_s": SYNC_BLOCKS / wall_s,
                        "apply_ms_per_block": sum(c["apply_ms"]
                                                  for c in calls)
                        / SYNC_BLOCKS})
    finally:
        telemetry.set_enabled(True)
        ladder._launch = inner
    emit({"phase": "sync_registry_ab", "runs": out, "note": "a record, "
          "not a check: the windows' wall summed", "card": card})
    return {"runs": out}


# ---------------------------------------------------------------------------
# Phase 9: consensus, BASELINE.json config 1
# ---------------------------------------------------------------------------

CONS_TXS = MAX_BLOCK_TXS  # config 1's block width: max_block_size_txs
# run A: 40 heights (config 1 has no depth: a live net; cut for the
# script's time); the standby key joins at 10 and leaves at 20,
# validator 1 equivocates at 25, a forged prevote reaches node 0 at 30,
# node 3 (SQLite stores, file WAL) crashes after 35
CONS_SCHEDULE = Schedule(heights=40, txs=CONS_TXS, join_at=10, leave_at=20,
                         equivocate_at=25, forge_at=30, restart_after=35)
CONS_B_HEIGHTS = 15       # run B, the same schedule on "auto"
N_RECHECK_CALLS = 64      # node 0's last verify dispatches held to the plain

# the host stages of a height, read inside the calls: (owner, attribute)
CONS_STAGES = {
    "check_tx_batch": (Mempool, "check_tx_batch"),
    "reap": (Mempool, "reap"),
    "make_block": (State, "make_block"),
    "part_set": (Block, "make_part_set"),
    "sign_proposal": (PrivValidator, "sign_proposal"),
    "sign_vote": (PrivValidator, "sign_vote"),
    "from_bytes": (Block, "from_bytes"),
    "vote_from_obj": (Vote, "from_obj"),
    "vote_set_add": (VoteSet, "_add_verified"),
    "validate_block": (BlockExecutor, "validate_block"),
    "save_block": (BlockStore, "save_block"),
    "wal": (WAL, "save"),
    "apply_block": (BlockExecutor, "apply_block"),
    "deliver": (LocalClient, "deliver_tx_batch"),
    "results_hash": (texec.ABCIResponses, "results_hash"),
    "save_responses": (StateStore, "save_abci_responses"),
    "app_commit": (LocalClient, "commit"),
    "mempool_update": (Mempool, "update"),
    "recheck": (Mempool, "_recheck_txs"),
    "state_save": (StateStore, "save"),
    "events": (EventBus, "publish"),
}


def _stage_patches(acc: list) -> list:
    """Wrap each CONS_STAGES function (for every node: they are the
    classes' own) so that it adds its host ms to acc[0][stage]; and
    BatchVerifier.verify_async so that the dispatch and the resolver's
    wait add to acc[0]["verify"] and count acc[0]["verify_calls"]."""
    def timed(fn, stage):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                acc[0][stage] += (time.perf_counter() - t0) * 1e3
        return call

    patches = []
    for stage, (owner, name) in CONS_STAGES.items():
        fn = vars(owner)[name]
        if isinstance(fn, classmethod):
            patches.append((owner, name, classmethod(timed(fn.__func__,
                                                           stage))))
        else:
            patches.append((owner, name, timed(fn, stage)))

    def verify_async(self, items, inner=tverifier.BatchVerifier.verify_async):
        acc[0]["verify_calls"] += 1
        return timed(timed(inner, "verify")(self, items), "verify")

    patches.append((tverifier.BatchVerifier, "verify_async", verify_async))
    return patches


def _node0_recorder(verifier, log: deque) -> list:
    """Patches that keep, for each of node 0's last N_RECHECK_CALLS
    dispatches, the card tensors and verdicts of the launches it made (on
    the dispatching thread: other nodes' threads launch at the same time
    over sockets). A dispatch is a call of the verifier's direct path: a
    call that bypassed the coalescer, or one merged dispatch on the
    coalescer's thread (which looks the direct path up on the instance at
    each dispatch)."""
    inner_direct = verifier._verify_async_direct
    current: dict = {}   # thread id -> launches of its dispatch in progress

    def verify_direct(items, *path):
        me = threading.get_ident()
        current[me] = []
        try:
            return inner_direct(items, *path)
        finally:
            log.append(current.pop(me))

    def rec(name, fn):
        def call(*args):
            out = fn(*args)
            mine = current.get(threading.get_ident())
            if mine is not None:
                mine.append((name, args, out))
            return out
        return call

    return [(verifier, "_verify_async_direct", verify_direct),
            (ladder, "verify", rec("verify", ladder.verify)),
            (ladder, "verify_pre", rec("verify_pre", ladder.verify_pre))]


def _recheck_plain(log: deque) -> dict:
    """The recorded launches' verdicts against the plain versions on the
    same card tensors: all launches of a kernel concatenated into one
    plain call."""
    launches = [x for call in log for x in call]
    out = {"calls": len(log), "launches": len(launches)}
    for name in VERIFY_KERNELS:
        mine = [(args, got) for n, args, got in launches if n == name]
        if not mine:
            out[name + "_lanes"] = 0
            continue
        cols = [torch.cat(c) for c in zip(*(a for a, _ in mine))]
        got = torch.cat([g for _, g in mine])
        if name == "verify":
            pk, rb, sb, hb = cols
            want = ladder.verify_plain(pk, rb, ladder.digits_from_bytes(sb),
                                       ladder.digits_from_bytes(hb))
        else:
            xn, y, ok, rb, sb, hb = cols
            want = ladder.verify_pre_plain(
                xn, y, ok, rb, ladder.digits_from_bytes(sb),
                ladder.digits_from_bytes(hb))
        require(torch.equal(got.cpu(), want.cpu()),
                f"node 0's {name} verdicts differ from the plain version's")
        out[name + "_lanes"] = int(got.numel())
    return out


def _agree(net, h: int) -> None:
    """Every live node at height h, with the same block, app hash and
    State bytes."""
    nodes = [n for i, n in enumerate(net.nodes) if net.live[i]]
    require(all(n.cs.state.last_block_height == h for n in nodes),
            f"height {h}: the nodes are at {net.heights()}")
    for what, get in (
            ("block", lambda n: n.block_store.load_block_meta(h).block_id
             .hash),
            ("app hash", lambda n: n.app.app_hash),
            ("state", lambda n: tenc.cdumps(n.cs.state.to_obj()))):
        require(len({get(n) for n in nodes}) == 1,
                f"height {h}: the nodes differ in their {what}")


def _run_consensus(name: str, verifier_of, sched: Schedule, home: str,
                   timer: list, card: str, node0_log=None) -> dict:
    """One run of the config-1 schedule `sched`."""
    net = Testnet(verifier_of=verifier_of, home=home, file_nodes=(FILE_NODE,))
    heights = sched.heights
    clock_ns = [T0]
    tclock.set_source(lambda: clock_ns[0])
    subs = [n.event_bus.subscribe("smoke", "tm.event = 'Tx'",
                                  capacity=4 * CONS_TXS) for n in net.nodes]
    acc = [defaultdict(float)]
    saved = _patched(_stage_patches(acc))
    if node0_log is not None:
        saved += _patched(_node0_recorder(net.nodes[0].block_exec.verifier,
                                          node0_log))
    fed, per_height, tx_events, restart = [], [], 0, None
    forged_rejected = None
    mark = len(timer)
    t_start = time.perf_counter()
    try:
        net.start()
        acc[0] = defaultdict(float)
        t0 = time.perf_counter()
        # each height's wall runs from the generator's resumption (clock
        # step, txs, events) to the net's commit of that height
        for h, refused in run_schedule(net, sched, standby_key(), clock_ns,
                                       fed):
            wall = (time.perf_counter() - t0) * 1e3
            if refused is not None:
                forged_rejected = refused
            _agree(net, h)
            for sub in subs:
                while not sub.empty():
                    sub.get_nowait()
                    tx_events += 1
            per_height.append({"height": h, "wall_ms": wall, **acc[0]})
            if h == sched.restart_after <= heights:
                restart = _restart(net, subs, h, card)
            acc[0] = defaultdict(float)
            t0 = time.perf_counter()
        wall_s = time.perf_counter() - t_start
    finally:
        _restore(saved)
        tclock.set_source(None)
    blocks = [net.nodes[0].block_store.load_block(x) for x in range(1, h + 1)]
    hashes = [b.hash() for b in blocks]
    counts = Counter(tx for b in blocks for tx in b.data.txs)
    require(counts == Counter(fed) and max(counts.values()) == 1,
            f"run {name}: the committed txs are not the fed txs, each once")
    require(tx_events == len(net.nodes) * len(fed)
            and all(n.event_bus.dropped_total == 0 for n in net.nodes),
            f"run {name}: {tx_events} Tx events for {len(fed)} txs, or drops")
    evidence = [(b.header.height, ev) for b in blocks
                for ev in b.evidence.evidence]
    out = {"hashes": hashes, "blocks": len(blocks), "txs": len(fed),
           "per_height": per_height, "wall_s": wall_s, "restart": restart,
           "evidence": evidence, "forged_rejected": forged_rejected,
           "rounds": [b.last_commit.round() for b in blocks[1:]],
           "validators": [len(n.cs.state.validators) for n in net.nodes]}
    if heights >= sched.equivocate_at:
        _check_misbehaviour(net, out, net.keys[1], sched.equivocate_at)
    # the last commit of block h holds one precommit a validator of h - 1
    sizes = [len(b.last_commit.precommits) for b in blocks[1:]]
    require(heights <= sched.join_at + 2 or max(sizes) == 5,
            f"run {name}: the standby key never joined")
    require(heights <= sched.leave_at + 2 or sizes[-1] == 4,
            f"run {name}: the standby key never left")
    _report_run(name, out, timer, mark, card)
    net.close()
    return out


def _restart(net, subs, height: int, card: str) -> dict:
    """Node 3 crashes after `height` commits; it is rebuilt from its
    SQLite files and WAL with a fresh app, and rejoins."""
    t0 = time.perf_counter()
    net.stop_node(FILE_NODE)
    t1 = time.perf_counter()
    hs_ms = []
    inner = Handshaker.handshake

    def handshake(self, conns):
        ts = time.perf_counter()
        try:
            return inner(self, conns)
        finally:
            hs_ms.append((time.perf_counter() - ts) * 1e3)
    Handshaker.handshake = handshake
    try:
        t2 = time.perf_counter()
        replayed = net.restart_node(FILE_NODE)
        t3 = time.perf_counter()
    finally:
        Handshaker.handshake = inner
    node = net.nodes[FILE_NODE]
    subs[FILE_NODE] = node.event_bus.subscribe(
        "smoke", "tm.event = 'Tx'", capacity=4 * CONS_TXS)
    require(node.handshaker.n_blocks == height,
            f"the handshake replayed {node.handshaker.n_blocks} blocks")
    require(node.app.app_hash == net.nodes[0].app.app_hash
            and node.cs.state.last_block_height == height,
            "the restarted node's app hash differs from the others'")
    out = {"phase": "consensus_restart", "node": FILE_NODE,
           "stop_ms": (t1 - t0) * 1e3, "handshake_ms": hs_ms[0],
           "handshake_blocks": node.handshaker.n_blocks,
           "catchup_ms": (t3 - t2) * 1e3 - hs_ms[0],
           "catchup_messages": replayed, "app_hash": node.app.app_hash.hex(),
           "card": card}
    emit(out)
    return out


def _check_misbehaviour(net, out: dict, key, height: int) -> None:
    """The equivocation's evidence committed in exactly one block, known
    as committed to every node's pool; the forged vote refused."""
    ev = out["evidence"]
    require(len(ev) == 1 and ev[0][0] >= height
            and ev[0][1].address() == key.pubkey.address
            and ev[0][1].height() == height,
            f"the equivocation's evidence: {[(h, e.to_obj()) for h, e in ev]}")
    for i, n in enumerate(net.nodes):
        require(n.evidence_pool.store.is_committed(ev[0][1])
                and not n.evidence_pool.pending_evidence(),
                f"node {i}'s pool does not hold the evidence as committed")
    require(out["forged_rejected"] is True,
            "node 0 counted the forged prevote")


def _stats(rows: list, key: str) -> dict:
    vals = sorted(r.get(key, 0.0) for r in rows)
    return {"median": vals[len(vals) // 2], "max": vals[-1]}


def _report_run(name: str, out: dict, timer: list, mark: int,
                card: str) -> None:
    rows = out["per_height"]
    kernels = _step_kernels(timer, mark)
    kernel_ms = sum(kernels["kernel_ms"].values())
    verify_ms = sum(r.get("verify", 0.0) for r in rows)
    emit({"phase": "consensus", "run": name, "blocks": out["blocks"],
          "txs": out["txs"], "wall_s": out["wall_s"],
          "blocks_per_s": out["blocks"] / out["wall_s"],
          "txs_per_s": out["txs"] / out["wall_s"],
          "verify_calls": int(sum(r.get("verify_calls", 0) for r in rows)),
          "verify_ms": verify_ms, "kernel_ms": kernels["kernel_ms"],
          "launches": kernels["launches"],
          "device_busy": kernel_ms / (out["wall_s"] * 1e3),
          "rounds_above_0": sum(1 for r in out["rounds"] if r),
          "validators_at_end": out["validators"],
          "evidence_at": [h for h, _ in out["evidence"]], "card": card})
    keys = sorted({k for r in rows for k in r} - {"height"})
    emit({"phase": "consensus_stages", "run": name, "unit": "ms a height, "
          "summed over the 4 nodes", "stages": {k: _stats(rows, k)
                                                for k in keys},
          "card": card})


def phase_consensus(card: str, device) -> dict:
    """BASELINE.json config 1: four in-process validators (kvstore, 1000-tx
    blocks) over a full-mesh relay, run A on BatchVerifier("cuda") for
    CONS_SCHEDULE's heights with a join, a leave, an equivocation, a forged
    vote and a crash and restart of node 3, then run B on "auto" for
    CONS_B_HEIGHTS heights of the same schedule: the same chain."""
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    node0_log: deque = deque(maxlen=N_RECHECK_CALLS)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cons-") as home:
        cuda_of = {i: tverifier.BatchVerifier("cuda", device=device)
                   for i in range(4)}
        run_a = _run_consensus("A", cuda_of.__getitem__, CONS_SCHEDULE,
                               os.path.join(home, "a"), timer, card,
                               node0_log)
        launches = dict(ladder.launches)
        auto = tverifier.BatchVerifier("auto", device=device)
        run_b = _run_consensus("B", lambda i: auto,
                               CONS_SCHEDULE._replace(heights=CONS_B_HEIGHTS),
                               os.path.join(home, "b"), timer, card)
    ladder._launch = inner
    rechecked = _recheck_plain(node0_log)
    emit({"phase": "consensus_summary", "launches": launches,
          "b_launches": {k: v - launches[k] for k, v in
                         ladder.launches.items()},
          "recheck": rechecked,
          "verifier_stats": [cuda_of[i].stats for i in range(4)],
          "run_b_hashes_equal": run_b["hashes"][:CONS_B_HEIGHTS]
          == run_a["hashes"][:CONS_B_HEIGHTS], "card": card})
    require(run_b["hashes"][:CONS_B_HEIGHTS]
            == run_a["hashes"][:CONS_B_HEIGHTS],
            "run B's chain differs from run A's: it depends on the route")
    # a consensus call verifies 1-4 signatures: its batch pads to 8 lanes,
    # below the predecompression cache's 64 (ops/ed25519._PREDECOMP_MIN_BATCH),
    # so the port runs every check on B1 (ladder_kernel<true>) and B2 never
    # launches; the JAX package at 8 lanes runs its jnp ladder, no Pallas
    # kernel (verify_from_bytes_best takes verify_pallas from 512 lanes)
    _require_launched(launches, ("verify",), "consensus")
    require(launches["verify_pre"] == 0 and launches["sign_rb"] == 0,
            f"consensus launched a kernel off its route: {launches}")
    require(ladder.launches == launches,
            f"run B (auto, host loop) launched kernels: {ladder.launches}")
    return launches




# ---------------------------------------------------------------------------
# Phase 10: BASELINE.json config 1 over loopback TCP
# ---------------------------------------------------------------------------

P2P_MEASURE = (5, 40)     # blocks/s, txs/s and stages over these heights
P2P_DROP_AT = 8           # node 3's links stopped when node 0 commits 8
P2P_DROPPED_HEIGHTS = 3   # the other three commit this many more alone
P2P_JOIN_AT = 34          # the fast-syncing joiner added at 34
P2P_HEIGHTS = 40          # the feeder stops here, then the mempools drain
P2P_WINDOW = 16           # the joiner's verify_window: a window verifies
#                           16 commits of 3-4 signatures (the block commits
#                           at +2/3), 48-64, padded to the predecompression
#                           cache's 64 lanes. SockNet.add_joiner downloads
#                           the backlog before the sync starts, as a pool
#                           runs ahead of a long backlog, so the windows are
#                           full
P2P_FEED = 2000           # node 0's mempool kept at >= this many fresh txs
#                           until node 0 commits P2P_HEIGHTS
P2P_FEED_BATCH = 500
P2P_WALL_S = 420.0        # the whole phase's wall limit


def _phase_deadline(t0: float):
    """Seconds left of the phase's wall limit; a stall past it fails."""
    def left(what: str) -> float:
        rem = P2P_WALL_S - (time.perf_counter() - t0)
        require(rem > 0, f"p2p: out of wall time at {what}")
        return rem
    return left


class _Feeder:
    """Keeps node 0's mempool at >= P2P_FEED fresh unique txs until node 0
    commits P2P_HEIGHTS; mempool gossip alone carries them to the others."""

    def __init__(self, node):
        self.node, self.fed, self.error = node, [], None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="smoke-feeder")

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                if self.node.block_store.height() >= P2P_HEIGHTS:
                    return
                if self.node.mempool.size() < P2P_FEED:
                    k = len(self.fed)
                    txs = [b"p2p/k%d=v%d" % (k + i, i)
                           for i in range(P2P_FEED_BATCH)]
                    res = self.node.mempool.check_tx_batch(txs)
                    self.fed += [t for t, r in zip(txs, res) if r.ok]
                else:
                    time.sleep(0.005)
        except Exception as e:  # surfaced by stop()
            self.error = e

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(10)
        require(self.error is None and not self._thread.is_alive(),
                f"the feeder failed: {self.error!r}")


def _p2p_stage_patches(node, rec: dict) -> list:
    """Node 0's per-height readings: the first time of each (height,
    round, step) it enters, when its proposal block completes, and its
    verify calls, apply and validate ms by height."""
    cs = node.cs

    def on_step(msg):
        if msg.get("type") == "new_round_step":
            rec["steps"].setdefault((msg["height"], msg["round"],
                                     msg["step"]), time.perf_counter())
    cs.broadcast_hooks.append(on_step)

    inner_part = cs._add_proposal_block_part

    def add_part(height, part):
        out = inner_part(height, part)
        rs = cs.rs
        if rs.proposal_block is not None:
            rec["block_done"].setdefault((rs.height, rs.round),
                                         time.perf_counter())
        return out

    def timed(fn, key):
        def call(*args, **kw):
            h = cs.rs.height
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                rec[key][h] += (time.perf_counter() - t0) * 1e3
        return call

    verifier = node.block_exec.verifier
    inner_async = verifier.verify_async

    def verify_async(items):
        h = cs.rs.height
        t0 = time.perf_counter()
        resolve = inner_async(items)

        def wait():
            try:
                return resolve()
            finally:
                rec["verify_ms"][h] += (time.perf_counter() - t0) * 1e3
        rec["verify_calls"][h] += 1
        rec["verify_sigs"][h] += len(items)
        return wait

    exe = node.block_exec
    return [(cs, "_add_proposal_block_part", add_part),
            (verifier, "verify_async", verify_async),
            (exe, "apply_block", timed(exe.apply_block, "apply_ms")),
            (exe, "validate_block", timed(exe.validate_block,
                                          "validate_ms"))]


def _p2p_heights(node, rec: dict, heights) -> list:
    """Per-height rows of node 0 from its readings, at the round that
    committed each height."""
    rows = []
    for h in heights:
        cr = node.block_store.load_seen_commit(h).round()
        st = rec["steps"]

        def gap(a, b):
            ta, tb = st.get((h, cr, a)), st.get((h, cr, b))
            return None if ta is None or tb is None else (tb - ta) * 1e3
        t_prop = st.get((h, cr, 3))
        t_block = rec["block_done"].get((h, cr))
        calls = rec["verify_calls"][h]
        rows.append({
            "height": h, "round": cr,
            "proposal_to_block_ms": (t_block - t_prop) * 1e3
            if t_prop is not None and t_block is not None else None,
            "prevote_quorum_ms": gap(4, 6), "precommit_quorum_ms": gap(6, 8),
            "verify_calls": calls,
            "sigs_per_call": rec["verify_sigs"][h] / calls if calls else 0,
            "verify_ms": rec["verify_ms"][h], "apply_ms": rec["apply_ms"][h],
            "validate_ms": rec["validate_ms"][h]})
    return rows


def _median(rows: list, key: str):
    vals = sorted(r[key] for r in rows if r[key] is not None)
    return vals[len(vals) // 2] if vals else None


def _channel_bytes_patches(acc: Counter) -> list:
    """MConnection.send / try_send add the bytes of every message queued
    to acc[channel]."""
    from tendermint_tpu_torch.p2p.conn.mconn import MConnection

    def counted(fn):
        def call(self, ch_id, msg, *a, **kw):
            ok = fn(self, ch_id, msg, *a, **kw)
            if ok:
                acc[f"{ch_id:#04x}"] += len(msg)
            return ok
        return call
    return [(MConnection, "send", counted(MConnection.send)),
            (MConnection, "try_send", counted(MConnection.try_send))]


def _aead_alone(reps: int = 200) -> dict:
    """The native burst AEAD on one thread with no net around it: a burst
    of 64 frames of 1000 bytes (the MConnection packet of a block part)
    sealed and opened `reps` times; -> host us a frame."""
    rng = np.random.RandomState(SEED)
    key = rng.bytes(32)
    chunks = [rng.bytes(1003) for _ in range(64)]
    t0 = time.perf_counter()
    for i in range(reps):
        wire = native.aead_seal_burst(key, 64 * i, chunks)
    t1 = time.perf_counter()
    sealed = native.split_wire(wire)
    for _ in range(reps):
        native.aead_open_burst(key, 64 * (reps - 1), sealed)
    t2 = time.perf_counter()
    n = reps * len(chunks)
    return {"seal_us_per_frame": (t1 - t0) * 1e6 / n,
            "open_us_per_frame": (t2 - t1) * 1e6 / n, "frames": n,
            "frame_bytes": 1003}


def _last_launch_patches(last: dict) -> list:
    """ladder.verify / verify_pre keep the arguments of their last launch
    on the card (any node's) in last[name], for _launch_alone."""
    def keep(name, fn):
        def call(*args):
            last[name] = args
            return fn(*args)
        return call
    return [(ladder, n, keep(n, getattr(ladder, n))) for n in VERIFY_KERNELS]


def _launch_alone(last: dict, reps: int = 20) -> dict:
    """Each kernel's device ms a launch on the net's own last arguments,
    timed alone on one thread after the net (CUDA events around `reps`
    launches after a warm-up), beside the times in the run, where the
    nodes' streams share the card."""
    out = {}
    for name, args in last.items():
        fn = getattr(ladder, name)
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        out[name] = {"lanes": int(args[0].shape[0]),
                     "ms": start.elapsed_time(end) / reps}
    return out


def _in_run_timer_patches(log: list) -> list:
    """The ladder library's verify launchers wrapped so that each launch
    records CUDA events on its own stream just before and after it, in the
    same host call (csrc/launch_timer.cpp); `log` gets (name, lanes,
    start, end) for every launch. Events recorded from Python around a
    launch would time the interpreter lock of a ~100-thread net as well."""
    lib = _build.ladder_lib()
    timer = _build.launch_timer_lib()
    record = ctypes.cast(ctypes.CDLL("libcuda.so.1").cuEventRecord,
                         ctypes.c_void_p)
    patches = []
    for name, fn_name, timed in (
            ("verify", "tm_ladder_verify", timer.tm_timed_verify),
            ("verify_pre", "tm_ladder_verify_pre",
             timer.tm_timed_verify_pre)):
        launcher = ctypes.cast(getattr(lib, fn_name), ctypes.c_void_p)

        def call(*args, name=name, timed=timed, launcher=launcher):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()      # creates the events; the timer re-records
            end.record()
            err = timed(record, start, end, launcher, *args)
            log.append((name, args[-3].value, start, end))
            return err
        patches.append((lib, fn_name, call))
    return patches


def _in_run_device_time(log: list, ref, wall_s: float) -> dict:
    """The run's timed launches: event ms by kernel and by lanes, and the
    device-busy share, the union of the launch intervals (the nodes'
    streams run concurrently) over the phase's wall."""
    torch.cuda.synchronize()
    spans, by = [], {}
    for name, lanes, start, end in log:
        t0, t1 = ref.elapsed_time(start), ref.elapsed_time(end)
        spans.append((t0, t1))
        k = by.setdefault(name, {"launches": 0, "event_ms": 0.0,
                                 "by_lanes": {}})
        k["launches"] += 1
        k["event_ms"] += t1 - t0
        row = k["by_lanes"].setdefault(str(lanes), {"launches": 0,
                                                     "event_ms": 0.0})
        row["launches"] += 1
        row["event_ms"] += t1 - t0
    for k in by.values():
        for row in k["by_lanes"].values():
            row["ms_per_launch"] = row["event_ms"] / row["launches"]
    busy, reach = 0.0, None
    for t0, t1 in sorted(spans):
        if reach is None or t0 > reach:
            busy += t1 - t0
            reach = t1
        elif t1 > reach:
            busy += t1 - reach
            reach = t1
    return {"by_kernel": by, "busy_ms": busy,
            "device_busy": busy / (wall_s * 1e3)}


def _drop_and_rejoin(net, left, card: str) -> dict:
    """Node 3's links stopped at P2P_DROP_AT; the other three commit
    P2P_DROPPED_HEIGHTS more; then its handshakes are allowed again and the
    persistent redial must bring it back and gossip catch it up."""
    n3 = net.nodes[3]
    at = n3.block_store.height()
    net.drop_links(3)
    require(n3.switch.peers.size() == 0, "node 3 kept a link")
    t0 = time.perf_counter()
    target = max(net.heights()) + P2P_DROPPED_HEIGHTS
    net.wait_height(target, left("the three without node 3"),
                    nodes=net.nodes[:3])
    alone_s = time.perf_counter() - t0
    behind = max(net.heights()) - n3.block_store.height()
    n3_id = n3.switch.node_info.id
    net.restore_links(3)
    t1 = time.perf_counter()
    redial_s = net.wait_for(lambda: n3.switch.peers.size() == 3,
                            left("node 3's redial"), "node 3's redial")
    tip = max(net.heights())
    catchup_s = net.wait_height(tip, left("node 3's catch-up"),
                                nodes=[n3]) + redial_s
    out = {"phase": "p2p_rejoin", "node": 3, "dropped_at": at,
           "three_alone_s": alone_s,
           "heights_committed_without_node3": target - at,
           "heights_behind_at_restore": behind,
           # the peers whose trust store banned node 3 for its dropped
           # link (a bad event as the first of a trust interval)
           "banned_by": [i for i, n in enumerate(net.nodes[:3])
                         if n3_id in n.switch.banned],
           "redial_s": redial_s,
           "caught_up_to": tip, "catchup_s": catchup_s,
           "redial_wall_s": time.perf_counter() - t1, "card": card}
    emit(out)
    return out


def _join(net, left, card: str) -> dict:
    """The fifth node, no validator, downloads the backlog its peers
    report, fast-syncs it by P2P_WINDOW-block windows over the switch,
    switches to consensus and follows. The sync's wall and blocks/s start
    when its reactors do, after the download."""
    before = ted.predecomp_stats()
    launches = dict(ladder.launches)
    at = net.nodes[0].block_store.height()
    t0 = time.perf_counter()
    joiner = net.add_joiner(verify_window=P2P_WINDOW,
                            timeout_s=left("the joiner's download"))
    t1 = time.perf_counter()
    bc = joiner.blockchain_reactor
    net.wait_for(lambda: bc.synced or bc.sync_error is not None,
                 left("the joiner's sync"), "the joiner's sync")
    wall = time.perf_counter() - t1
    require(bc.sync_error is None, f"the joiner's sync: {bc.sync_error!r}")
    synced = joiner.block_store.height()
    after = ted.predecomp_stats()
    out = {"phase": "p2p_join", "joined_at": at, "window_blocks": P2P_WINDOW,
           "download_s": t1 - t0, "synced_to": synced, "sync_wall_s": wall,
           "blocks_per_s": synced / wall,
           "routes": {k: after[k] - before[k] for k in ("full", "fill",
                                                       "hit")},
           "launches": _launch_delta(launches), "card": card}
    emit(out)
    return out


def _run_p2p(verifier_of, card: str, node0_log=None, last=None,
             timed=None) -> dict:
    """The socket net's run: P2P_HEIGHTS heights with node 3 dropped and
    redialled and a joiner; then the feeder stops and the mempools drain.
    With `timed` (a list), every launch is timed in the run, and the
    result holds `ref`, the event those times count from."""
    from tendermint_tpu_torch.p2p import socknet
    from tendermint_tpu_torch.p2p.conn.secret import frame_stats

    t_start = time.perf_counter()
    left = _phase_deadline(t_start)
    net = socknet.SockNet(socknet.bench_config(), verifier_of=verifier_of)
    rec = {"steps": {}, "block_done": {}, **{k: defaultdict(float) for k in (
        "verify_calls", "verify_sigs", "verify_ms", "apply_ms",
        "validate_ms")}}
    chan: Counter = Counter()
    commit_t: dict = {}
    saved = _patched(_channel_bytes_patches(chan))
    feeder = ref = None
    if timed is not None:
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
        saved += _patched(_in_run_timer_patches(timed))
    try:
        net.start()
        n0 = net.nodes[0]
        saved += _patched(_p2p_stage_patches(n0, rec))
        if node0_log is not None:
            saved += _patched(_node0_recorder(n0.block_exec.verifier,
                                              node0_log))
        if last is not None:
            saved += _patched(_last_launch_patches(last))
        inner_save = n0.state_store.save

        def save(state):
            inner_save(state)
            commit_t.setdefault(state.last_block_height, time.perf_counter())
        saved += _patched([(n0.state_store, "save", save)])
        frame_stats.reset()
        feeder = _Feeder(n0)
        feeder.start()
        net.wait_height(P2P_DROP_AT, left(f"height {P2P_DROP_AT}"),
                        nodes=[n0])
        rejoin = _drop_and_rejoin(net, left, card)
        net.wait_height(P2P_JOIN_AT, left("the joiner's height"),
                        nodes=[n0])
        join = _join(net, left, card)
        net.wait_height(P2P_HEIGHTS, left("the last fed height"))
        feeder.stop()
        net.wait_for(lambda: all(n.mempool.size() == 0 for n in net.nodes),
                     left("the drain"), "the mempools' drain")
        top = min(net.heights())
        net.wait_height(top, left("the last height"))
        wall_s = time.perf_counter() - t_start
        frames = frame_stats.snapshot()
        bad = net.disagreements()
        require(not bad, f"p2p: the nodes disagree: {bad[:5]}")
        blocks = [n0.block_store.load_block(h)
                  for h in range(1, n0.block_store.height() + 1)]
        counts = Counter(tx for b in blocks for tx in b.data.txs)
        require(counts == Counter(feeder.fed) and max(counts.values()) == 1,
                f"p2p: the committed txs are not the {len(feeder.fed)} fed, "
                f"each once ({sum(counts.values())} committed)")
        compact = [n.consensus_reactor.compact_stats.snapshot()
                   for n in net.nodes]
        lo, hi = P2P_MEASURE
        span = commit_t[hi] - commit_t[lo]
        txs = sum(len(b.data.txs) for b in blocks[lo:hi])
        rows = _p2p_heights(n0, rec, range(lo + 1, hi + 1))
        bans = [{"node": i, "peer": pid[:8], "strikes": r["strikes"]}
                for i, n in enumerate(net.nodes)
                for pid, r in sorted(n.switch.banned.items())]
    finally:
        if feeder is not None and not feeder._stop.is_set():
            feeder._stop.set()
        # the net first: the nodes still running while others close go on
        # verifying, and the launch timer must see every launch
        net.close()
        _restore(saved[::-1])   # node 0's verifier is wrapped twice
    agg_msgs = sum(c["agg_sent"] for c in compact)
    out = {"phase": "p2p", "validators": 4, "nodes": len(net.nodes),
           "heights": n0.block_store.height(), "txs_fed": len(feeder.fed),
           "measured_heights": [lo, hi], "blocks_per_s": (hi - lo) / span,
           "txs_per_s": txs / span, "wall_s": wall_s,
           "rounds_above_0": sum(1 for r in rows if r["round"]),
           "bans": bans, "card": card}
    emit(out)
    emit({"phase": "p2p_stages", "node": 0, "unit": "median over heights "
          f"{lo + 1}-{hi}", "stages": {k: _median(rows, k) for k in (
              "proposal_to_block_ms", "prevote_quorum_ms",
              "precommit_quorum_ms", "verify_calls", "sigs_per_call",
              "verify_ms", "apply_ms", "validate_ms")},
          "max": {k: max((r[k] for r in rows if r[k] is not None),
                         default=None) for k in (
              "proposal_to_block_ms", "prevote_quorum_ms",
              "precommit_quorum_ms", "verify_ms", "apply_ms")},
          "card": card})
    emit({"phase": "p2p_wire", "frames_sealed": frames["sealed_burst"]
          + frames["sealed_frame"], "frames_opened": frames["opened_burst"]
          + frames["opened_frame"], "per_frame_sealed": frames["sealed_frame"],
          "per_frame_opened": frames["opened_frame"],
          "frames_per_seal_burst": frames["sealed_burst"]
          / max(1, frames["seal_calls"]),
          "frames_per_open_burst": frames["opened_burst"]
          / max(1, frames["open_calls"]),
          # host wall of the native calls in the net, GIL reacquire
          # after each call included (aead_alone: the calls by themselves)
          "seal_wall_us_per_frame": frames["seal_s"] * 1e6
          / max(1, frames["sealed_burst"]),
          "open_wall_us_per_frame": frames["open_s"] * 1e6
          / max(1, frames["opened_burst"]),
          "bytes_by_channel": dict(sorted(chan.items())),
          "aead_alone": _aead_alone(), "card": card})
    emit({"phase": "p2p_compact",
          "offers": sum(c["sent"] for c in compact),
          "received": dict(sum((Counter(c["received"]) for c in compact),
                               Counter())),
          "reconstructions": dict(sum((Counter(c["reconstruct"])
                                       for c in compact), Counter())),
          "fetches": sum(c["fetch_requests"] for c in compact),
          "fetched_txs": sum(c["fetch_missing_txs"] for c in compact),
          "vote_agg_msgs": agg_msgs,
          "votes_per_vote_agg": sum(c["agg_votes_sent"] for c in compact)
          / max(1, agg_msgs), "card": card})
    require(frames["sealed_frame"] == 0 and frames["opened_frame"] == 0
            and frames["sealed_burst"] > 0 and frames["opened_burst"] > 0,
            f"p2p: a frame left the native burst AEAD: {frames}")
    require(rejoin["caught_up_to"] >= rejoin["dropped_at"]
            + rejoin["heights_committed_without_node3"],
            "p2p: node 3 did not catch up")
    require(join["synced_to"] >= P2P_JOIN_AT - 1
            and net.nodes[4].block_store.height() >= P2P_HEIGHTS
            and not net.nodes[4].consensus_reactor.fast_sync,
            "p2p: the joiner did not sync and follow")
    return {"join": join, "rejoin": rejoin, "wall_s": wall_s, "ref": ref}


def phase_p2p(card: str, device, verifier=None) -> dict:
    """BASELINE.json config 1 over loopback TCP (p2p.socknet): four
    validators and a fast-syncing joiner, every node on its own
    BatchVerifier("cuda") (`verifier(i)` in a rehearsal, which times no
    launch)."""
    if verifier is None:
        # built before the net: a node whose first verify call built the
        # kernels would hold its state machine, its peers' recv threads
        # and their keepalives for the build's minute
        _build.ladder_lib()
    native.aead_lib()
    _zero_launches()
    node0_log: deque = deque(maxlen=N_RECHECK_CALLS)
    verifiers: dict = {}

    def verifier_of(i):
        if i not in verifiers:
            verifiers[i] = (verifier(i) if verifier is not None else
                            tverifier.BatchVerifier("cuda", device=device))
        return verifiers[i]
    last: dict = {}
    timed: list = []
    on_card = verifier is None
    out = _run_p2p(verifier_of, card, node0_log, last if on_card else None,
                   timed if on_card else None)
    launches = dict(ladder.launches)
    rechecked = _recheck_plain(node0_log)
    if on_card:
        dev = _in_run_device_time(timed, out["ref"], out["wall_s"])
        emit({"phase": "p2p_kernels", "in_run": dev["by_kernel"],
              "timed_launches": len(timed),
              "device_busy_ms": dev["busy_ms"],
              "device_busy": dev["device_busy"],
              "launch_alone": _launch_alone(last), "wall_s": out["wall_s"],
              "card": card})
        require(len(timed) == launches["verify"] + launches["verify_pre"],
                f"p2p: {len(timed)} launches timed of {launches}")
    emit({"phase": "p2p_summary", "launches": launches,
          "join_launches": out["join"]["launches"],
          "join_routes": out["join"]["routes"], "recheck": rechecked,
          "verifier_stats": [v.stats for _, v in sorted(verifiers.items())],
          "card": card})
    # consensus checks verify 1-4 signatures (B1: 8 lanes, below the
    # cache's 64); the joiner's 16-block windows verify 64, which walk
    # the cache full (B1) then fill and hit (B2); nothing signs on the card
    _require_launched(launches, ("verify", "verify_pre"), "p2p")
    require(launches["sign_rb"] == 0,
            f"p2p launched the sign kernel: {launches}")
    require(rechecked["calls"] == N_RECHECK_CALLS,
            f"p2p: node 0 made {rechecked['calls']} verify dispatches")
    return launches

# ------------------------------------------- phase 11: config 1 as OS processes

PROC_HEIGHTS = 20         # the feeders stop when node 0 commits this (it
#                           passes it while node 3 is down)
PROC_CRASH_AT = 8         # node 3 is SIGKILLed when node 0 commits this
PROC_MEASURE = (4, 20)    # blocks/s and txs/s over these heights (metas)
PROC_BOOT_S = 90.0        # every node's status at height >= 2 within
PROC_WALL_S = 180.0       # the phase's wall limit from the nodes' start
PROC_FEED_BATCH = 128     # txs a broadcast_tx_batch cast
PROC_BACKLOG = 3000       # a feeder backs off while the mempool holds more
PROC_SAMPLE_KEYS = 16     # committed keys abci_query'd on every node
PROC_GPU_POLL_S = 0.25    # nvidia-smi utilization.gpu sampling period


class _WSFeeder:
    """run_socket's spammer (bench_testnet.py :554-585) on the port's
    WSClient: casts of PROC_FEED_BATCH fresh txs to node `tid`, a
    num_unconfirmed_txs call after every four, backing off while it
    exceeds `backlog`; a broken socket is reopened."""

    def __init__(self, net, tid: int, backlog: int = PROC_BACKLOG):
        self.net, self.tid, self.sent, self.errors = net, tid, 0, 0
        self.backlog = backlog
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"smoke-ws-feeder-{tid}")

    def _run(self) -> None:
        ws = None
        while not self._stop.is_set():
            try:
                if ws is None:
                    ws = self.net.ws(self.tid, timeout=30.0)
                for _ in range(4):
                    ws.cast("broadcast_tx_batch", txs=[
                        (b"pn%d/k%d=v" % (self.tid, self.sent + k)).hex()
                        for k in range(PROC_FEED_BATCH)])
                    self.sent += PROC_FEED_BATCH
                while not self._stop.is_set() and ws.call(
                        "num_unconfirmed_txs", timeout=30.0)["n_txs"] \
                        > self.backlog:
                    time.sleep(0.05)
            except Exception:
                self.errors += 1
                if ws is not None:
                    ws.close()
                    ws = None
                time.sleep(0.2)
        if ws is not None:
            ws.close()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # a boot that failed never
            self._thread.join(40)            # started the feeders


class _GpuSampler:
    """nvidia-smi's utilization.gpu every PROC_GPU_POLL_S: the share of
    its sample period in which a kernel ran, a coarse figure."""

    def __init__(self):
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="smoke-gpu-sampler")

    def _run(self) -> None:
        while not self._stop.wait(PROC_GPU_POLL_S):
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=utilization.gpu",
                     "--format=csv,noheader,nounits", "-i", "0"],
                    capture_output=True, text=True, timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                return   # no nvidia-smi (a CPU rehearsal): no samples
            if out.returncode == 0 and out.stdout.strip().isdigit():
                self.samples.append((time.perf_counter(),
                                     int(out.stdout.strip())))

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(10)

    def share(self, t0: float, t1: float):
        vals = [u for t, u in self.samples if t0 <= t <= t1]
        return (sum(vals) / len(vals) / 100.0 if vals else None), len(vals)


def _proc_status(net, i: int):
    try:
        return net.rpc(i, 5.0).call("status")
    except Exception:
        return None


def _signed_in_commit(net, val_index: int, after: int) -> int:
    """The first height above `after` whose commit on node 0 holds
    validator val_index's precommit, or 0."""
    c = net.rpc(0, 10.0)
    top = int(c.call("status")["latest_block_height"])
    for h in range(after + 1, top):
        pcs = c.call("commit", height=h)["commit"]["precommits"]
        if pcs[val_index] is not None:
            return h
    return 0


def _restart_node3(net, left, device: str) -> dict:
    """SIGKILL node 3 by its pid when node 0 commits PROC_CRASH_AT and
    restart it from the same home with fast sync on. Its handshake
    (seconds, blocks replayed into the fresh app) comes from its start
    line; this script times the restart to its RPC answering (the
    interpreter, the CUDA context, the handshake and the first of the
    sync), the sync (to `syncing` false) and the rejoin (to its
    precommit in a commit of node 0)."""
    with open(os.path.join(net.home(3), "config",
                           "priv_validator.json")) as f:
        pub = json.load(f)["pub_key"]["value"]
    vals = net.rpc(0).call("validators")["validators"]["validators"]
    idx = [v["pubkey"] for v in vals].index(pub)
    net.wait_for(lambda: net.height(0) >= PROC_CRASH_AT,
                 left("the crash height"), "node 0 at the crash height")
    killed_at = net.height(3)
    net.kill(3)
    t_kill = time.perf_counter()
    net.start(3, extra=["--device", device])
    net.wait_for(lambda: _proc_status(net, 3) is not None,
                 left("node 3's restart"), "node 3's RPC after restart")
    t_up = time.perf_counter()
    start_h = net.height(3)
    started = re.findall(r"^node started: .* store_height=(\d+) "
                         r"state_height=(\d+) height=(\d+) "
                         r"handshake_s=([\d.]+) replayed=(\d+)$",
                         net.log(3), re.M)
    require(len(started) == 2, f"procnet: node 3's start lines {started}")
    net.wait_for(lambda: (_proc_status(net, 3) or {}).get(
        "syncing", True) is False, left("node 3's sync"), "node 3's sync")
    t_synced = time.perf_counter()
    synced_h = net.height(3)
    net.wait_for(lambda: _signed_in_commit(net, idx, synced_h) > 0,
                 left("node 3's rejoin"), "node 3's precommit in a commit",
                 poll_s=0.5)
    t_rejoin = time.perf_counter()
    return {"killed_at_height": killed_at, "node0_at_kill": PROC_CRASH_AT,
            "store_height": int(started[1][0]),
            "state_height": int(started[1][1]),
            "start_height": int(started[1][2]),
            "handshake_s": float(started[1][3]),
            "handshake_blocks": int(started[1][4]),
            "height_at_rpc": start_h, "synced_to": synced_h,
            "signed_at": _signed_in_commit(net, idx, synced_h),
            "restart_to_rpc_s": t_up - t_kill, "sync_s": t_synced - t_up,
            "rejoin_s": t_rejoin - t_synced, "down_s": t_rejoin - t_kill,
            "validator_index": idx}


def _proc_rate(net, top: int) -> dict:
    """Blocks/s and txs/s over PROC_MEASURE from node 0's block metas
    (header times) and blocks."""
    lo, hi = PROC_MEASURE
    metas = net.metas(0, top)
    t_lo = metas[lo - 1]["header"]["time_ns"]
    t_hi = metas[hi - 1]["header"]["time_ns"]
    span = (t_hi - t_lo) / 1e9
    txs = sum(m["header"]["num_txs"] for m in metas[lo:hi])
    return {"blocks_per_s": (hi - lo) / span, "txs_per_s": txs / span,
            "span_s": span, "txs": txs}


def _proc_txs(net, top: int) -> tuple:
    """Every committed tx of node 0's blocks 1..top: (Counter, list)."""
    txs = [tx for b in net.block_txs(0, top) for tx in b]
    return Counter(txs), txs


def _node_libs() -> None:
    """Build the libraries the node processes load (the same digests,
    so that no node pays a build inside its first call)."""
    _build.ladder_lib()
    native.module()
    native.aead_lib()
    native.hostops_lib()
    native.codec()
    native.kv()


def _agreed_txs(net, tag: str, top: int) -> tuple:
    """Every node holds the same blocks 1..top and no tx is committed
    twice; returns node 0's committed txs (Counter, list)."""
    bad = net.disagreements(top)
    require(not bad, f"{tag}: the nodes disagree: {bad[:5]}")
    counts, txs = _proc_txs(net, top)
    twice = [tx for tx, c in counts.items() if c > 1]
    require(not twice, f"{tag}: {len(twice)} txs committed twice")
    return counts, txs


def _procnet_net(tag: str, settings: dict, device: str, extra=None,
                 restart: bool = True) -> dict:
    """BASELINE config 1 as four OS processes (procnet.ProcNet), the run
    phases 11 and 12 share: `cli testnet` with `settings`, four `cli node
    --p2p --no-fast-sync --device <device>` processes, two WebSocket
    feeders of broadcast_tx_batch to nodes 0 and 1 until node 0 commits
    PROC_HEIGHTS, node 3 SIGKILLed at PROC_CRASH_AT and restarted with
    fast sync; then agreement at every height, no tx committed twice,
    PROC_SAMPLE_KEYS keys answered by every node, no early exit, every
    node's exit code 0, and one kernel line a process. `extra` (phase 12)
    subscribes as soon as the nodes answer RPC (`subscribe(net, left)`),
    starts more load after the boot (`start(net)`), stops it with the
    feeders (`stop()`), may drain the mempools (`drain`), and ends it
    once every node is at the last height (`finish(left)`). Without
    `restart` node 3 runs through (one kernel line a node). Returns the
    run's readings."""
    from tendermint_tpu_torch.procnet import ProcNet, free_block
    _node_libs()
    root = tempfile.mkdtemp(prefix=f"{tag}-")
    net = ProcNet(root, base_port=free_block(8))
    net.write_tree(f"chip-smoke-{tag}")
    net.configure(settings)
    sampler = _GpuSampler()
    feeders = [_WSFeeder(net, tid) for tid in (0, 1)]
    t_start = time.perf_counter()

    def left(what: str) -> float:
        rem = PROC_WALL_S - (time.perf_counter() - t_start)
        require(rem > 0, f"{tag}: out of wall time at {what}")
        return rem
    ok = False
    try:
        net.start_all(extra=["--no-fast-sync", "--device", device])
        sampler.start()
        if extra is not None:
            extra.subscribe(net, left)
        net.wait_for(lambda: min(net.heights()) >= 2,
                     min(PROC_BOOT_S, left("boot")), "boot")
        boot_s = time.perf_counter() - t_start
        if extra is not None:
            extra.start(net)
        for f in feeders:
            f.start()
        t_feed = time.perf_counter()
        rejoin = _restart_node3(net, left, device) if restart else None
        net.wait_for(lambda: net.height(0) >= PROC_HEIGHTS,
                     left("the last fed height"), "node 0 at the last height")
        t_fed = time.perf_counter()
        for f in feeders:
            f.stop()
        if extra is not None:
            extra.stop()
            if extra.drain:
                net.wait_for(lambda: all(
                    net.rpc(i).call("num_unconfirmed_txs")["n_txs"] == 0
                    for i in range(net.n)), left("the mempools' drain"),
                    "the mempools' drain", poll_s=0.25)
        net.wait_for(lambda: min(net.heights()) >= PROC_HEIGHTS,
                     left("every node at the last height"),
                     "every node at the last height")
        if extra is not None:
            extra.finish(left)
        wall_s = time.perf_counter() - t_start
        top = min(net.heights())
        counts, txs = _agreed_txs(net, tag, top)
        keys = random.Random(SEED).sample(txs, min(PROC_SAMPLE_KEYS,
                                                   len(txs)))

        def answers(i: int) -> None:
            for tx in keys:
                k, v = tx.split(b"=", 1)
                got = net.rpc(i).call("abci_query", data=k.hex())
                require(bytes.fromhex(got["response"]["value"]) == v,
                        f"{tag}: node {i} answers {k!r} wrong")
        with ThreadPoolExecutor(net.n) as pool:   # the nodes side by side
            list(pool.map(answers, range(net.n)))
        rate = _proc_rate(net, top)
        bans = {i: net.rpc(i).call("net_info").get("banned", {})
                for i in range(net.n)}
        early = net.early_exits()
        require(not early, f"{tag}: node processes exited early {early}")
        busy, n_samples = sampler.share(t_feed, t_fed)
        ok = True
    finally:
        for f in feeders:
            f.stop()
        if extra is not None:
            extra.stop()
        t_stop = time.perf_counter()
        codes = net.stop_all()
        stop_s = time.perf_counter() - t_stop
        sampler.stop()
        if not ok:
            for i in range(net.n):
                tail = net.log(i).splitlines()[-40:] \
                    if os.path.exists(net.log_path(i)) else []
                print(f"{tag} node {i} log tail:", *tail, sep="\n",
                      file=sys.stderr)
    emit({"phase": f"{tag}_teardown", "stop_all_s": stop_s,
          "after_wall_s": time.perf_counter() - t_start - wall_s})
    # one line a process: its stop line, and for node 3's killed first
    # process the line of the last height it committed before the kill
    lines = {i: net.kernel_lines(i) for i in range(net.n)}
    require(all(codes[i] == 0 for i in range(net.n)),
            f"{tag}: node exit codes {codes}")
    require([len(lines[i]) for i in range(net.n)]
            == [1, 1, 1, 2 if restart else 1],
            f"{tag}: kernel lines a process {lines}")
    launches = {k: sum(line["launches"][k]
                       for i in lines for line in lines[i])
                for k in ladder.launches}
    shutil.rmtree(root, ignore_errors=True)
    return {"lines": lines, "launches": launches, "rate": rate,
            "restart": rejoin, "busy": busy, "n_samples": n_samples,
            "boot_s": boot_s, "wall_s": wall_s, "top": top, "txs": txs,
            "counts": counts, "bans": bans,
            "sent": sum(f.sent for f in feeders),
            "errors": sum(f.errors for f in feeders)}


def _verifier_reading(line: dict) -> dict:
    """A process's verify counts from its kernel line. Submissions are the
    verify_async calls (direct_calls + coalesced_calls); `calls` are the
    direct path's dispatches (those that bypassed the coalescer, merged
    ones and fallback re-runs); dispatch ms are host ms a dispatch, wait
    ms the caller's ms a submission blocked for its verdicts."""
    v = line["verifier"]
    c = line.get("coalescer") or {}
    subs = v.get("direct_calls", v["calls"]) + v.get("coalesced_calls", 0)
    out = {"launches": line["launches"], "routes": line["routes"],
           "submissions": subs, "direct_calls": v.get("direct_calls",
                                                      v["calls"]),
           "coalesced_calls": v.get("coalesced_calls", 0),
           "dispatches": v["calls"], "sigs": v["sigs"],
           "dispatch_ms_per_dispatch": 1e3 * v["dispatch_s"]
           / max(1, v["calls"]),
           "wait_ms_per_call": 1e3 * v["wait_s"] / max(1, subs),
           "host_ms_per_call": 1e3 * (v["dispatch_s"] + v["wait_s"])
           / max(1, subs),
           "device": line["device"], "counted_to_height": line["height"]}
    if c:
        out.update(merged_dispatches=c["dispatches"],
                   calls_per_merge_mean=c["merged_calls"]
                   / max(1, c["dispatches"]),
                   calls_per_merge_max=c["calls_max"],
                   fallbacks=c["fallbacks"],
                   loop_waits=v.get("loop_waits", 0),
                   loop_wait_ms=1e3 * v.get("loop_wait_s", 0.0))
    return out


def _require_b1_everywhere(tag: str, lines: dict, on_card: bool) -> None:
    for i in lines:
        for line in lines[i]:
            require(not on_card or (line["device"].startswith("cuda")
                                    and line["launches"]["verify"] > 0),
                    f"{tag}: a process of node {i} did not launch B1: "
                    f"{line}")


def _require_serial_commit_path(tag: str, lines: dict) -> None:
    """Every process ran the serial commit path it was configured with."""
    for i in lines:
        for line in lines[i]:
            p = line["pipeline"]
            require(p["mode"] == "off" and p["group_flushes"] == 0
                    and line["native"]["partsets"]["native"] == 0,
                    f"{tag}: node {i} off the serial commit path: {p}")


def phase_procnet(card: str, device: str = "cuda") -> dict:
    """BASELINE config 1 as four OS processes on the thread plane without
    coalescing (`reactor: "threads"`, `verifier_coalesce: "off"`), the
    plane of its runs before the event loop, so that they stay
    comparable. A rehearsal on the CPU passes device="cpu":
    the nodes then run "auto" (the host loop at these batch sizes) and
    no launch is required."""
    from tendermint_tpu_torch.procnet import bench_settings
    on_card = device.startswith("cuda")
    run = _procnet_net("procnet", bench_settings(
        "cuda" if on_card else "auto", reactor="threads",
        verifier_coalesce="off", pipeline="off"), device)
    lines, rate, restart = run["lines"], run["rate"], run["restart"]
    per_node = {i: lines[i][-1] for i in range(4)}
    emit({"phase": "procnet", "validators": 4, "processes": 4,
          "plane": {"reactor": "threads", "verifier_coalesce": "off"},
          "heights": run["top"], "measured_heights": list(PROC_MEASURE),
          "blocks_per_s": rate["blocks_per_s"],
          "txs_per_s": rate["txs_per_s"], "measure_span_s": rate["span_s"],
          "txs_committed": len(run["txs"]), "txs_sent": run["sent"],
          "feeder_errors": run["errors"], "boot_s": run["boot_s"],
          "wall_s": run["wall_s"], "banned_by": {
              i: sorted(p[:8] for p in b) for i, b in run["bans"].items()},
          "card": card})
    emit({"phase": "procnet_restart", **restart,
          "sync_routes": per_node[3]["routes"],
          "sync_launches": per_node[3]["launches"], "card": card})
    emit({"phase": "procnet_kernels",
          "by_node": {i: _verifier_reading(per_node[i]) for i in per_node},
          "node3_killed_process": _verifier_reading(lines[3][0]),
          "note": "launches sum every process's last line; node 3's killed "
          "process is counted to the last height it committed before the "
          "kill", "launches": run["launches"], "card": card})
    emit({"phase": "procnet_device", "utilization_gpu_mean": run["busy"],
          "samples": run["n_samples"], "window": "feeders' start to node 0 "
          f"at {PROC_HEIGHTS}", "note": "coarse: nvidia-smi "
          "utilization.gpu (share of each sample period with a kernel "
          f"running), polled every {PROC_GPU_POLL_S} s", "card": card})
    _require_b1_everywhere("procnet", lines, on_card)
    for i in lines:
        for line in lines[i]:
            require(line["reactor"] == "threads" and line["loop"] is None
                    and line["verifier"]["coalesced_calls"] == 0,
                    f"procnet: node {i} off the thread plane: {line}")
    _require_serial_commit_path("procnet", lines)
    require(run["launches"]["sign_rb"] == 0,
            f"procnet launched the sign kernel: {run['launches']}")
    require(restart["signed_at"] > restart["synced_to"],
            f"procnet: node 3 did not sign after its rejoin: {restart}")
    return run


# ----------------------------- phase 12: config 1 on the JAX node's defaults

LOOP_SYNC_CONNS = 32      # the third feeder's WebSocket connections to node 2
LOOP_SUBSCRIBERS = 200    # WebSocket NewBlock subscribers on node 1
LOOP_EVENTS = (4, 20)     # every subscriber sees each of these heights
N_COALESCE_CALLS = 64     # single-signature calls of the coalescer check
N_COALESCE_THREADS = 8


class _SyncFeeder:
    """LOOP_SYNC_CONNS WebSocket connections to node `tid`, each a thread
    casting single broadcast_tx_sync calls of fresh txs (the front door's
    TxBatcher merges them), pausing while node tid's mempool holds more
    than PROC_BACKLOG. `acked` holds every tx answered with code 0."""

    def __init__(self, tid: int = 2):
        self.tid = tid
        self.acked: list = []
        self.per_conn = [0] * LOOP_SYNC_CONNS
        self.refused = self.errors = 0
        self.paused_s = 0.0
        self.drain = True
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._full = threading.Event()
        self._threads: list = []

    def start(self, net) -> None:
        self.net = net
        self._threads = [threading.Thread(
            target=self._run, args=(c,), daemon=True,
            name=f"smoke-sync-feeder-{c}")
            for c in range(LOOP_SYNC_CONNS)]
        self._threads.append(threading.Thread(
            target=self._watch, daemon=True, name="smoke-sync-watch"))
        for t in self._threads:
            t.start()

    def _watch(self) -> None:
        while not self._stop.wait(0.1):
            try:
                n = self.net.rpc(self.tid, 5.0).call(
                    "num_unconfirmed_txs")["n_txs"]
            except Exception:  # tmlint: allow(exception-hygiene): a feeder's backlog poll: a node down mid-restart answers nothing, and the next tick polls again
                continue
            (self._full.set if n > PROC_BACKLOG else self._full.clear)()
            if self._full.is_set():
                self.paused_s += 0.1

    def _run(self, c: int) -> None:
        ws, k = None, 0
        while not self._stop.is_set():
            if self._full.is_set():
                time.sleep(0.05)
                continue
            tx = b"sy%02d/k%d=v" % (c, k)
            k += 1
            try:
                if ws is None:
                    ws = self.net.ws(self.tid, timeout=30.0)
                res = ws.call("broadcast_tx_sync", tx=tx.hex(),
                              timeout=30.0)
            except Exception as e:
                refused = "mempool is full" in str(e)
                with self._lock:
                    if refused:
                        self.refused += 1
                    else:
                        self.errors += 1
                if not refused and ws is not None:
                    ws.close()
                    ws = None
                continue
            with self._lock:
                if res["code"] == 0:
                    self.acked.append(tx)
                    self.per_conn[c] += 1
                else:
                    self.refused += 1
        if ws is not None:
            ws.close()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            if t.ident is not None:     # started (not after a failed boot)
                t.join(40)


class _Subscribers:
    """LOOP_SUBSCRIBERS WebSocket connections to node `tid`, each
    subscribed to NewBlock, read by ONE selector thread of this process
    (200 reader threads would load this process's interpreter more than
    the node's loop): each event's block height is the first "height" of
    its frame. `heights[i]` lists what subscriber i received, in order."""

    def __init__(self, tid: int = 1, n: int = LOOP_SUBSCRIBERS,
                 query: str = "tm.event = 'NewBlock'"):
        self.tid, self.n, self.query = tid, n, query
        self.drain = False
        self.heights: list = []
        self.closed = self.replies = 0
        self.subscribed_at = -1
        self._stop = threading.Event()
        self._thread = None
        self._socks: list = []

    def start(self, net, left) -> None:
        """Connect and subscribe every subscriber, and wait for each
        subscription's reply."""
        import selectors
        net.wait_for(lambda: _proc_status(net, self.tid) is not None,
                     left("node 1's RPC"), "node 1's RPC")
        port = net.rpc_port(self.tid)
        self._sel = selectors.DefaultSelector()
        # every upgrade request goes out before the first answer is read:
        # the node answers them together, so that the subscriptions are
        # in place within a round trip or two of its RPC coming up (one
        # round trip each, in turn, let a fast chain pass height 5 first)
        socks = []
        for i in range(self.n):
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            s.sendall(b"GET /websocket HTTP/1.1\r\nHost: x\r\n"
                      b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      b"Sec-WebSocket-Key: c21va2Utc3Vic2NyaWJlcg==\r\n"
                      b"Sec-WebSocket-Version: 13\r\n\r\n")
            socks.append(s)
        for i, s in enumerate(socks):
            head = b""
            while b"\r\n\r\n" not in head:
                chunk = s.recv(4096)
                require(chunk, "loop: a subscriber's upgrade was refused")
                head += chunk
            require(b" 101 " in head.split(b"\r\n")[0],
                    f"loop: subscriber upgrade {head[:60]!r}")
            body = json.dumps({"jsonrpc": "2.0", "id": i,
                               "method": "subscribe", "params": {
                                   "query": self.query}}
                              ).encode()
            s.sendall(bytes([0x81, 0x80 | 126]) + struct.pack(">H",
                                                               len(body))
                      + b"\x00" * 4 + body)
            s.setblocking(False)
            self._socks.append(s)
            self.heights.append([])
            self._sel.register(s, selectors.EVENT_READ,
                               [i, bytearray(head.partition(b"\r\n\r\n")[2])])
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="smoke-subscribers")
        self._thread.start()
        net.wait_for(lambda: self.replies == self.n,
                     left("the subscriptions"), "the subscriptions' replies")
        self.subscribed_at = net.height(self.tid)

    def _frames(self, i: int, buf: bytearray) -> None:
        while len(buf) >= 2:
            n, pos = buf[1] & 0x7F, 2
            if n == 126:
                if len(buf) < 4:
                    return
                n, pos = struct.unpack(">H", bytes(buf[2:4]))[0], 4
            elif n == 127:
                if len(buf) < 10:
                    return
                n, pos = struct.unpack(">Q", bytes(buf[2:10]))[0], 10
            if len(buf) < pos + n:
                return
            payload = bytes(buf[pos:pos + n])
            del buf[:pos + n]
            if b'"#event"' in payload[:64]:
                m = re.search(rb'"height": (\d+)', payload)
                if m:
                    self.heights[i].append(int(m.group(1)))
            else:
                self.replies += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            for key, _ in self._sel.select(0.2):
                i, buf = key.data
                try:
                    data = key.fileobj.recv(1 << 20)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if not data:
                    self._sel.unregister(key.fileobj)
                    self.closed += 1
                    continue
                buf += data
                self._frames(i, buf)

    def seen_through(self, h: int) -> bool:
        return all(hs and hs[-1] >= h for hs in self.heights)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
        for s in self._socks:
            s.close()
        self._socks = []


class _LoopLoad:
    """Phase 12's load beside the two feeders: the sync feeder to node 2
    and the subscribers of node 1; the mempools drain before the checks,
    so that every acknowledged tx is in a block."""

    drain = True

    def __init__(self):
        self.sync = _SyncFeeder()
        self.subs = _Subscribers()

    def subscribe(self, net, left) -> None:
        self.subs.start(net, left)

    def start(self, net) -> None:
        self.sync.start(net)

    def stop(self) -> None:
        self.sync.stop()

    def finish(self, left) -> None:
        """Every subscriber through the last height, then closed (before
        the nodes stop, so that a close by the server is counted)."""
        deadline = time.monotonic() + min(30.0, left("the subscribers"))
        while not self.subs.seen_through(LOOP_EVENTS[1]) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        self.subs.stop()


def _coalescer_check(device) -> dict:
    """The coalescer on the card, before the net: one call's dispatch is
    held on a gate while N_COALESCE_THREADS threads submit
    N_COALESCE_CALLS single-signature calls (utils/vectors.edge_items'
    lanes and forged ones); released, the dispatcher merges them into ONE
    dispatch and one verify launch. That launch's verdicts must equal the
    plain version on the same card tensors, each caller's slice its own
    oracle verdict and its own direct launch. Then a dispatch made to
    raise (a failing launch) must reach every caller of its merge as
    VerifierError."""
    items, expect = vectors.edge_items(N_COALESCE_CALLS - 8, SEED + 12)
    for i in range(8):           # forged: a valid signature, one byte off
        sk = (SEED + 100 + i).to_bytes(32, "little")
        msg = b"coalesce-forged-%d" % i
        sig = bytearray(ed25519_ref.sign(sk, msg))
        sig[(7 * i) % 64] ^= 0x10
        items.append((ed25519_ref.public_key(sk), msg, bytes(sig)))
        expect.append(ed25519_fast.verify(items[-1][0], msg, bytes(sig)))
    v = tverifier.BatchVerifier("cuda", device=device)
    entered, gate = threading.Event(), threading.Event()
    sizes, recorded = [], []
    inner = v._verify_async_direct

    def held(batch, *path):
        sizes.append(len(batch))
        if len(sizes) == 1:
            entered.set()
            require(gate.wait(60), "loop: the held dispatch was not released")
        return inner(batch, *path)

    def rec(name, fn):
        def call(*args):
            out = fn(*args)
            recorded.append((name, args, out))
            return out
        return call

    def submit_all() -> list:
        """The calls from N_COALESCE_THREADS threads while the first
        dispatch is held; their resolvers in item order."""
        resolvers = [None] * len(items)
        entered.clear()
        gate.clear()
        sizes.clear()
        first = v.verify_async([items[0]])
        require(entered.wait(60), "loop: the first dispatch never ran")

        def worker(t):
            for j in range(t, len(items), N_COALESCE_THREADS):
                resolvers[j] = v.verify_async([items[j]])
        ths = [threading.Thread(target=worker, args=(t,))
               for t in range(N_COALESCE_THREADS)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        co = v._coalescer
        deadline = time.monotonic() + 60
        while len(co._queue) < len(items):
            require(time.monotonic() < deadline, "loop: calls not queued")
            time.sleep(0.001)
        gate.set()
        return [first] + resolvers

    saved = _patched([(v, "_verify_async_direct", held),
                      (ladder, "verify", rec("verify", ladder.verify)),
                      (ladder, "verify_pre",
                       rec("verify_pre", ladder.verify_pre))])
    try:
        before = dict(ladder.launches)
        resolvers = submit_all()
        got = [bool(r()[0]) for r in resolvers[1:]]
        merged = [x for x in recorded if x[1][0].shape[0] >= len(items)]
        launched = {k: ladder.launches[k] - before[k] for k in before}
        require(sizes == [1, len(items)],
                f"loop: the calls were not merged into one dispatch: {sizes}")
        require(len(merged) == 1 and merged[0][0] == "verify",
                f"loop: the merge did not make one B1 launch: "
                f"{[(n, a[0].shape[0]) for n, a, _ in recorded]}")
        _, args, out = merged[0]
        pk, rb, sb, hb = args
        plain = ladder.verify_plain(pk, rb, ladder.digits_from_bytes(sb),
                                    ladder.digits_from_bytes(hb))
        require(torch.equal(out.cpu(), plain.cpu()),
                "loop: the merged launch differs from the plain version")
        require(got == expect, "loop: a caller's merged verdict differs "
                "from the oracle")
        direct = [bool(v._verify_async_direct([it])()[0]) for it in items]
        require(direct == got, "loop: a caller's merged verdict differs "
                "from its own direct launch")
        st = v.coalescer_stats()
        # a failing launch: every caller of the merge raises VerifierError
        fail_calls = []

        def failing(*a):
            fail_calls.append(1)
            raise RuntimeError("tm_ladder_verify launch failed: injected")
        saved += _patched([(v, "_dispatch_cuda", failing)])
        resolvers = submit_all()
        errors = 0
        for r in resolvers:
            try:
                r()
            except tverifier.VerifierError:
                errors += 1
        require(errors == len(resolvers),
                f"loop: {errors} of {len(resolvers)} callers of a failed "
                f"merge saw VerifierError")
    finally:
        _restore(saved)
        v.close()
    return {"calls": len(items), "threads": N_COALESCE_THREADS,
            "dispatch_sizes": [1, len(items)], "merged_lanes":
            int(merged[0][1][0].shape[0]), "valid": sum(got),
            "launches": launched, "coalescer": st,
            "failed_merge": {"callers": len(resolvers),
                             "verifier_errors": errors,
                             "launch_attempts": len(fail_calls)}}


def phase_procnet_loop(card: str, device: str = "cuda",
                       procnet: dict = None) -> dict:
    """BASELINE config 1 as four OS processes on the JAX node's defaults
    (`reactor: "auto"`, the event loop; `verifier_coalesce: "auto"`;
    `verifier_backend: "cuda"`): phase 11's net and checks, plus the
    front door's load (the sync feeder to node 2 through its TxBatcher,
    LOOP_SUBSCRIBERS NewBlock subscribers on node 1) and the plane's
    checks. `procnet` is phase 11's run, for the plane_ab line. A CPU
    rehearsal passes device="cpu" (no coalescer kernel check, no launch
    required)."""
    from tendermint_tpu_torch.procnet import bench_settings
    on_card = device.startswith("cuda")
    if on_card:
        check = _coalescer_check(torch.device(device))
        emit({"phase": "procnet_loop_coalescer_check", **check,
              "card": card})
    # node 3 runs through in both arms, so that plane_ab compares like
    # with like; phase 13 restarts it on this plane, load and coalescer
    load = _LoopLoad()
    try:
        run = _procnet_net("procnet_loop", bench_settings(
            "cuda" if on_card else "auto", reactor="auto",
            verifier_coalesce="auto", pipeline="off"), device, extra=load,
            restart=False)
    finally:
        load.subs.stop()
    lines, rate = run["lines"], run["rate"]
    per_node = {i: lines[i][-1] for i in range(4)}
    acked = Counter(load.sync.acked)
    committed = {tx: run["counts"][tx] for tx in acked}
    lo, hi = LOOP_EVENTS
    want = list(range(lo, hi + 1))
    drops = [sorted(set(want) - set(hs)) for hs in load.subs.heights]
    out_of_order = sum(1 for hs in load.subs.heights if hs != sorted(hs))
    emit({"phase": "procnet_loop", "validators": 4, "processes": 4,
          "plane": {"reactor": "auto", "verifier_coalesce": "auto"},
          "heights": run["top"], "measured_heights": list(PROC_MEASURE),
          "blocks_per_s": rate["blocks_per_s"],
          "txs_per_s": rate["txs_per_s"], "measure_span_s": rate["span_s"],
          "txs_committed": len(run["txs"]), "txs_sent": run["sent"],
          "feeder_errors": run["errors"], "boot_s": run["boot_s"],
          "wall_s": run["wall_s"], "banned_by": {
              i: sorted(p[:8] for p in b) for i, b in run["bans"].items()},
          "card": card})
    emit({"phase": "procnet_loop_kernels",
          "by_node": {i: _verifier_reading(per_node[i]) for i in per_node},
          "launches": run["launches"], "card": card})
    batcher = per_node[2]["tx_batcher"] or {}
    emit({"phase": "procnet_loop_rpc", "sync_conns": LOOP_SYNC_CONNS,
          "sync_acked": len(acked), "sync_committed": sum(
              1 for c in committed.values() if c == 1),
          "sync_refused": load.sync.refused, "sync_errors": load.sync.errors,
          "sync_acked_per_conn": [min(load.sync.per_conn),
                                  max(load.sync.per_conn)],
          "sync_paused_s": load.sync.paused_s,
          "batcher_node2": batcher, "txs_per_flush": batcher.get("txs", 0)
          / max(1, batcher.get("flushes", 0)),
          "subscribers": LOOP_SUBSCRIBERS, "events": sum(
              len(h) for h in load.subs.heights),
          "subscribed_at_height": load.subs.subscribed_at,
          "subscriber_drops": sum(len(d) for d in drops),
          "subscribers_with_drops": sum(1 for d in drops if d),
          "missed_heights": sorted(Counter(h for d in drops for h in d)
                                   .items())[:10],
          "out_of_order": out_of_order, "closed_by_server":
          load.subs.closed, "card": card})
    emit({"phase": "procnet_loop_threads", "by_node": {
        i: [{"threads": ln["threads"], "loop": ln["loop"]}
            for ln in lines[i]] for i in lines}, "card": card})
    emit({"phase": "procnet_loop_device",
          "utilization_gpu_mean": run["busy"], "samples": run["n_samples"],
          "window": f"feeders' start to node 0 at {PROC_HEIGHTS}",
          "card": card})
    # the same net and load on the loop with coalescing off: the plane_ab
    # line's third arm, which isolates the coalescer's share
    off_load = _LoopLoad()
    try:
        off = _procnet_net("procnet_loop_off", bench_settings(
            "cuda" if on_card else "auto", reactor="auto",
            verifier_coalesce="off", pipeline="off"), device,
            extra=off_load, restart=False)
    finally:
        off_load.subs.stop()
    emit({"phase": "procnet_loop_off", "plane": {
        "reactor": "auto", "verifier_coalesce": "off"},
        "heights": off["top"], "blocks_per_s": off["rate"]["blocks_per_s"],
        "txs_per_s": off["rate"]["txs_per_s"], "boot_s": off["boot_s"],
        "wall_s": off["wall_s"], "by_node": {
            i: _verifier_reading(off["lines"][i][-1]) for i in range(4)},
        "loop": {i: off["lines"][i][-1]["loop"] for i in range(4)},
        "sync_acked": len(off_load.sync.acked), "subscriber_events": sum(
            len(h) for h in off_load.subs.heights),
        "utilization_gpu_mean": off["busy"], "card": card})
    _require_b1_everywhere("procnet_loop_off", off["lines"], on_card)
    _require_serial_commit_path("procnet_loop_off", off["lines"])
    if procnet is not None:
        def plane(r):
            readings = [_verifier_reading(r["lines"][i][-1])
                        for i in range(4)]
            return {"blocks_per_s": r["rate"]["blocks_per_s"],
                    "b1_launches_a_node": r["launches"]["verify"] / 4,
                    "submissions_a_node": sum(x["submissions"]
                                              for x in readings) / 4,
                    "dispatches_a_node": sum(x["dispatches"]
                                             for x in readings) / 4,
                    "host_ms_a_call": [x["host_ms_per_call"]
                                       for x in readings],
                    "loop_busy_share": [
                        (r["lines"][i][-1]["loop"] or {}).get("busy_share")
                        for i in range(4)],
                    "wait_ms_a_call": [x["wait_ms_per_call"]
                                       for x in readings]}
        emit({"phase": "plane_ab", "threads_off": plane(procnet),
              "loop_off": plane(off), "loop_auto": plane(run),
              "note": "a record, not a check: phase 11 (reactor threads, "
              "coalescing off, no front-door load) beside phase 12 on the "
              "loop with coalescing on (the JAX defaults) and off, both "
              "with the sync feeder and the subscribers; nodes 0-3's last "
              "processes; in this order: threads_off, loop_auto, loop_off",
              "card": card})
    _check_loop_run("procnet_loop", run, load, on_card)
    _require_serial_commit_path("procnet_loop", lines)
    return run


def _check_loop_run(tag: str, run: dict, load, on_card: bool) -> None:
    """Phase 12's checks of a run on the loop plane with the front door's
    load: B1 in every process and no B3, node 3 signing after its
    rejoin (in a run with the restart), every sync-acknowledged tx
    committed once, every subscriber
    seeing every height in order, one loop thread and no per-peer thread
    in every process, and every coalescer accounting for its calls."""
    lines, restart = run["lines"], run["restart"]
    acked = Counter(load.sync.acked)
    committed = {tx: run["counts"][tx] for tx in acked}
    lo, hi = LOOP_EVENTS
    want = list(range(lo, hi + 1))
    drops = [sorted(set(want) - set(hs)) for hs in load.subs.heights]
    out_of_order = sum(1 for hs in load.subs.heights if hs != sorted(hs))
    _require_b1_everywhere(tag, lines, on_card)
    require(run["launches"]["sign_rb"] == 0,
            f"{tag} launched the sign kernel: {run['launches']}")
    require(restart is None or restart["signed_at"] > restart["synced_to"],
            f"{tag}: node 3 did not sign after its rejoin: {restart}")
    require(acked and all(c == 1 for c in committed.values()),
            f"{tag}: {sum(1 for c in committed.values() if c != 1)} "
            f"of {len(acked)} sync-acknowledged txs not committed once")
    require(not any(drops) and not out_of_order and not load.subs.closed,
            f"{tag}: subscribers missed heights ({sum(map(len, drops))}"
            f" drops, {out_of_order} out of order, {load.subs.closed} closed)")
    for i in lines:
        for j, line in enumerate(lines[i]):
            th, v, c = line["threads"], line["verifier"], line["coalescer"]
            require(line["reactor"] == "loop" and th["tm-reactor-loop"] == 1
                    and th["mconn-"] == th["gossip-"]
                    == th["mempool-bcast-"] == 0,
                    f"{tag}: node {i}'s threads {th}")
            # node 3's first process is the killed one in a restart run
            stopped = restart is None or not (i == 3 and j == 0)
            require(c["submissions"] > 0
                    and v["coalesced_calls"] == c["submissions"]
                    and v["calls"] == v["direct_calls"]
                    + v["coalesced_dispatches"]
                    # the verifier's stats are read before the
                    # coalescer's, which counts a dispatch before it runs
                    and 0 < v["coalesced_dispatches"] <= c["dispatches"]
                    + c["isolated_calls"]
                    and (c["merged_calls"] == c["submissions"] if stopped
                         else c["merged_calls"] <= c["submissions"]),
                    f"{tag}: node {i}'s coalescer does not account "
                    f"for its calls: {v} {c}")


# -------------------- phase 13: config 1 on the JAX node's default commit path

SWEEP_TARGET = 4          # the crash sweep commits to this height; it crashes
#                           the first commit after wave B's injection
SWEEP_WAVES = ([b"fp/a%d=v%d" % (i, i) for i in range(1, 4)],
               [b"fp/b%d=w%d" % (i, i) for i in range(1, 4)])


def _commit_path_reading(line: dict) -> dict:
    """A process's pipeline and native-route counts from its kernel line."""
    p, nat = line["pipeline"], line["native"]
    return {"height": line["height"], "mode": p["mode"],
            "group_flushes": p["group_flushes"], "stage_ms": p["stage_ms"],
            "stage_n": p["stage_n"], "precompute": p["precompute"],
            "overlap_ratio": p["overlap_ratio"],
            "partsets": nat["partsets"], "codec": nat["codec"],
            "kvstore": nat["kvstore"],
            "b1_launches": line["launches"]["verify"]}


def _require_pipelined(tag: str, run: dict) -> None:
    """Every process on the pipelined commit path: one group flush a
    height it committed in consensus (node 3's killed process within one
    of its last printed height; its restarted process at most the
    heights after its handshake, at least those after its sync), no
    failed precompute, every part set from tm_partset_build, every block
    with txs on the kv core; and node 3's restart found its block store
    at its state's height or one above."""
    lines, restart = run["lines"], run["restart"]
    for i in lines:
        for j, line in enumerate(lines[i]):
            r = _commit_path_reading(line)
            h, f = r["height"], r["group_flushes"]
            if i != 3:
                flushes_ok = f == h
            elif j == 0:
                flushes_ok = h - 1 <= f <= h + 1
            else:
                flushes_ok = h - restart["synced_to"] <= f \
                    <= h - restart["start_height"]
            require(r["mode"] == "on" and flushes_ok,
                    f"{tag}: node {i} process {j}: {f} group flushes at "
                    f"height {h} ({restart})")
            require(r["precompute"]["failed"] == 0,
                    f"{tag}: node {i}'s precompute failed: {r['precompute']}")
            require(r["partsets"]["python"] == 0,
                    f"{tag}: node {i} built part sets in Python: "
                    f"{r['partsets']}")
            kv = r["kvstore"]
            require(kv["native"] > 0 and kv["per_tx"] == kv["pure"] == 0,
                    f"{tag}: node {i}'s blocks off the kv core: {kv}")
            require(r["codec"]["native"] > 0,
                    f"{tag}: node {i} never took the codec: {r['codec']}")
    require(restart["store_height"] in (restart["state_height"],
                                        restart["state_height"] + 1),
            f"{tag}: node 3's handshake found the store at "
            f"{restart['store_height']}, the state at "
            f"{restart['state_height']}")


class _Crash(BaseException):
    """A simulated process death: nothing between the fail point and the
    sweep may swallow it."""


def _sweep_node(home: str, gen, key, device: str, recovery=None, app=None):
    """A single-validator port Node on the pipelined path (MockTicker,
    `app` or the kvstore app, files under `home`), verifying on
    `device`, with the `base` settings `recovery` (the recovery plane's
    keys)."""
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.consensus.ticker import MockTicker
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile
    pv_path = os.path.join(home, "priv_validator.json")
    if os.path.exists(pv_path):
        pv = PrivValidatorFile.load(pv_path)
    else:
        os.makedirs(home, exist_ok=True)
        pv = PrivValidatorFile(pv_path, key)
        pv._persist()
    cfg = test_config(home)
    cfg.base.verifier_backend = "cuda" if device.startswith("cuda") \
        else "python"
    cfg.base.pipeline = "auto"
    for k, v in (recovery or {}).items():
        setattr(cfg.base, k, v)
    node = Node(cfg, gen, priv_validator=pv,
                app=KVStoreApp() if app is None else app,
                device=device if device.startswith("cuda") else None)
    node.consensus.ticker.stop()
    node.consensus.ticker = MockTicker(node.consensus._on_timeout_fire)
    return node


def _sweep_inject(node, txs) -> None:
    """Duplicate-tolerant: after a restart the mempool WAL replays its
    pending txs; kvstore sets are idempotent."""
    for tx in txs:
        try:
            node.mempool.check_tx(tx)
        except Exception:  # tmlint: allow(exception-hygiene): duplicate-tolerant inject: after a restart the mempool WAL replays its pending txs, and kvstore sets are idempotent
            pass


def _sweep_commit_to(node, height: int, max_ticks: int = 400) -> None:
    for _ in range(max_ticks):
        if node.height >= height:
            return
        node.consensus.ticker.fire_next()
    require(False, f"crash sweep: stuck at height {node.height}")


def _sweep_drain(node, max_ticks: int = 200) -> None:
    for _ in range(max_ticks):
        if node.mempool.size() == 0:
            return
        node.consensus.ticker.fire_next()
    require(False, f"crash sweep: the mempool never drained "
                   f"({node.mempool.size()})")


def _sweep_chain(node) -> list:
    return [node.block_store.load_block(h).to_bytes()
            for h in range(1, node.block_store.height() + 1)]


def phase_crash_sweep(card: str, device: str = "cuda") -> dict:
    """tests/test_fail_points.py's crash-at-every-index sweep on the port,
    verifying on `device`: for each of the ten pipelined COMMIT_POINTS
    that fire without the state tree, a single-validator node commits
    to height 2 (and its proof block), is crashed (fail.set_callback
    raising) at that point of its next commit, a height >= 3, is rebuilt
    from its stores and WAL (the
    handshake's replay, the WAL catchup), and commits to SWEEP_TARGET
    and drains its mempool. Its app hash and every block must equal an
    uncrashed run's (pinned clock), and B1 must launch. Launch counts
    zeroed at the start, read at the end."""
    on_card = device.startswith("cuda")
    root = tempfile.mkdtemp(prefix="crash-sweep-")
    key = PrivKey.generate(b"\x0a" * 32)
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    gen = GenesisDoc(chain_id="crash-sweep", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    points = [p for p in tfail.COMMIT_POINTS
              if not p.startswith("statetree.")]
    wave_a, wave_b = SWEEP_WAVES
    rows = []
    _zero_launches()
    tclock.set_source(lambda: T0)
    t_start = time.perf_counter()
    try:
        control = _sweep_node(os.path.join(root, "control"), gen, key,
                              device)
        control.start()
        _sweep_inject(control, wave_a)
        _sweep_commit_to(control, 2)
        _sweep_inject(control, wave_b)
        _sweep_commit_to(control, SWEEP_TARGET)
        _sweep_drain(control)
        want_hash, want_chain = control.consensus.state.app_hash, \
            _sweep_chain(control)
        control.stop()
        for index, point in enumerate(points, start=1):
            home = os.path.join(root, f"crash{index}")
            node = _sweep_node(home, gen, key, device)
            node.start()
            _sweep_inject(node, wave_a)
            _sweep_commit_to(node, 2)
            hit = []

            def crash(i):
                hit.append(i)
                raise _Crash(f"index {i}")

            tfail.reset()
            tfail.set_callback(crash)
            tfail.set_target(index)
            try:
                _sweep_inject(node, wave_b)
                _sweep_commit_to(node, SWEEP_TARGET)
            except _Crash:
                pass
            finally:
                tfail.set_target(None)
                tfail.clear_callback()
                tfail.reset()
            require(hit == [index], f"crash sweep: {point} did not fire")
            crashed_at = node.height
            node.consensus._stopped = True
            try:
                node.stop()
            except Exception:  # tmlint: allow(exception-hygiene): the stop of a node the sweep crashed on purpose: its torn state may fail to close; the restarted node is what is checked
                pass
            t0 = time.perf_counter()
            node2 = _sweep_node(home, gen, key, device)
            node2.start()
            recover_s = time.perf_counter() - t0
            recovered_at = node2.height
            store_h, state_h = node2.handshake_heights
            _sweep_inject(node2, wave_b)
            _sweep_commit_to(node2, SWEEP_TARGET)
            _sweep_drain(node2)
            chain = _sweep_chain(node2)
            rows.append({"index": index, "point": point,
                         "crashed_at_height": crashed_at,
                         "store_height": store_h, "state_height": state_h,
                         "handshake_blocks": node2.handshake_blocks,
                         "recovered_at_height": recovered_at,
                         "final_height": node2.height,
                         "recover_s": recover_s,
                         "app_hash_equal":
                             node2.consensus.state.app_hash == want_hash,
                         "blocks_equal": chain == want_chain})
            node2.stop()
            require(recovered_at >= crashed_at,
                    f"crash sweep: {point} lost a committed height")
            require(rows[-1]["app_hash_equal"] and rows[-1]["blocks_equal"],
                    f"crash sweep: {point} recovered to another chain: "
                    f"{rows[-1]}")
    finally:
        tclock.set_source(None)
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(ladder.launches)
    emit({"phase": "procnet_pipeline_crash_sweep", "points": rows,
          "target_height": SWEEP_TARGET, "blocks": len(want_chain),
          "launches": launches, "wall_s": time.perf_counter() - t_start,
          "card": card})
    require(not on_card or launches["verify"] >= 1,
            f"crash sweep: B1 did not launch: {launches}")
    return launches


def phase_procnet_pipeline(card: str, device: str = "cuda",
                           loop: dict = None) -> dict:
    """BASELINE config 1 as four OS processes on the JAX node's full
    defaults: phase 12's net, load and checks with `pipeline: "auto"`
    (the pipelined finalize with group commit, streaming part sets from
    tm_partset_build, the precomputed next proposal), the native codec
    and the kv core; then the pipeline's checks (_require_pipelined).
    `loop` is phase 12's run, for the pipeline_ab line. A CPU rehearsal
    passes device="cpu" (no launch required)."""
    from tendermint_tpu_torch.procnet import bench_settings
    on_card = device.startswith("cuda")
    load = _LoopLoad()
    try:
        run = _procnet_net("procnet_pipeline", bench_settings(
            "cuda" if on_card else "auto", reactor="auto",
            verifier_coalesce="auto", pipeline="auto"), device, extra=load)
    finally:
        load.subs.stop()
    lines, rate, restart = run["lines"], run["rate"], run["restart"]
    per_node = {i: lines[i][-1] for i in range(4)}
    emit({"phase": "procnet_pipeline", "validators": 4, "processes": 4,
          "plane": {"reactor": "auto", "verifier_coalesce": "auto",
                    "pipeline": "auto"},
          "heights": run["top"], "measured_heights": list(PROC_MEASURE),
          "blocks_per_s": rate["blocks_per_s"],
          "txs_per_s": rate["txs_per_s"], "measure_span_s": rate["span_s"],
          "txs_committed": len(run["txs"]), "txs_sent": run["sent"],
          "feeder_errors": run["errors"], "boot_s": run["boot_s"],
          "wall_s": run["wall_s"], "sync_acked": len(load.sync.acked),
          "subscriber_events": sum(len(h) for h in load.subs.heights),
          "banned_by": {i: sorted(p[:8] for p in b)
                        for i, b in run["bans"].items()}, "card": card})
    emit({"phase": "procnet_pipeline_restart", **restart,
          "sync_routes": per_node[3]["routes"],
          "sync_launches": per_node[3]["launches"], "card": card})
    emit({"phase": "procnet_pipeline_kernels",
          "by_node": {i: _verifier_reading(per_node[i]) for i in per_node},
          "node3_killed_process": _verifier_reading(lines[3][0]),
          "loop": {i: per_node[i]["loop"] for i in per_node},
          "launches": run["launches"], "card": card})
    emit({"phase": "procnet_pipeline_commit_path", "by_node": {
        i: [_commit_path_reading(ln) for ln in lines[i]] for i in lines},
        "note": "node 3's first entry is its killed process, counted to "
        "the last height it committed", "card": card})
    emit({"phase": "procnet_pipeline_device",
          "utilization_gpu_mean": run["busy"], "samples": run["n_samples"],
          "window": f"feeders' start to node 0 at {PROC_HEIGHTS}",
          "card": card})
    if loop is not None:
        emit({"phase": "pipeline_ab",
              "pipeline_off": {"blocks_per_s": loop["rate"]["blocks_per_s"],
                               "txs_per_s": loop["rate"]["txs_per_s"]},
              "pipeline_on": {"blocks_per_s": rate["blocks_per_s"],
                              "txs_per_s": rate["txs_per_s"]},
              "note": "a record, not a check: phase 12 (pipeline off, the "
              "native codec and kv core on) beside phase 13 (the JAX "
              "defaults) in this call, the same net and load", "card": card})
    _check_loop_run("procnet_pipeline", run, load, on_card)
    _require_pipelined("procnet_pipeline", run)
    return run


# ------------------------------------------ phase 14: the recovery plane

SS_HEIGHTS = 1920         # bench_sync.py's recorded run (BENCH_sync.json):
SS_VALIDATORS = 4         # 1920 heights, 4 validators, 100 txs a block,
SS_TXS = 100              # every tx a new key, a snapshot at 1900 in
SS_SNAPSHOT_AT = 1900     # 256 KiB chunks
SS_CHUNK_KB = 256
SS_WINDOW = 64            # bench_sync's fresh node's verify_window
SS_LINK_RATE = 64_000_000  # bench_sync's in-process links, B/s a direction
SS_TIMEOUT_S = 300.0      # an arm's limit to the frontier
SS_GIVE_UP_S = 10.0       # bench_sync's give_up_s
WIDE_GIVE_UP_S = 3.0      # the flipped copy's fall-back
PROC_SS_RECOVERY = {"snapshot_interval": 10, "snapshot_keep": 2,
                    "retain_heights": 20}   # nodes 0-2
PROC_SS_MAX_AGE = 10      # the genesis' evidence horizon: the state store
#                           prunes behind h - 9 (the default 100000 would
#                           keep every state row)
PROC_SS_RESTART_ABOVE = 11  # node 3 restarts when nodes 0-2 pass this
#                             (the first snapshot, at 10, is published)
PROC_SS_AFTER = 5         # heights node 0 commits after node 3 signs again
PROC_SS_WALL_S = 300.0
PROC_SS_WATCH_S = 1.0     # the meta watcher's period
SWEEP_SS_TARGET = 6       # tests/test_snapshot.py's sweep: commit to 6
SWEEP_SS_RECOVERY = {"snapshot_interval": 2, "snapshot_keep": 2,
                     "retain_heights": 2}
SWEEP_SS_MAX_AGE = 4
SWEEP_SS_WAVES = ([b"sn/a%d=v%d" % (i, i) for i in range(1, 4)],
                  [b"sn/b%d=w%d" % (i, i) for i in range(1, 4)],
                  [b"sn/c%d=u%d" % (i, i) for i in range(1, 4)])


def _ss_verifier(device):
    """The fresh nodes' verifier: BatchVerifier("cuda") on the card (every
    verify of the path reaches the kernels), the host one in a CPU
    rehearsal."""
    if device is not None and device.type == "cuda":
        return tverifier.BatchVerifier("cuda", device=device)
    return tverifier.BatchVerifier("python")


def _cold_cache() -> None:
    with ted._predecomp_lock:
        ted._predecomp.clear()
        ted._predecomp_seen.clear()


def _link_config():
    from tendermint_tpu_torch.config import P2PConfig
    return P2PConfig(send_rate=SS_LINK_RATE, recv_rate=SS_LINK_RATE)


def _ss_source(device, root: str) -> dict:
    """bench_sync.build_source's chain on the port's ChainBuilder (B3 signs
    every commit), each block saved with its commit as the serving node's
    block store does, and the snapshot at SS_SNAPSHOT_AT taken from the
    builder's app at that height."""
    from tendermint_tpu_torch.storage.snapshot import (SnapshotStore,
                                                       build_payload)
    b = ChainBuilder(SS_VALIDATORS, SS_TXS, key_space=1 << 40,
                     chain_id="chip-smoke-statesync", device=device)
    bs = BlockStore(MemDB())
    snaps = SnapshotStore(os.path.join(root, "src-snapshots"))
    times: dict = {}
    t0 = time.perf_counter()
    take_s = frontier = None
    for h in range(1, SS_HEIGHTS + 1):
        block = b.build(1, times)[0]
        bs.save_block(block, block.make_part_set(b.part_size), b.last_commit)
        if h == SS_SNAPSHOT_AT:
            t1 = time.perf_counter()
            snaps.take(h, build_payload(b.state, b.last_commit,
                                        b.app.snapshot_items()),
                       SS_CHUNK_KB * 1024)
            take_s = time.perf_counter() - t1
        if h == SS_HEIGHTS - 1:
            frontier = b.state     # the height a syncing node reaches
    return {"gen": b.gen, "state": b.state, "block_store": bs,
            "snaps": snaps, "manifest": snaps.load_manifest(SS_SNAPSHOT_AT),
            "frontier": frontier, "build_s": time.perf_counter() - t0,
            "take_s": take_s, "build_stages_ms": times}


def _fresh_side(gen, root: str, verifier, restore: bool,
                give_up_s: float = SS_GIVE_UP_S, with_blocks: bool = True):
    """bench_sync._fresh_arm's fresh node on the port: MemDB stores, the
    kvstore app after init_chain, a fast-syncing blockchain reactor at
    SS_WINDOW behind the state-sync gate, and with `restore` the
    StateSyncReactor. Returns its parts; `on_done` stamps the restore."""
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.consensus import ConsensusState, MockTicker
    from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
    from tendermint_tpu_torch.p2p.test_util import make_switch
    from tendermint_tpu_torch.statesync import StateSyncReactor
    from tendermint_tpu_torch.storage import SnapshotStore
    app = KVStoreApp()
    conns = AppConns(local_client_creator(app))
    ss, bs = StateStore(MemDB()), BlockStore(MemDB())
    state = ss.load_or_genesis(gen)
    conns.consensus.init_chain(
        [ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen.chain_id)
    genesis_rows = dict(ss.db.iterate())
    exe = BlockExecutor(ss, conns.consensus, verifier=verifier)
    side = SimpleNamespace(app=app, ss=ss, bs=bs, gate=threading.Event(),
                           genesis_rows=genesis_rows, restored_at=None,
                           restore_launches=None, reactor=None, bc=None)
    sw = make_switch(network=gen.chain_id, seed=b"\x52" * 32,
                     config=_link_config())
    if with_blocks:
        cs = ConsensusState(test_config().consensus, state, exe, bs,
                            priv_validator=None, ticker_factory=MockTicker)
        cons = ConsensusReactor(cs, fast_sync=True)
        side.bc = BlockchainReactor(state, exe, bs, fast_sync=True,
                                    consensus_reactor=cons,
                                    verify_window=SS_WINDOW,
                                    gate=side.gate if restore else None)
        sw.add_reactor("consensus", cons)
        sw.add_reactor("blockchain", side.bc)
    if restore:
        def on_done(st):
            side.restored_at = time.perf_counter()
            side.restore_launches = dict(ladder.launches)
            if st is not None and side.bc is not None:
                cs.state = st
                side.bc.adopt_restored(st)
            side.gate.set()

        side.local = SnapshotStore(os.path.join(root, "snapshots"))
        side.reactor = StateSyncReactor(
            side.local, gen.chain_id, restore=True,
            statesync_dir=os.path.join(root, "statesync"), block_store=bs,
            state_store=ss, app=app, verifier=verifier, on_restored=on_done,
            give_up_s=give_up_s)
        sw.add_reactor("statesync", side.reactor)
    side.sw = sw
    return side


def _serving_switch(gen, state, block_store, snaps):
    from tendermint_tpu_torch.p2p.test_util import make_switch
    from tendermint_tpu_torch.statesync import StateSyncReactor
    sw = make_switch(network=gen.chain_id, seed=b"\x51" * 32,
                     config=_link_config())
    if block_store is not None:
        sw.add_reactor("blockchain", BlockchainReactor(
            state, None, block_store, fast_sync=False))
    sw.add_reactor("statesync", StateSyncReactor(snaps, gen.chain_id))
    sw.start()
    return sw


def _ss_arm(src: dict, use_statesync: bool, root: str, device) -> dict:
    """One of bench_sync's two arms: a fresh node to the frontier, by a
    snapshot restore and the tail, or by fast sync from genesis. Its
    seconds split into discovery, manifest, fetch, restore (assemble,
    verify, app install, stores) and tail; its kernel launches, the
    restore's apart."""
    from tendermint_tpu_torch.p2p.test_util import connect_switches
    verifier = _ss_verifier(device)
    _cold_cache()
    sw_src = _serving_switch(src["gen"], src["state"], src["block_store"],
                             src["snaps"])
    side = _fresh_side(src["gen"], root, verifier, use_statesync)
    side.sw.start()
    log: list = []
    on_card = device is not None and device.type == "cuda"
    saved = _patched(_in_run_timer_patches(log)) if on_card else []
    ref = None
    if on_card:
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
    before = dict(ladder.launches)
    try:
        t0 = time.perf_counter()
        connect_switches(sw_src, side.sw)
        deadline = time.monotonic() + SS_TIMEOUT_S
        while time.monotonic() < deadline and not side.bc.synced:
            require(side.bc.sync_error is None,
                    f"statesync_chain: the sync failed: {side.bc.sync_error!r}")
            if side.reactor is not None:
                require(side.reactor.restore_error is None,
                        "statesync_chain: the restore failed: "
                        f"{side.reactor.restore_error!r}")
            time.sleep(0.01)
        t1 = time.perf_counter()
    finally:
        _restore(saved)
        sw_src.stop()
        side.sw.stop()
        verifier.close()
    require(side.bc.synced, f"statesync_chain: the "
            f"{'statesync' if use_statesync else 'replay'} arm did not reach "
            f"the frontier within {SS_TIMEOUT_S} s "
            f"(at {side.bs.height()})")
    launches = {k: ladder.launches[k] - before[k] for k in before}
    out = {"seconds": t1 - t0, "frontier": side.bs.height(),
           "launches": launches, "verifier_stats": dict(verifier.stats),
           "side": side}
    if use_statesync:
        status = side.reactor.status()
        tm = status["timings"]
        out.update(
            restored_height=status["restore_height"],
            discovery_s=tm.get("discovery_s", 0.0),
            manifest_s=tm.get("manifest_s", 0.0),
            fetch_s=tm.get("fetch_s", 0.0),
            restore_s=sum(tm.get(k, 0.0) for k in
                          ("assemble_s", "verify_s", "app_s", "stores_s")),
            restore_stages_s={k: tm.get(k, 0.0) for k in
                              ("assemble_s", "verify_s", "app_s",
                               "stores_s")},
            to_restored_s=side.restored_at - t0,
            tail_s=t1 - side.restored_at,
            restore_launches={k: side.restore_launches[k] - before[k]
                              for k in before},
            chunks=status["chunks_total"], chunks_ok=status["chunks_ok"],
            chunks_bad=status["chunks_bad"], banned=status["banned"],
            local_snapshots=side.local.list_heights())
    if on_card:
        out["device"] = _in_run_device_time(log, ref, t1 - t0)
    return out


def phase_statesync_chain(card: str, device) -> dict:
    """Phase 14, arm 1: bench_sync.py's shape on the port. Two fresh
    nodes over in-process switches, each verifying on `device`: one
    restores the snapshot at 1900 and fast-syncs the tail to 1919, the
    other fast-syncs from genesis. Launch counts zeroed before the chain
    build (B3), read after both arms."""
    root = tempfile.mkdtemp(prefix="statesync-chain-")
    _zero_launches()
    try:
        src = _ss_source(device, root)
        build_launches = dict(ladder.launches)
        m = src["manifest"]
        emit({"phase": "statesync_build", "heights": SS_HEIGHTS,
              "validators": SS_VALIDATORS, "txs_per_block": SS_TXS,
              "snapshot_height": m["height"], "chunks": len(m["chunks"]),
              "bytes": m["size"], "chunk_kb": SS_CHUNK_KB,
              "build_s": src["build_s"], "snapshot_take_s": src["take_s"],
              "build_stages_ms": src["build_stages_ms"],
              "sign_launches": build_launches["sign_rb"], "card": card})
        arms = {"statesync": _ss_arm(src, True, os.path.join(root, "ss"),
                                     device),
                "replay": _ss_arm(src, False, os.path.join(root, "replay"),
                                  device)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(ladder.launches)
    final = tenc.cdumps(src["frontier"].to_obj())
    for name, arm in arms.items():
        side = arm.pop("side")
        require(arm["frontier"] == SS_HEIGHTS - 1,
                f"statesync_chain: the {name} arm stopped at "
                f"{arm['frontier']}")
        require(tenc.cdumps(side.bc.state.to_obj()) == final
                and side.ss.load().equals(src["frontier"])
                and side.app.app_hash == src["frontier"].app_hash,
                f"statesync_chain: the {name} arm's state or app hash differs "
                "from the source's")
        if name == "statesync":
            require(arm["restored_height"] == SS_SNAPSHOT_AT,
                    f"statesync_chain: restored {arm['restored_height']}")
            require(side.bs.base() == SS_SNAPSHOT_AT + 1,
                    f"statesync_chain: the restored store's base is "
                    f"{side.bs.base()}, the reference writes "
                    f"{SS_SNAPSHOT_AT + 1}")
            require(side.ss.load_snapshot_pin(SS_SNAPSHOT_AT) == m
                    and side.ss.latest_snapshot_height() == SS_SNAPSHOT_AT
                    and arm["local_snapshots"] == [SS_SNAPSHOT_AT],
                    "statesync_chain: the snapshot pin or the adopted "
                    "snapshot differs from the source's manifest")
    emit({"phase": "statesync_chain", "arms": arms,
          "speedup_statesync_vs_replay":
              arms["replay"]["seconds"] / arms["statesync"]["seconds"],
          "links_bytes_per_s": SS_LINK_RATE, "verify_window": SS_WINDOW,
          "launches": launches, "card": card})
    on_card = device is not None and device.type == "cuda"
    require(not on_card
            or arms["statesync"]["restore_launches"]["verify"] >= 1,
            "statesync_chain: the restore's light verify did not launch B1: "
            f"{arms['statesync']['restore_launches']}")
    require(not on_card or (arms["statesync"]["launches"]["verify"] >= 1
                            and launches["sign_rb"] >= SS_HEIGHTS),
            f"statesync_chain: launches {launches}")
    return launches


def _wide_snapshot(commit_path, root: str):
    """A snapshot at phase 3's height whose commit is phase 3's 10,000-
    validator commit: the State of a chain whose last block is phase 3's
    block id, signed by that set, over a kvstore app of seeded pairs."""
    from tendermint_tpu_torch.state.state import make_genesis_state
    from tendermint_tpu_torch.storage import SnapshotStore
    from tendermint_tpu_torch.storage.snapshot import build_payload
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    vs, bid, commit = commit_path
    gen = GenesisDoc(chain_id=CHAIN, genesis_time_ns=1, validators=[
        GenesisValidator(v.pubkey, v.voting_power) for v in vs.validators])
    state = make_genesis_state(gen)
    app = KVStoreApp()
    rng = random.Random(SEED)
    items = sorted((b"wide/k%d" % i, b"v%d" % rng.randrange(1 << 30))
                   for i in range(4096))
    state.last_block_height = HEIGHT
    state.last_block_id = bid
    state.last_block_time_ns = HEIGHT * 10 ** 9
    state.last_validators = vs
    state.app_hash = app.restore_items(
        items, HEIGHT, validators=[(v.pubkey, v.voting_power)
                                   for v in vs.validators])
    payload = build_payload(state, commit, app.snapshot_items())
    snaps = SnapshotStore(os.path.join(root, "wide-src"))
    manifest = snaps.take(HEIGHT, payload, SS_CHUNK_KB * 1024)
    # the same payload with one signature byte flipped
    bad = tenc.cloads(tenc.cdumps(payload))
    k = len(vs.validators) // 3
    sig = bytes.fromhex(bad["commit"]["precommits"][k]["signature"])
    bad["commit"]["precommits"][k]["signature"] = _flip(sig, 20).hex()
    evil = SnapshotStore(os.path.join(root, "wide-evil"))
    evil_manifest = evil.take(HEIGHT, bad, SS_CHUNK_KB * 1024)
    return gen, state, snaps, manifest, evil, evil_manifest


def _wide_restore(gen, snaps, root: str, device, give_up_s: float):
    """A fresh node (state sync only: there are no blocks to sync) restores
    from a switch serving `snaps`. Returns (side, seconds, device time)."""
    from tendermint_tpu_torch.p2p.test_util import connect_switches
    verifier = _ss_verifier(device)
    sw_src = _serving_switch(gen, None, None, snaps)
    side = _fresh_side(gen, root, verifier, True, give_up_s=give_up_s,
                       with_blocks=False)
    side.sw.start()
    log: list = []
    on_card = device is not None and device.type == "cuda"
    saved = _patched(_in_run_timer_patches(log)) if on_card else []
    ref = None
    if on_card:
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
    try:
        t0 = time.perf_counter()
        connect_switches(sw_src, side.sw)
        require(side.reactor.finished.wait(SS_TIMEOUT_S),
                "statesync_wide: the restore never concluded")
        t1 = time.perf_counter()
    finally:
        _restore(saved)
        sw_src.stop()
        side.sw.stop()
        verifier.close()
    dev = _in_run_device_time(log, ref, t1 - t0) if on_card else None
    return side, t1 - t0, dev, log


def phase_statesync_wide(card: str, commit_path, device) -> dict:
    """Phase 14, arm 2: a snapshot whose commit is signed by 10,000
    validators (phase 3's keys and commit, config 3's width). A fresh
    node restores it from a cold predecompression cache, so its light
    verify runs B1 at 10,000 lanes; then a copy with one flipped
    signature byte must be refused with "invalid signature in commit",
    the snapshot poisoned and no store touched. Launch counts zeroed
    before, read after."""
    from tendermint_tpu_torch.statesync import apply_restore
    from tendermint_tpu_torch.storage import SnapshotStore
    root = tempfile.mkdtemp(prefix="statesync-wide-")
    _zero_launches()
    try:
        gen, state, snaps, manifest, evil, evil_manifest = \
            _wide_snapshot(commit_path, root)
        _cold_cache()
        side, secs, dev, log = _wide_restore(
            gen, snaps, os.path.join(root, "good"), device, SS_GIVE_UP_S)
        good = side.reactor.status()
        require(side.reactor.restore_error is None
                and good["restore_height"] == HEIGHT
                and side.bs.height() == HEIGHT
                and side.bs.base() == HEIGHT + 1
                and side.ss.load_snapshot_pin(HEIGHT) == manifest
                and side.app.app_hash == state.app_hash
                and side.ss.load().last_validators.hash() ==
                commit_path[0].hash(),
                f"statesync_wide: the restore of {HEIGHT}: {good}")
        b1_lanes = sum(n for name, n, _, _ in log if name == "verify")
        # the refusal, from the apply itself and through a restore
        scratch = SnapshotStore(os.path.join(root, "scratch"))
        refused = None
        try:
            check = _ss_verifier(device)
            apply_restore(evil, evil_manifest, BlockStore(MemDB()),
                          StateStore(MemDB()), scratch, KVStoreApp(),
                          gen.chain_id, verifier=check)
        except ValueError as e:
            refused = str(e)
        finally:
            check.close()
        require(refused == "invalid signature in commit",
                f"statesync_wide: the flipped copy: {refused!r}")
        bad_side, bad_s, _, _ = _wide_restore(
            gen, evil, os.path.join(root, "bad"), device, WIDE_GIVE_UP_S)
        bad = bad_side.reactor.status()
        poisoned = sorted(bad_side.reactor._poisoned)
        require(bad_side.reactor.restore_error is None
                and bad_side.reactor.restored_state is None
                and poisoned == [(HEIGHT, evil_manifest["root"])]
                and bad_side.bs.height() == 0
                and dict(bad_side.ss.db.iterate()) == bad_side.genesis_rows
                and bad_side.local.list_heights() == []
                and bad["fallback"] == 1,
                f"statesync_wide: the flipped copy was not refused cleanly: "
                f"{bad}, poisoned {poisoned}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(ladder.launches)
    emit({"phase": "statesync_wide", "validators": len(commit_path[0]
                                                         .validators),
          "height": HEIGHT, "chunks": len(manifest["chunks"]),
          "bytes": manifest["size"], "restore_s": secs,
          "stages_s": good["timings"], "b1_lanes": b1_lanes,
          "device": dev, "refused": refused, "refusal_s": bad_s,
          "refusal_stages_s": bad["timings"], "launches": launches,
          "card": card})
    on_card = device is not None and device.type == "cuda"
    require(not on_card or b1_lanes >= len(commit_path[0].validators),
            f"statesync_wide: B1 ran {b1_lanes} lanes in the restore")
    return launches


class _MetaWatch:
    """Every PROC_SS_WATCH_S, the newest 20 block metas of every node that
    answers: height -> node -> (block hash, app hash). A pruning node keeps
    only its last ~20 heights, so the agreement at every height is read
    while the heights are held."""

    def __init__(self, net):
        self.net = net
        self.seen: dict = defaultdict(dict)
        self.time_ns: dict = {}         # height -> its header's time
        self.txs: dict = {}             # height -> its header's num_txs
        self.failed_reads = Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="smoke-meta-watch")

    def read(self) -> None:
        for i in range(self.net.n):
            top = self.net.height(i)
            if top < 1:
                continue
            try:
                metas = self.net.held_metas(i, max(1, top - 19), top)
            except Exception as e:
                self.failed_reads[f"{i}: {type(e).__name__}"] += 1
                continue
            for h, m in metas.items():
                self.seen[h][i] = (m["block_id"]["hash"],
                                   m["header"]["app_hash"])
                self.time_ns[h] = m["header"]["time_ns"]
                self.txs[h] = m["header"]["num_txs"]

    def _run(self) -> None:
        while not self._stop.wait(PROC_SS_WATCH_S):
            self.read()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(30)


def _set_max_age(net, max_age: int) -> None:
    """Every node's genesis gets evidence max_age `max_age` (one shared
    genesis, rewritten in each home before any node starts)."""
    for i in range(net.n):
        path = os.path.join(net.home(i), "config", "genesis.json")
        with open(path) as f:
            doc = json.load(f)
        doc["consensus_params"]["evidence"]["max_age"] = max_age
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)


def _signed_in_held_commit(net, val_index: int, after: int) -> int:
    """_signed_in_commit over the commits node 0 still holds: a pruning
    node answers no commit below its base."""
    from tendermint_tpu_torch.rpc.client import RPCClientError
    c = net.rpc(0, 10.0)
    top = int(c.call("status")["latest_block_height"])
    for h in range(after + 1, top):
        try:
            pcs = c.call("commit", height=h)["commit"]["precommits"]
        except RPCClientError:
            continue            # pruned since `after` was read
        if pcs[val_index] is not None:
            return h
    return 0


def _rejoin_by_snapshot(net, left, device: str) -> dict:
    """Node 3 SIGKILLed when node 0 commits PROC_CRASH_AT, wiped with `cli
    unsafe_reset_all`, and restarted with --state-sync once nodes 0-2 pass
    PROC_SS_RESTART_ABOVE; the restart timed to its RPC, to its restore (its
    status at a height >= 1 while syncing), to the end of its sync and to
    its precommit in a commit of node 0."""
    with open(os.path.join(net.home(3), "config",
                           "priv_validator.json")) as f:
        pub = json.load(f)["pub_key"]["value"]
    vals = net.rpc(0).call("validators")["validators"]["validators"]
    idx = [v["pubkey"] for v in vals].index(pub)
    net.wait_for(lambda: net.height(0) >= PROC_CRASH_AT,
                 left("the crash height"), "node 0 at the crash height")
    killed_at = net.height(3)
    net.kill(3)
    net.reset(3)
    require(not os.path.exists(os.path.join(net.home(3), "data")),
            "procnet_statesync: unsafe_reset_all left node 3's data")
    net.wait_for(lambda: min(net.height(i) for i in range(3))
                 > PROC_SS_RESTART_ABOVE, left("the restart height"),
                 "nodes 0-2 past the restart height")
    net_at_restart = net.height(0)
    t_kill_done = time.perf_counter()
    net.start(3, extra=["--state-sync", "--device", device])
    net.wait_for(lambda: _proc_status(net, 3) is not None,
                 left("node 3's restart"), "node 3's RPC after restart")
    t_up = time.perf_counter()
    net.wait_for(lambda: net.height(3) >= 1, left("node 3's restore"),
                 "node 3's restore", poll_s=0.05)
    t_restored = time.perf_counter()
    restored_seen = net.height(3)
    net.wait_for(lambda: (_proc_status(net, 3) or {}).get(
        "syncing", True) is False, left("node 3's sync"), "node 3's sync")
    t_synced = time.perf_counter()
    synced_h = net.height(3)
    signed = {}

    def signs() -> bool:
        signed["at"] = _signed_in_held_commit(net, idx, synced_h)
        return signed["at"] > 0
    net.wait_for(signs, left("node 3's rejoin"),
                 "node 3's precommit in a commit", poll_s=0.5)
    t_rejoin = time.perf_counter()
    return {"killed_at_height": killed_at, "node0_at_kill": PROC_CRASH_AT,
            "node0_at_restart": net_at_restart,
            "height_seen_restored": restored_seen, "synced_to": synced_h,
            "signed_at": signed["at"],
            "restart_to_rpc_s": t_up - t_kill_done,
            "rpc_to_restored_s": t_restored - t_up,
            "restored_to_synced_s": t_synced - t_restored,
            "synced_to_signed_s": t_rejoin - t_synced,
            "restart_to_signed_s": t_rejoin - t_kill_done,
            "validator_index": idx}


def phase_procnet_statesync(card: str, device: str = "cuda") -> dict:
    """Phase 14, arm 3: phase 13's net and load (four `cli node --p2p`
    processes on the JAX node's defaults: loop plane, coalescing, the
    pipeline; two feeders, the subscribers and the sync connections of
    _LoopLoad) with snapshots every 10 heights, 2 kept and 20 heights
    retained on nodes 0-2 (and the evidence horizon at PROC_SS_MAX_AGE in
    the genesis, so that the state store prunes too). Node 3 is SIGKILLed
    at PROC_CRASH_AT, wiped, and restarted with --state-sync after the
    net passes 11: it must restore a snapshot height that is a multiple
    of 10, fast-sync the tail, sign again, and agree with every node at
    every height above its restore; nodes 0-2 must end pruned above 1, never
    above their latest snapshot, with at most 2 snapshots. A CPU
    rehearsal passes device="cpu" (no launch required)."""
    from tendermint_tpu_torch.procnet import (ProcNet, bench_settings,
                                              free_block)
    on_card = device.startswith("cuda")
    _node_libs()
    tag = "procnet_statesync"
    root = tempfile.mkdtemp(prefix=f"{tag}-")
    net = ProcNet(root, base_port=free_block(8))
    net.write_tree(f"chip-smoke-{tag}")
    net.configure(bench_settings("cuda" if on_card else "auto",
                                 reactor="auto", verifier_coalesce="auto",
                                 pipeline="auto"))
    net.configure({"base": PROC_SS_RECOVERY}, nodes=range(3))
    _set_max_age(net, PROC_SS_MAX_AGE)
    feeders = [_WSFeeder(net, tid) for tid in (0, 1)]
    load = _LoopLoad()
    watch = _MetaWatch(net)
    t_start = time.perf_counter()

    def left(what: str) -> float:
        rem = PROC_SS_WALL_S - (time.perf_counter() - t_start)
        require(rem > 0, f"{tag}: out of wall time at {what}")
        return rem
    ok = False
    try:
        net.start_all(extra=["--no-fast-sync", "--device", device])
        load.subscribe(net, left)
        net.wait_for(lambda: min(net.heights()) >= 2,
                     min(PROC_BOOT_S, left("boot")), "boot")
        boot_s = time.perf_counter() - t_start
        load.start(net)
        for f in feeders:
            f.start()
        watch.start()
        rejoin = _rejoin_by_snapshot(net, left, device)
        stop_at = max(PROC_HEIGHTS, rejoin["signed_at"] + PROC_SS_AFTER)
        net.wait_for(lambda: net.height(0) >= stop_at,
                     left("the last fed height"), "node 0 at the last height")
        # node 0's blocks stop_at - 4 .. stop_at, read now: it prunes
        # behind retain_heights while the waits below run
        c0, fed = net.rpc(0, 30.0), []
        for h in range(stop_at - 4, stop_at + 1):
            fed += [bytes.fromhex(t) for t in
                    c0.call("block", height=h)["block"]["data"]["txs"]]
        require(fed, f"{tag}: no tx in node 0's blocks "
                     f"{stop_at - 4}-{stop_at}")
        for f in feeders:
            f.stop()
        load.stop()
        net.wait_for(lambda: all(
            net.rpc(i).call("num_unconfirmed_txs")["n_txs"] == 0
            for i in range(net.n)), left("the mempools' drain"),
            "the mempools' drain", poll_s=0.25)
        net.wait_for(lambda: min(net.heights()) >= stop_at,
                     left("every node at the last height"),
                     "every node at the last height")
        load.finish(left)
        watch.stop()
        watch.read()
        top = min(net.heights())
        keys = random.Random(SEED).sample(fed, min(PROC_SAMPLE_KEYS,
                                                   len(fed)))
        # the sync feeder's acknowledged txs: node 0 prunes its blocks, so
        # a seeded sample is read back from every node's app instead of
        # counted in the blocks
        keys += random.Random(SEED + 1).sample(
            load.sync.acked, min(PROC_SAMPLE_KEYS, len(load.sync.acked)))
        for tx in keys:
            k, v = tx.split(b"=", 1)
            for i in range(net.n):
                got = net.rpc(i).call("abci_query", data=k.hex())
                require(bytes.fromhex(got["response"]["value"]) == v,
                        f"{tag}: node {i} answers {k!r} wrong")
        early = net.early_exits()
        require(not early, f"{tag}: node processes exited early {early}")
        wall_s = time.perf_counter() - t_start
        ok = True
    finally:
        for f in feeders:
            f.stop()
        load.stop()
        load.subs.stop()
        watch.stop()
        codes = net.stop_all()
        if not ok:
            for i in range(net.n):
                tail = net.log(i).splitlines()[-40:] \
                    if os.path.exists(net.log_path(i)) else []
                print(f"{tag} node {i} log tail:", *tail, sep="\n",
                      file=sys.stderr)
    lines = {i: net.kernel_lines(i) for i in range(net.n)}
    shutil.rmtree(root, ignore_errors=True)
    require(all(codes[i] == 0 for i in range(net.n)),
            f"{tag}: node exit codes {codes}")
    require([len(lines[i]) for i in range(net.n)] == [1, 1, 1, 2],
            f"{tag}: kernel lines a process {lines}")
    rec = {i: lines[i][-1]["recovery"] for i in range(net.n)}
    n3 = rec[3]["statesync"]
    restored = n3["restore_height"]
    # agreement at every height above node 3's restore that it holds, up
    # to the last height another node was read at (the last read of node
    # 3 can be a height ahead of the others')
    others_top = max((h for h, by in watch.seen.items() if set(by) - {3}),
                     default=0)
    bad, unseen = [], []
    for h, by in sorted(watch.seen.items()):
        if len({v for v in by.values()}) > 1:
            bad.append((h, by))
        if restored < h <= others_top and 3 in by and not set(by) - {3}:
            unseen.append(h)
    n3_heights = sorted(h for h, by in watch.seen.items()
                        if 3 in by and h > restored)
    lo, hi = PROC_MEASURE      # phase 13's window, from the watched metas
    require(lo in watch.time_ns and hi in watch.time_ns,
            f"{tag}: the watcher missed height {lo} or {hi}")
    span = (watch.time_ns[hi] - watch.time_ns[lo]) / 1e9
    rate = {"blocks_per_s": (hi - lo) / span, "txs_per_s": sum(
        watch.txs[h] for h in range(lo + 1, hi + 1)) / span,
        "span_s": span}
    launches = {k: sum(line["launches"][k]
                       for i in lines for line in lines[i])
                for k in ladder.launches}
    emit({"phase": tag, "validators": 4, "processes": 4,
          "plane": {"reactor": "auto", "verifier_coalesce": "auto",
                    "pipeline": "auto"}, "recovery": PROC_SS_RECOVERY,
          "evidence_max_age": PROC_SS_MAX_AGE, "heights": top,
          "measured_heights": list(PROC_MEASURE), **rate,
          "boot_s": boot_s, "wall_s": wall_s, "rejoin": rejoin,
          "node3_restore": n3, "heights_compared": len(watch.seen),
          "meta_reads_failed": dict(watch.failed_reads),
          "node3_heights_seen": [n3_heights[0], n3_heights[-1]]
          if n3_heights else [], "txs_sent": sum(f.sent for f in feeders),
          "sync_acked": len(load.sync.acked),
          "subscriber_events": sum(len(h) for h in load.subs.heights),
          "card": card})
    emit({"phase": f"{tag}_planes", "by_node": {
        i: {"process": j, "height": ln["height"],
            "launches": ln["launches"], "recovery": ln["recovery"]}
        for i in lines for j, ln in enumerate(lines[i])},
        "note": "node 3's entry is its restarted process (its killed "
        "process counted to the last height it committed, before the "
        "wipe)", "launches": launches, "card": card})
    require(not bad, f"{tag}: the nodes disagree: {bad[:3]}")
    lo_ev, hi_ev = LOOP_EVENTS
    want = list(range(lo_ev, hi_ev + 1))
    drops = [sorted(set(want) - set(hs)) for hs in load.subs.heights]
    require(load.sync.acked and not any(drops) and not load.subs.closed
            and all(hs == sorted(hs) for hs in load.subs.heights),
            f"{tag}: {len(load.sync.acked)} sync acks; subscribers missed "
            f"{sum(map(len, drops))} heights, {load.subs.closed} closed")
    for i in lines:
        for line in lines[i]:
            th = line["threads"]
            require(line["reactor"] == "loop" and th["tm-reactor-loop"] == 1
                    and th["mconn-"] == th["gossip-"]
                    == th["mempool-bcast-"] == 0,
                    f"{tag}: node {i}'s threads {th}")
    require(restored > 0 and restored % PROC_SS_RECOVERY[
        "snapshot_interval"] == 0 and n3["error"] is None
            and rec[3]["block_base"] == restored + 1,
            f"{tag}: node 3 restored {restored}: {rec[3]}")
    require(not unseen and n3_heights and n3_heights[-1] >= stop_at,
            f"{tag}: node 3's heights without another node's: {unseen} "
            f"(failed reads {dict(watch.failed_reads)}, "
            f"{[(h, watch.seen[h]) for h in unseen[:3]]})")
    require(rejoin["signed_at"] > rejoin["synced_to"],
            f"{tag}: node 3 did not sign after its rejoin: {rejoin}")
    for i in range(3):
        r = rec[i]
        require(r["block_base"] > 1 and r["state_floor"] > 1
                and r["block_base"] <= r["latest_pin"]
                and len(r["snapshot_heights"]) <= PROC_SS_RECOVERY[
                    "snapshot_keep"]
                and r["snapshots"]["published"] >= 1,
                f"{tag}: node {i}'s pruning or snapshots: {r}")
    require(not on_card or (lines[3][-1]["device"].startswith("cuda")
                            and lines[3][-1]["launches"]["verify"] > 0),
            f"{tag}: node 3's restarted process did not launch B1: "
            f"{lines[3][-1]['launches']}")
    return {"launches": launches, "lines": lines, "rejoin": rejoin}


def _crash_stop(node) -> None:
    node.consensus._stopped = True
    try:
        node.stop()
    except Exception:
        pass


def _held_blocks(node) -> dict:
    bs = node.block_store
    return {h: bs.load_block(h).to_bytes()
            for h in range(bs.base(), bs.height() + 1)}


def phase_recovery_sweep(card: str, device: str = "cuda") -> dict:
    """Phase 14, arm 4: the reference's recovery crash sweeps on a
    single-validator node verifying on `device`, on a pinned clock.
    tests/test_snapshot.py's: a node with snapshots every 2 heights, 2
    kept, 2 heights retained, crashed at snapshot.after_chunk,
    snapshot.before_publish and prune.mid_range on its way to
    SWEEP_SS_TARGET, rebuilt from its files, must reach the app hash and
    the blocks of an uncrashed control run with the plane off, with no
    half snapshot visible. tests/test_statesync.py's: a restore of the
    source node's snapshot at SWEEP_SS_TARGET, its chunks on disk, crashed
    at statesync.before_apply and statesync.after_restore inside a Node's
    start, must be completed by the next start (resume_pending_restore)
    and the node then commit the source's next heights to its blocks and
    app hash. Launch counts zeroed at the start, read at the end."""
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    on_card = device.startswith("cuda")
    root = tempfile.mkdtemp(prefix="recovery-sweep-")
    key = PrivKey.generate(b"\x0b" * 32)
    gen = GenesisDoc(chain_id="recovery-sweep", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    gen.consensus_params.evidence.max_age = SWEEP_SS_MAX_AGE
    wave_a, wave_b, wave_c = SWEEP_SS_WAVES
    rows = []
    _zero_launches()
    tclock.set_source(lambda: T0)
    t_start = time.perf_counter()
    try:
        control = _sweep_node(os.path.join(root, "control"), gen, key,
                                 device)
        control.start()
        _sweep_inject(control, wave_a)
        _sweep_commit_to(control, 3)
        _sweep_inject(control, wave_b)
        _sweep_commit_to(control, SWEEP_SS_TARGET)
        _sweep_drain(control)
        want_hash, want_blocks = control.consensus.state.app_hash, \
            _held_blocks(control)
        control.stop()
        for point in ("snapshot.after_chunk", "snapshot.before_publish",
                      "prune.mid_range"):
            home = os.path.join(root, point)
            node = _sweep_node(home, gen, key, device, SWEEP_SS_RECOVERY)
            node.start()
            _sweep_inject(node, wave_a)
            _sweep_commit_to(node, 3)
            hit = []

            def crash(name):
                hit.append(name)
                raise _Crash(name)

            tfail.arm(point, crash)
            try:
                _sweep_inject(node, wave_b)
                _sweep_commit_to(node, SWEEP_SS_TARGET)
            except _Crash:
                pass
            finally:
                tfail.disarm_all()
            require(hit == [point], f"recovery sweep: {point} did not fire")
            crashed_at = node.height
            _crash_stop(node)
            t0 = time.perf_counter()
            node2 = _sweep_node(home, gen, key, device, SWEEP_SS_RECOVERY)
            node2.start()
            recover_s = time.perf_counter() - t0
            recovered_at = node2.height
            _sweep_inject(node2, wave_b)
            _sweep_commit_to(node2, SWEEP_SS_TARGET)
            _sweep_drain(node2)
            held = _held_blocks(node2)
            snaps = node2.snapshot_store
            for h in snaps.list_heights():
                snaps.assemble_payload(h)
            tmp_left = [n for n in os.listdir(snaps.root_dir)
                        if n.startswith(".tmp-")]
            rows.append({"point": point, "crashed_at_height": crashed_at,
                         "recovered_at_height": recovered_at,
                         "final_height": node2.height,
                         "handshake_blocks": node2.handshake_blocks,
                         "recover_s": recover_s,
                         "recovery": node2.recovery_counts(),
                         "app_hash_equal":
                             node2.consensus.state.app_hash == want_hash,
                         "blocks_equal": all(want_blocks.get(h) == b
                                             for h, b in held.items()),
                         "blocks_held": [min(held), max(held)],
                         "tmp_dirs_left": tmp_left})
            node2.stop()
            require(recovered_at >= crashed_at,
                    f"recovery sweep: {point} lost a committed height")
            require(rows[-1]["app_hash_equal"] and rows[-1]["blocks_equal"]
                    and not tmp_left,
                    f"recovery sweep: {point}: {rows[-1]}")
        # the restore crashes, from the source's snapshot at the target
        src = _sweep_node(os.path.join(root, "source"), gen, key,
                             device, SWEEP_SS_RECOVERY)
        src.start()
        _sweep_inject(src, wave_a)
        _sweep_commit_to(src, 3)
        _sweep_inject(src, wave_b)
        _sweep_commit_to(src, SWEEP_SS_TARGET)
        snap_h = SWEEP_SS_TARGET
        require(snap_h in src.snapshot_store.list_heights()
                and src.height == snap_h and src.mempool.size() == 0
                and src.consensus.state.app_hash == want_hash,
                "recovery sweep: the source's snapshot at the target")
        _sweep_inject(src, wave_c)
        _sweep_commit_to(src, snap_h + 1)
        src_top, src_hash = src.height, src.consensus.state.app_hash
        src_blocks = _held_blocks(src)
        snap_dir = src.snapshot_store.dir_for(snap_h)
        src.stop()
        for point in ("statesync.before_apply", "statesync.after_restore"):
            home = os.path.join(root, point)
            target = os.path.join(home, "data", "statesync", str(snap_h))
            shutil.copytree(snap_dir, target)
            hit = []

            def crash(name):
                hit.append(name)
                raise _Crash(name)

            tfail.arm(point, crash)
            try:
                _sweep_node(home, gen, key, device, SWEEP_SS_RECOVERY)
            except _Crash:
                pass
            finally:
                tfail.disarm_all()
            require(hit == [point], f"recovery sweep: {point} did not fire")
            t0 = time.perf_counter()
            node = _sweep_node(home, gen, key, device, SWEEP_SS_RECOVERY)
            recover_s = time.perf_counter() - t0
            counts = node.recovery_counts()
            restored = (node.height, node.consensus.state.app_hash,
                        node.block_store.base())
            node.start()
            _sweep_inject(node, wave_c)
            _sweep_commit_to(node, src_top)
            got = _held_blocks(node)
            both = sorted(set(got) & set(src_blocks))
            rows.append({"point": point, "resumed_restore":
                         counts["resumed_restore"], "height": restored[0],
                         "base": restored[2], "recover_s": recover_s,
                         "recovery": counts,
                         "app_hash_equal": restored[1] == want_hash,
                         "next_blocks_compared": both,
                         "next_blocks_equal": bool(both) and all(
                             got[h] == src_blocks[h] for h in both),
                         "next_app_hash_equal": node.height == src_top and
                         node.consensus.state.app_hash == src_hash,
                         "statesync_left": os.listdir(os.path.dirname(
                             target))})
            node.stop()
            require(counts["resumed_restore"] == snap_h
                    and restored[0] == snap_h
                    and restored[2] == snap_h + 1
                    and rows[-1]["app_hash_equal"]
                    and rows[-1]["next_blocks_equal"]
                    and rows[-1]["next_app_hash_equal"]
                    and counts["snapshot_heights"][-1:] == [snap_h]
                    and rows[-1]["statesync_left"] == [],
                    f"recovery sweep: {point}: {rows[-1]}")
    finally:
        tclock.set_source(None)
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(ladder.launches)
    emit({"phase": "recovery_sweep", "points": rows,
          "target_height": SWEEP_SS_TARGET, "launches": launches,
          "wall_s": time.perf_counter() - t_start, "card": card})
    require(not on_card or launches["verify"] >= 1,
            f"recovery sweep: B1 did not launch: {launches}")
    return launches



# ------------------------------- phase 15: the observability plane

TEL_STALL_AT = 14         # node 0's height when nodes 2 and 3 are stopped
TEL_STALL_S = 3           # TM_CUDA_TRACE_STALL_S of the planes-on run
TEL_STOP_S = 6.0          # the SIGSTOP: twice the stall window, far below
#                           the links' 35 s idle timeout (the ban hazard)
TEL_RESUME = 3            # heights node 0 commits after the SIGCONT
TEL_B1_REPS = 50          # launches of the consensus shape timed alone
TEL_SLO_WAIT_S = 30.0     # the trackers' wait for their last deliveries
TEL_WALL_S = 300.0        # a run's wall limit from the nodes' start
TEL_BACKLOG = 1000        # the feeders' back-off: with each feeder's bursts
#                           and the other's gossip in flight a mempool stays
#                           below its 4,000, so CheckTx refuses no fed tx
#                           and every tx the SLO plane samples is committed
TEL_PLANES = {"telemetry": True, "trace": "on", "slo": "on", "prof": "on",
              "queue_watch": "on"}
TEL_OFF = {"telemetry": False, "trace": "off", "slo": "off", "prof": "off",
           "queue_watch": "off"}


def _prom(text: str) -> dict:
    """Prometheus text 0.0.4 -> {(name, ((label, value), ...)): value};
    a line that is neither a comment nor a sample fails the run."""
    out, kinds = {}, {}
    for ln in text.splitlines():
        if not ln or ln.startswith("# HELP "):
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            kinds[name] = kind
            continue
        m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$', ln)
        require(m is not None, f"telemetry: not Prometheus text: {ln[:80]!r}")
        labels = tuple(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|'
                                  r'\\.)*)"', m.group(2) or ""))
        out[(m.group(1), labels)] = float(m.group(3))
    require(kinds, "telemetry: /metrics has no TYPE line")
    return out


def _http_get(net, i: int, path: str, timeout: float = 30.0) -> bytes:
    import urllib.request
    url = f"http://127.0.0.1:{net.rpc_port(i)}{path}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        require(r.status == 200, f"telemetry: GET {path} on node {i}: "
                f"{r.status}")
        return r.read()


def _healthz(net, i: int) -> dict:
    return json.loads(_http_get(net, i, "/healthz", 10.0))


def _b1_consensus_shape(device) -> dict:
    """B1's device ms a launch at the consensus path's shape (4
    signatures padded to 8 lanes), timed alone by the launch timer
    (csrc/launch_timer.cpp) around TEL_B1_REPS launches."""
    keys = [PrivKey.generate(s) for s in _seeds(4, SEED + 15)]
    items = [(k.pubkey.ed25519, b"vote %d" % i, k.sign(b"vote %d" % i))
             for i, k in enumerate(keys)]
    pk, rb, sb, hb, _ = ted.prep_items(items)
    log: list = []
    saved = _patched(_in_run_timer_patches(log))
    try:
        ted.verify_prepared_async(pk, rb, sb, hb, device=device)
        torch.cuda.synchronize()
        log.clear()
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
        t0 = time.perf_counter()
        for _ in range(TEL_B1_REPS):
            ted.verify_prepared_async(pk, rb, sb, hb, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        _restore(saved)
    row = _in_run_device_time(log, ref, wall)["by_kernel"]["verify"]
    require(list(row["by_lanes"]) == ["8"],
            f"telemetry: the consensus shape is not 8 lanes: {row}")
    return {"lanes": 8, "launches": row["launches"],
            "ms_per_launch": row["by_lanes"]["8"]["ms_per_launch"]}


def _tel_stall(net, left) -> dict:
    """SIGSTOP nodes 2 and 3 for TEL_STOP_S (nodes 0 and 1 lose their
    quorum), read /healthz on nodes 0 and 1 during the stop, SIGCONT,
    then wait for the chain and the two verdicts to recover."""
    import signal as _signal
    h_stop = net.height(0)
    pids = [net.procs[i].pid for i in (2, 3)]
    for pid in pids:
        os.kill(pid, _signal.SIGSTOP)
    t0 = time.perf_counter()
    seen = {}
    try:
        while time.perf_counter() - t0 < TEL_STOP_S:
            for i in (0, 1):
                if i not in seen:
                    h = _healthz(net, i)
                    if h["stall"]["stalled"] and not h["ok"]:
                        seen[i] = round(time.perf_counter() - t0, 3)
            time.sleep(0.2)
    finally:
        for pid in pids:
            os.kill(pid, _signal.SIGCONT)
    stopped_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    net.wait_for(lambda: net.height(0) >= h_stop + TEL_RESUME,
                 left("the resumption"), "the chain's resumption")
    resumed_s = time.perf_counter() - t1
    net.wait_for(lambda: all(_healthz(net, i)["ok"] and not
                             _healthz(net, i)["stall"]["stalled"]
                             for i in (0, 1)),
                 left("the verdicts' recovery"), "/healthz ok again",
                 poll_s=0.25)
    require(set(seen) == {0, 1},
            f"telemetry: /healthz did not say stalled during the stop: "
            f"{seen}")
    return {"height_at_stop": h_stop, "stopped_s": round(stopped_s, 3),
            "stalled_seen_after_s": seen,
            "resumed_after_s": round(resumed_s, 3)}


def _flight_records(net, i: int) -> list:
    import glob
    out = []
    for path in sorted(glob.glob(os.path.join(net.home(i), "data",
                                              "tm_stall_h*.json"))):
        with open(path) as f:
            doc = json.load(f)
        out.append({"height": doc["height"],
                    "stalled_s": doc["stalled_s"],
                    "sections": sorted(k for k in doc if k in (
                        "timeline", "profile", "queues", "consensus")),
                    "timeline_spans": len(doc["timeline"]["spans"])})
    return out


def _tel_readings(net, left, heights, fed_committed: dict) -> dict:
    """Every plane's reading off the running net (planes on).
    `fed_committed[i]` counts the committed txs fed to node i's front
    door, every tx its SLO tracker sampled."""
    from tendermint_tpu_torch.telemetry import merge as tmerge
    lo, hi = heights
    out = {"metrics": {}, "slo": {}, "healthz": {}, "profile": {}}
    for i in range(net.n):
        h0 = net.height(i)
        fam = _prom(_http_get(net, i, "/metrics").decode())
        h1 = net.height(i)
        ns = "tmcuda_"
        cons_h = fam[(ns + "consensus_height", ())]
        require(h0 <= cons_h <= h1 + 1,
                f"telemetry: node {i}'s consensus height gauge {cons_h} "
                f"outside {h0}..{h1 + 1}")
        cuda = (("backend", "cuda"),)
        out["metrics"][i] = {
            "families": len({k[0] for k in fam}),
            "consensus_height": cons_h,
            "verifier_calls_cuda": fam.get(
                (ns + "verifier_calls_total", cuda), 0.0),
            "verifier_sigs_cuda": fam.get(
                (ns + "verifier_sigs_total", cuda), 0.0),
            "dispatch_count_cuda": fam.get(
                (ns + "verifier_dispatch_seconds_count", cuda), 0.0),
            "dispatch_sum_s_cuda": fam.get(
                (ns + "verifier_dispatch_seconds_sum", cuda), 0.0),
            "trace_events_dropped": fam.get(
                (ns + "trace_events_dropped_total", ()), 0.0),
            "event_dropped": fam.get((ns + "event_dropped_total", ()), 0.0)}
    dumps = [net.rpc(i, 60.0).call("dump_height_timeline")
             for i in range(net.n)]
    # phase 20b's inputs: the dumps of the three report tools
    out["tool_inputs"] = {"timeline": dumps}
    offsets = tmerge.estimate_offsets(dumps)
    window = [dict(d, spans=[e for e in d["spans"]
                             if e["n"] in ("p2p.recv", "mempool.recv")
                             or lo <= e["h"] <= hi]) for d in dumps]
    att = tmerge.attribution(window, offsets)
    digests = defaultdict(dict)
    for d in dumps:
        for e in d["spans"]:
            if e["n"] == "transition.digest":
                digests[e["h"]][d["node"]] = e["a"]["digest"]
    missing = [h for h in range(lo, hi + 1) if len(digests[h]) < net.n]
    split = [h for h in range(lo, hi + 1) if len(set(digests[h].values()))
             > 1]
    require(not split, f"telemetry: transition digests disagree at "
            f"heights {split[:5]}")
    require(not missing, f"telemetry: transition digests missing at "
            f"heights {missing[:5]} ({[len(digests[h]) for h in missing[:5]]})")
    per_node = {}
    for d in dumps:
        commits = {e["h"]: e["t"] for e in d["spans"] if e["n"] == "commit"}
        t_lo, t_hi = commits.get(lo), commits.get(hi)
        vd = [e for e in d["spans"] if e["n"] == "verify.dispatch"
              and t_lo is not None and t_hi is not None
              and t_lo <= e["t"] <= t_hi]
        per_node[d["node"]] = {
            "events": d["events"], "capacity": d["capacity"],
            "verify_dispatch_per_height": len(vd) / max(1, hi - lo),
            "verify_dispatch_ms_mean": (sum(e["d"] for e in vd) / 1e6
                                        / max(1, len(vd))),
            "verify_dispatch_ms_per_height": (sum(e["d"] for e in vd)
                                              / 1e6 / max(1, hi - lo)),
            "height_wall_ms": ((t_hi - t_lo) / 1e6 / max(1, hi - lo)
                               if t_lo and t_hi else None)}
    out["timeline"] = {
        "offsets_ms": {n: round(o / 1e6, 3) for n, o in offsets.items()},
        "rtt_floor_s": tmerge.pair_rtt_floor_s(dumps),
        "heights": att["heights"], "heights_skipped":
            att["heights_skipped"], "coverage_mean": att["coverage_mean"],
        "stages_ms_p50_p95": att["stages_ms_p50_p95"],
        "digest_heights": hi - lo + 1, "per_node": per_node}
    for i in (0, 1):
        # every tx node i's feeder sent is sampled there, committed and
        # delivered to node i's Tx subscriber: once the last delivery is
        # read nothing is left in flight
        deadline = time.monotonic() + min(TEL_SLO_WAIT_S,
                                          left("the SLO deliveries"))
        while True:
            s = net.rpc(i, 30.0).call("slo")
            if s["in_flight"] == 0 or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        dropped = sum(s["dropped"].values())
        require(s["monotonic_violations"] == 0,
                f"telemetry: node {i}'s SLO stamps out of order: "
                f"{s['monotonic_violations']}")
        acct = {k: s[k] for k in ("sampled_total", "completed_total",
                                  "in_flight", "dropped")}
        require(s["sampled_total"] > 0 and s["in_flight"] == 0 and
                s["sampled_total"] == s["completed_total"] + dropped and
                s["completed_total"] == fed_committed[i],
                f"telemetry: node {i}'s sampled txs unaccounted: {acct}, "
                f"{fed_committed[i]} of its fed txs committed")
        st = s["stages"]
        out["slo"][i] = {
            "sampled": s["sampled_total"], "completed": s["completed_total"],
            "dropped": s["dropped"], "in_flight": s["in_flight"],
            "fed_committed": fed_committed[i], "monotonic_violations": 0,
            **{f"{name}_{q}": st[name][q] for name in ("e2e_commit",
                                                        "e2e_delivery")
               for q in ("p50_ms", "p99_ms")},
            "legs_p50_ms": {name: st[name]["p50_ms"] for name in st}}
    for i in range(net.n):
        h = _healthz(net, i)
        require(h["ok"] and h["queues"]["table"],
                f"telemetry: node {i}'s /healthz at the end: {h}")
        out["healthz"][i] = {"ok": h["ok"], "queues": {
            k: {f: v[f] for f in ("high_water", "capacity", "events")}
            for k, v in h["queues"]["table"].items()},
            "stall_episodes": h["stall"]["episodes"]}
        p = net.rpc(i, 30.0).call("debug_profile", action="dump")
        require(p["collapsed"].strip() and p["samples"] > 0,
                f"telemetry: node {i}'s profiler has no stacks")
        out["tool_inputs"].setdefault("profile", []).append(p)
        out["tool_inputs"].setdefault("slo", []).append(
            net.rpc(i, 30.0).call("slo", sketches=True))
        out["profile"][i] = {"samples": p["samples"],
                             "wait_samples": p["wait_samples"],
                             "stacks": p["stacks"], "shares": p["shares"]}
    return out


def _telemetry_net(tag: str, planes: dict, env: dict, device: str,
                   stall: bool) -> dict:
    """Phase 13's net (config 1, four `cli node --p2p` processes on the
    JAX node's defaults, two WebSocket feeders) with `planes` in every
    node's base config and `env` in its environment, and one WebSocket
    subscriber of `tm.event = 'Tx'` on each fed node (the SLO plane's
    deliver stage). With `stall` the run stops nodes 2 and 3 at
    TEL_STALL_AT and reads every plane before the nodes stop."""
    from tendermint_tpu_torch.procnet import ProcNet, bench_settings, \
        free_block
    on_card = device.startswith("cuda")
    _node_libs()
    settings = bench_settings("cuda" if on_card else "auto", reactor="auto",
                              verifier_coalesce="auto", pipeline="auto")
    settings["base"].update(planes)
    root = tempfile.mkdtemp(prefix=f"{tag}-")
    net = ProcNet(root, base_port=free_block(8), env_of=lambda i: env)
    net.write_tree(f"chip-smoke-{tag}")
    net.configure(settings)
    sampler = _GpuSampler()
    feeders = [_WSFeeder(net, tid, TEL_BACKLOG) for tid in (0, 1)]
    subs = [_Subscribers(tid, n=1, query="tm.event = 'Tx'")
            for tid in (0, 1)]
    t_start = time.perf_counter()

    def left(what: str) -> float:
        rem = TEL_WALL_S - (time.perf_counter() - t_start)
        require(rem > 0, f"{tag}: out of wall time at {what}")
        return rem
    ok, stall_out, readings = False, None, None
    try:
        net.start_all(extra=["--no-fast-sync", "--device", device])
        sampler.start()
        for s in subs:
            s.start(net, left)
        net.wait_for(lambda: min(net.heights()) >= 2,
                     min(PROC_BOOT_S, left("boot")), "boot")
        boot_s = time.perf_counter() - t_start
        for f in feeders:
            f.start()
        t_feed = time.perf_counter()
        if stall:
            net.wait_for(lambda: net.height(0) >= TEL_STALL_AT,
                         left("the stall height"), "the stall height")
            stall_out = _tel_stall(net, left)
        net.wait_for(lambda: net.height(0) >= PROC_HEIGHTS,
                     left("the last fed height"), "node 0 at the last height")
        t_fed = time.perf_counter()
        for f in feeders:
            f.stop()
        net.wait_for(lambda: all(
            net.rpc(i).call("num_unconfirmed_txs")["n_txs"] == 0
            for i in range(net.n)), left("the mempools' drain"),
            "the mempools' drain", poll_s=0.25)
        net.wait_for(lambda: min(net.heights()) >= PROC_HEIGHTS,
                     left("every node at the last height"),
                     "every node at the last height")
        top = min(net.heights())
        counts, txs = _agreed_txs(net, tag, top)
        rate = _proc_rate(net, top)
        rate["before_stall"] = _rate_over(net, top, PROC_MEASURE[0],
                                          TEL_STALL_AT - 1)
        if stall:
            fed = {tid: sum(1 for tx in txs if tx.startswith(b"pn%d/" % tid))
                   for tid in (0, 1)}
            readings = _tel_readings(net, left, PROC_MEASURE, fed)
        early = net.early_exits()
        require(not early, f"{tag}: node processes exited early {early}")
        busy, n_samples = sampler.share(t_feed, t_fed)
        wall_s = time.perf_counter() - t_start
        ok = True
    finally:
        for f in feeders:
            f.stop()
        for s in subs:
            s.stop()
        codes = net.stop_all()
        sampler.stop()
        if not ok:
            for i in range(net.n):
                tail = net.log(i).splitlines()[-40:] \
                    if os.path.exists(net.log_path(i)) else []
                print(f"{tag} node {i} log tail:", *tail, sep="\n",
                      file=sys.stderr)
    lines = {i: net.kernel_lines(i) for i in range(net.n)}
    require(all(codes[i] == 0 for i in range(net.n)),
            f"{tag}: node exit codes {codes}")
    require([len(lines[i]) for i in range(net.n)] == [1] * net.n,
            f"{tag}: kernel lines a process {lines}")
    records = {i: _flight_records(net, i) for i in range(net.n)}
    launches = {k: sum(lines[i][0]["launches"][k] for i in lines)
                for k in ladder.launches}
    shutil.rmtree(root, ignore_errors=True)
    return {"lines": {i: lines[i][0] for i in lines}, "rate": rate,
            "launches": launches, "busy": busy, "n_samples": n_samples,
            "boot_s": boot_s, "wall_s": wall_s, "top": top,
            "txs": len(txs), "stall": stall_out, "readings": readings,
            "records": records, "tx_events": [len(s.heights[0])
                                              for s in subs],
            "sent": sum(f.sent for f in feeders),
            "errors": sum(f.errors for f in feeders)}


def _rate_over(net, top: int, lo: int, hi: int) -> dict:
    """Blocks/s and txs/s over heights lo..hi from node 0's metas."""
    metas = net.metas(0, top)
    span = (metas[hi - 1]["header"]["time_ns"]
            - metas[lo - 1]["header"]["time_ns"]) / 1e9
    txs = sum(m["header"]["num_txs"] for m in metas[lo:hi])
    return {"heights": [lo, hi], "blocks_per_s": (hi - lo) / span,
            "txs_per_s": txs / span}


def _tel_kernel_line_check(tag: str, lines: dict, on: bool,
                           on_card: bool) -> dict:
    """Each process's stop line: its verifier's families (read beside
    its plain counts) equal those counts, one dispatch observation a
    call; with the planes off every family stays at zero."""
    out = {}
    for i, line in lines.items():
        t, v = line["telemetry"], line["verifier"]
        calls = t["calls"]["cuda"] + t["calls"]["python"] \
            + v["empty_calls"]
        sigs = t["sigs"]["cuda"] + t["sigs"]["python"]
        n_disp = t["dispatch"]["cuda"]["count"] + \
            t["dispatch"]["python"]["count"]
        if on:
            require(t["enabled"] and t["namespace"] == "tmcuda",
                    f"{tag}: node {i}'s registry is off: {t}")
            require(calls == v["calls"] and sigs == v["sigs"]
                    and n_disp == calls - v["empty_calls"],
                    f"{tag}: node {i}'s verifier families {t} disagree "
                    f"with its counts {v}")
            require(not on_card or (t["calls"]["cuda"] + v["empty_calls"]
                                    == v["calls"] > 0
                                    and line["launches"]["verify"] > 0),
                    f"{tag}: node {i} verified off the card: {line}")
        else:
            require(not t["enabled"] and calls - v["empty_calls"] == sigs
                    == n_disp == 0,
                    f"{tag}: node {i}'s families moved with telemetry "
                    f"off: {t}")
        out[i] = {"calls": v["calls"], "empty_calls": v["empty_calls"],
                  "sigs": v["sigs"],
                  "family_calls_cuda": t["calls"]["cuda"],
                  "family_sigs_cuda": t["sigs"]["cuda"],
                  "dispatch_s_cuda": t["dispatch"]["cuda"]["sum"],
                  "plain_dispatch_s": v["dispatch_s"],
                  "plain_wait_s": v["wait_s"],
                  "launches": line["launches"]}
    return out


def _divergence_on_card(device) -> dict:
    """The dual-PYTHONHASHSEED replay with its children on the card, the
    same trajectory in this process on the card (B1 counted) and on the
    CPU: three equal streams."""
    from tendermint_tpu_torch.analysis import divergence
    t0 = time.perf_counter()
    dual = divergence.run_dual_seed_replay(seed=7, device=str(device))
    t1 = time.perf_counter()
    _zero_launches()
    here = divergence.replay_digests(7, device=device)
    launched = dict(ladder.launches)
    cpu = divergence.replay_digests(7, device="cpu")
    require(dual["identical"], f"divergence: the streams differ under "
            f"PYTHONHASHSEED {dual['hash_seeds']}: {dual['streams']}")
    require(dual["streams"][0].splitlines() == here == cpu,
            f"divergence: the card's stream {here} is not the CPU's {cpu}")
    require(launched["verify"] > 0, f"divergence: no B1 launch {launched}")
    return {"seed": 7, "heights": dual["heights"], "identical": True,
            "equal_to_cpu": True, "dual_s": round(t1 - t0, 3),
            "in_process_launches": launched, "last": here[-1]}


def phase_procnet_telemetry(card: str, device: str = "cuda",
                            pipeline_run: dict = None) -> dict:
    """BASELINE config 1 as four OS processes on the JAX node's defaults
    with every observability plane on (trace, SLO, profiler, queue
    watch, TM_CUDA_DIVERGENCE, a 3 s stall window): the metrics, merged
    timelines, digests, SLO tables, health verdicts and profiles off the
    running net, a stall of nodes 2 and 3, the divergence replay on the
    card, and a second run with telemetry and every plane off for the
    overhead. `pipeline_run` is phase 13's run, printed beside. A CPU
    rehearsal passes device="cpu" (no launch required)."""
    on_card = device.startswith("cuda")
    b1 = _b1_consensus_shape(torch.device(device)) if on_card else None
    env = {"TM_CUDA_DIVERGENCE": "on",
           "TM_CUDA_TRACE_STALL_S": str(TEL_STALL_S)}
    run = _telemetry_net("procnet_telemetry", TEL_PLANES, env, device,
                         stall=True)
    kl = _tel_kernel_line_check("procnet_telemetry", run["lines"], True,
                                on_card)
    rd = run["readings"]
    for i in range(4):
        m = rd["metrics"][i]
        require(0 < m["verifier_calls_cuda"] <= kl[i]["family_calls_cuda"]
                or not on_card,
                f"procnet_telemetry: node {i}'s /metrics calls "
                f"{m['verifier_calls_cuda']} against its stop line "
                f"{kl[i]['family_calls_cuda']}")
        # a dispatch counts at its launch, its seconds at its verdicts:
        # a scrape may fall between the two for the calls in flight
        require(0 <= m["verifier_calls_cuda"] - m["dispatch_count_cuda"]
                <= 4, f"procnet_telemetry: node {i}'s dispatch count "
                f"{m['dispatch_count_cuda']} against its calls "
                f"{m['verifier_calls_cuda']}")
    recs = run["records"]
    h_stop = run["stall"]["height_at_stop"]
    episode = {i: [r for r in recs[i] if r["height"] >= h_stop - 1]
               for i in recs}
    for i in (0, 1):
        require(len(episode[i]) == 1 and len(episode[i][0]["sections"])
                == 4, f"procnet_telemetry: node {i}'s flight records "
                f"of the stall: {recs[i]}")
    emit({"phase": "procnet_telemetry", "validators": 4, "processes": 4,
          "planes": TEL_PLANES, "env": env, "heights": run["top"],
          "measured_heights": list(PROC_MEASURE),
          "blocks_per_s": run["rate"]["blocks_per_s"],
          "txs_per_s": run["rate"]["txs_per_s"], "txs_committed": run["txs"],
          "txs_sent": run["sent"], "feeder_errors": run["errors"],
          "tx_events_read": run["tx_events"], "boot_s": run["boot_s"],
          "wall_s": run["wall_s"], "card": card})
    emit({"phase": "procnet_telemetry_metrics", "by_node": rd["metrics"],
          "stop_lines": kl, "card": card})
    tl = rd["timeline"]
    dispatch_ms = {n: r["verify_dispatch_ms_per_height"]
                   for n, r in tl["per_node"].items()}
    emit({"phase": "procnet_telemetry_timeline", **tl,
          "b1_alone": b1, "kernel_ms_per_height": (
              {n: r["verify_dispatch_per_height"] * b1["ms_per_launch"]
               for n, r in tl["per_node"].items()} if b1 else None),
          "dispatch_ms_per_height": dispatch_ms,
          "note": "dispatch spans run from a verify's dispatch to its "
          "verdicts on the host; kernel ms = dispatches a height x B1's "
          "launch-timer ms at 8 lanes, timed alone in this call",
          "card": card})
    emit({"phase": "procnet_telemetry_slo", "by_node": rd["slo"],
          "card": card})
    emit({"phase": "procnet_telemetry_health", "healthz": rd["healthz"],
          "profile": rd["profile"], "note": "profiler shares count "
          "samples of Python frames; a thread blocked in a CUDA wait "
          "sits in C and is charged to its caller's subsystem as busy",
          "card": card})
    emit({"phase": "procnet_telemetry_stall", **run["stall"],
          "flight_records": recs, "card": card})
    div = _divergence_on_card(torch.device(device)) if on_card else \
        _divergence_cpu()
    emit({"phase": "procnet_telemetry_divergence", **div, "card": card})
    off = _telemetry_net("procnet_telemetry_off", TEL_OFF, {}, device,
                         stall=False)
    _tel_kernel_line_check("procnet_telemetry_off", off["lines"], False,
                           on_card)
    emit({"phase": "procnet_telemetry_overhead",
          "planes_on": {"blocks_per_s": run["rate"]["blocks_per_s"],
                        "txs_per_s": run["rate"]["txs_per_s"],
                        "before_stall": run["rate"]["before_stall"]},
          "planes_off": {"blocks_per_s": off["rate"]["blocks_per_s"],
                         "txs_per_s": off["rate"]["txs_per_s"],
                         "before_stall": off["rate"]["before_stall"]},
          "phase13": (None if pipeline_run is None else
                      {"blocks_per_s": pipeline_run["rate"]["blocks_per_s"],
                       "txs_per_s": pipeline_run["rate"]["txs_per_s"]}),
          "note": "a record, not a check: over heights "
          f"{PROC_MEASURE[0]}-{PROC_MEASURE[1]} the planes-on run includes "
          f"the {TEL_STOP_S} s stall; before_stall is heights "
          f"{PROC_MEASURE[0]}-{TEL_STALL_AT - 1} of both runs",
          "card": card})
    if on_card:
        for tag, r in (("procnet_telemetry", run),
                       ("procnet_telemetry_off", off)):
            _require_b1_everywhere(tag, {i: [ln] for i, ln in
                                         r["lines"].items()}, on_card)
    return {"launches": run["launches"], "off_launches": off["launches"],
            "rate": run["rate"], "off_rate": off["rate"],
            "tool_inputs": rd["tool_inputs"]}


#: phase_telemetry_planes' arms: each plane alone on the node's defaults
#: (registry and queue watch on), then every plane off and all on
TEL_ARMS = (
    ("defaults", {}, {}),
    ("trace", {"trace": "on"}, {}),
    ("slo", {"slo": "on"}, {}),
    ("prof", {"prof": "on"}, {}),
    ("divergence", {}, {"TM_CUDA_DIVERGENCE": "on"}),
    ("all_on", TEL_PLANES, {"TM_CUDA_DIVERGENCE": "on",
                            "TM_CUDA_TRACE_STALL_S": str(TEL_STALL_S)}),
    ("all_off", TEL_OFF, {}),
)


def phase_telemetry_planes(card: str, device: str = "cuda") -> dict:
    """Not part of main(): phase 15's net without the stall, once for
    each arm of TEL_ARMS in one call, for the cost of each plane alone
    (blocks/s and txs/s over heights 5-40, B1 launched)."""
    on_card = device.startswith("cuda")
    out = {}
    for name, planes, env in TEL_ARMS:
        base = dict(TEL_OFF, telemetry=True, queue_watch="on")
        base.update(planes)
        run = _telemetry_net(f"planes_{name}", base, env, device,
                             stall=False)
        if on_card:
            _require_b1_everywhere(f"planes_{name}", {
                i: [ln] for i, ln in run["lines"].items()}, on_card)
        out[name] = {"blocks_per_s": run["rate"]["blocks_per_s"],
                     "txs_per_s": run["rate"]["txs_per_s"],
                     "heights_5_19": run["rate"]["before_stall"],
                     "planes": base, "env": env}
        emit({"phase": "telemetry_planes", "arm": name, **out[name],
              "card": card})
    return out


def _divergence_cpu() -> dict:
    """The CPU rehearsal's divergence arm: the dual replay on the CPU."""
    from tendermint_tpu_torch.analysis import divergence
    dual = divergence.run_dual_seed_replay(seed=7, device="cpu")
    require(dual["identical"], f"divergence: {dual['streams']}")
    return {"seed": 7, "heights": dual["heights"], "identical": True}


# ----------------------- phase 16: the state tree fed over gRPC, read lite

ST_BURST = 1200           # one broadcast_tx_batch to node 0 at the start: a
#                           block of max_block_size_txs (1000) new keys, the
#                           phase's largest wave (device route on the card)
ST_GRPC_CLIENTS = 8       # BroadcastAPIClients on node 2 (its 8 workers)
ST_GRPC_TXS = 6           # txs each client sends, one BroadcastTx at a time
ST_LITE_TXS = 8           # fed txs read through the lite proxy's `tx`
ST_PROOF_KEYS = 16        # fed keys proven by node 1 (and one absent key)
LITE_READERS = 4          # heights read through the lite proxy at once
ST_WALL_S = 150.0         # the net's wall limit from the nodes' start
ST_ABCI_HEIGHTS = 4       # the gRPC ABCI node's heights
ST_WAVE_REPS = 5          # timed runs of the largest wave on each route
ST_TREE_ENV = {"TM_CUDA_STATE_TREE": "on"}
ST_SWEEP_WAVES = ([b"st/a%d=v%d" % (i, i) for i in range(1, 4)],
                  [b"st/b%d=w%d" % (i, i) for i in range(1, 4)])
ST_SWEEP_TARGET = 3


@contextlib.contextmanager
def _env(values: dict):
    """os.environ with `values` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _GrpcFeeder:
    """ST_GRPC_CLIENTS threads, each its own BroadcastAPIClient to node
    2's gRPC listener, sending ST_GRPC_TXS unique `k=v` txs one at a
    time; BroadcastTx returns after the commit, so the clients set the
    rate. Every response is checked: CheckTx and DeliverTx codes 0,
    height >= 1, hash = sha256(tx)."""

    def __init__(self, addr: str):
        self.addr = addr
        self.committed: list = []   # (tx, height)
        self.bad: list = []
        self.errors: list = []
        self._lock = threading.Lock()
        self._threads = [threading.Thread(
            target=self._run, args=(c,), daemon=True,
            name=f"smoke-grpc-feeder-{c}") for c in range(ST_GRPC_CLIENTS)]

    def _run(self, c: int) -> None:
        from tendermint_tpu_torch.rpc.grpc_service import BroadcastAPIClient
        client = BroadcastAPIClient(self.addr, timeout=60.0)
        try:
            client.ping()
            for i in range(ST_GRPC_TXS):
                tx = b"st/g%d/k%d=v%06d" % (c, i, i)
                res = client.broadcast_tx(tx)
                ok = (res.check_tx.code == 0 and res.deliver_tx.code == 0
                      and res.height >= 1
                      and res.hash == hashlib.sha256(tx).digest())
                with self._lock:
                    (self.committed if ok else self.bad).append(
                        (tx, int(res.height)))
        except Exception as e:  # reported and required empty below
            with self._lock:
                self.errors.append(repr(e))
        finally:
            client.close()

    def run(self, timeout: float) -> float:
        t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        for t in self._threads:
            t.join(max(1.0, timeout - (time.perf_counter() - t0)))
        require(not any(t.is_alive() for t in self._threads),
                "statetree: a gRPC client did not finish")
        return time.perf_counter() - t0


def _lite_process(net, root: str, node_port: int, port: int, device: str):
    """`cli lite` as its own process on `device`, reading node 0, trusting
    height 1, with a fresh home; its output in lite.log."""
    log = open(os.path.join(root, "lite.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.cli", "--home",
         os.path.join(root, "lite_home"), "lite", "--node-addr",
         f"http://127.0.0.1:{node_port}", "--laddr",
         f"tcp://127.0.0.1:{port}", "--trust-height", "1", "--device",
         device], stdout=log, stderr=subprocess.STDOUT, env=net._env(),
        cwd=root)
    return proc, log


def _lite_line(root: str) -> dict:
    with open(os.path.join(root, "lite.log"), "rb") as f:
        found = re.findall(rb"^lite kernels (\{.*\})$", f.read(), re.M)
    require(len(found) == 1, f"statetree: lite kernels lines {found}")
    return json.loads(found[0])


def _replay_app_hashes(block_txs: list) -> list:
    """The app hash of every version 1..len(block_txs) of a fresh
    StateTree on the CPU that hashes every wave with hashlib (no native
    batch, no device batch): the kvstore's tree backend, block by block."""
    from tendermint_tpu_torch.statetree import StateTree
    tree = StateTree(device="cpu", native_lib=False)
    out = []
    saved = _patched([(merkle, "_SHA_DEVICE_MIN", 1 << 62)])
    try:
        for h, txs in enumerate(block_txs, start=1):
            for tx in txs:
                k, _, v = tx.partition(b"=") if b"=" in tx else (tx, b"", tx)
                tree.set(k, v)
            out.append(tree.commit(h))
    finally:
        _restore(saved)
    return out


def _wave_timing(block_txs: list, device) -> dict:
    """The phase's largest wave (the leaf payloads of its largest block)
    on the device route, the native batch and hashlib: ms (median of
    ST_WAVE_REPS) and equal digests."""
    txs = max(block_txs, key=len)
    sha = hashlib.sha256
    payloads = []
    for tx in txs:
        k, _, v = tx.partition(b"=")
        payloads.append(b"\x00" + sha(k).digest() + sha(v).digest())
    n = len(payloads)

    def timed(fn):
        ms, out = [], None
        for _ in range(ST_WAVE_REPS):
            t0 = time.perf_counter()
            out = fn()
            ms.append(1e3 * (time.perf_counter() - t0))
        return sorted(ms)[len(ms) // 2], out

    dev_ms, dev = timed(lambda: merkle._sha256_many_device(
        payloads, n, len(payloads[0]), device))
    nat_ms, nat = timed(lambda: native.sha256_batch(payloads))
    hl_ms, hl = timed(lambda: [sha(p).digest() for p in payloads])
    require(dev == nat == hl, "statetree: a wave's digests differ by route")
    return {"payloads": n, "payload_bytes": len(payloads[0]),
            "device_ms": dev_ms, "native_ms": nat_ms, "hashlib_ms": hl_ms,
            "digests_equal": True, "device": str(device)}


def _lite_reads(proxy, top: int, fed: list) -> tuple:
    """commit, validators and block of every height 1..top through the
    lite proxy, each certified; `tx` for a sample of fed txs. Returns
    the certified app hash of each height and the reads' seconds. The
    heights are read LITE_READERS at a time (the proxy serves each
    request on its own thread), a height's three reads in order."""
    def read(h: int) -> bytes:
        cm = proxy.call("commit", height=h)
        vals = proxy.call("validators", height=h)
        blk = proxy.call("block", height=h)
        require(cm["certified"] and vals["certified"]
                and blk["block"]["header"]["height"] == h,
                f"statetree: lite read of height {h}")
        return bytes.fromhex(cm["header"]["app_hash"])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(LITE_READERS) as pool:
        certified = dict(zip(range(1, top + 1),
                             pool.map(read, range(1, top + 1))))
    t_heights = time.perf_counter() - t0
    sample = random.Random(SEED + 16).sample(fed, min(ST_LITE_TXS, len(fed)))
    for tx, _ in sample:
        res = proxy.call("tx", hash=hashlib.sha256(tx).digest())
        require(bytes.fromhex(res["tx"]) == tx,
                f"statetree: lite tx read of {tx!r}")
    return certified, {"heights": top, "reads": 3 * top,
                       "readers": LITE_READERS,
                       "heights_s": t_heights, "txs": len(sample),
                       "txs_s": time.perf_counter() - t0 - t_heights}


def _refusals(net, chain_id: str, device) -> dict:
    """A SecureClient over a stub of node 0's RPC that serves height 3's
    header with a flipped byte, and one whose commit carries a forged
    signature: both must raise CertificationError."""
    from tendermint_tpu_torch.lite import (HTTPProvider, InquiringCertifier,
                                           MemProvider, SecureClient)

    class Stub:
        def __init__(self, forge):
            self.rpc, self.forge = net.rpc(0), forge

        def call(self, method, **params):
            res = copy.deepcopy(self.rpc.call(method, **params))
            if method == "commit" and params.get("height") == 3:
                self.forge(res)
            return res

    def flip(obj, field, i=0):
        raw = bytearray(bytes.fromhex(obj[field]))
        raw[i] ^= 1
        obj[field] = raw.hex()

    out = {}
    v = tverifier.BatchVerifier("cuda", device=device)
    try:
        for name, forge in (
                ("flipped_header_byte",
                 lambda r: flip(r["header"], "app_hash")),
                ("forged_signature",
                 lambda r: flip(next(pc for pc in r["commit"]["precommits"]
                                     if pc is not None), "signature", 5))):
            stub = Stub(forge)
            trusted = HTTPProvider(stub).get_by_height(1)
            sc = SecureClient(stub, InquiringCertifier(
                chain_id, trusted, MemProvider(), verifier=v))
            try:
                sc.commit(3)
                out[name] = None
            except CertificationError as e:
                out[name] = str(e)
            require(out[name] is not None,
                    f"statetree: the {name} commit was certified")
    finally:
        v.close()
    return out


def _state_proofs(net, proxy, keys: list) -> dict:
    """abci_query(prove=True) on node 1 for `keys` (values known) and one
    absent key at a version v it retains (its height - 1, re-pinned on
    each try), each proof decoded with statetree.proof_from_bytes and
    verified against the app hash of the lite-certified header v + 1;
    a flipped value must fail."""
    from tendermint_tpu_torch.statetree import (ProofError, proof_from_bytes,
                                                verify)
    c = net.rpc(1)
    rows = {"present": 0, "absent": 0, "versions": set()}
    items = [(k, v) for k, v in keys] + [(b"st/absent/key", None)]
    tampered = None
    for k, want in items:
        for _ in range(20):
            h = int(c.call("status")["latest_block_height"])
            res = c.call("abci_query", data=k.hex(), height=h - 1,
                         prove=True)["response"]
            if res.get("code", 0) == 0 and res.get("proof"):
                break
            time.sleep(0.2)
        require(res.get("code", 0) == 0 and res.get("proof"),
                f"statetree: node 1 gave no proof for {k!r}: {res}")
        version = int(res["height"])
        value = bytes.fromhex(res.get("value") or "")
        require(value == (want or b""),
                f"statetree: node 1 answers {k!r} with {value!r}")
        proof = proof_from_bytes(bytes.fromhex(res["proof"]))
        app_hash = bytes.fromhex(proxy.call(
            "commit", height=version + 1)["header"]["app_hash"])
        verify(proof, k, want, app_hash)
        rows["present" if want is not None else "absent"] += 1
        rows["versions"].add(version)
        if tampered is None and want is not None:
            try:
                verify(proof, k, want + b"!", app_hash)
                tampered = "verified"
            except ProofError as e:
                tampered = str(e)
    require(tampered not in (None, "verified"),
            f"statetree: a tampered proof verified ({tampered})")
    rows["versions"] = sorted(rows["versions"])
    rows["tampered"] = tampered
    return rows


def _grpc_abci_run(device: str, over_grpc: bool) -> list:
    """A single-validator port Node (MockTicker, in memory) whose state-
    tree kvstore sits behind ABCIGrpcServer and is reached through
    grpc_client_creator, or on the local client: the app hashes of its
    blocks 1..ST_ABCI_HEIGHTS over the same txs."""
    from tendermint_tpu_torch.abci.grpc_app import (ABCIGrpcServer,
                                                    grpc_client_creator)
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.consensus.ticker import MockTicker
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    from tendermint_tpu_torch.types.priv_validator import LocalSigner
    on_card = device.startswith("cuda")
    key = PrivKey.generate(b"\x0b" * 32)
    gen = GenesisDoc(chain_id="grpc-abci", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    cfg = test_config("")
    cfg.base.verifier_backend = "cuda" if on_card else "python"
    cfg.consensus.max_block_size_txs = 3
    app = KVStoreApp(device=device)
    server = None
    if over_grpc:
        server = ABCIGrpcServer(app, "127.0.0.1:0")
        server.start()
        creator = grpc_client_creator(f"127.0.0.1:{server.port}")
    else:
        creator = local_client_creator(app)
    try:
        node = Node(cfg, gen, priv_validator=PrivValidator(LocalSigner(key)),
                    client_creator=creator, app=None if over_grpc else app,
                    in_memory=True, device=device if on_card else None)
        node.consensus.ticker.stop()
        node.consensus.ticker = MockTicker(node.consensus._on_timeout_fire)
        node.start()
        try:
            _sweep_inject(node, [b"ga/%02d=v%d" % (i, i) for i in range(9)])
            _sweep_commit_to(node, ST_ABCI_HEIGHTS)
            return [node.block_store.load_block_meta(h).header.app_hash
                    for h in range(1, ST_ABCI_HEIGHTS + 1)]
        finally:
            node.stop()
    finally:
        if server is not None:
            server.stop()


def _statetree_crash_points(device: str) -> list:
    """A single-validator node with the state tree on, crashed at each
    statetree.* fail point of a commit (tfail.arm raising), rebuilt from
    its files, must reach the uncrashed run's app hash and still prove."""
    from tendermint_tpu_torch.statetree import proof_from_bytes, verify
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    root = tempfile.mkdtemp(prefix="statetree-sweep-")
    key = PrivKey.generate(b"\x0e" * 32)
    gen = GenesisDoc(chain_id="st-sweep", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    app_of = lambda: KVStoreApp(device=device)   # noqa: E731
    wave_a, wave_b = ST_SWEEP_WAVES
    rows = []
    tclock.set_source(lambda: T0)
    try:
        control = _sweep_node(os.path.join(root, "control"), gen, key,
                              device, app=app_of())
        control.start()
        _sweep_inject(control, wave_a)
        _sweep_commit_to(control, 1)
        _sweep_inject(control, wave_b)
        _sweep_commit_to(control, ST_SWEEP_TARGET)
        want = control.consensus.state.app_hash
        control.stop()
        for point in ("statetree.before_root_flush",
                      "statetree.after_node_write"):
            home = os.path.join(root, point.replace(".", "_"))
            node = _sweep_node(home, gen, key, device, app=app_of())
            node.start()
            _sweep_inject(node, wave_a)
            _sweep_commit_to(node, 1)
            hit = []

            def crash(name):
                hit.append(name)
                raise _Crash(name)

            tfail.arm(point, crash)
            try:
                _sweep_inject(node, wave_b)
                _sweep_commit_to(node, ST_SWEEP_TARGET)
            except _Crash:
                pass
            finally:
                tfail.disarm_all()
            require(hit == [point], f"statetree sweep: {point} did not fire")
            crashed_at = node.height
            node.consensus._stopped = True
            try:
                node.stop()
            except Exception:  # tmlint: allow(exception-hygiene): the stop of a node the sweep crashed on purpose: its torn state may fail to close; the restarted node is what is checked
                pass
            node2 = _sweep_node(home, gen, key, device, app=app_of())
            node2.start()
            recovered_at = node2.height
            _sweep_inject(node2, wave_b)
            _sweep_commit_to(node2, ST_SWEEP_TARGET)
            res = node2.app.query("", b"st/a1", 0, True)
            verify(proof_from_bytes(res.proof), b"st/a1", res.value,
                   node2.app.app_hash)
            rows.append({"point": point, "crashed_at_height": crashed_at,
                         "recovered_at_height": recovered_at,
                         "handshake_blocks": node2.handshake_blocks,
                         "app_hash_equal":
                             node2.consensus.state.app_hash == want,
                         "proof_verified": True})
            node2.stop()
            require(recovered_at >= crashed_at and rows[-1]["app_hash_equal"],
                    f"statetree sweep: {point} did not recover: {rows[-1]}")
    finally:
        tclock.set_source(None)
        shutil.rmtree(root, ignore_errors=True)
    return rows


def _statetree_reading(line: dict) -> dict:
    st = line["statetree"]
    c = st["commits"]
    return {"height": line["height"], "sha_batches": st["sha_batches"],
            "commits": c["count"],
            "commit_ms_per_height": 1e3 * c["sum"] / max(1, c["count"]),
            "dirty_leaves": st["dirty_leaves"]["sum"],
            "b1_launches": line["launches"]["verify"],
            "device": line["device"]}


def phase_procnet_statetree(card: str, device: str = "cuda") -> dict:
    """Phase 13's four `cli node --p2p` processes on the JAX defaults with
    TM_CUDA_STATE_TREE=on (the kvstore's authenticated state tree, its
    waves hashed on the node's device) and rpc.grpc_laddr on node 2; a
    burst of ST_BURST txs over JSON-RPC to node 0, then ST_GRPC_CLIENTS
    BroadcastAPIClients feeding node 2; a `cli lite` process on `device`
    reading node 0. Checks: every gRPC response committed with codes 0
    and its hash; agreement of block and app hash at every height; a
    host replay (hashlib) gives every app hash; every height's commit,
    validators and block certified through the lite proxy (B1 launched
    there), a sample of fed txs with their proofs; forged headers and
    signatures refused; node 1's state proofs verified against lite-
    certified app hashes, a tampered one refused. Then, in this process:
    a node over gRPC ABCI commits the local client's app hashes, and a
    crash at each statetree.* point recovers. A CPU rehearsal passes
    device="cpu" (no launch required)."""
    from tendermint_tpu_torch.procnet import (ProcNet, bench_settings,
                                              free_block, print_log_tail)
    from tendermint_tpu_torch.rpc.client import JSONRPCClient
    on_card = device.startswith("cuda")
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    _node_libs()
    tag = "procnet_statetree"
    root = tempfile.mkdtemp(prefix=f"{tag}-")
    base = free_block(10)
    grpc_port, lite_port = base + 8, base + 9
    net = ProcNet(root, base_port=base, env_of=lambda i: ST_TREE_ENV)
    chain_id = f"chip-smoke-{tag}"
    net.write_tree(chain_id)
    net.configure(bench_settings("cuda" if on_card else "auto",
                                 reactor="auto", verifier_coalesce="auto",
                                 pipeline="auto"))
    net.configure({"rpc": {"grpc_laddr": f"tcp://127.0.0.1:{grpc_port}"}},
                  nodes=[2])
    feeder = _GrpcFeeder(f"127.0.0.1:{grpc_port}")
    lite = lite_log = None
    t_start = time.perf_counter()

    def left(what: str) -> float:
        rem = ST_WALL_S - (time.perf_counter() - t_start)
        require(rem > 0, f"{tag}: out of wall time at {what}")
        return rem
    ok = False
    _zero_launches()
    try:
        net.start_all(extra=["--no-fast-sync", "--device", device])
        net.wait_for(lambda: min(net.heights()) >= 2,
                     min(PROC_BOOT_S, left("boot")), "boot")
        boot_s = time.perf_counter() - t_start
        lite, lite_log = _lite_process(net, root, net.rpc_port(0),
                                       lite_port, device)
        proxy = JSONRPCClient(f"http://127.0.0.1:{lite_port}", timeout=60)

        def lite_up():
            require(lite.poll() is None, f"{tag}: the lite proxy exited")
            try:
                proxy.call("status")
                return True
            except Exception:
                return False
        net.wait_for(lite_up, left("the lite proxy"), "the lite proxy")
        h_burst = net.height(0)
        burst = [b"st/burst/k%05d=v%06d" % (i, i) for i in range(ST_BURST)]
        admitted = net.rpc(0, 60.0).call(
            "broadcast_tx_batch", txs=[tx.hex() for tx in burst])
        require(all(r["code"] == 0 for r in admitted["results"]),
                f"{tag}: the burst was refused: {admitted['results'][:3]}")
        feed_s = feeder.run(left("the gRPC feed"))
        require(not feeder.errors and not feeder.bad and
                len(feeder.committed) == ST_GRPC_CLIENTS * ST_GRPC_TXS,
                f"{tag}: gRPC feed: errors {feeder.errors[:3]}, bad "
                f"{feeder.bad[:3]}, {len(feeder.committed)} committed")
        last_fed = max(h for _, h in feeder.committed)
        net.wait_for(lambda: all(
            net.rpc(i).call("num_unconfirmed_txs")["n_txs"] == 0
            for i in range(net.n)), left("the mempools' drain"),
            "the mempools' drain", poll_s=0.25)
        target = max(last_fed, net.height(0)) + 2
        net.wait_for(lambda: min(net.heights()) >= target,
                     left("every node past the feed"),
                     "every node past the feed")
        top = min(net.heights())
        bad = net.disagreements(top)
        require(not bad, f"{tag}: the nodes disagree: {bad[:5]}")
        metas = net.metas(0, top)
        block_txs = net.block_txs(0, top)
        committed = Counter(tx for b in block_txs for tx in b)
        missing = [tx for tx in burst + [t for t, _ in feeder.committed]
                   if committed[tx] != 1]
        require(not missing, f"{tag}: {len(missing)} fed txs not committed "
                "exactly once")
        t0 = time.perf_counter()
        replay = _replay_app_hashes(block_txs[:top - 1])
        replay_s = time.perf_counter() - t0
        headers = [bytes.fromhex(m["header"]["app_hash"]) for m in metas]
        require(replay == headers[1:top],
                f"{tag}: the host replay's app hashes differ from the "
                "headers'")
        certified, lite_reads = _lite_reads(proxy, top, feeder.committed)
        require([certified[h] for h in range(1, top + 1)] == headers,
                f"{tag}: lite-certified app hashes differ from node 0's")
        refused = _refusals(net, chain_id, dev)
        keys = random.Random(SEED + 17).sample(
            [tuple(tx.split(b"=", 1)) for tx, _ in feeder.committed]
            + [tuple(tx.split(b"=", 1)) for tx in burst], ST_PROOF_KEYS)
        proofs = _state_proofs(net, proxy, keys)
        wave = _wave_timing(block_txs, dev)
        burst_height = next(h for h, b in enumerate(block_txs, 1)
                            if any(tx.startswith(b"st/burst/") for tx in b))
        lo = max(h_burst, 2)
        span = (metas[top - 1]["header"]["time_ns"]
                - metas[lo - 1]["header"]["time_ns"]) / 1e9
        rate = {"heights": [lo, top], "blocks_per_s": (top - lo) / span,
                "txs": sum(len(b) for b in block_txs[lo:top]),
                "span_s": span, "burst_height": burst_height,
                "largest_block_txs": max(len(b) for b in block_txs)}
        early = net.early_exits()
        require(not early, f"{tag}: node processes exited early {early}")
        wall_s = time.perf_counter() - t_start
        ok = True
    finally:
        if lite is not None and lite.poll() is None:
            lite.send_signal(signal.SIGINT)
            try:
                lite_code = lite.wait(30)
            except subprocess.TimeoutExpired:
                lite.kill()
                lite_code = lite.wait(10)
        else:
            lite_code = None if lite is None else lite.returncode
        if lite_log is not None:
            lite_log.close()
        codes = net.stop_all()
        if not ok:
            for name in [f"node{i}.log" for i in range(net.n)] + ["lite.log"]:
                path = os.path.join(root, name)
                tail = open(path, errors="replace").read().splitlines()[-40:] \
                    if os.path.exists(path) else []
                print(f"{tag} {name} tail:", *tail, sep="\n",
                      file=sys.stderr)
    if lite_code:
        print_log_tail(f"{tag} cli lite exited {lite_code}",
                       os.path.join(root, "lite.log"))
    lines = {i: net.kernel_lines(i) for i in range(net.n)}
    lite_line = _lite_line(root)
    shutil.rmtree(root, ignore_errors=True)
    require(all(codes[i] == 0 for i in range(net.n)) and lite_code == 0,
            f"{tag}: exit codes {codes}, lite {lite_code}")
    require([len(lines[i]) for i in range(net.n)] == [1] * net.n,
            f"{tag}: kernel lines a process {lines}")
    per_node = {i: lines[i][0] for i in lines}
    launches = {k: sum(per_node[i]["launches"][k] for i in per_node)
                + lite_line["launches"][k] for k in ladder.launches}
    readings = {i: _statetree_reading(per_node[i]) for i in per_node}
    sha_total = {k: sum(r["sha_batches"][k] for r in readings.values())
                 for k in ("device", "native", "host")}
    emit({"phase": tag, "validators": 4, "processes": 5,
          "plane": {"reactor": "auto", "verifier_coalesce": "auto",
                    "pipeline": "auto", "state_tree": "on"},
          "heights": top, "blocks_per_s": rate["blocks_per_s"],
          "rate": rate, "burst_txs": ST_BURST,
          "grpc_clients": ST_GRPC_CLIENTS,
          "grpc_txs_committed": len(feeder.committed),
          "grpc_feed_s": feed_s, "boot_s": boot_s, "wall_s": wall_s,
          "replay": {"heights": top - 1, "equal": True, "s": replay_s},
          "note": "blocks/s on the pure-Python kvstore (the tree turns the "
          "kv core off): not comparable with phase 13's", "card": card})
    emit({"phase": f"{tag}_commit", "by_node": readings,
          "sha_batches_total": sha_total,
          "commit_ms_per_height_mean": sum(
              r["commit_ms_per_height"] for r in readings.values()) / 4,
          "largest_wave": wave, "card": card})
    emit({"phase": f"{tag}_lite", "reads": lite_reads,
          "lite_kernels": lite_line, "refused": refused,
          "state_proofs": proofs, "card": card})
    emit({"phase": f"{tag}_kernels", "b1_by_process": {
        **{f"node{i}": per_node[i]["launches"]["verify"] for i in per_node},
        "lite": lite_line["launches"]["verify"]},
        "launches": launches, "card": card})
    if on_card:
        _require_b1_everywhere(tag, {i: [per_node[i]] for i in per_node},
                               on_card)
        require(lite_line["launches"]["verify"] > 0,
                f"{tag}: the lite proxy did not launch B1: {lite_line}")
        require(sha_total["device"] > 0,
                f"{tag}: no wave took the device route: {sha_total}")
    require(lite_line["certify"]["certified"] >= 3 * top
            and lite_line["certify"]["refused"] == 0,
            f"{tag}: lite certifications {lite_line['certify']}")
    for i, r in readings.items():
        require(r["commits"] >= r["height"],
                f"{tag}: node {i} committed {r['commits']} trees to "
                f"height {r['height']}")

    # in this process: gRPC ABCI and the crash points, on `device`
    sweep_t0 = time.perf_counter()
    _zero_launches()
    with _env(ST_TREE_ENV):
        over = _grpc_abci_run(device, over_grpc=True)
        local = _grpc_abci_run(device, over_grpc=False)
        require(over == local and len(set(local[1:])) > 1,
                f"{tag}: gRPC ABCI app hashes {over} != local {local}")
        crash_rows = _statetree_crash_points(device)
    sweep_launches = dict(ladder.launches)
    emit({"phase": f"{tag}_abci_grpc", "heights": ST_ABCI_HEIGHTS,
          "app_hashes_equal": True, "crash_points": crash_rows,
          "launches": sweep_launches,
          "wall_s": time.perf_counter() - sweep_t0, "card": card})
    require(not on_card or sweep_launches["verify"] >= 1,
            f"{tag}: the in-process arms did not launch B1: "
            f"{sweep_launches}")
    return {"launches": launches, "sweep_launches": sweep_launches}


# ----------------------------------------------- phase 17: the chaos plane

CHAOS_SEED = 42           # bench.py's seed for its chaos and wire arms
#: 17a: scale_spec(4) as bench.py's 4-validator point (bench.py:444-455)
CHAOS_SCALE4 = {"n": 4, "target": 8, "settle": 20, "max_steps": 600,
                "digest": "8045e74f7859b6ceb630994bed069949df83c8ce08cc9e"
                          "dc8e606072db4bd0e1",
                "heights": 9, "steps": 335}
#: 17b: ACCEPTANCE_SPEC at run_chaos's defaults (target 10, settle 60)
CHAOS_CLASSIC = {"digest": "79b0311654b2ca8785c7439acaa8429b110d2f3c5db2a0"
                           "d3226bef12c00ec50d",
                 "heights": 14, "steps": 237, "crash_node": 2,
                 "crash_point": "consensus.before_save_block"}
#: 17c: the 32-validator point of BENCH_chaos.json
CHAOS_SCALE32 = {"n": 32, "target": 4, "settle": 10, "max_steps": 400,
                 "digest": "05008501c25f0b51992f21e58ed82ebd1389e89a846c12"
                           "b56b9dc96838f73290",
                 "heights": 9, "steps": 291, "valset_updates": 3}
CHAOS_WALL_S = 360.0      # phase 17's wall limit, 17a to 17d
#: bench.py's WIRECHAOS_SPEC and WIRECHAOS_HOSTILE (bench.py:649-661)
WIRECHAOS_SPEC = {
    "drop": 0.0008,
    "corrupt": 0.0005,
    "delay": 0.10, "delay_steps": [1, 3],
    "partitions": [{"start": 160, "stop": 320,
                    "groups": [[3], [0, 1, 2]]}],
    "stalls": [{"start": 400, "stop": 480, "links": [[0, 1], [1, 0]]}],
    "resets": [{"at": 560, "links": [[1, 2]]},
               {"at": 680, "links": [[2, 3]]}],
    "step_ms": 25,
}
WIRECHAOS_HOSTILE = ("garbage_after_auth", "handshake_stall",
                     "slow_handshake", "flood")
#: the plan digest of WIRECHAOS_SPEC at CHAOS_SEED on four nodes
WIRECHAOS_PLAN_SHA256 = ("7187574ea7b6e0563c6c65af9d514d34b542b835fa0f726e"
                         "e64075dd5e0489b9")
WIRE_WINDOW_S = 19.0      # the armed window (bench.py's TM_BENCH_WIRECHAOS_S
#                           is 30 s; cut: time. The last episode ends at 17 s)
WIRE_PREFILL = 2500       # node 0's backlog before the window
WIRE_LIVENESS_S = 30.0    # an episode's recovery bound
#: bench.py's shortened defenses (child_env and p2p_cfg), as p2p fields
WIRE_P2P = {"pex": False, "handshake_timeout_s": 5.0, "ban_base_s": 6.0,
            "ban_score": 30}


@contextlib.contextmanager
def _quiet_logs():
    """The port's loggers at error for the in-process nets (32 nodes of
    info lines), restored after."""
    import logging
    roots = [logging.getLogger(n) for n in ("tm", "tendermint_tpu_torch")]
    saved = [r.level for r in roots]
    for r in roots:
        r.setLevel(logging.ERROR)
    try:
        yield
    finally:
        for r, lvl in zip(roots, saved):
            r.setLevel(lvl)


def _chaos_verifier(on_card: bool):
    """bench.py's pinning of the device route (bench.py:431-441): one
    BatchVerifier("cuda") without coalescing as the default verifier, so
    that every verify of the nets is a B1 launch. Returns the verifier
    it replaced, for _restore_verifier."""
    saved = tverifier._default
    if on_card:
        v = tverifier.BatchVerifier("cuda", coalesce="off")
        from tendermint_tpu_torch.node import prebuild
        prebuild(v)
        tverifier.set_default_verifier(v)
    return saved


def _chaos_check(tag: str, r: dict, want: dict) -> None:
    got = (r["fault_log_sha256"], r["max_height"], r["steps"])
    require(got == (want["digest"], want["heights"], want["steps"]),
            f"{tag}: (digest, heights, steps) {got}, the JAX package's "
            f"{(want['digest'], want['heights'], want['steps'])}")
    require(r["violations"] == [], f"{tag}: violations {r['violations']}")
    lite = r.get("lite") or {}
    require(lite.get("active") and
            lite.get("certified_height") == r["max_height"],
            f"{tag}: the lite certifier {lite} at top {r['max_height']}")


def _chaos_line(tag: str, r: dict, launches: dict, card: str, **extra):
    emit({"phase": tag, "digest": r["fault_log_sha256"],
          "heights": r["max_height"], "steps": r["steps"],
          "wall_s": r["wall_seconds"], "blocks_per_s": r["blocks_per_sec"],
          "checks_total": r["checks_total"],
          "faults_injected_total": r["faults_injected_total"],
          "lite": r.get("lite"), "churn": r.get("churn"),
          "recovery_steps": r["recovery"]["latency_steps"],
          "launches": launches, **extra, "card": card})


def _chaos_scale4(card: str, dev, left) -> dict:
    from tendermint_tpu_torch.chaos.runner import run_chaos, scale_spec
    c = CHAOS_SCALE4
    left("chaos_scale4")
    _zero_launches()
    r = run_chaos(spec=scale_spec(c["n"]), seed=CHAOS_SEED, n=c["n"],
                  target_height=c["target"], max_steps=c["max_steps"],
                  settle_steps=c["settle"], device=dev)
    launches = dict(ladder.launches)
    _chaos_check("chaos_scale4", r, c)
    _chaos_line("chaos_scale4", r, launches, card)
    return launches


def _chaos_classic(card: str, dev, left) -> dict:
    from tendermint_tpu_torch.analysis import lockwatch
    from tendermint_tpu_torch.chaos.runner import ACCEPTANCE_SPEC, run_chaos
    c = CHAOS_CLASSIC
    left("chaos_classic")
    fd, trace = tempfile.mkstemp(prefix="chaos-classic-", suffix=".json")
    os.close(fd)
    _zero_launches()
    lockwatch.clear()
    try:
        with _env({"TM_CUDA_LOCKCHECK": "on"}):
            r = run_chaos(spec=ACCEPTANCE_SPEC, seed=CHAOS_SEED,
                          trace_path=trace, device=dev)
        launches = dict(ladder.launches)
        with open(trace) as f:
            log = json.load(f)["fault_log"]
    finally:
        lockwatch.uninstall()
        lockwatch.clear()
        os.unlink(trace)
    _chaos_check("chaos_classic", r, c)
    ev = r["evidence"]
    require(ev["injected_double_signs"] > 0 and
            ev["committed"] == ev["injected_double_signs"],
            f"chaos_classic: double-signs committed as evidence {ev}")
    crashes = [e for e in log if e["kind"] == "crash"]
    restarts = [e for e in log if e["kind"] == "restart"]
    require([(e["node"], e["point"]) for e in crashes] ==
            [(c["crash_node"], c["crash_point"])] and
            [e["node"] for e in restarts] == [c["crash_node"]],
            f"chaos_classic: crashes {crashes}, restarts {restarts}")
    healed = [e for e in r["recovery"]["episodes"] if e["kind"] == "crash"]
    require(healed and healed[0]["recovery_steps"] is not None,
            f"chaos_classic: node {c['crash_node']} did not recover "
            f"{healed}")
    lw = r["lockwatch"]
    require(lw["cycles"] == [] and lw["locks_watched"] > 0,
            f"chaos_classic: lock-order cycles {lw['cycles']} "
            f"({lw['locks_watched']} locks watched)")
    _chaos_line("chaos_classic", r, launches, card,
                evidence=ev, crash=crashes[0], faults=r["faults_injected"],
                lockwatch={"locks_watched": lw["locks_watched"],
                           "edges": len(lw["edges"]), "cycles": lw["cycles"],
                           "attr_violations": len(lw["attr_violations"])})
    return launches


def _chaos_scale32(card: str, dev, on_card: bool, left) -> dict:
    from tendermint_tpu_torch.chaos.runner import run_chaos, scale_spec
    from tendermint_tpu_torch.telemetry import causal
    c = CHAOS_SCALE32
    left("chaos_scale32")
    v = tverifier.default_verifier() if on_card else None
    stats0 = dict(v.stats) if v is not None else {}
    timed, saved, ref = [], [], None
    if on_card:
        saved = _patched(_in_run_timer_patches(timed))
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        # each Node turns the causal plane to its config's "off", as the
        # JAX node does, over run_chaos's "on": the env knob wins over
        # both (the fault log is the same either way)
        with _env({"TM_CUDA_TRACE": "on"}):
            r = run_chaos(spec=scale_spec(c["n"]), seed=CHAOS_SEED,
                          n=c["n"], target_height=c["target"],
                          max_steps=c["max_steps"],
                          settle_steps=c["settle"], device=dev)
    finally:
        _restore(saved)
    wall = time.perf_counter() - t0
    launches = dict(ladder.launches)
    _chaos_check("chaos_scale32", r, c)
    lite, churn = r["lite"], r["churn"]
    require(lite["valset_updates"] == c["valset_updates"],
            f"chaos_scale32: valset updates {lite}")
    require(all(churn.get(k, 0) >= 1 for k in
                ("churn_join", "churn_leave", "churn_stake")),
            f"chaos_scale32: churn {churn}")
    spans = sorted(e["d"] for e in causal.dump()["spans"]
                   if e["n"] == "verify.dispatch")
    require(spans or not on_card,
            "chaos_scale32: no verify.dispatch span in the causal ring")
    extra = {"n_validators": c["n"],
             "n_genesis_validators": r["n_genesis_validators"],
             "run_wall_s": wall,
             "dispatch_spans": len(spans),
             "dispatch_p50_ms": (spans[len(spans) // 2] / 1e6
                                 if spans else None)}
    if on_card:
        extra["verify_calls"] = v.stats["calls"] - stats0["calls"]
        extra["verify_sigs"] = v.stats["sigs"] - stats0["sigs"]
        dev_t = _in_run_device_time(timed, ref, wall)
        b1 = dev_t["by_kernel"].get("verify", {})
        extra["b1_event_ms"] = b1.get("event_ms", 0.0)
        extra["b1_share_of_wall"] = b1.get("event_ms", 0.0) / (wall * 1e3)
        extra["device_busy"] = dev_t["device_busy"]
        extra["b1_by_lanes"] = b1.get("by_lanes", {})
    _chaos_line("chaos_scale32", r, launches, card, **extra)
    return launches


def _wire_net(tag: str, device: str, on_card: bool, left) -> dict:
    """17d: phase 13's four processes behind chaos.wire's proxy (see the
    module docstring). Returns the run's readings."""
    from tendermint_tpu_torch.chaos import hostile as thostile
    from tendermint_tpu_torch.chaos import wire as twire
    from tendermint_tpu_torch.procnet import ProcNet, bench_settings, free_block
    _node_libs()
    root = tempfile.mkdtemp(prefix=f"{tag}-")
    net = ProcNet(root, base_port=free_block(8))
    net.write_tree(f"chip-smoke-{tag}")
    net.configure(bench_settings("cuda" if on_card else "auto"))
    net.configure({"p2p": WIRE_P2P})
    proxy, sched = twire.proxy_for_testnet(
        WIRECHAOS_SPEC, CHAOS_SEED, net.n, lambda j: net.base_port + 2 * j)
    for i in range(net.n):
        with open(net.config_path(i)) as f:
            cfg = json.load(f)
        peers = []
        for entry in cfg["p2p"]["persistent_peers"].split(","):
            if entry:
                pid, hostport = entry.split("@", 1)
                j = (int(hostport.rsplit(":", 1)[1]) - net.base_port) // 2
                peers.append(f"{pid}@127.0.0.1:{proxy.ports[(i, j)]}")
        cfg["p2p"]["persistent_peers"] = ",".join(peers)
        with open(net.config_path(i), "w") as f:
            json.dump(cfg, f, indent=1, sort_keys=True)
    proxy.start()
    monitor = None
    feeder = _WSFeeder(net, 0)
    hostile_threads, hostile_reports = [], []
    ok = False
    try:
        net.start_all(extra=["--no-fast-sync", "--device", device])
        net.wait_for(lambda: min(net.heights()) >= 2,
                     min(PROC_BOOT_S, left("boot")), f"{tag}: boot")
        feeder.start()
        net.wait_for(lambda: net.rpc(0).call("num_unconfirmed_txs")[
            "n_txs"] >= WIRE_PREFILL, left("prefill"), f"{tag}: prefill")
        wire_t0 = proxy.arm()
        monitor = twire.SocketInvariantMonitor(
            [f"http://127.0.0.1:{net.rpc_port(i)}" for i in range(net.n)])
        monitor.start()
        kw_of = {"garbage_after_auth": {"rounds": 12, "retry_gap_s": 1.2,
                                        "budget_s": WIRE_WINDOW_S + 10},
                 "flood": {"count": 48, "hold_s": 2.0},
                 "slow_handshake": {"byte_interval_s": 0.5,
                                    "budget_s": min(20.0, WIRE_WINDOW_S)},
                 "handshake_stall": {"budget_s": min(20.0, WIRE_WINDOW_S)}}
        for script in WIRECHAOS_HOSTILE:
            def run_script(s=script):
                try:
                    hostile_reports.append(thostile.run_hostile(
                        s, "127.0.0.1", net.base_port,
                        network=f"chip-smoke-{tag}", channels=[],
                        **kw_of[s]))
                except Exception as e:
                    hostile_reports.append({"script": s, "error": repr(e)})
            t = threading.Thread(target=run_script, daemon=True,
                                 name=f"smoke-hostile-{script}")
            t.start()
            hostile_threads.append(t)
        h0 = net.height(0)
        t0 = time.perf_counter()
        end_at = time.monotonic() + WIRE_WINDOW_S
        while time.monotonic() < end_at:
            early = net.early_exits()
            require(not early, f"{tag}: node processes exited early {early}")
            left("the window")
            time.sleep(1.0)
        h1 = net.height(0)
        dt = time.perf_counter() - t0
        feeder.stop()
        for t in hostile_threads:
            t.join(timeout=min(20.0, left("the hostile scripts")))
        require(not any(t.is_alive() for t in hostile_threads),
                f"{tag}: a hostile script outlived its budget")
        time.sleep(3.0)   # the monitor sees post-heal progress
        ends = [(ep["kind"], wire_t0 + ep["end"] * sched.step_ms / 1e3)
                for ep in sched.episodes()]
        monitor.stop()
        report = monitor.finalize(
            [e for e in ends if e[1] <= time.monotonic()],
            liveness_bound_s=WIRE_LIVENESS_S)
        top = min(net.heights())
        disagree = net.disagreements(top)
        applied = sched.applied_counts()
        ok = True
    finally:
        feeder.stop()
        if monitor is not None:
            monitor.stop()
        codes = net.stop_all()
        proxy.stop()
        if not ok:
            for i in range(net.n):
                tail = net.log(i).splitlines()[-40:] \
                    if os.path.exists(net.log_path(i)) else []
                print(f"{tag} node {i} log tail:", *tail, sep="\n",
                      file=sys.stderr)
    lines = {i: net.kernel_lines(i) for i in range(net.n)}
    require(all(codes[i] == 0 for i in range(net.n)),
            f"{tag}: node exit codes {codes}")
    require([len(lines[i]) for i in range(net.n)] == [1] * net.n,
            f"{tag}: kernel lines a process {lines}")
    launches = {k: sum(ln["launches"][k] for i in lines for ln in lines[i])
                for k in ladder.launches}
    shutil.rmtree(root, ignore_errors=True)
    return {"report": report, "hostile": hostile_reports, "ends": ends,
            "blocks": h1 - h0, "window_s": dt, "applied": applied,
            "plan_sha256": sched.plan_digest(), "disagree": disagree,
            "launches": launches, "lines": lines, "top": top,
            "sent": feeder.sent, "feeder_errors": feeder.errors}


def _wire_chaos(card: str, device: str, on_card: bool, left) -> dict:
    run = _wire_net("wire_chaos", device, on_card, left)
    rep = run["report"]
    require(run["plan_sha256"] == WIRECHAOS_PLAN_SHA256,
            f"wire_chaos: plan digest {run['plan_sha256']}")
    require(rep["violations"] == [] and not run["disagree"],
            f"wire_chaos: violations {rep['violations']}, disagreements "
            f"{run['disagree'][:3]}")
    eps = rep["recovery"]["episodes"]
    require(len(eps) == len(run["ends"]) == 4 and
            all(e["recovery_s"] is not None for e in eps),
            f"wire_chaos: episodes {eps} of {run['ends']}")
    hostile = {h.get("script"): h for h in run["hostile"]}
    for s in ("handshake_stall", "slow_handshake"):
        require(hostile.get(s, {}).get("defense_fired"),
                f"wire_chaos: {s} not closed by the victim {hostile.get(s)}")
    garbage = hostile.get("garbage_after_auth", {})
    require(garbage.get("saw_ban") and garbage.get("readmitted_after_ban"),
            f"wire_chaos: garbage_after_auth's ban lifecycle {garbage}")
    if on_card:
        require(all(ln["launches"]["verify"] > 0
                    for i in run["lines"] for ln in run["lines"][i]),
                f"wire_chaos: a process never launched B1 "
                f"{ {i: [ln['launches'] for ln in run['lines'][i]] for i in run['lines']} }")
    lat = rep["recovery"]["latency_seconds"]
    emit({"phase": "wire_chaos", "validators": 4, "processes": 4,
          "window_s": run["window_s"], "blocks": run["blocks"],
          "blocks_per_s": run["blocks"] / run["window_s"],
          "heights": run["top"], "plan_sha256": run["plan_sha256"],
          "faults_applied": run["applied"], "episodes": eps,
          "recovery_p50_s": lat["p50"], "recovery_max_s": lat["max"],
          "checks_total": rep["checks_total"],
          "heights_audited_all_nodes": rep["heights_audited_all_nodes"],
          "app_hash_chain_identical": rep["app_hash_chain_identical"],
          "txs_sent": run["sent"], "feeder_errors": run["feeder_errors"],
          "launches": run["launches"], "card": card})
    emit({"phase": "wire_chaos_hostile", "scripts": {
        s: {k: v for k, v in h.items() if k != "rounds"}
        for s, h in hostile.items()},
        "garbage_rounds": [o["outcome"] for o in garbage.get("rounds", [])],
        "card": card})
    return run


def phase_chaos(card: str, device: str = "cuda") -> dict:
    """Phase 17 (see the module docstring): the chaos plane's seeded runs
    at 4 and 32 validators and the wire-faulted four-process net. A CPU
    rehearsal passes device="cpu": the nets verify on the host and no
    launch is required."""
    on_card = device.startswith("cuda")
    dev = None if on_card else device
    t_phase = time.perf_counter()

    def left(what: str) -> float:
        rem = CHAOS_WALL_S - (time.perf_counter() - t_phase)
        require(rem > 0, f"chaos: out of wall time at {what}")
        return rem
    saved = _chaos_verifier(on_card)
    try:
        with _quiet_logs():
            scale4 = _chaos_scale4(card, dev, left)
            classic = _chaos_classic(card, dev, left)
            scale32 = _chaos_scale32(card, dev, on_card, left)
    finally:
        tverifier.set_default_verifier(saved)
    if on_card:
        for tag, launches in (("chaos_scale4", scale4),
                              ("chaos_classic", classic),
                              ("chaos_scale32", scale32)):
            _require_launched(launches, ("verify",), tag)
    wire = _wire_chaos(card, device, on_card, left)
    emit({"phase": "chaos_summary", "wall_s": time.perf_counter() - t_phase,
          "wall_limit_s": CHAOS_WALL_S, "card": card})
    return {"chaos_scale4": scale4, "chaos_classic": classic,
            "chaos_scale32": scale32, "wire_chaos": wire["launches"]}


# ------------------------------------------------------------- phase 18
SHARD_ARMS = (1, 8, 32)   # BENCH_shard.json's arms
SHARD_WINDOW_S = 3.0      # an arm's measured window (bench.py: 20 s)
SHARD_WARM_S = 1.0        # bench.py's lead before the window
SHARD_BOOT_S = 60.0       # every shard at height 2 within
SHARD_FEEDERS = 2         # bench.py's spammers: 64-tx broadcast_tx_batch
SHARD_BATCH = 64          # calls through the front door, 0.1 s apart
SHARD_PAUSE_S = 0.1
EDGE_KEYS = 400           # bench.py's load keyspace (lk0..lk399)
EDGE_RATE = 100.0         # TM_CUDA_RPC_RATE of each replica (bench.py)
EDGE_OFFERED = 250.0      # certified reads/s offered (bench.py)
EDGE_ARM_S = 3.0          # an arm's duration (bench.py: 8 s; cut: time)
EDGE_CONNS = 50           # the fleet's connections to a replica
EDGE_SAMPLE = 4           # replica reads verified client-side, a replica
EDGE_DRAIN_S = 4.0        # an arm's backlog: the wait for it, at most
EDGE_ARM_DRAIN_S = 2.0    # the fleet's wait for an arm's last answers
#                           (bench.py: 5 s; cut: time)
KNEE_RATES = (150, 300)   # bench.py: up to 4,800 (cut: time)
KNEE_RATE_S = 3.0         # a rate's window (bench.py: 8 s)
KNEE_CONNS = 1500
KNEE_SUBS = 300
KNEE_SLO_MS = 1500.0
SERVE_WALL_S = 420.0      # phase 18's wall limit, 18a to 18c


class _ShardFeeder:
    """bench.py's spammers: SHARD_FEEDERS threads, each casting
    SHARD_BATCH-tx broadcast_tx_batch calls of unique k/<t>/<i>=v<i>
    through the front door every SHARD_PAUSE_S."""

    def __init__(self, url: str):
        self.url = url
        self.sent = [0] * SHARD_FEEDERS
        self.errors = [0] * SHARD_FEEDERS
        self._stop = threading.Event()
        self._threads = [threading.Thread(
            target=self._run, args=(t,), daemon=True,
            name=f"smoke-shard-feeder-{t}") for t in range(SHARD_FEEDERS)]

    def _run(self, tid: int) -> None:
        from tendermint_tpu_torch.rpc.client import (JSONRPCClient,
                                                     RPCClientError)
        c = JSONRPCClient(self.url)
        i = 0
        while not self._stop.is_set():
            try:
                c.call("broadcast_tx_batch", txs=[
                    (b"k/%d/%d=v%d" % (tid, i + j, i + j)).hex()
                    for j in range(SHARD_BATCH)])
                i += SHARD_BATCH
                self.sent[tid] = i
            except (OSError, RPCClientError):
                self.errors[tid] += 1   # an overloaded front door
            self._stop.wait(SHARD_PAUSE_S)

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def halt(self) -> None:
        self._stop.set()

    def join(self) -> None:
        for t in self._threads:
            t.join(30)
        require(not any(t.is_alive() for t in self._threads),
                "shard_curve: a feeder did not stop")


def _verifier_counts(v) -> tuple:
    with v._stats_lock:
        st = dict(v.stats)
    return st, v.coalescer_stats()


def _read_keys(s, url: str) -> list:
    """Keys on two shards (one for n = 1), each written by
    broadcast_tx_sync through the front door."""
    from tendermint_tpu_torch.rpc.client import JSONRPCClient
    c = JSONRPCClient(url, timeout=60.0)
    picked, i = {}, 0
    while len(picked) < min(2, len(s)):
        k = b"xr/%d" % i
        picked.setdefault(s.router.map.chain_of(k), k)
        i += 1
    for k in picked.values():
        r = c.call("broadcast_tx_sync", tx=(k + b"=" + k).hex())
        require(r["code"] == 0, f"shard_curve: {k!r} refused {r}")
    return list(picked.values())


def _shard_reads(s, v, keys: list) -> dict:
    """Certified reads of `keys` (_read_keys) through CertifiedReader,
    every height of their chains from genesis; then a forged commit
    refused."""
    from tendermint_tpu_torch.shard import CertifiedReader, ReadProofError
    from tendermint_tpu_torch.shard import reads as sreads
    reader = s.reader()
    reads = []
    for k in keys:
        t0 = time.perf_counter()
        deadline = time.monotonic() + 30.0
        r = reader.read(k)
        while r["value"] != k and time.monotonic() < deadline:
            time.sleep(0.1)
            r = reader.read(k)
        require(r["value"] == k and r["certified_height"] >= r["height"],
                f"shard_curve: certified read of {k!r}: {r}")
        reads.append({"key": k.decode(), "chain_id": r["chain_id"],
                      "height": r["height"],
                      "certified_height": r["certified_height"],
                      "read_s": time.perf_counter() - t0})
    # a forged commit: the newest precommit's signature flipped
    k = keys[0]
    node = s.node_for_key(k)
    h = node.block_store.height()
    doc = sreads.serve_read(node, k, max(0, h - 2))
    for vote in doc["proof_commits"][-1]["signed_header"]["commit"][
            "precommits"]:
        if vote:
            sig = bytearray(bytes.fromhex(vote["signature"]))
            sig[0] ^= 0xFF
            vote["signature"] = bytes(sig).hex()
    cert = ContinuousCertifier(node.gen_doc.chain_id,
                               node.state_store.load_validators(1),
                               next_height=max(1, h - 1), verifier=v)
    try:
        CertifiedReader.verify(doc, cert)
        refused = False
    except ReadProofError:
        refused = True
    require(refused, "shard_curve: a forged commit proof was accepted")
    return {"reads": reads, "forged_refused": refused}


def _replay_shards(s, device) -> dict:
    """Each shard's stored blocks through a fresh single-chain kvstore:
    every header's app hash must be the replay's, bit for bit."""
    out = {}
    for nd in s.nodes:
        app = KVStoreApp(device=device)
        ah, top = b"", nd.block_store.height()
        for h in range(1, top + 1):
            blk = nd.block_store.load_block(h)
            require(blk is not None, f"shard_curve: {nd.gen_doc.chain_id} "
                    f"lacks block {h}")
            if h > 1:
                require(blk.header.app_hash == ah,
                        f"shard_curve: {nd.gen_doc.chain_id} height {h}: "
                        f"app hash differs from the single-chain replay")
            for tx in blk.data.txs:
                app.deliver_tx(tx)
            ah = app.commit()
        out[nd.gen_doc.chain_id] = top
    return out


def _shard_arm(n: int, card: str, device: str, on_card: bool,
               left) -> dict:
    """One arm of 18a (see the module docstring); returns its reading."""
    from tendermint_tpu_torch.node import prebuild
    from tendermint_tpu_torch.shard import ShardSet
    left(f"shard_curve n={n}")
    saved = tverifier._default
    own = None
    if on_card:
        own = tverifier.BatchVerifier("cuda")
        prebuild(own)
        tverifier.set_default_verifier(own)
    _zero_launches()
    timed, patches, ref = [], [], None
    s = feeder = None
    try:
        s = ShardSet(n, chain_prefix="bench",
                     device=None if on_card else device)
        v = s.verifier
        t_boot = time.perf_counter()
        s.start()
        host, port = s.serve()
        deadline = time.monotonic() + min(SHARD_BOOT_S, left("boot"))
        while s.frontier() < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        require(s.frontier() >= 2, f"shard_curve n={n}: boot stalled "
                f"{s.heights()}")
        boot_s = time.perf_counter() - t_boot
        feeder = _ShardFeeder(f"http://{host}:{port}")
        feeder.start()
        keys = _read_keys(s, f"http://{host}:{port}")
        time.sleep(SHARD_WARM_S)
        h0 = s.heights()
        st0, co0 = _verifier_counts(v)
        if on_card:
            patches = _patched(_in_run_timer_patches(timed))
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
        t0 = time.perf_counter()
        time.sleep(SHARD_WINDOW_S)
        dt = time.perf_counter() - t0
        _restore(patches)
        patches = []
        h1 = s.heights()
        st1, co1 = _verifier_counts(v)
        # a batch call in flight returns (or fails, once the front door
        # closes) by itself: the feeders are joined after the stop
        feeder.halt()
        reads = _shard_reads(s, v, keys)
    finally:
        _restore(patches)
        if feeder is not None:
            feeder.halt()
        if s is not None:
            s.stop()
        if feeder is not None:
            feeder.join()
        tverifier.set_default_verifier(saved)
        if own is not None:
            own.close()
    launches = dict(ladder.launches)
    parity = _replay_shards(s, device)
    blocks = sum(h1[c] - h0[c] for c in h1)
    calls = co1["submissions"] - co0["submissions"]
    disp = co1["dispatches"] - co0["dispatches"]
    vcalls = st1["calls"] - st0["calls"]
    row = {"phase": "shard_curve", "n_shards": n, "window_s": dt,
           "boot_s": boot_s, "blocks": blocks,
           "agg_blocks_per_s": blocks / dt,
           "per_shard_blocks_per_s": blocks / dt / n,
           "txs_sent": sum(feeder.sent), "feeder_errors": feeder.errors,
           "coalesce_calls": calls, "coalesce_dispatches": disp,
           "coalesce_factor": calls / disp if disp else None,
           "calls_max": co1["calls_max"],
           "verify_calls": vcalls,
           "mean_verify_batch": ((st1["sigs"] - st0["sigs"]) / vcalls
                                 if vcalls else None),
           "verify_dispatch_s": st1["dispatch_s"] - st0["dispatch_s"],
           "cross_shard": reads, "apphash_parity_heights": parity,
           "launches": launches, "device": str(v.device), "card": card}
    if on_card:
        dev_t = _in_run_device_time(timed, ref, dt)
        for name, key in (("verify", "b1"), ("verify_pre", "b2")):
            k = dev_t["by_kernel"].get(name, {})
            row[f"{key}_window_launches"] = k.get("launches", 0)
            row[f"{key}_by_lanes"] = k.get("by_lanes", {})
        b1_ms = dev_t["by_kernel"].get("verify", {}).get("event_ms", 0.0)
        row["b1_event_ms"] = b1_ms
        row["b1_share_of_window"] = b1_ms / (dt * 1e3)
        row["device_busy"] = dev_t["device_busy"]
        # the window's own launches: the certified reads and the forged
        # commit, after it, launch B1 too
        require(row["b1_window_launches"] > 0,
                f"shard_curve n={n}: no merged dispatch launched B1 in "
                f"the window {row['b1_by_lanes']}")
    emit(row)
    return row


def _replica_line(spec):
    """The last `replica kernels` line of a replica's current process
    (printed at each certified height): its reads by result and its RPC
    calls in flight, read from its log with no call to its busy RPC."""
    lines = _proc_kernel_lines(os.path.join(spec.home, "node.log"),
                               "replica")
    return lines[-1] if lines else None


def _edge_drain(specs) -> dict:
    """Wait until each replica prints a line for a newer certified height
    with no RPC call in flight (the arm's backlog served), at most
    EDGE_DRAIN_S; -> name: (verified reads, seconds, drained)."""
    t0 = time.perf_counter()
    h0 = {s.name: _replica_line(s)["edge"]["certified_height"]
          for s in specs}
    out = {}
    while len(out) < len(specs):
        dt = time.perf_counter() - t0
        for s in specs:
            ln = _replica_line(s)
            fresh = ln["edge"]["certified_height"] > h0[s.name]
            if s.name not in out and ((fresh and ln["rpc"]["inflight"] == 0)
                                      or dt > EDGE_DRAIN_S):
                out[s.name] = (ln["edge"]["reads"]["verified"], dt,
                               dt <= EDGE_DRAIN_S)
        time.sleep(0.2)
    return out


def _prime_keys(client, n: int, prefix: str = "lk",
                wait_s: float = 60.0) -> None:
    """bench.py's _prime_keyspace: n writes through `client`, then the
    last key committed."""
    for i in range(n):
        client.call("broadcast_tx_async",
                    tx=f"{prefix}{i}=seed{i}".encode().hex())
    last = f"{prefix}{n - 1}".encode().hex()
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            if client.call("abci_query", data=last)["response"].get("value"):
                return
        except OSError:
            pass
        time.sleep(0.3)
    require(False, f"serving: {prefix}{n - 1} not committed in {wait_s} s")


def _edge_arm(spec, val, rate: float, seed: int) -> dict:
    """bench.py's _replica_arm: EDGE_CONNS connections offering `rate`
    ops/s at one replica, half replica_read, half proven abci_query, for
    EDGE_ARM_S. A read's since_height follows the chain: validator
    `val`'s height - 3, refreshed every 0.5 s, as a client that reads on
    and so keeps its certifier near the top. bench.py pins it at the
    arm's start: then each queued read ships more commits as the chain
    grows (~5-6 blocks/s here), and the replica's backlog grew without
    bound on the card, and on a CPU host of 8 cores for the JAX
    package's replica as for this one (ROADMAP Queue 3)."""
    from tendermint_tpu_torch.serving.loadgen import (OpenLoopFleet,
                                                      op_query_prove)
    since = [max(0, val.call("status")["latest_block_height"] - 3)]
    done = threading.Event()

    def follow():
        while not done.wait(0.5):
            try:
                since[0] = max(since[0], val.call("status")[
                    "latest_block_height"] - 3)
            except OSError:
                pass    # keep the last height
    follower = threading.Thread(target=follow, daemon=True,
                                name="smoke-edge-since")
    follower.start()
    fleet = OpenLoopFleet("127.0.0.1", spec.rpc_port, seed=seed)
    try:
        fleet.connect(EDGE_CONNS)
        mix = [("replica_read", 0.5,
                lambda rng, i: ("replica_read", {
                    "key": f"lk{rng.randrange(EDGE_KEYS)}".encode().hex(),
                    "since_height": since[0]})),
               ("query_prove", 0.5, op_query_prove(EDGE_KEYS))]
        return fleet.run(EDGE_ARM_S, rate, mix, drain_s=EDGE_ARM_DRAIN_S)
    finally:
        done.set()
        follower.join(10)
        fleet.close()


def _point(p: dict) -> dict:
    keys = ("offered_rate", "offered", "completed_ok", "achieved_rate",
            "goodput_ratio", "errors", "unanswered", "p50_ms", "p95_ms",
            "p99_ms", "shed_conns", "events")
    return {k: p.get(k) for k in keys}


def _proc_kernel_lines(path: str, tag: str) -> list:
    """The last `<tag> kernels {...}` line of each process a Deployment
    log holds (a restarted process appends to the same log; each start
    prints its `... started`/`front door` line first)."""
    with open(path) as f:
        text = f.read()
    text = text[:text.rfind("\n") + 1]   # a line still being written
    starts = [m.start() for m in re.finditer(
        r"^(node started:|replica started:|shardset front door)", text,
        re.M)] + [len(text)]
    out = []
    for lo, hi in zip(starts, starts[1:]):
        found = re.findall(rf"^{tag} kernels (\{{.*\}})$", text[lo:hi],
                           re.M)
        if found:
            out.append(json.loads(found[-1]))
    return out


def _sum_launches(lines) -> dict:
    total = dict.fromkeys(ladder.launches, 0)
    for ln in lines:
        for k in total:
            total[k] += ln["launches"].get(k, 0)
    return total


def _client_verify(spec, v, n: int) -> dict:
    """EDGE_SAMPLE replica reads verified client-side by one certifier
    seeded from the genesis valset (each read ships the commits since
    the certifier's height); then a tampered value refused."""
    from tendermint_tpu_torch.rpc.client import JSONRPCClient
    from tendermint_tpu_torch.shard import CertifiedReader, ReadProofError
    from tendermint_tpu_torch.shard.reads import _genesis_valset
    from tendermint_tpu_torch.types.genesis import GenesisDoc
    gen = GenesisDoc.load(os.path.join(spec.home, "config", "genesis.json"))
    c = JSONRPCClient(spec.rpc_address, timeout=60.0)
    cert = ContinuousCertifier(gen.chain_id, _genesis_valset(gen),
                               verifier=v)
    rng = random.Random(n)
    for _ in range(n):
        k = f"lk{rng.randrange(EDGE_KEYS)}".encode()
        doc = c.call("replica_read", key=k.hex(),
                     since_height=cert.certified_height)
        require(doc.get("value_proof") is not None,
                f"edge_replicas: {spec.name} served {k!r} unproven")
        CertifiedReader.verify(doc, cert)
    doc = c.call("replica_read", key=b"lk0".hex())
    doc["value"] = b"forged".hex()
    try:
        CertifiedReader.verify(doc, ContinuousCertifier(
            gen.chain_id, _genesis_valset(gen), verifier=v))
        refused = False
    except ReadProofError:
        refused = True
    require(refused, f"edge_replicas: a tampered value from {spec.name} "
            f"was accepted")
    return {"verified": n, "certified_height": cert.certified_height,
            "tampered_refused": refused}


def _edge_replicas(card: str, device: str, on_card: bool, left) -> dict:
    """18b (see the module docstring); returns its reading."""
    from tendermint_tpu_torch.rpc.client import JSONRPCClient
    from tendermint_tpu_torch.serving import Deployment, Topology
    left("edge_replicas")
    topo = Topology(kind="validators", n_validators=2, n_replicas=2,
                    chain_id="chip-smoke-edge", max_seconds=SERVE_WALL_S,
                    env={"TM_CUDA_STATE_TREE": "on"}, device=device)
    out = tempfile.mkdtemp(prefix="edge_replicas-")
    d = Deployment(topo, out, kind_env={"replica": {
        "TM_CUDA_RPC_RATE": str(EDGE_RATE)}})
    if on_card:
        for spec in d.specs:    # every verify of every process on B1
            path = os.path.join(spec.home, "config", "config.json")
            with open(path) as f:
                cfg = json.load(f)
            cfg["base"]["verifier_backend"] = "cuda"
            with open(path, "w") as f:
                json.dump(cfg, f)
    v = tverifier.BatchVerifier("cuda" if on_card else "python",
                                device=None if on_card else device)
    reps = [s for s in d.specs if s.kind == "replica"]
    row = {"phase": "edge_replicas", "validators": 2, "replicas": 2,
           "rate_per_replica": EDGE_RATE, "offered": EDGE_OFFERED,
           "arm_s": EDGE_ARM_S}
    _zero_launches()
    t0 = time.perf_counter()
    d.start()
    try:
        d.wait_height(3, timeout_s=min(120.0, left("edge boot")))
        row["boot_s"] = time.perf_counter() - t0
        val = d.clients(kind="validator")[0]
        _prime_keys(val, EDGE_KEYS)
        frontier = val.call("status")["latest_block_height"]
        d.wait(lambda c: c.call("status")["edge"]["certified_height"]
               >= frontier, min(90.0, left("edge certify")),
               "replicas did not certify the primed frontier",
               kind="replica")
        row["primed_frontier"] = frontier
        # client-side verification first, while the chains are short
        row["client_verify"] = {s.name: _client_verify(s, v, EDGE_SAMPLE)
                                for s in reps}
        v0 = _replica_line(reps[0])["edge"]["reads"]["verified"]
        one = _edge_arm(reps[0], val, EDGE_OFFERED, seed=23)
        v1, drain, drained = _edge_drain(reps[:1])["replica0"]
        row["one_replica"] = {**_point(one), "verified": v1 - v0,
                              "drain_s": drain, "drained": drained}
        before = [_replica_line(s)["edge"]["reads"]["verified"]
                  for s in reps]
        results = [None, None]

        def arm(i):
            results[i] = _edge_arm(reps[i], val, EDGE_OFFERED / 2,
                                   seed=31 + i)
        threads = [threading.Thread(target=arm, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        after = _edge_drain(reps)
        row["two_replicas"] = [
            {**_point(r), "verified": after[s.name][0] - b,
             "drain_s": after[s.name][1], "drained": after[s.name][2]}
            for r, s, b in zip(results, reps, before)]
        agg1 = one["completed_ok"] / EDGE_ARM_S
        agg2 = sum(r["completed_ok"] for r in results) / EDGE_ARM_S
        row["agg_ok_per_s_1"], row["agg_ok_per_s_2"] = agg1, agg2
        row["scaling_2x"] = agg2 / agg1 if agg1 else None
        require(row["one_replica"]["verified"] > 0 and
                all(r["verified"] > 0 for r in row["two_replicas"]),
                f"edge_replicas: a replica verified no read {row}")
        # SIGKILL replica0: the supervisor restarts it, and it certifies
        # the frontier of the moment again
        top = val.call("status")["latest_block_height"]
        rep0 = JSONRPCClient(reps[0].rpc_address, timeout=5.0)
        t_kill = time.perf_counter()
        d.kill("replica0")

        def recertified(c):
            return (d.restarts.get("replica0", 0) >= 1 and
                    c.call("status")["edge"]["certified_height"] >= top)
        d.wait(lambda c: recertified(rep0),
               min(120.0, left("edge restart")),
               "replica0 did not certify again after its restart",
               kind="replica")
        row["restart_to_certified_s"] = time.perf_counter() - t_kill
        require(not d.dead, f"edge_replicas: dead processes {d.dead}")
    finally:
        d.stop(cleanup=False)
        v.close()
    lines = {s.name: _proc_kernel_lines(
        os.path.join(s.home, "node.log"),
        "node" if s.kind == "validator" else "replica") for s in d.specs}
    shutil.rmtree(out, ignore_errors=True)
    launches = _sum_launches(ln for ls in lines.values() for ln in ls)
    row["process_launches"] = {n: [ln["launches"] for ln in ls]
                               for n, ls in lines.items()}
    row["client_launches"] = dict(ladder.launches)
    row["launches"] = launches
    row["card"] = card
    require(all(lines.values()), f"edge_replicas: a process printed no "
            f"kernel line {[n for n, ls in lines.items() if not ls]}")
    if on_card:
        for n, ls in lines.items():
            require(sum(ln["launches"]["verify"] for ln in ls) > 0,
                    f"edge_replicas: {n} never launched B1")
    emit(row)
    return launches


def _raise_nofile() -> None:
    """bench.py's bench_load_json: the open-file limit up to 16384 (the
    fleet's 1,500 sockets here and in the shard-set process)."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = max(soft, min(hard, 16384))
    if soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))


def _load_knee(card: str, device: str, left) -> dict:
    """18c (see the module docstring); returns its reading."""
    from tendermint_tpu_torch.serving import Deployment, Topology
    from tendermint_tpu_torch.serving.loadgen import (OpenLoopFleet,
                                                      default_mix,
                                                      find_knee, sweep)
    left("load_knee")
    _raise_nofile()
    topo = Topology(kind="shardset", n_shards=2, max_seconds=SERVE_WALL_S,
                    env={"TM_CUDA_STATE_TREE": "on"}, device=device)
    out = tempfile.mkdtemp(prefix="load_knee-")
    d = Deployment(topo, out, max_restarts=0)
    fleet = None
    row = {"phase": "load_knee", "shards": 2, "rate_s": KNEE_RATE_S}
    _zero_launches()
    d.start()
    try:
        d.wait(lambda c: bool(c.call("shards")["chains"]),
               min(90.0, left("front door")), "front door did not come up")
        _prime_keys(d.clients()[0], EDGE_KEYS)
        fleet = OpenLoopFleet("127.0.0.1", d.specs[0].rpc_port, seed=17)
        row["conns"] = fleet.connect(KNEE_CONNS)
        row["subscribers"] = fleet.subscribe(KNEE_SUBS,
                                             "tm.event = 'NewBlock'")
        row["shed_conns_at_connect"] = fleet.shed_conns
        left("load_knee sweep")
        points = sweep(fleet, list(KNEE_RATES), KNEE_RATE_S,
                       default_mix(EDGE_KEYS))
        knee = find_knee(points, p99_slo_ms=KNEE_SLO_MS)
        row["curve"] = [_point(p) for p in points]
        row["knee_rate"] = knee["offered_rate"] if knee else None
        row["knee"] = _point(knee) if knee else None
        # a knee: the first rate within find_knee's service level
        require(knee is not None,
                f"load_knee: the front door missed the service level "
                f"(goodput >= 0.85, p99 <= {KNEE_SLO_MS} ms) at "
                f"{KNEE_RATES[0]}/s {row['curve']}")
        require(all(p["events"] > 0 for p in points),
                f"load_knee: a rate pushed no event {row['curve']}")
        require(not d.dead, f"load_knee: the shard-set process died "
                f"{d.dead}")
    finally:
        if fleet is not None:
            fleet.close()
        d.stop(cleanup=False)
    lines = _proc_kernel_lines(os.path.join(d.specs[0].home, "node.log"),
                               "shardset")
    shutil.rmtree(out, ignore_errors=True)
    require(lines, "load_knee: the shard-set process printed no kernel "
            "line")
    launches = _sum_launches(lines)
    row["launches"] = launches
    row["process"] = {k: lines[-1][k] for k in ("heights", "verifier",
                                                "coalescer", "device")}
    row["card"] = card
    emit(row)
    return launches


def phase_serving(card: str, device: str = "cuda") -> dict:
    """Phase 18 (see the module docstring): the shard curve in this
    process, the edge replicas and the knee sweep as port processes. A
    CPU rehearsal passes device="cpu": no launch is required."""
    on_card = device.startswith("cuda")
    t_phase = time.perf_counter()

    def left(what: str) -> float:
        rem = SERVE_WALL_S - (time.perf_counter() - t_phase)
        require(rem > 0, f"serving: out of wall time at {what}")
        return rem
    _node_libs()
    arms = []
    with _quiet_logs():
        for n in SHARD_ARMS:
            arms.append(_shard_arm(n, card, device, on_card, left))
    factors = [a["coalesce_factor"] or 0.0 for a in arms]
    require(factors[-1] > factors[0],
            f"shard_curve: the coalesce factor does not rise with the "
            f"shards {factors}")
    shard_launches = _sum_launches(arms)
    edge = _edge_replicas(card, device, on_card, left)
    knee = _load_knee(card, device, left)
    left("the end of phase 18")
    emit({"phase": "serving_summary",
          "wall_s": time.perf_counter() - t_phase,
          "wall_limit_s": SERVE_WALL_S,
          "coalesce_factors": dict(zip(SHARD_ARMS, factors)),
          "card": card})
    return {"shard_curve": shard_launches, "edge_replicas": edge,
            "load_knee": knee}


MESH_ARMS = ("off", "auto", "2", "4", "8")  # 19a's BatchVerifier(mesh=) arms
MESH_FORCE = 8            # logical devices laid over cuda:0 for the N arms
MESH_TAMPER = (137, 4242, 9001)  # BENCH_mesh.json's tampered lanes
MESH_REPS = 3             # timed verifies an arm, after a warm one
MESH_ROOT_WIDTHS = (2, 4, 8)
MESH_STEP = 2             # verify_step's shards (its root's levels cost
#                           launches a shard: 2 keeps it to ~2 s)
MESH_SYNC_BLOCKS = 200    # 19c's drain: phase 8's first blocks, one
#                           window of 12,800 signatures, two chunks
MESH_WINDOW_MESH = "4"    # 19c's base.verifier_mesh


@contextlib.contextmanager
def _mesh_env(**env):
    """The TM_CUDA_MESH* knobs set for the block, restored after; the
    Merkle plane's cached mesh is dropped on both sides so that it
    resolves under the knobs in force."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    merkle._mesh_state = None
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        merkle._mesh_state = None


def _mesh_items(commit_path):
    """The 10,000-validator commit's (pubkey, sign bytes, signature)
    items with MESH_TAMPER's signatures corrupted in R (s stays < L)."""
    vs, bid, commit = commit_path
    items, _ = vs.commit_verification_items(CHAIN, bid, HEIGHT, commit)
    return [(p, m, bytes([s[0] ^ 1]) + s[1:]) if i in MESH_TAMPER
            else (p, m, s) for i, (p, m, s) in enumerate(items)]


def _mesh_arm(spec: str, items, want, device, card: str, timer: list):
    """One BatchVerifier(mesh=spec) arm of 19a from a cold
    predecompression cache: a warm verify (each shard full, B1), a
    counted one (fill, B2; launches = shards x chunks, one mesh dispatch
    a chunk), then MESH_REPS timed ones (hit, B2)."""
    from tendermint_tpu_torch import telemetry
    _cold_cache()
    v = tverifier.BatchVerifier("cuda", device=device, mesh=spec,
                                coalesce="off")
    try:
        got = v.verify(items)
        shards = max(1, v.mesh_devices)
        chunks = -(-len(items) // tverifier.BATCH_CHUNK)
        d0 = telemetry.value("mesh_dispatch_total", {"kind": "verify"}) or 0
        before, mark = dict(ladder.launches), len(timer)
        got2 = v.verify(items)
        torch.cuda.synchronize()
        delta = {k: ladder.launches[k] - before[k] for k in before}
        dispatches = (telemetry.value("mesh_dispatch_total",
                                      {"kind": "verify"}) or 0) - d0
        kernel_ms = sum(_kernel_ms(timer[mark:]).values())
        walls = []
        for _ in range(MESH_REPS):
            t0 = time.perf_counter()
            v.verify(items)
            walls.append((time.perf_counter() - t0) * 1e3)
        gauge = telemetry.value("verifier_mesh_devices")
    finally:
        v.close()
    row = {"phase": "mesh_commit", "mesh": spec,
           "mesh_devices": v.mesh_devices, "min_bucket": v._min_bucket,
           "sigs": len(items), "chunks": chunks, "shards": shards,
           "launches": delta, "mesh_dispatches": dispatches,
           "kernel_ms": kernel_ms, "median_ms": float(np.median(walls)),
           "walls_ms": walls, "sigs_per_s": len(items) /
           (float(np.median(walls)) / 1e3), "card": card}
    emit(row)
    require(np.array_equal(got, want) and np.array_equal(got2, want),
            f"mesh_commit {spec}: verdicts differ from mesh off and the "
            f"oracle")
    require(delta["verify"] + delta["verify_pre"] == shards * chunks
            and delta["sign_rb"] == 0,
            f"mesh_commit {spec}: launches {delta}, want {shards} x "
            f"{chunks}")
    if spec == "auto":
        from tendermint_tpu_torch.parallel import mesh as pmesh
        n = pmesh.resolve_mesh_size(
            "auto", len(pmesh.logical_devices(device.type)))
        want_n = n if n >= 2 else 0
    else:
        want_n = int(spec) if spec.isdigit() else 0
    require(v.mesh_devices == want_n and gauge == v.mesh_devices,
            f"mesh_commit {spec}: mesh_devices {v.mesh_devices} (gauge "
            f"{gauge}), want {want_n}")
    require(dispatches == (chunks if v.mesh_devices >= 2 else 0),
            f"mesh_commit {spec}: {dispatches} mesh dispatches, want "
            f"{chunks if v.mesh_devices >= 2 else 0}")
    return row


def _mesh_commit(commit_path, device, card: str) -> dict:
    """19a: the commit through every BatchVerifier(mesh=) arm."""
    from tendermint_tpu_torch import telemetry
    items = _mesh_items(commit_path)
    t0 = time.perf_counter()
    oracle = np.array(tkeys.verify_many(items), np.bool_)
    oracle_ms = (time.perf_counter() - t0) * 1e3
    require(sorted(np.flatnonzero(~oracle).tolist()) == list(MESH_TAMPER),
            "mesh_commit: the oracle rejects other lanes than the "
            "tampered ones")
    occ0 = telemetry.value("mesh_shard_occupancy") or {"count": 0,
                                                       "sum": 0.0}
    timer: list = []
    inner = _time_launches(timer)
    _zero_launches()
    try:
        rows = []
        for spec in MESH_ARMS:
            if spec.isdigit():
                with _mesh_env(TM_CUDA_MESH_FORCE_DEVICES=MESH_FORCE):
                    rows.append(_mesh_arm(spec, items, oracle, device,
                                          card, timer))
            else:
                rows.append(_mesh_arm(spec, items, oracle, device, card,
                                      timer))
    finally:
        ladder._launch = inner
    launches = dict(ladder.launches)
    occ = telemetry.value("mesh_shard_occupancy")
    count = occ["count"] - occ0["count"]
    emit({"phase": "mesh_commit_summary", "launches": launches,
          "oracle_route": "openssl" if tkeys._ossl is not None else "table",
          "oracle_ms": oracle_ms, "occupancy_observations": count,
          "occupancy_mean": (occ["sum"] - occ0["sum"]) / max(1, count),
          "median_ms": {r["mesh"]: r["median_ms"] for r in rows},
          "card": card})
    sharded = sum((1 + MESH_REPS + 1) * r["chunks"] for r in rows
                  if r["mesh_devices"] >= 2)
    require(count == sharded, f"mesh_commit: {count} occupancy "
                              f"observations, want {sharded}")
    _require_launched(launches, VERIFY_KERNELS, "mesh commit")
    return launches


def _mesh_merkle(commit_path, device, card: str) -> dict:
    """19b: root_host of the commit's 10,000 sign bytes through the mesh
    at each width, held to root_plain and the native root; then
    verify_step (the sharded verify and root) on the same batch."""
    from tendermint_tpu_torch import telemetry
    from tendermint_tpu_torch.parallel import mesh as pmesh
    items = _mesh_items(commit_path)
    leaves = [m for _, m, _ in items]
    want = merkle.root_plain(leaves)
    native_root = native.merkle_root(leaves)
    require(native_root == want, "mesh_merkle: native root != root_plain")
    _zero_launches()
    roots = {}
    r0 = telemetry.value("merkle_roots_total", {"impl": "mesh"}) or 0
    d0 = telemetry.value("mesh_dispatch_total", {"kind": "merkle"}) or 0
    for k in MESH_ROOT_WIDTHS:
        with _mesh_env(TM_CUDA_MESH=k, TM_CUDA_MESH_FORCE_DEVICES=MESH_FORCE):
            t0 = time.perf_counter()
            got = merkle.root_host(leaves)
            ms = (time.perf_counter() - t0) * 1e3
            ndev = merkle._mesh_state[1]
        # the same call under "auto", with CUDA initialized and the
        # logical devices present: the native root
        with _mesh_env(TM_CUDA_MESH_FORCE_DEVICES=MESH_FORCE):
            n0 = telemetry.value("merkle_roots_total",
                                 {"impl": "native"}) or 0
            t0 = time.perf_counter()
            got_auto = merkle.root_host(leaves)
            native_ms = (time.perf_counter() - t0) * 1e3
            auto_native = (telemetry.value("merkle_roots_total",
                                           {"impl": "native"}) or 0) - n0
        roots[k] = {"ms": ms, "native_ms": native_ms, "devices": ndev,
                    "equal": got == want}
        require(ndev == k and got == want,
                f"mesh_merkle: the {k}-wide root differs or ran on "
                f"{ndev} devices")
        require(got_auto == want and auto_native == 1,
                f"mesh_merkle: under auto the root was not the native "
                f"one ({auto_native} native roots)")
    n_mesh = (telemetry.value("merkle_roots_total", {"impl": "mesh"})
              or 0) - r0
    n_disp = (telemetry.value("mesh_dispatch_total", {"kind": "merkle"})
              or 0) - d0
    require(n_mesh == len(MESH_ROOT_WIDTHS) == n_disp,
            f"mesh_merkle: merkle_roots_total{{impl=mesh}} +{n_mesh}, "
            f"mesh dispatches +{n_disp}")
    pk, rb, sb, hb, pre = ted.prepare_batch_bytes(*zip(*items))
    digests = merkle.pad_digests(np.frombuffer(
        b"".join(merkle.leaf_hash(m) for m in leaves),
        np.uint8).reshape(len(leaves), 32))
    with _mesh_env(TM_CUDA_MESH_FORCE_DEVICES=MESH_FORCE):
        step = pmesh.verify_step(pmesh.make_mesh(MESH_STEP, device.type))
        t0 = time.perf_counter()
        ok, root = step(pk, rb, sb, hb, digests, len(leaves))
        root = root.cpu().numpy().tobytes()
        step_ms = (time.perf_counter() - t0) * 1e3
    verdicts = ok[:len(items)] & pre
    launches = dict(ladder.launches)
    emit({"phase": "mesh_merkle", "leaves": len(leaves), "roots": roots,
          "mesh_roots": n_mesh, "verify_step_ms": step_ms,
          "verify_step_rejected": np.flatnonzero(~verdicts).tolist(),
          "launches": launches, "card": card})
    require(root == want and sorted(np.flatnonzero(~verdicts).tolist())
            == list(MESH_TAMPER),
            "mesh_merkle: verify_step's verdicts or root differ")
    require(launches["verify"] + launches["verify_pre"] == MESH_STEP,
            f"mesh_merkle: verify_step launched {launches}, want "
            f"{MESH_STEP} shards")
    return launches


def _mesh_drain(gen, recv, verifier) -> tuple:
    """A fresh node drains `recv` (its sentinel last) through the window
    engine; -> (store height, app hash, state bytes)."""
    reactor, ss, bs, exe = _sync_node(gen, verifier)
    _instant_peers(reactor, {"peer": recv})
    try:
        reactor.pool.make_next_requests()
        for _ in range(4 * len(recv)):
            if reactor.state.last_block_height >= len(recv) - 1:
                break
            if not reactor._sync_window():
                reactor.pool.make_next_requests()
    finally:
        reactor.stop()
    return (bs.height(), reactor.state.app_hash,
            tenc.cdumps(reactor.state.to_obj()))


def _mesh_window(chain, device, card: str) -> dict:
    """19c: MESH_SYNC_BLOCKS of phase 8's chain drained by a verifier that
    node.build_verifier builds from base.verifier_mesh, and by an
    unsharded one; equal heights, app hashes and states."""
    from tendermint_tpu_torch.config import BaseConfig
    from tendermint_tpu_torch.node import build_verifier
    gen, wire = chain
    recv = [Block.from_bytes(raw) for raw in wire[:MESH_SYNC_BLOCKS + 1]]
    plain = tverifier.BatchVerifier("auto", device=device)
    t0 = time.perf_counter()
    want = _mesh_drain(gen, recv, plain)
    plain_s = time.perf_counter() - t0
    plain.close()
    _zero_launches()
    with _mesh_env(TM_CUDA_MESH_FORCE_DEVICES=MESH_FORCE):
        v, owned = build_verifier(
            BaseConfig(verifier_mesh=MESH_WINDOW_MESH), device=device)
        chunked = []    # (real, padded) of each dispatch's chunks
        inner_chunks = v._chunks

        def chunks(n, *args):
            out = inner_chunks(n, *args)
            chunked.append([(hi - lo, ted._bucket(hi - lo,
                                                  min_size=v._min_bucket))
                            for lo, hi, _ in out])
            return out
        v._chunks = chunks
        try:
            t0 = time.perf_counter()
            got = _mesh_drain(gen, recv, v)
            mesh_s = time.perf_counter() - t0
        finally:
            v.close()
    launches = dict(ladder.launches)
    emit({"phase": "mesh_window", "blocks": MESH_SYNC_BLOCKS,
          "mesh": MESH_WINDOW_MESH, "mesh_devices": v.mesh_devices,
          "owned": owned, "height": got[0], "app_hash": got[1].hex(),
          "unsharded_s": plain_s, "sharded_s": mesh_s,
          "chunks_max": max(map(len, chunked), default=0),
          "launches": launches, "card": card})
    require(owned and v.mesh_devices == int(MESH_WINDOW_MESH),
            f"mesh_window: the verifier ran on {v.mesh_devices} devices")
    require(got == want and got[0] == MESH_SYNC_BLOCKS
            and got[1] == recv[MESH_SYNC_BLOCKS].header.app_hash,
            "mesh_window: the sharded drain differs from the unsharded")
    require(launches["verify"] + launches["verify_pre"] > 0,
            f"mesh_window: no verify kernel launched: {launches}")
    require(any(len(c) >= 2 and any(r < p for r, p in c) for c in chunked),
            f"mesh_window: no window dispatch of two or more chunks with "
            f"a padded one: {chunked}")
    return launches


def phase_mesh(card: str, commit_path, chain, device) -> dict:
    """Phase 19 (see the module docstring): the device mesh over logical
    devices laid on the one card."""
    from tendermint_tpu_torch import telemetry
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    t0 = time.perf_counter()
    try:
        out = {"mesh_commit": _mesh_commit(commit_path, device, card),
               "mesh_merkle": _mesh_merkle(commit_path, device, card),
               "mesh_window": _mesh_window(chain, device, card)}
    finally:
        telemetry.set_enabled(was)
    emit({"phase": "mesh_summary", "wall_s": time.perf_counter() - t0,
          "card": card})
    return out


# ------------------------------------- phase 20: the operator's env surface

KNOB_SIGS = 100           # 20a's commit: phase 3's first 100 keys
KNOB_TAMPER = (17, 73)    # 20a's lanes with a flipped signature byte
#: the verifier knobs 20a sets, every one cleared outside its arm
KNOB_NAMES = ("TM_CUDA_VERIFIER", "TM_CUDA_AUTO_THRESHOLD",
              "TM_CUDA_COALESCE", "TM_CUDA_COALESCE_WAIT_MS",
              "TM_CUDA_COALESCE_MAX_BATCH", "TM_TPU_VERIFIER",
              "TM_TPU_AUTO_THRESHOLD", "TM_TPU_COALESCE")
#: 20a's arms: (name, env, verify calls, B1/B2 launches wanted)
KNOB_ARMS = (
    ("defaults", {}, 1, False),
    ("cuda_threshold_64", {"TM_CUDA_AUTO_THRESHOLD": "64",
                           "TM_CUDA_COALESCE": "off"}, 2, True),
    ("tpu_threshold_64", {"TM_TPU_AUTO_THRESHOLD": "64"}, 1, False),
    ("cuda_verifier_python", {"TM_CUDA_VERIFIER": "python"}, 1, False),
)
#: 20b: each tool, its input kind, its output arguments
KNOB_TOOLS = (("trace_merge", "timeline", ["--out", "merged.json"]),
              ("slo_report", "slo", ["--report", "report.json"]),
              ("profile_merge", "profile", ["--out", "merged.collapsed"]))


@contextlib.contextmanager
def _knob_env(values: dict):
    """KNOB_NAMES cleared and `values` set for the block, restored
    after."""
    saved = {k: os.environ.get(k) for k in KNOB_NAMES}
    for k in KNOB_NAMES:
        os.environ.pop(k, None)
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _knob_items(keys) -> list:
    """(pubkey, sign bytes, signature) of a KNOB_SIGS-validator commit of
    `keys`, with a flipped signature byte in each KNOB_TAMPER lane."""
    vs, _, commit = build_commit(keys[:KNOB_SIGS])
    items = []
    for idx, vote in enumerate(commit.precommits):
        sig = _flip(vote.signature, 7) if idx in KNOB_TAMPER \
            else vote.signature
        items.append((vs.validators[idx].pubkey, vote.sign_bytes(CHAIN),
                      sig))
    return items


def _knob_arm(name: str, env: dict, calls: int, want: bool, items,
              plain, on_card: bool, card: str) -> dict:
    """One arm of 20a: node.build_verifier of a default BaseConfig under
    `env`, then `calls` verifies of `items` from a cold predecompression
    cache; verdicts held to the plain version's; B1/B2 launches counted
    (the ladder's counts and the launch timer's events) and wanted or
    not."""
    from tendermint_tpu_torch.config import BaseConfig
    from tendermint_tpu_torch.node import build_verifier
    timed, saved, ref = [], [], None
    with _knob_env(env):
        # a CPU rehearsal builds each arm's verifier on the CPU
        v, owned = build_verifier(BaseConfig(),
                                  device=None if on_card else "cpu")
        try:
            _cold_cache()
            if on_card:
                saved = _patched(_in_run_timer_patches(timed))
                ref = torch.cuda.Event(enable_timing=True)
                ref.record()
            _zero_launches()
            walls = []
            try:
                for _ in range(calls):
                    t0 = time.perf_counter()
                    got = v.verify(items)
                    walls.append(time.perf_counter() - t0)
                    require(np.array_equal(got, plain),
                            f"knobs {name}: verdicts differ from the plain "
                            f"version's at lanes "
                            f"{np.flatnonzero(got != plain)[:8].tolist()}")
            finally:
                _restore(saved)
            launches = dict(ladder.launches)
            settings = {"backend": v.backend,
                        "auto_threshold": v.auto_threshold,
                        "coalesce": v.coalesce, "owned": owned}
        finally:
            if owned:
                v.close()
    b12 = launches["verify"] + launches["verify_pre"]
    dev_t = (_in_run_device_time(timed, ref, sum(walls))["by_kernel"]
             if on_card else {})
    require(launches["sign_rb"] == 0, f"knobs {name}: B3 launched")
    if on_card:
        require(len(timed) == b12, f"knobs {name}: {len(timed)} timed "
                f"launches against the counts {launches}")
        require((b12 > 0) == want, f"knobs {name}: B1/B2 launches "
                f"{launches}, wanted {'some' if want else 'none'}")
    out = {"arm": name, "env": env, "settings": settings,
           "launches": launches, "walls_ms": [w * 1e3 for w in walls],
           "event_ms": {k: r["event_ms"] for k, r in dev_t.items()},
           "refused_lanes": np.flatnonzero(~got).tolist()}
    emit({"phase": "knobs_route", **out, "card": card})
    return out


def _knob_tools(inputs: dict, card: str) -> dict:
    """20b: phase 15's four dumps of each kind, written to files, through
    `python -m tendermint_tpu_torch.scripts.<tool> --files ...`; each
    output equals the in-process merge of the same dumps."""
    from tendermint_tpu_torch.procnet import child_env
    from tendermint_tpu_torch.scripts import profile_merge, slo_report, \
        trace_merge
    from tendermint_tpu_torch.telemetry import merge as tmerge
    from tendermint_tpu_torch.telemetry import profile as tprofile
    from tendermint_tpu_torch.telemetry import slo as tslo
    select = {"trace_merge": trace_merge.select,
              "slo_report": slo_report.select,
              "profile_merge": profile_merge.select}
    root = tempfile.mkdtemp(prefix="knob-tools-")
    out = {}
    try:
        for tool, kind, args in KNOB_TOOLS:
            docs = inputs[kind]
            names = []
            for i, doc in enumerate(docs):
                names.append(f"{kind}{i}.json")
                with open(os.path.join(root, names[-1]), "w") as f:
                    json.dump(doc, f)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"tendermint_tpu_torch.scripts.{tool}",
                 "--files", *names, *args], cwd=root, env=child_env(),
                capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            require(proc.returncode == 0, f"knobs {tool} exited "
                    f"{proc.returncode}: {proc.stderr[-2000:]}")
            with open(os.path.join(root, args[1]), "rb") as f:
                got = f.read()
            # the in-process merge of the dumps the tool's own selection
            # keeps (a node without data is skipped)
            live, _ = select[tool](docs)
            if tool == "trace_merge":
                want = json.dumps(tmerge.merge_report(live)["perfetto"])
                same = got == want.encode()
            elif tool == "slo_report":
                merged = tslo.merge_snapshots(live)
                # the report's merge, and its printed table byte for byte
                same = json.loads(got)["merged"] == json.loads(
                    json.dumps(merged)) and proc.stdout == (
                    slo_report.render(live, merged)
                    + f"[slo_report] full report -> {args[1]}\n")
            else:
                want = tprofile.merge_dumps(live)["collapsed"] + "\n"
                same = got == want.encode()
            require(live, f"knobs {tool}: no node's dump has data")
            require(same, f"knobs {tool}: its output differs from the "
                    f"in-process merge of the same {len(docs)} dumps")
            out[tool] = {"files": len(docs), "merged": len(live),
                         "output_bytes": len(got),
                         "wall_s": wall,
                         "stdout_head": proc.stdout.splitlines()[:2]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "knobs_tools", **out, "card": card})
    return out


def phase_knobs(card: str, keys, tool_inputs: dict,
                device: str = "cuda") -> dict:
    """Phase 20 (see the module docstring): the verifier's knobs deciding
    the route on a KNOB_SIGS-signature commit of phase 3's keys, and the
    three report tools on phase 15's dumps. Returns the launches of the
    arms."""
    on_card = device.startswith("cuda")
    t0 = time.perf_counter()
    items = _knob_items(keys)
    plain = ted.verify_batch([it[0] for it in items],
                             [it[1] for it in items],
                             [it[2] for it in items], device="cpu")
    require(np.flatnonzero(~plain).tolist() == list(KNOB_TAMPER),
            f"knobs: the plain version refuses {np.flatnonzero(~plain)}")
    arms = [_knob_arm(name, env, calls, want, items, plain, on_card, card)
            for name, env, calls, want in KNOB_ARMS]
    tools = _knob_tools(tool_inputs, card)
    launches = {k: sum(a["launches"][k] for a in arms)
                for k in ladder.launches}
    emit({"phase": "knobs_summary", "launches": launches,
          "arms": {a["arm"]: a["launches"] for a in arms},
          "tools": sorted(tools), "wall_s": time.perf_counter() - t0,
          "card": card})
    return launches


@contextlib.contextmanager
def _serial_commit_path():
    """Phases 9 and 10 on the serial commit path (pipeline "off"), the
    path of their earlier runs: run A and run B of phase 9 must
    give the same blocks, and the precompute's header stamp comes from
    a worker thread's read of the stepped clock."""
    tpipeline.configure("off")
    try:
        yield
    finally:
        tpipeline.configure("auto")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    walls: dict = {}
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:
        """The seconds since the previous lap, as the phase `name`'s."""
        now = time.perf_counter()
        walls[name] = now - t_lap[0]
        t_lap[0] = now
    # the kernels and host libraries build, and the children's bytecode
    # is compiled, while phases 3 and 4's keys and commits are made
    warm = _share_bytecode()
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(phase_build)
        prepared = prepare_commits()
        rate, ptxas = built.result()
    warm_err = warm.communicate(timeout=300)[1]
    require(warm.returncode == 0, f"the bytecode warm-up failed:\n{warm_err}")
    lap("build")
    kernels = phase_kernels(device, rate)
    lap("kernels")
    commit_launches, keys, commit_path = phase_main(card, prepared=prepared)
    lap("commit")
    mixed_launches = phase_mixed(card, keys, prepared["mixed"])
    lap("mixed")
    kernels.update(phase_sign_kernel(device, rate))
    lap("sign_kernel")
    lite_launches = phase_lite(card)
    lap("lite")
    block_launches = phase_block(card, keys, commit_path, device)
    lap("block")
    sync_launches, sync_chain = phase_sync(card, device)
    lap("sync")
    with _serial_commit_path():
        consensus_launches = phase_consensus(card, device)
        lap("consensus")
        p2p_launches = phase_p2p(card, device)
        lap("p2p")
    procnet = phase_procnet(card)
    lap("procnet")
    procnet_loop = phase_procnet_loop(card, procnet=procnet)
    lap("procnet_loop")
    procnet_pipeline = phase_procnet_pipeline(card, loop=procnet_loop)
    sweep_launches = phase_crash_sweep(card)
    lap("pipeline")
    ss_chain_launches = phase_statesync_chain(card, device)
    ss_wide_launches = phase_statesync_wide(card, commit_path, device)
    procnet_ss = phase_procnet_statesync(card)
    recovery_launches = phase_recovery_sweep(card)
    lap("recovery")
    procnet_tel = phase_procnet_telemetry(card,
                                          pipeline_run=procnet_pipeline)
    lap("telemetry")
    procnet_st = phase_procnet_statetree(card)
    lap("statetree")
    chaos = phase_chaos(card)
    lap("chaos")
    serving = phase_serving(card)
    lap("serving")
    mesh = phase_mesh(card, commit_path, sync_chain, device)
    lap("mesh")
    knob_launches = phase_knobs(card, keys, procnet_tel["tool_inputs"])
    lap("knobs")
    emit({"phase": "script_walls", "seconds": walls,
          "total_s": sum(walls.values()), "card": card})
    table = []
    for name, info in KERNELS.items():
        table.append({
            "name": info["name"], "route": "cuda",
            "source": "tendermint_tpu_torch/csrc/ladder.cu",
            "replaces": info["replaces"], "status": "ported",
            "checked": True, "launches": lite_launches[name],
            "launches_by_path": {"commit_10k": commit_launches[name],
                                 "mixed_commit": mixed_launches[name],
                                 "lite_chain": lite_launches[name],
                                 "block_height": block_launches[name],
                                 "fast_sync": sync_launches[name],
                                 "consensus": consensus_launches[name],
                                 "p2p": p2p_launches[name],
                                 "procnet": procnet["launches"][name],
                                 "procnet_loop":
                                     procnet_loop["launches"][name],
                                 "procnet_pipeline":
                                     procnet_pipeline["launches"][name],
                                 "crash_sweep": sweep_launches[name],
                                 "statesync_chain": ss_chain_launches[name],
                                 "statesync_wide": ss_wide_launches[name],
                                 "procnet_statesync":
                                     procnet_ss["launches"][name],
                                 "recovery_sweep": recovery_launches[name],
                                 "procnet_telemetry":
                                     procnet_tel["launches"][name],
                                 "procnet_telemetry_off":
                                     procnet_tel["off_launches"][name],
                                 "procnet_statetree":
                                     procnet_st["launches"][name],
                                 "statetree_sweep":
                                     procnet_st["sweep_launches"][name],
                                 "chaos_scale4":
                                     chaos["chaos_scale4"][name],
                                 "chaos_classic":
                                     chaos["chaos_classic"][name],
                                 "chaos_scale32":
                                     chaos["chaos_scale32"][name],
                                 "wire_chaos": chaos["wire_chaos"][name],
                                 "shard_curve":
                                     serving["shard_curve"][name],
                                 "edge_replicas":
                                     serving["edge_replicas"][name],
                                 "load_knee": serving["load_knee"][name],
                                 "mesh_commit": mesh["mesh_commit"][name],
                                 "mesh_merkle": mesh["mesh_merkle"][name],
                                 "mesh_window": mesh["mesh_window"][name],
                                 "knobs": knob_launches[name]},
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
            "bound_ms": kernels[name]["bound_ms"],
            "bound_by": kernels[name]["bound_by"],
            "library_ms": None, "shape_n": kernels[name]["n"],
            "sweep_ms": kernels[name]["sweep_ms"], "ptxas": ptxas[name]})
    emit({"kernels": table, "not_ported": [], "card": card})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
