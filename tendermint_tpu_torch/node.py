"""Node — assembles stores, app conns, handshake, WAL, consensus, the
reactor stack and the p2p switch: the port's copy of
`tendermint_tpu/node.py` (node/node.go:121-353).

With `with_p2p=True` the node runs the full networking stack: mempool /
evidence / blockchain (fast-sync) / consensus reactors + optional PEX on
an encrypted switch, listening on config.p2p.laddr and dialing seeds and
persistent peers. Without it, the node is a self-contained single-process
validator (the in-process test/tooling mode).

Every signature check of the node (handshake replay, consensus votes,
fast-sync windows, evidence) goes through one BatchVerifier built from
`config.base.verifier_backend`, `verifier_mesh` (TM_CUDA_MESH wins) and
`verifier_coalesce*` on `device`:
with every one of them at its default and no device, the process-wide
default verifier, as the JAX node shares its own. `verifier=` hands the
node a verifier its caller owns (a ShardSet's one verifier for all its
shards): the node uses it for every path and never closes it. Without a
device and without a card, any backend but "python" raises
(utils/device.resolve): the node never moves to the CPU quietly.

Socket plane: with `config.base.reactor` "auto" or "loop" (the default,
as in the JAX node) the node runs ONE ReactorLoop thread,
`tm-reactor-loop-<pid>`, that owns every peer socket, the reactors'
per-peer gossip tasks and the async RPC front door's connections; it is
created when the switch or the RPC server first needs it. `loop=`
injects a loop the caller owns (and stops); a loop the node created is
stopped after the switch. "threads" runs the thread-per-connection plane
and the threaded RPC server.

The pipelined block hot path follows `config.base.pipeline` ("auto", on,
by default, as in the JAX node): the node configures `pipeline` before
it builds its ConsensusState.

The recovery plane follows `base.snapshot_interval`, `snapshot_keep`,
`snapshot_chunk_kb`, `retain_heights` and `state_sync`, each under its
knob (TM_CUDA_SNAPSHOT_INTERVAL etc., env over config; all off by
default; an in-memory node has no home for snapshot files and keeps it
off): a SnapshotStore under `<db_dir>/snapshots`, a torn state-sync
restore under `<db_dir>/statesync` resumed before the handshake, the
handshake's local-snapshot seam, a SnapshotManager on the commit path's
post-commit hooks and on the fast-sync apply path, and with p2p the
StateSyncReactor on channel 0x60 (advertised only with the plane on),
whose restore holds the fast-sync gate on a node at height 0.

The observability planes are wired as in the JAX node, before anything
instrumented runs: the metric registry (`base.telemetry`, on, and
`telemetry_namespace`), the causal plane (`base.trace`; the node id is
the p2p identity once the switch exists, and the keepalive RTTs ride its
dumps), the sampling profiler (`base.prof`, `prof_hz`), the queue
observatory (`base.queue_watch`, on) and the SLO plane (`base.slo`,
`slo_sample`); each `TM_CUDA_*` knob wins over its key. At start the
stall detector runs when the trace plane is on and TM_CUDA_TRACE_STALL_S
is above 0 (`_on_stall` writes the flight-recorder file), the profiler
starts when it is on, and the queue watcher whenever the observatory is.
The planes are process-global: in-process nets share them.

With `config.rpc.grpc_laddr` set the node serves the gRPC BroadcastAPI
(rpc/grpc_service.py) on the RPC core, whether or not it serves JSON-RPC.
A kvstore app the node builds itself hashes its state tree (with
TM_CUDA_STATE_TREE on) on the node's `device`.

The chaos plane's link faults follow `base.chaos` and `chaos_seed`
("off" by default; TM_CUDA_CHAOS wins): the node configures the plane
before its switch wraps any link (p2p/switch.py).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from tendermint_tpu_torch import pipeline, telemetry
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.config import Config, _mode_on, resolve_reactor
from tendermint_tpu_torch.consensus.replay import Handshaker, catchup_replay
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import TimeoutTicker
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage import (WAL, BlockStore, SnapshotManager,
                                          SnapshotStore, StateStore, open_db)
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile
from tendermint_tpu_torch.utils import knobs
from tendermint_tpu_torch.utils.log import tm_logger


def _parse_laddr(laddr: str) -> tuple:
    """tcp://host:port -> (host, port)."""
    s = laddr.split("://", 1)[-1]
    host, _, port = s.rpartition(":")
    return host or "0.0.0.0", int(port)


def build_verifier(base, device=None):
    """-> (verifier, owned) for a BaseConfig: the process-wide default
    verifier when the resolved settings (each knob over its config
    field: TM_CUDA_VERIFIER, TM_CUDA_MESH, TM_CUDA_COALESCE,
    TM_CUDA_COALESCE_WAIT_MS, TM_CUDA_COALESCE_MAX_BATCH, and
    TM_CUDA_AUTO_THRESHOLD, which has none) are at their defaults and
    there is no device, else a BatchVerifier of its own. Builds the
    kernels and the host prep now on a card, so that no verify call of
    the node pays a build."""
    from tendermint_tpu_torch.models import verifier as _verifier
    backend = knobs.knob_str("TM_CUDA_VERIFIER",
                             config=base.verifier_backend, default="auto")
    mesh = knobs.knob_str("TM_CUDA_MESH", config=base.verifier_mesh,
                          default="auto")
    coalesce = knobs.knob_str("TM_CUDA_COALESCE",
                              config=str(base.verifier_coalesce),
                              default="auto")
    wait_ms = knobs.knob_float("TM_CUDA_COALESCE_WAIT_MS",
                               config=base.verifier_coalesce_wait_ms,
                               default=2.0)
    max_batch = knobs.knob_int("TM_CUDA_COALESCE_MAX_BATCH",
                               config=base.verifier_coalesce_max_batch,
                               default=0)
    threshold = knobs.knob_int("TM_CUDA_AUTO_THRESHOLD", default=128)
    settings = (backend, mesh, coalesce, wait_ms, max_batch, threshold)
    if settings == ("auto", "auto", "auto", 2.0, 0, 128) and device is None:
        v, owned = _verifier.default_verifier(), False
    else:
        v, owned = _verifier.BatchVerifier(
            backend, device=device, mesh=mesh, auto_threshold=threshold,
            coalesce=coalesce, coalesce_wait_ms=wait_ms,
            coalesce_max_batch=max_batch), True
    prebuild(v)
    return v, owned


def prebuild(verifier) -> None:
    """On a card, build the kernels and the host prep of `verifier` now,
    so that no verify call pays a build."""
    if verifier.device is not None and verifier.device.type == "cuda":
        from tendermint_tpu_torch import native
        from tendermint_tpu_torch.ops import _build
        if not native.disabled():
            native.module()
        _build.ladder_lib()


class Node:
    def __init__(self, config: Config, gen_doc: GenesisDoc,
                 priv_validator=None, app=None, client_creator=None,
                 mempool=None, evidence_pool=None, in_memory=False,
                 with_p2p=False, fast_sync=False, with_rpc=False,
                 wal_readonly=False, device=None, loop=None,
                 verifier=None):
        # logging is configured once at the CLI entry point; the chain id
        # rides as a logger field
        self.logger = tm_logger("node", chain=gen_doc.chain_id)
        self.config = config
        self.gen_doc = gen_doc
        # the socket plane, validated now; the loop itself is created
        # when the switch or the RPC listener first needs one
        self.reactor = resolve_reactor(config.base.reactor)
        self.loop = loop
        # chaos plane knobs (env TM_CUDA_CHAOS wins inside resolve();
        # "off" keeps every link on the existing code)
        from tendermint_tpu_torch import chaos as _chaos
        _chaos.configure(mode=config.base.chaos,
                         seed=config.base.chaos_seed)
        # the pipelined hot path ("off": the serial path)
        pipeline.configure(mode=config.base.pipeline)
        # Merkle roots shard only at an explicit verifier_mesh N
        # (TM_CUDA_MESH wins inside ops/merkle.py)
        from tendermint_tpu_torch.ops import merkle as _merkle
        _merkle.configure_mesh(config.base.verifier_mesh)
        self._owns_loop = loop is None

        # telemetry wiring BEFORE any instrumented subsystem runs (the
        # handshake below already drives the verifier); the env knob
        # TM_CUDA_TELEMETRY wins over the config key inside configure()
        telemetry.configure(enabled=config.base.telemetry,
                            namespace=config.base.telemetry_namespace)
        # causal tracing plane (env TM_CUDA_TRACE wins inside enabled();
        # off = untraced wire bytes + zero span recording). The node id
        # is refined to the p2p identity in _build_p2p.
        from tendermint_tpu_torch.telemetry import causal as _causal
        _causal.configure(mode=config.base.trace)
        if not _causal.node():
            _causal.set_node(config.base.moniker or f"pid{os.getpid()}")
        self._stall_detector = None
        # runtime introspection plane (env wins inside each resolve):
        # sampling profiler + queue observatory, both process-global —
        # several in-process nodes share one sampler and one catalog
        from tendermint_tpu_torch.telemetry import profile as _profile
        from tendermint_tpu_torch.telemetry import queues as _queues
        _profile.configure(mode=config.base.prof, hz=config.base.prof_hz)
        _queues.configure(mode=config.base.queue_watch)
        # tx-lifecycle SLO plane (env TM_CUDA_SLO / _SLO_SAMPLE win
        # inside the resolvers; off = one cached flag check per entry
        # point). Process-global like the profiler: stage stamps are
        # first-wins idempotent across in-process nodes.
        from tendermint_tpu_torch.telemetry import slo as _slo
        _slo.configure(mode=config.base.slo, sample=config.base.slo_sample)

        def db_path(name):
            if in_memory:
                return None
            p = config.path(config.base.db_dir)
            os.makedirs(p, exist_ok=True)
            return os.path.join(p, name + ".db")

        self.block_store = BlockStore(open_db(db_path("blockstore")))
        self.state_store = StateStore(open_db(db_path("state")))

        # the recovery plane's settings (each knob over its config field);
        # in-memory nodes have no home to keep snapshot files in, so the
        # plane stays off there
        base = config.base
        self._snap_interval = knobs.knob_int(
            "TM_CUDA_SNAPSHOT_INTERVAL", config=base.snapshot_interval)
        self._snap_keep = knobs.knob_int(
            "TM_CUDA_SNAPSHOT_KEEP", config=base.snapshot_keep, default=2)
        self._snap_chunk_kb = knobs.knob_int(
            "TM_CUDA_SNAPSHOT_CHUNK_KB", config=base.snapshot_chunk_kb,
            default=256)
        self._retain_heights = knobs.knob_int(
            "TM_CUDA_RETAIN_HEIGHTS", config=base.retain_heights)
        self._state_sync = knobs.knob_bool(
            "TM_CUDA_STATE_SYNC", config=_mode_on(base.state_sync))
        self.snapshot_store = None
        self._statesync_dir = ""
        if not in_memory:
            data_dir = config.path(base.db_dir)
            self.snapshot_store = SnapshotStore(
                os.path.join(data_dir, "snapshots"))
            self._statesync_dir = os.path.join(data_dir, "statesync")
        else:
            self._snap_interval = 0
            self._retain_heights = 0
            self._state_sync = False

        if client_creator is None:
            if app is None:
                from tendermint_tpu_torch.abci.apps import KVStoreApp
                app = KVStoreApp(device=device)
            client_creator = local_client_creator(app)
        self.app = app
        self.app_conns = AppConns(client_creator)

        # verification plane, built before the first verification path
        # (handshake replay) so every path of the node uses it; ownership
        # is recorded now, so that a stop in any order never closes a
        # verifier the node was handed
        if verifier is not None:
            self.verifier, self._owns_verifier = verifier, False
        else:
            self.verifier, self._owns_verifier = build_verifier(
                config.base, device)

        # a state-sync restore a crash tore mid-apply is repaired here,
        # before the handshake reads the stores (the apply is
        # idempotent; incomplete downloads are left for the reactor)
        #: the State a torn restore's resume installed, else None
        self.resumed_restore = None
        if self._statesync_dir and os.path.isdir(self._statesync_dir) \
                and self.app is not None:
            from tendermint_tpu_torch.statesync import resume_pending_restore
            self.resumed_restore = resume_pending_restore(
                self._statesync_dir, self.block_store, self.state_store,
                self.snapshot_store, self.app, gen_doc.chain_id,
                verifier=self.verifier, logger=self.logger)

        # ABCI handshake: sync app with stores (consensus/replay.go:211)
        stored = self.state_store.load()
        #: the block store's and the state's heights the handshake found
        self.handshake_heights = (
            self.block_store.height(),
            stored.last_block_height if stored is not None else 0)
        t0 = time.perf_counter()
        handshaker = Handshaker(self.state_store, self.block_store, gen_doc,
                                verifier=self.verifier,
                                snapshot_store=self.snapshot_store,
                                app=self.app)
        state = handshaker.handshake(self.app_conns)
        #: the handshake's wall and the blocks it replayed into the app
        self.handshake_s = time.perf_counter() - t0
        self.handshake_blocks = handshaker.n_blocks

        if mempool is None:
            from tendermint_tpu_torch.mempool import Mempool
            mempool = Mempool(
                self.app_conns.mempool, config=config.mempool,
                height=state.last_block_height,
                wal_dir=(None if in_memory or
                         not getattr(config.mempool, "wal_dir", "")
                         else config.path(config.mempool.wal_dir)))
            # the tx WAL just replayed may hold the last stored block's
            # txs (a crash between its save and the mempool's update); a
            # restarted proposer would commit them twice. A store a
            # state-sync restore bootstrapped holds no block at its top.
            top = self.block_store.height()
            last = self.block_store.load_block(top) if top > 0 else None
            if last is not None:
                mempool.drop_committed(last.data.txs)
        self.mempool = mempool

        if evidence_pool is None:
            from tendermint_tpu_torch.evidence import (EvidencePool,
                                                       EvidenceStore)
            evidence_pool = EvidencePool(
                EvidenceStore(open_db(db_path("evidence"))), state,
                state_store=self.state_store, verifier=self.verifier)
        self.evidence_pool = evidence_pool

        self.event_bus = EventBus()
        self.block_exec = BlockExecutor(
            self.state_store, self.app_conns.consensus,
            mempool=mempool, evidence_pool=evidence_pool,
            event_bus=self.event_bus, verifier=self.verifier)

        if in_memory:
            from tendermint_tpu_torch.storage.wal import NilWAL
            self.wal = NilWAL()
        else:
            self.wal = WAL(config.path(config.consensus.wal_path),
                           light=config.consensus.wal_light,
                           readonly=wal_readonly)

        self.consensus = ConsensusState(
            config.consensus, state, self.block_exec, self.block_store,
            mempool=mempool, evidence_pool=evidence_pool,
            priv_validator=priv_validator, wal=self.wal,
            event_bus=self.event_bus, ticker_factory=TimeoutTicker)
        if hasattr(mempool, "txs_available_hook"):
            mempool.txs_available_hook = lambda: self.consensus.submit(
                {"type": "txs_available"})

        # recovery plane: interval snapshots, retention and pruning on
        # the commit path (and, below, on the fast-sync apply path)
        self.snapshots = None
        if self.snapshot_store is not None and \
                (self._snap_interval > 0 or self._retain_heights > 0):
            self.snapshots = SnapshotManager(
                self.snapshot_store, self.state_store, self.block_store,
                self.app, interval=self._snap_interval,
                keep=self._snap_keep,
                chunk_size=self._snap_chunk_kb * 1024,
                retain_heights=self._retain_heights)
            self.consensus.post_commit_hooks.append(
                self.snapshots.maybe_snapshot)

        # ------------------------------------------------ p2p reactor stack
        self.switch = None
        self.statesync_reactor = None
        self._statesync_gate = None
        self.fast_sync = fast_sync
        if with_p2p:
            self._build_p2p(state, fast_sync, in_memory)

        self.rpc_server = None
        self.rpc_core = None
        self.rpc_address = None
        self.with_rpc = with_rpc
        #: the gRPC BroadcastAPI server, when config.rpc.grpc_laddr is set
        self.grpc_server = None

        # tx indexer + service (node/node.go:294-320)
        from tendermint_tpu_torch.state.txindex import (
            IndexerService, KVTxIndexer, NullTxIndexer)
        if config.tx_index.indexer == "kv":
            tags = [t for t in config.tx_index.index_tags.split(",") if t]
            self.tx_indexer = KVTxIndexer(
                open_db(db_path("tx_index")), index_tags=tags,
                index_all_tags=config.tx_index.index_all_tags)
        else:
            self.tx_indexer = NullTxIndexer()
        self.indexer_service = IndexerService(self.tx_indexer,
                                              self.event_bus)

    def _ensure_loop(self):
        """The node's ONE event loop when the plane is the loop, else
        None; shared by the p2p switch and the RPC listener."""
        if self.loop is None and self.reactor == "loop":
            from tendermint_tpu_torch.p2p.conn.loop import ReactorLoop
            self.loop = ReactorLoop(name=f"tm-reactor-loop-{os.getpid()}")
        return self.loop

    def _build_p2p(self, state, fast_sync: bool, in_memory: bool) -> None:
        """node/node.go:235-265: switch + reactors (+PEX)."""
        from tendermint_tpu_torch.blockchain import BlockchainReactor
        from tendermint_tpu_torch.consensus import compact
        from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
        from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
        from tendermint_tpu_torch.mempool.reactor import MempoolReactor
        from tendermint_tpu_torch.p2p import NodeInfo, NodeKey, Switch
        from tendermint_tpu_torch.utils import log as _log

        if in_memory:
            from tendermint_tpu_torch.types.keys import PrivKey
            node_key = NodeKey(PrivKey.generate())
        else:
            node_key = NodeKey.load_or_generate(
                self.config.path("config/node_key.json"))
        self.node_key = node_key
        # compact-plane capabilities ride the handshake's `other` list;
        # empty (hence byte-identical handshake) with both off
        cc = self.config.consensus
        node_info = NodeInfo(
            pubkey=node_key.pubkey,
            moniker=self.config.base.moniker,
            network=self.gen_doc.chain_id,
            other=compact.wire_capabilities(compact.compact_on(cc),
                                            compact.voteagg_on(cc)))
        self.switch = Switch(self.config.p2p, node_key, node_info,
                             loop=self._ensure_loop())
        # causal plane: the node id stamped into envelopes and dumps is
        # the p2p identity, and the keepalive-RTT provider the merger
        # cross-checks its clock offsets against
        from tendermint_tpu_torch.telemetry import causal as _causal
        _causal.set_node(node_info.id[:12])
        _causal.set_rtt_provider(
            lambda: {p.id[:12]: p.rtt_s
                     for p in self.switch.peers.list()})
        # the p2p identity on every tm.* log line of the process
        _log.bind(node=node_info.id[:8])

        self.consensus_reactor = ConsensusReactor(
            self.consensus, fast_sync=fast_sync,
            gossip_sleep_s=self.config.consensus.peer_gossip_sleep_ms / 1e3)
        # state sync only engages on a node with nothing below it: a
        # genesis-fresh store joining an established chain
        restore = bool(self._state_sync and fast_sync and
                       self.snapshot_store is not None and
                       self.app is not None and
                       state.last_block_height == 0)
        if restore:
            import threading
            self._statesync_gate = threading.Event()
        expect_peers = bool(self.config.p2p.persistent_peers or
                            self.config.p2p.seeds)
        self.blockchain_reactor = BlockchainReactor(
            state, self.block_exec, self.block_store, fast_sync=fast_sync,
            consensus_reactor=self.consensus_reactor,
            gate=self._statesync_gate, expect_peers=expect_peers,
            redial=self._dial_configured_peers,
            after_apply=(self.snapshots.maybe_snapshot
                         if self.snapshots is not None else None))
        if self.snapshots is not None:
            self.snapshots.peer_floor = self._peer_floor
        self.mempool_reactor = MempoolReactor(
            self.mempool, broadcast=self.config.mempool.broadcast)
        self.evidence_reactor = EvidenceReactor(self.evidence_pool)

        if self.snapshot_store is not None and \
                (restore or self._snap_interval > 0):
            # the channel is only advertised when the recovery plane is
            # on: peers without it never see 0x60 traffic (try_send
            # checks the remote's advertised channels)
            from tendermint_tpu_torch.statesync import StateSyncReactor
            self.statesync_reactor = StateSyncReactor(
                self.snapshot_store, self.gen_doc.chain_id,
                restore=restore, statesync_dir=self._statesync_dir,
                block_store=self.block_store,
                state_store=self.state_store, app=self.app,
                verifier=self.verifier,
                on_restored=self._on_state_sync_done)

        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("blockchain", self.blockchain_reactor)
        self.switch.add_reactor("consensus", self.consensus_reactor)
        self.switch.add_reactor("evidence", self.evidence_reactor)
        if self.statesync_reactor is not None:
            self.switch.add_reactor("statesync", self.statesync_reactor)

        from tendermint_tpu_torch.p2p.trust import TrustMetricStore
        self.trust_store = TrustMetricStore(
            open_db(None if in_memory else
                    self.config.path(self.config.base.db_dir, "trust.db")))
        self.switch.trust_store = self.trust_store

        if self.config.p2p.pex:
            from tendermint_tpu_torch.p2p.pex import AddrBook, PEXReactor
            book_path = None if in_memory else \
                self.config.path("config/addrbook.json")
            self.addr_book = AddrBook(
                path=book_path, strict=self.config.p2p.addr_book_strict)
            self.pex_reactor = PEXReactor(
                self.addr_book, seed_mode=self.config.p2p.seed_mode)
            self.switch.add_reactor("pex", self.pex_reactor)
            self.switch.addr_book = self.addr_book

    def start(self) -> None:
        self.logger.info("starting node",
                         chain_id=self.gen_doc.chain_id,
                         height=self.consensus.state.last_block_height,
                         fast_sync=self.fast_sync)
        # WAL catchup for the in-flight height (consensus/replay.go:93).
        # In fast-sync mode the consensus reactor replays at
        # switch_to_consensus instead — replaying now would be wiped by
        # the post-sync state reset.
        if not self.fast_sync:
            try:
                catchup_replay(self.consensus, self.wal)
            except ValueError as e:
                # missing marker for a committed height / multi-height
                # WAL over genesis state: not fatal (the node proceeds
                # without replay) but must be visible
                self.logger.error("WAL catchup replay skipped", err=str(e))

        if self.loop is not None:
            self.loop.start()

        if self.switch is not None:
            host, port = _parse_laddr(self.config.p2p.laddr)
            self.switch.listen(host, port)
            if hasattr(self, "addr_book"):
                self.addr_book.add_our_address(self.switch.listen_address)
            self.switch.start()  # starts all reactors; consensus reactor
            #                      starts the state machine unless fast-sync
            self._dial_configured_peers()
        else:
            self.consensus.start()

        self.indexer_service.start()

        # stall-detector flight recorder (trace plane on + a nonzero
        # TM_CUDA_TRACE_STALL_S window): no height progress for the
        # window dumps the causal timeline + consensus state for
        # post-mortem, once per stall episode
        from tendermint_tpu_torch.telemetry import causal as _causal
        from tendermint_tpu_torch.telemetry import profile as _profile
        from tendermint_tpu_torch.telemetry import queues as _queues
        stall_s = knobs.knob_float("TM_CUDA_TRACE_STALL_S", default=0.0)
        if _causal.enabled() and stall_s > 0:
            self._stall_detector = _causal.StallDetector(
                lambda: self.height, self._on_stall, stall_s)
            self._stall_detector.start()
        # runtime introspection: start the sampler when the profiler is
        # on, and the queue-observatory watcher whenever the observatory
        # is (both process-global daemons — in-process nets share them;
        # node.stop() leaves them for peers)
        _profile.maybe_start()
        _queues.ensure_watch()

        # the HTTP and gRPC listeners are independent: asking for one
        # binds only that one (a gRPC-only operator gets no JSON-RPC
        # surface on the config's default 0.0.0.0 address)
        if self.with_rpc or self.config.rpc.grpc_laddr:
            from tendermint_tpu_torch.rpc import RPCEnv, make_server
            # the loop plane serves RPC on the SAME loop as the p2p
            # sockets (rpc/aserver.py); threads keep the threaded server
            rpc_loop = self._ensure_loop() if self.with_rpc else None
            if rpc_loop is not None and not rpc_loop.running:
                rpc_loop.start()
            self.rpc_server, self.rpc_core = make_server(
                RPCEnv.from_node(self), loop=rpc_loop)
            if self.with_rpc:
                host, port = _parse_laddr(self.config.rpc.laddr)
                self.rpc_address = self.rpc_server.serve(host, port)
            if self.config.rpc.grpc_laddr:
                from tendermint_tpu_torch.rpc.grpc_service import (
                    BroadcastAPIServer)
                self.grpc_server = BroadcastAPIServer(
                    self.rpc_core, self.config.rpc.grpc_laddr)
                self.grpc_server.start()
                self.logger.info("grpc broadcast api listening",
                                 port=self.grpc_server.port)

    def _on_state_sync_done(self, state) -> None:
        """The state-sync restore concluded. On success every store is
        bootstrapped at the snapshot height: adopt the state across the
        node's live components; either way release the fast-sync gate,
        so that block sync proceeds (from the snapshot, or from genesis
        after a fall-back)."""
        if state is not None:
            self.consensus.state = state
            self.blockchain_reactor.adopt_restored(state)
            self.evidence_pool.state = state
            self.mempool.update(state.last_block_height, [])
            self.logger.info("state sync complete; fast-syncing tail",
                             height=state.last_block_height)
        if self._statesync_gate is not None:
            self._statesync_gate.set()

    def _peer_floor(self) -> int:
        """The pruner's peer frontier: the first height a connected peer
        may still need from this node. The JAX node takes the blockchain
        reactor's min_peer_height() + 1, the heights peers reported in
        status responses; those stop once a node leaves fast sync, so on
        a net whose peers connected at genesis the frontier stays at
        their connect-time heights and nothing is ever pruned. The port
        also reads each peer's consensus height (its round state's
        height - 1 is committed): a peer's need is one above the larger
        of the two. A peer that is fast-syncing sends no round state and
        keeps the frontier at its reported height."""
        bc, cons = self.blockchain_reactor, self.consensus_reactor
        with bc._ph_lock:
            reported = dict(bc._peer_heights)
        states = dict(cons.peer_states)
        need = []
        for pid in set(reported) | set(states):
            h = reported.get(pid, 0)
            ps = states.get(pid)
            if ps is not None:
                with ps.lock:
                    h = max(h, ps.height - 1)
            need.append(h + 1)
        # no peer: no bound (the JAX reading's min_peer_height() + 1)
        return min(need) if need else (1 << 62) + 1

    def recovery_counts(self) -> dict:
        """The recovery plane's plain counts: the restore (height, chunks
        fetched, bad and timed out, bans, stage seconds), the snapshot
        manager's (published, pruned heights, floor, seconds), the
        snapshots on disk and the base of both stores."""
        ss = self.statesync_reactor
        status = ss.status() if ss is not None else None
        return {
            "statesync": status,
            "snapshots": (dict(self.snapshots.counts)
                          if self.snapshots is not None else None),
            "snapshot_heights": (self.snapshot_store.list_heights()
                                 if self.snapshot_store is not None
                                 else []),
            "latest_pin": self.state_store.latest_snapshot_height(),
            "block_base": self.block_store.base(),
            "state_floor": self.state_store.prune_floor(),
            "resumed_restore": (
                None if self.resumed_restore is None
                else self.resumed_restore.last_block_height)}

    def _on_stall(self, height: int, stalled_s: float) -> None:
        """Flight-recorder dump: the causal timeline plus the same
        consensus snapshot the dump_consensus_state RPC serves, written
        where a post-mortem will look (the node's data dir when it has
        one, else the system tempdir)."""
        import json
        import tempfile
        from tendermint_tpu_torch.rpc import RPCCore, RPCEnv
        from tendermint_tpu_torch.telemetry import causal as _causal
        from tendermint_tpu_torch.telemetry import profile as _profile
        from tendermint_tpu_torch.telemetry import queues as _queues
        doc = {"height": height, "stalled_s": round(stalled_s, 3),
               "timeline": _causal.dump(),
               # WHERE the threads are (the profiler's table) and WHICH
               # queue backed up first (the observatory's high-water
               # table) ride along with the what-happened timeline
               "profile": _profile.snapshot(),
               "queues": _queues.table()}
        try:
            core = RPCCore(RPCEnv.from_node(self))
            doc["consensus"] = core.dump_consensus_state()
        except Exception as e:
            doc["consensus_error"] = repr(e)
        out_dir = tempfile.gettempdir()
        if self.config.home:
            d = self.config.path(self.config.base.db_dir)
            if os.path.isdir(d):
                out_dir = d
        path = os.path.join(
            out_dir, f"tm_stall_h{height}_{int(time.time())}.json")
        try:
            with open(path, "w") as f:
                json.dump(doc, f)
            self.logger.error("consensus stalled: flight recorder dumped",
                              height=height,
                              stalled_s=round(stalled_s, 1), path=path)
        except OSError as e:
            self.logger.error("stall dump failed", err=repr(e))

    def _dial_configured_peers(self) -> None:
        from tendermint_tpu_torch.p2p import NetAddress
        persistent = [a for a in
                      self.config.p2p.persistent_peers.split(",") if a]
        seeds = [a for a in self.config.p2p.seeds.split(",") if a]
        if persistent:
            self.switch.dial_peers_async(
                [NetAddress.from_string(a) for a in persistent],
                persistent=True)
        if seeds:
            self.switch.dial_peers_async(
                [NetAddress.from_string(a) for a in seeds])

    def stop(self) -> None:
        if self._stall_detector is not None:
            self._stall_detector.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop()
        self.indexer_service.stop()
        if self.switch is not None:
            self.switch.stop()
            self.trust_store.save()
        else:
            self.consensus.stop()
        if self.loop is not None and self._owns_loop:
            # after the switch: peer teardowns run ON the loop; an
            # injected loop belongs to its creator
            self.loop.stop()
        if hasattr(self.mempool, "close"):
            self.mempool.close()
        self.app_conns.close()
        if hasattr(self.wal, "close"):
            self.wal.close()
        # only a verifier this node owns: the shared default verifier
        # keeps serving the process's other nodes
        if self._owns_verifier:
            self.verifier.close()

    @property
    def height(self) -> int:
        return self.consensus.state.last_block_height


def default_node(home: str, app=None, in_memory=False, with_p2p=False,
                 fast_sync: Optional[bool] = None, device=None,
                 loop=None, state_sync: bool = False) -> Node:
    """DefaultNewNode (node/node.go:79): load config tree from `home`.
    `state_sync` turns `base.state_sync` on over the file's value (the
    CLI's --state-sync)."""
    from tendermint_tpu_torch.config import default_config
    config = default_config(home)
    if state_sync:
        config.base.state_sync = True
    gen_doc = GenesisDoc.load(os.path.join(home, "config", "genesis.json"))
    pv = PrivValidatorFile.load_or_generate(
        os.path.join(home, "config", "priv_validator.json"))
    if fast_sync is None:
        fast_sync = with_p2p and config.base.fast_sync
    return Node(config, gen_doc, priv_validator=pv, app=app,
                in_memory=in_memory, with_p2p=with_p2p,
                fast_sync=fast_sync, device=device, loop=loop)
