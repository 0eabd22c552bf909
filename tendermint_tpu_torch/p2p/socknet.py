"""A validator net over loopback TCP: BASELINE.json config 1 (a
4-validator kvstore testnet) as the socket arm of `bench_testnet.py`
(`run_socket`) runs it, on the port, in one process.

Each node has its own kvstore app, ABCI connections, MemDB state and
block stores, mempool, evidence pool, event bus, BlockExecutor and
ConsensusState with a real TimeoutTicker, and the four reactors
(consensus, mempool, evidence, blockchain) on a Switch with encrypted
links that listens on 127.0.0.1:0; each node dials the nodes built after
it as persistent peers, so each pair has one link and one dialer.
Nothing but the sockets carries proposals, parts, votes, txs, evidence
and blocks between nodes.

Every switch has a TrustMetricStore, as the JAX node's has, so the ban
plane runs: a peer's error-stop scores a bad event, and a score under
`ban_score` bans the peer's id at the handshake for `ban_base_s`.

`drop_links(i)` stops node i's links and refuses its handshakes until
`restore_links(i)`; the persistent redial then brings it back and gossip
catches it up. `add_joiner()` adds a node that is no validator; it
downloads the chain's backlog, then fast-syncs it by BlockchainReactor
windows before it switches to consensus.
`add_node()` puts a node built elsewhere (any object with `switch`,
`block_store`, `state_store`, `cs` and `mempool`, e.g. a JAX package
node in the wire-parity tests) on the same mesh.

`bench_config()` gives config 1's socket settings (bench_testnet.py
run_socket, :471-480): propose 400 ms (+100 a round), prevote and
precommit 200 ms (+100), commit 100 ms, 1000 txs a block, a mempool of
4000. Every signature check of a node goes through its BlockExecutor's
verifier: `verifier_of(i)` gives node i's BatchVerifier.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.blockchain.reactor import (VERIFY_WINDOW,
                                                     BlockchainReactor)
from tendermint_tpu_torch.config import Config
from tendermint_tpu_torch.consensus import compact
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.evidence import EvidencePool, EvidenceStore
from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
from tendermint_tpu_torch.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.p2p.trust import TrustMetricStore
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage import BlockStore, MemDB, NilWAL, StateStore
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.priv_validator import (LocalSigner,
                                                       PrivValidator)

CHAIN_ID = "bench-socknet"   # bench_testnet.py run_socket's
POWER = 10
N_VALS = 4


def validator_keys(n: int = N_VALS) -> List[PrivKey]:
    """The config-1 keys of bench_testnet.py: seed bytes([i + 1]) * 32."""
    return [PrivKey.generate(bytes([i + 1]) * 32) for i in range(n)]


def node_key(i: int) -> NodeKey:
    """Node i's p2p identity (seed bytes([101 + i]) * 32), apart from
    its validator key."""
    return NodeKey(PrivKey.generate(bytes([101 + i]) * 32))


def genesis(keys: List[PrivKey], chain_id: str = CHAIN_ID) -> GenesisDoc:
    return GenesisDoc(chain_id=chain_id, genesis_time_ns=1,
                      validators=[GenesisValidator(k.pubkey.ed25519, POWER)
                                  for k in keys])


def bench_config() -> Config:
    """Config 1's socket settings (bench_testnet.py:471-480)."""
    c = Config()
    c.consensus = replace(
        c.consensus,
        timeout_propose=400, timeout_propose_delta=100,
        timeout_prevote=200, timeout_prevote_delta=100,
        timeout_precommit=200, timeout_precommit_delta=100,
        timeout_commit=100, max_block_size_txs=1000)
    c.mempool = replace(c.mempool, size=4000)
    return c


class LinksDropped(ConnectionError):
    """A handshake refused while the net holds a node's links down."""


class SockNode:
    """One node's parts, as the net built them."""

    def __init__(self, index: int, key: Optional[PrivKey]):
        self.index = index
        self.key = key              # validator key; None for a joiner
        self.app = self.conns = self.state_store = self.block_store = None
        self.mempool = self.evidence_pool = self.event_bus = None
        self.block_exec = self.cs = self.switch = None
        self.consensus_reactor = self.blockchain_reactor = None
        self.mempool_reactor = self.evidence_reactor = None
        self.states: Dict[int, bytes] = {}   # height -> State bytes saved

    def reactors(self) -> dict:
        """The reactors by name, in the JAX node's order."""
        return {"mempool": self.mempool_reactor,
                "blockchain": self.blockchain_reactor,
                "consensus": self.consensus_reactor,
                "evidence": self.evidence_reactor}

    def close(self) -> None:
        self.switch.stop()
        self.mempool.close()
        self.conns.close()


def build_node(i: int, key: Optional[PrivKey], gen: GenesisDoc,
               config: Config, verifier, fast_sync: bool = False,
               verify_window: int = VERIFY_WINDOW) -> SockNode:
    """Node i's app, stores, mempool, evidence pool, event bus,
    BlockExecutor, ConsensusState (a real TimeoutTicker) and reactors, on
    MemDB stores at genesis; no switch. Its state_store records the State
    bytes of every height it saves in `node.states`."""
    node = SockNode(i, key)
    node.block_store = BlockStore(MemDB())
    node.state_store = StateStore(MemDB())
    inner_save = node.state_store.save

    def save(state):
        inner_save(state)
        node.states[state.last_block_height] = encoding.cdumps(
            state.to_obj())
    node.state_store.save = save
    node.app = KVStoreApp()
    node.conns = AppConns(local_client_creator(node.app))
    state = Handshaker(node.state_store, node.block_store, gen,
                       verifier=verifier).handshake(node.conns)
    node.mempool = Mempool(node.conns.mempool, config=config.mempool,
                           height=state.last_block_height)
    node.evidence_pool = EvidencePool(
        EvidenceStore(MemDB()), state, state_store=node.state_store,
        verifier=verifier)
    node.event_bus = EventBus()
    node.block_exec = BlockExecutor(
        node.state_store, node.conns.consensus, mempool=node.mempool,
        evidence_pool=node.evidence_pool, event_bus=node.event_bus,
        verifier=verifier)
    node.cs = ConsensusState(
        config.consensus, state, node.block_exec, node.block_store,
        mempool=node.mempool, evidence_pool=node.evidence_pool,
        priv_validator=(PrivValidator(LocalSigner(key))
                        if key is not None else None),
        wal=NilWAL(), event_bus=node.event_bus)
    node.consensus_reactor = ConsensusReactor(
        node.cs, fast_sync=fast_sync,
        gossip_sleep_s=config.consensus.peer_gossip_sleep_ms / 1e3)
    node.blockchain_reactor = BlockchainReactor(
        state, node.block_exec, node.block_store, fast_sync=fast_sync,
        consensus_reactor=node.consensus_reactor,
        verify_window=verify_window, expect_peers=True)
    node.mempool_reactor = MempoolReactor(
        node.mempool, broadcast=config.mempool.broadcast)
    node.evidence_reactor = EvidenceReactor(node.evidence_pool)
    return node


class SockNet:
    __test__ = False  # not a pytest class, whatever the module's importer

    def __init__(self, config: Optional[Config] = None,
                 verifier_of: Callable[[int], object] = lambda i: None,
                 n_vals: int = N_VALS, chain_id: str = CHAIN_ID):
        self.config = config if config is not None else bench_config()
        self.verifier_of = verifier_of
        self.keys = validator_keys(n_vals)
        self.gen = genesis(self.keys, chain_id)
        self.nodes: List[SockNode] = []
        self.others: list = []      # nodes added with add_node
        self._dropped: set = set()  # node ids whose handshakes fail
        self._lock = threading.Lock()

    # -------------------------------------------------------------- building

    def _build(self, i: int, key: Optional[PrivKey], fast_sync: bool,
               verify_window: int) -> SockNode:
        node = build_node(i, key, self.gen, self.config, self.verifier_of(i),
                          fast_sync, verify_window)
        nk = node_key(i)
        info = NodeInfo(pubkey=nk.pubkey, moniker=f"node{i}",
                        network=self.gen.chain_id,
                        other=compact.wire_capabilities(
                            compact.compact_on(self.config.consensus),
                            compact.voteagg_on(self.config.consensus)))
        node.switch = Switch(self.config.p2p, nk, info, encrypt=True)
        node.switch.trust_store = TrustMetricStore(MemDB())
        node.switch.id_filters.append(self._refuse_dropped(nk.id()))
        for name, reactor in node.reactors().items():
            node.switch.add_reactor(name, reactor)
        node.switch.listen("127.0.0.1", 0)
        return node

    def _refuse_dropped(self, own_id: str):
        def check(their_id: str) -> None:
            with self._lock:
                if own_id in self._dropped or their_id in self._dropped:
                    raise LinksDropped(f"links of {own_id[:8]} or "
                                       f"{their_id[:8]} are dropped")
        return check

    def _all(self) -> list:
        return self.nodes + self.others

    @staticmethod
    def _dial(node, targets) -> None:
        """node dials each of `targets` as a persistent peer."""
        node.switch.dial_peers_async(
            [n.switch.listen_address for n in targets], persistent=True)

    # --------------------------------------------------------------- driving

    def start(self, validators=None) -> None:
        """Build the validators (`validators`: their indices, by default
        all; others may join with add_node), start them, and mesh them:
        each node dials every node built after it, so each pair has one
        dialer, which redials the link when it drops (two nodes dialing
        each other at once would churn through the switch's
        simultaneous-dial tiebreak at boot)."""
        for i in (range(len(self.keys)) if validators is None
                  else validators):
            self.nodes.append(self._build(i, self.keys[i], False,
                                          VERIFY_WINDOW))
        for node in self.nodes:
            node.switch.start()
        for i, node in enumerate(self.nodes):
            self._dial(node, self.nodes[i + 1:])

    def add_node(self, node) -> None:
        """Put an externally built, listening and started node on the
        mesh: it dials every node of the net."""
        self._dial(node, self._all())
        self.others.append(node)

    def add_joiner(self, verify_window: int = 16,
                   timeout_s: float = 30.0) -> SockNode:
        """A node with no validator key that fast-syncs the chain by
        BlockchainReactor windows of `verify_window` blocks, switches to
        consensus when caught up and follows.

        It first dials the net, asks its peers for every block they
        report and waits (at most timeout_s) until its pool holds them
        all; only then do its reactors start. That stands in for a long
        backlog, where the pool runs up to MAX_PENDING_REQUESTS heights
        ahead of the sync and each window is full: the sync cuts a window
        from the consecutive blocks its pool holds, and with a backlog of
        a few dozen blocks that arrive no faster than it applies them its
        windows stay small."""
        node = self._build(len(self.keys), None, True, verify_window)
        peers = self._all()
        pool = node.blockchain_reactor.pool
        self._dial(node, peers)
        self.wait_for(lambda: pool.num_peers() == len(peers), timeout_s,
                      "the joiner's peer statuses")
        backlog = pool.max_peer_height() - node.block_store.height()
        pool.make_next_requests()
        self.wait_for(lambda: len(pool.peek_window(backlog)) >= backlog,
                      timeout_s, "the joiner's download")
        node.switch.start()
        self.nodes.append(node)
        return node

    def drop_links(self, i: int) -> None:
        """Stop the links of self.nodes[i]; its handshakes fail until
        restored. Node i stops its own ends gracefully (no trust event);
        its peers see the link fail, score it a bad event as the switch
        scores any transport error, and redial it as a persistent peer."""
        node = self.nodes[i]
        with self._lock:
            self._dropped.add(node.switch.node_info.id)
        for peer in node.switch.peers.list():
            node.switch.stop_peer_gracefully(peer)

    def restore_links(self, i: int) -> None:
        with self._lock:
            self._dropped.discard(self.nodes[i].switch.node_info.id)

    def feed(self, i: int, txs: List[bytes]) -> int:
        """Node i's mempool takes `txs`; returns how many it admitted."""
        return sum(1 for r in self.nodes[i].mempool.check_tx_batch(txs)
                   if r.ok)

    def heights(self) -> List[int]:
        return [n.block_store.height() for n in self._all()]

    def wait_for(self, cond: Callable[[], bool], timeout_s: float,
                 what: str) -> float:
        """Poll `cond` every 10 ms until it holds; returns the seconds it
        took. Raises TimeoutError with the net's heights after
        `timeout_s`."""
        t0 = time.monotonic()
        while not cond():
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(
                    f"{what}: not within {timeout_s} s; heights "
                    f"{self.heights()}, steps "
                    f"{[(n.cs.rs.height, n.cs.rs.round, int(n.cs.rs.step)) for n in self._all()]}")
            time.sleep(0.01)
        return time.monotonic() - t0

    def wait_height(self, h: int, timeout_s: float, nodes=None) -> float:
        nodes = self._all() if nodes is None else nodes
        return self.wait_for(
            lambda: all(n.block_store.height() >= h for n in nodes),
            timeout_s, f"height {h}")

    def disagreements(self) -> List[str]:
        """Heights at which two nodes hold different block hashes or State
        bytes (each node at the heights it holds)."""
        bad = []
        top = max(self.heights())
        for h in range(1, top + 1):
            hashes = {n.block_store.load_block_meta(h).block_id.hash
                      for n in self._all() if n.block_store.height() >= h}
            states = {n.states[h] for n in self._all()
                      if h in getattr(n, "states", {})}
            if len(hashes) > 1:
                bad.append(f"height {h}: {len(hashes)} block hashes")
            if len(states) > 1:
                bad.append(f"height {h}: {len(states)} states")
        return bad

    def close(self) -> None:
        for node in self.nodes:
            node.close()
