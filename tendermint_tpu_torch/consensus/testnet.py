"""An in-process validator net: BASELINE.json config 1 (a 4-validator
kvstore testnet) as `bench_testnet.py` and the consensus tests of the
JAX package wire it, on the port.

Each validator has its own kvstore app, ABCI connections, state and
block stores, mempool, evidence pool, event bus, BlockExecutor and
ConsensusState with a MockTicker; a full-mesh relay carries every
proposal, block part and vote a node broadcasts to the other live nodes
(consensus/common_test.go:343 randConsensusNet over in-memory
connections). The caller moves the net by firing the nodes' pending
timeouts (`run_until`), so a run is deterministic given the clock;
`run_schedule` drives config 1's run (fresh txs every height, a
validator joining and leaving, an equivocation, a forged vote, a crash)
height by height.

Nodes listed in `file_nodes` keep their stores in SQLite files, their
consensus WAL in a file and their mempool's tx WAL under `home`; the
others use MemDB and NilWAL. `stop_node` / `restart_node` take such a
node down and rebuild it from its files: the handshake replays the
stored blocks into a fresh app, the WAL's tail is replayed, and the node
rejoins the relay.

Every signature check of a node goes through its BlockExecutor's
verifier: `verifier_of(i)` gives node i's BatchVerifier (None: the
port's default verifier, on the card).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.config import test_config
from tendermint_tpu_torch.consensus.replay import Handshaker, catchup_replay
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import MockTicker
from tendermint_tpu_torch.evidence import EvidencePool, EvidenceStore
from tendermint_tpu_torch.mempool import Mempool
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage import (WAL, BlockStore, MemDB, NilWAL,
                                          SQLiteDB, StateStore)
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.priv_validator import (LocalSigner,
                                                       PrivValidator)
from tendermint_tpu_torch.types.vote import Vote, VoteType

RELAYED = ("proposal", "block_part", "vote")
CHAIN_ID = "bench-net"    # bench_testnet.py's
POWER = 10                # each validator's voting power
MAX_BLOCK_TXS = 1000      # config 1's block width: max_block_size_txs
N_VALS = 4                # config 1's validators, each running a node
FILE_NODE = 3             # the node on files, which crashes and restarts
MAX_TICKS = 400           # rounds of timeouts run_until fires at most
T0 = 1_700_000_000 * 10 ** 9  # run_schedule's stepped clock starts here, ns
# a block id nothing proposes: a prevote for it conflicts with any other
FAKE_BID = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))


def validator_keys() -> List[PrivKey]:
    """The config-1 keys of bench_testnet.py: seed bytes([i + 1]) * 32."""
    return [PrivKey.generate(bytes([i + 1]) * 32) for i in range(N_VALS)]


def standby_key() -> PrivKey:
    """The key that joins by a `val:` tx and runs no node
    (bench_testnet.py's first churn standby key)."""
    return PrivKey.generate(bytes([200, 1]) * 16)


def val_tx(key: PrivKey, power: int) -> bytes:
    """The kvstore's validator-update tx: `val:<pubkey hex>/<power>`."""
    return b"val:%s/%d" % (key.pubkey.ed25519.hex().encode(), power)


class TestnetNode:
    """One validator's parts, as the net built them."""

    def __init__(self, index: int, key: PrivKey):
        self.index = index
        self.key = key
        self.dbs: list = []
        self.app = self.conns = self.state_store = self.block_store = None
        self.mempool = self.evidence_pool = self.event_bus = None
        self.block_exec = self.wal = self.cs = None
        self.handshaker: Optional[Handshaker] = None

    def close(self) -> None:
        self.cs.stop()
        self.wal.close()
        self.mempool.close()
        self.conns.close()
        for db in self.dbs:
            db.close()


class Testnet:
    __test__ = False  # not a pytest class, whatever the module's importer

    def __init__(self, verifier_of: Callable[[int], object] = lambda i: None,
                 home: Optional[str] = None, file_nodes=()):
        self.keys = validator_keys()
        self.gen = GenesisDoc(
            chain_id=CHAIN_ID, genesis_time_ns=1,
            validators=[GenesisValidator(k.pubkey.ed25519, POWER)
                        for k in self.keys])
        self.verifier_of = verifier_of
        self.home = home
        self.file_nodes = set(file_nodes)
        if self.file_nodes and home is None:
            raise ValueError("file-backed nodes need a home directory")
        self.live = [True] * N_VALS
        self.nodes = [self._build(i) for i in range(N_VALS)]
        for i, node in enumerate(self.nodes):
            node.cs.broadcast_hooks.append(self._relay_from(i))

    # -------------------------------------------------------------- building

    def _path(self, i: int, *parts: str) -> str:
        """A file of node i under home; its directory is made."""
        path = os.path.join(self.home, f"node{i}", *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def _db(self, node: TestnetNode, name: str):
        if node.index in self.file_nodes:
            db = SQLiteDB(self._path(node.index, "data", name + ".db"))
        else:
            db = MemDB()
        node.dbs.append(db)
        return db

    def _build(self, i: int) -> TestnetNode:
        """Node i from its stores (empty ones at genesis): the handshake
        brings a fresh app to the stores' height."""
        node = TestnetNode(i, self.keys[i])
        on_file = i in self.file_nodes
        node.block_store = BlockStore(self._db(node, "blockstore"))
        node.state_store = StateStore(self._db(node, "state"))
        node.app = KVStoreApp()
        node.conns = AppConns(local_client_creator(node.app))
        verifier = self.verifier_of(i)
        node.handshaker = Handshaker(node.state_store, node.block_store,
                                     self.gen, verifier=verifier)
        state = node.handshaker.handshake(node.conns)
        node.mempool = Mempool(
            node.conns.mempool, height=state.last_block_height,
            wal_dir=os.path.join(self.home, f"node{i}", "data",
                                 "mempool.wal") if on_file else None)
        node.evidence_pool = EvidencePool(
            EvidenceStore(self._db(node, "evidence")), state,
            state_store=node.state_store, verifier=verifier)
        node.event_bus = EventBus()
        node.block_exec = BlockExecutor(
            node.state_store, node.conns.consensus, mempool=node.mempool,
            evidence_pool=node.evidence_pool, event_bus=node.event_bus,
            verifier=verifier)
        node.wal = (WAL(self._path(i, "data", "cs.wal", "wal")) if on_file
                    else NilWAL())
        config = test_config().consensus
        config.max_block_size_txs = MAX_BLOCK_TXS
        node.cs = ConsensusState(
            config, state, node.block_exec, node.block_store,
            mempool=node.mempool, evidence_pool=node.evidence_pool,
            priv_validator=PrivValidator(LocalSigner(node.key)),
            wal=node.wal, event_bus=node.event_bus,
            ticker_factory=MockTicker)
        return node

    def _relay_from(self, i: int):
        def relay(msg: dict) -> None:
            if msg["type"] not in RELAYED:
                return
            for j, dst in enumerate(self.nodes):
                if j != i and self.live[j]:
                    dst.cs.submit(dict(msg), peer_id=f"node{i}")
        return relay

    # --------------------------------------------------------------- driving

    def start(self) -> None:
        for node in self.nodes:
            node.cs.start()

    def heights(self) -> List[int]:
        return [n.cs.state.last_block_height for i, n in
                enumerate(self.nodes) if self.live[i]]

    def run_until(self, height: int) -> None:
        """Fire the live nodes' timeouts one node at a time until every
        live node has committed `height`: the net stops at that height,
        and no node starts the next one before the caller feeds it."""
        for _ in range(MAX_TICKS):
            for i, node in enumerate(self.nodes):
                if min(self.heights()) >= height:
                    return
                if self.live[i]:
                    node.cs.ticker.fire_next()
        raise AssertionError(
            f"net did not reach height {height}; at {self.heights()}, steps "
            f"{[(n.cs.rs.height, n.cs.rs.round, int(n.cs.rs.step)) for n in self.nodes]}")

    def feed(self, txs: List[bytes]) -> None:
        """Every live node's mempool takes `txs` in one check_tx_batch;
        each must be admitted."""
        for i, node in enumerate(self.nodes):
            if self.live[i]:
                bad = [r.log for r in node.mempool.check_tx_batch(txs)
                       if not r.ok]
                if bad:
                    raise AssertionError(f"node {i} refused txs: {bad[:3]}")

    # ------------------------------------------------------ crash and restart

    def stop_node(self, i: int) -> None:
        if i not in self.file_nodes:
            raise ValueError(f"node {i} keeps no files to restart from")
        self.live[i] = False
        self.nodes[i].close()

    def restart_node(self, i: int) -> int:
        """Rebuild node i from its files, replay its WAL's tail, start it
        and put it back on the relay; returns the messages replayed."""
        node = self._build(i)
        self.nodes[i] = node
        replayed = catchup_replay(node.cs, node.wal)
        node.cs.broadcast_hooks.append(self._relay_from(i))
        self.live[i] = True
        node.cs.start()
        return replayed

    def close(self) -> None:
        for i, node in enumerate(self.nodes):
            if self.live[i]:
                node.close()
                self.live[i] = False


# ------------------------------------------------------- config 1's schedule

class Schedule(NamedTuple):
    """A config-1 run, by height: `heights` heights of `txs` fresh txs;
    the standby key joins at `join_at` and leaves at `leave_at`;
    validator 1 prevotes twice at `equivocate_at`, the second vote to
    nodes 0, 2 and 3; a prevote of validator 2 with a flipped signature
    byte reaches node 0 at `forge_at`; FILE_NODE crashes after it has
    committed `restart_after`."""
    heights: int
    txs: int
    join_at: int
    leave_at: int
    equivocate_at: int
    forge_at: int
    restart_after: int


def conflicting_prevote(key, valset, height: int, flip: bool = False) -> dict:
    """`key`'s signed round-0 prevote at `height` for FAKE_BID, as a relay
    message; `flip` spoils one byte of its signature."""
    i, _ = valset.get_by_address(key.pubkey.address)
    v = Vote(key.pubkey.address, i, height, 0, T0 + 7, VoteType.PREVOTE,
             FAKE_BID)
    sig = key.sign(v.sign_bytes(CHAIN_ID))
    if flip:
        sig = sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]
    v.signature = sig
    return {"type": "vote", "vote": v.to_obj()}


def run_schedule(net, sched: Schedule, standby: PrivKey, clock_ns: list,
                 fed: list) -> Iterator[Tuple[int, Optional[bool]]]:
    """Drive `net` (a Testnet, or a net with its keys, nodes, feed and
    run_until) through `sched`. Before height h the clock `clock_ns[0]`
    steps one second, every live mempool takes sched.txs fresh txs (while
    h <= sched.heights) and h's events arrive; the net then runs until
    it has committed h, and the generator yields (h, whether node 0
    refused the forged prevote, or None at a height without one). Past
    sched.heights it runs on, with no txs and no events, until the
    mempools are empty. Every tx fed is appended to `fed`. The caller
    restarts FILE_NODE when it is given h == sched.restart_after <=
    sched.heights."""
    h = 0
    while h < sched.heights or any(n.mempool.size() for n in net.nodes):
        h += 1
        if h > sched.heights + 10:
            raise AssertionError("the mempools did not drain")
        clock_ns[0] += 10 ** 9
        forged_refused = None
        if h <= sched.heights:
            forged_refused = _height_events(net, h, sched, standby, fed)
        net.run_until(h)
        yield h, forged_refused


def _height_events(net, h: int, sched: Schedule, standby: PrivKey,
                   fed: list) -> Optional[bool]:
    txs = [b"bench/k%d=v%d" % (len(fed) + i, i) for i in range(sched.txs)]
    fed += txs
    net.feed(txs)
    for at, power in ((sched.join_at, POWER), (sched.leave_at, 0)):
        if h == at:
            fed.append(val_tx(standby, power))
            net.feed([fed[-1]])
    valset = net.nodes[0].cs.rs.validators
    if h == sched.equivocate_at:
        msg = conflicting_prevote(net.keys[1], valset, h)
        for j in (0, 2, 3):
            net.nodes[j].cs.submit(dict(msg), peer_id="byzantine")
    if h != sched.forge_at:
        return None
    idx, _ = valset.get_by_address(net.keys[2].pubkey.address)
    net.nodes[0].cs.submit(
        conflicting_prevote(net.keys[2], valset, h, flip=True),
        peer_id="byzantine")
    return net.nodes[0].cs.rs.votes.prevotes(0).votes[idx] is None
