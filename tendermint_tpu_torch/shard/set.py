"""ShardSet — N independent chains assembled as VALUES in one process:
the port's copy of `tendermint_tpu/shard/set.py`.

Each shard is a full ``Node`` (its own genesis doc, valset, stores, WAL,
mempool and consensus state machine) with a DISTINCT chain id and, when
a home directory is given, its own on-disk home. What the shards SHARE
is the process's amortization plane: ONE verifier (so concurrent small
verifies from many chains merge in its coalescer into bigger dispatches)
and ONE ``ReactorLoop`` for the process's sockets (the front door's
listener and any node-level loop use).

The shared verifier is handed to every node (``Node(verifier=)``), so a
node never owns it: stopping shards in ANY order never closes it. With
``device=None`` it is the process default (``default_verifier()``, on
the card, coalescing "auto", as the JAX shards share theirs); with a
device (``"cpu"`` in the tests) the set builds one
``BatchVerifier("auto", device=...)`` — coalescing "auto" too — and
closes it once, after every node has stopped. The shared loop is
stopped once by the set, last. Without a card and without a device the
set raises: it never moves to the CPU quietly.

Every node's logger carries a ``chain=<id>`` field, and per-shard
telemetry rides a bounded ``chain`` label (``shard_height``, updated on
the commit path)."""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.shard import resolve_shards
from tendermint_tpu_torch.shard.router import _m_height


class ShardSet:
    """Assemble, run and tear down N single-process chains.

    ``n_shards=None`` resolves the TM_CUDA_SHARDS knob. ``home=None``
    runs every shard in memory (the bench/test shape); a directory gives
    each shard its own ``<home>/<chain_id>`` home.
    ``config_factory(i, chain_id)`` / ``app_factory(i, chain_id)``
    customize each shard's config and ABCI app (defaults: the test
    consensus profile and a KVStoreApp on the set's device)."""

    def __init__(self, n_shards: Optional[int] = None,
                 chain_prefix: str = "shard", home: Optional[str] = None,
                 config_factory: Optional[Callable] = None,
                 app_factory: Optional[Callable] = None, device=None):
        from tendermint_tpu_torch.config import test_config
        from tendermint_tpu_torch.models import verifier as _verifier
        from tendermint_tpu_torch.node import Node, prebuild
        from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                        GenesisValidator)
        from tendermint_tpu_torch.types.keys import PrivKey
        from tendermint_tpu_torch.types.priv_validator import (
            LocalSigner, PrivValidator)

        n = n_shards if n_shards is not None else resolve_shards()
        if n < 1:
            raise ValueError(f"ShardSet needs >= 1 shard, got {n}")
        self.home = home
        self.device = device
        self.loop = None
        self.rpc_server = None
        self.rpc_address = None
        self.router = None
        self.nodes: List = []
        # the one verifier of the set, built before any node
        if device is None:
            self.verifier = _verifier.default_verifier()
            self._owns_verifier = False
        else:
            self.verifier = _verifier.BatchVerifier("auto", device=device)
            self._owns_verifier = True
        prebuild(self.verifier)
        for i in range(n):
            chain_id = f"{chain_prefix}-{i:02d}"
            # deterministic per-chain validator key: the shard curve's
            # arms and their single-chain controls sign identically
            key = PrivKey.generate(
                hashlib.sha256(chain_id.encode()).digest())
            gen = GenesisDoc(
                chain_id=chain_id, genesis_time_ns=1,
                validators=[GenesisValidator(key.pubkey.ed25519, 10)])
            if config_factory is not None:
                cfg = config_factory(i, chain_id)
            else:
                cfg = test_config(
                    os.path.join(home, chain_id) if home else "")
            app = app_factory(i, chain_id) if app_factory else None
            node = Node(cfg, gen,
                        priv_validator=PrivValidator(LocalSigner(key)),
                        app=app, in_memory=home is None,
                        with_p2p=False, device=device,
                        loop=self.ensure_loop(), verifier=self.verifier)
            # per-shard telemetry scoping: height per chain, updated on
            # the commit path (bounded label — the chain ids are ours)
            gauge = _m_height.labels(chain_id)
            gauge.set(node.consensus.state.last_block_height)
            node.consensus.post_commit_hooks.append(
                lambda state, g=gauge: g.set(state.last_block_height))
            self.nodes.append(node)
        self.chains: List[str] = [nd.gen_doc.chain_id
                                  for nd in self.nodes]
        self._by_chain: Dict[str, int] = {
            c: i for i, c in enumerate(self.chains)}

    # ------------------------------------------------------- assembly

    def ensure_loop(self):
        """The ONE shared ReactorLoop of the shard plane (front door and
        every member node). Created lazily, started with the set."""
        if self.loop is None:
            from tendermint_tpu_torch.p2p.conn.loop import ReactorLoop
            self.loop = ReactorLoop(name="tm-shard-loop")
        return self.loop

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self):
        return iter(self.nodes)

    def node_for_chain(self, chain_id: str):
        i = self._by_chain.get(chain_id)
        if i is None:
            raise KeyError(f"unknown chain {chain_id!r}")
        return self.nodes[i]

    def node_for_key(self, key: bytes):
        return self.nodes[self.router_map().shard_of(bytes(key))]

    def router_map(self):
        from tendermint_tpu_torch.shard.router import ShardMap
        if self.router is not None:
            return self.router.map
        return ShardMap(self.chains)

    # ------------------------------------------------------ lifecycle

    def start(self) -> None:
        for node in self.nodes:
            node.start()

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> tuple:
        """Open the one front door: an AsyncRPCServer on the shared loop
        serving the router's merged route table. Returns the bound
        (host, port)."""
        from tendermint_tpu_torch.shard.router import make_shard_server
        if self.rpc_server is not None:
            return self.rpc_address
        self.rpc_server, self.router = make_shard_server(
            self, loop=self.ensure_loop())
        self.rpc_address = self.rpc_server.serve(host, port)
        return self.rpc_address

    def reader(self, verifier=None):
        """An in-process certified cross-shard reader (shard/reads.py)
        over this set — what a shard-A-resident client uses to read
        shard B without trusting it. Its certifiers verify on
        `verifier`, by default the set's own."""
        from tendermint_tpu_torch.shard.reads import CertifiedReader
        if self.router is None:
            from tendermint_tpu_torch.shard.router import ShardRouter
            self.router = ShardRouter(self)
        return CertifiedReader(
            shard_set=self,
            verifier=self.verifier if verifier is None else verifier)

    def heights(self) -> Dict[str, int]:
        return {nd.gen_doc.chain_id:
                nd.consensus.state.last_block_height
                for nd in self.nodes}

    def frontier(self) -> int:
        """The minimum committed height across shards (the laggard)."""
        return min(self.heights().values())

    def stop(self) -> None:
        """Tear the set down. Each node's stop leaves the shared verifier
        alone (it never owned it); the shared loop stops after every
        node released its sockets and timers, and a verifier the set
        built is closed once, last."""
        if self.rpc_server is not None:
            self.rpc_server.stop()
            self.rpc_server = None
        for node in self.nodes:
            try:
                node.stop()
            except Exception as e:
                # one shard's teardown failure must not leak the rest
                node.logger.error("shard node stop failed", err=repr(e))
        if self.loop is not None:
            self.loop.stop()
            self.loop = None
        if self._owns_verifier:
            self.verifier.close()
