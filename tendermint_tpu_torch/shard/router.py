"""Shard router — the deterministic key-space -> chain map behind the
async RPC front door: the port's copy of `tendermint_tpu/shard/router.py`.

One listener serves N chains. The map is a HASH RANGE over the tx key
prefix (the bytes before ``=`` in the kvstore tx grammar): the first 8
bytes of ``sha256(prefix)`` scale into ``n_shards`` equal ranges, so the
assignment is a pure function of ``(key, n_shards)`` — the same across
processes, restarts and the two packages, with no coordination state.
The map carries a VERSION (``shard_mapping_version``): a rebalance (a
shard count change) bumps it, responses quote it, and clients detect a
remap by comparing.

Routing surface (the merged route table ``make_shard_server`` registers
on one ``AsyncRPCServer``):

- key-routed: ``broadcast_tx_{sync,async,commit}`` (tx key prefix),
  ``broadcast_tx_batch`` (split per shard, results in input order),
  ``abci_query`` (by ``data``), ``shard_read`` (the certified cross-shard
  read of shard/reads.py);
- chain-scoped passthroughs: ``status``/``block``/``commit``/... take an
  optional ``chain_id`` param (default: the first shard, the
  single-chain shape);
- shard-global: ``shards`` (the map and per-shard heights),
  ``tx_search`` (fanned out and merged), ``subscribe``/``unsubscribe``
  (WebSocket; ``chain_id`` selects one bus, empty subscribes every
  shard's bus on one socket).

``chain_of_call`` is the bounded ``chain`` label of ``rpc_call_seconds``:
it only returns ids of the map (never a client-minted string), so the
label's cardinality is the shard count."""

from __future__ import annotations

import hashlib
import inspect
from typing import Dict, List

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.rpc.server import RPCError

_m_hits = telemetry.counter(
    "shard_router_hits_total",
    "Key-routed front-door calls delivered to a shard, by chain",
    ("chain",))
_m_height = telemetry.gauge(
    "shard_height", "Last committed height per shard chain", ("chain",))
_m_mapping_version = telemetry.gauge(
    "shard_mapping_version",
    "Version of the key-space -> chain mapping currently routing")
_m_cross_reads = telemetry.counter(
    "shard_cross_reads_total",
    "Certified cross-shard reads, by outcome "
    "(served / verified / rejected)",
    ("result",))


def key_prefix(tx: bytes) -> bytes:
    """The routing key of a tx: the bytes before ``=`` (the kvstore
    grammar's key), or the whole tx when it has no ``=``. A tx and a
    later ``abci_query`` for its key therefore route identically."""
    return bytes(tx).split(b"=", 1)[0]


class ShardMap:
    """Hash-range key-space mapping: pure function of (key, n_shards),
    stamped with a version so clients can detect a rebalance."""

    __slots__ = ("chains", "version")

    def __init__(self, chains: List[str], version: int = 1):
        if not chains:
            raise ValueError("ShardMap needs at least one chain")
        self.chains = list(chains)
        self.version = int(version)
        _m_mapping_version.set(self.version)

    @property
    def n(self) -> int:
        return len(self.chains)

    def shard_of(self, key: bytes) -> int:
        """Deterministic shard index for a routing key: the first 8
        bytes of sha256(key) scaled into n equal hash ranges."""
        h = int.from_bytes(hashlib.sha256(bytes(key)).digest()[:8],
                           "big")
        return (h * self.n) >> 64

    def chain_of(self, key: bytes) -> str:
        return self.chains[self.shard_of(key)]

    def rebalanced(self, chains: List[str]) -> "ShardMap":
        """A NEW mapping at version+1 (shard count changed). Keys only
        move because n changed — same chains, same assignment."""
        return ShardMap(chains, version=self.version + 1)

    def to_obj(self) -> dict:
        n = self.n
        return {
            "version": self.version,
            "n_shards": n,
            "chains": self.chains,
            # [lo, hi) of the 64-bit hash space per shard, hex — what a
            # client needs to route locally without asking the server
            "ranges": [
                {"chain_id": c,
                 "lo": format((i * (1 << 64)) // n, "016x"),
                 "hi": format(((i + 1) * (1 << 64)) // n, "016x")}
                for i, c in enumerate(self.chains)],
        }


#: routes delegated verbatim to one shard's RPCCore, selected by an
#: optional chain_id param prepended to the original signature
_PASSTHROUGH = (
    "status", "net_info", "blockchain", "genesis", "block",
    "block_results", "commit", "validators", "dump_consensus_state",
    "unconfirmed_txs", "num_unconfirmed_txs", "abci_info", "tx",
    "dump_height_timeline",
)


class ShardRouter:
    """The merged front door over a ShardSet: one route table, N
    RPCCores. Handlers run on the async server's worker pool exactly
    like single-chain handlers."""

    def __init__(self, shard_set):
        from tendermint_tpu_torch.rpc.core import RPCCore, RPCEnv
        self.shard_set = shard_set
        self.map = ShardMap([n.gen_doc.chain_id
                             for n in shard_set.nodes])
        self.cores: List[RPCCore] = [
            RPCCore(RPCEnv.from_node(n)) for n in shard_set.nodes]
        self._by_chain: Dict[str, int] = {
            c: i for i, c in enumerate(self.map.chains)}
        self._hits = [_m_hits.labels(c) for c in self.map.chains]

    # ---------------------------------------------------- resolution

    def core_for_key(self, key: bytes):
        i = self.map.shard_of(key)
        self._hits[i].inc()
        return self.cores[i]

    def _core_for_chain(self, chain_id: str):
        if not chain_id:
            return self.cores[0]
        i = self._by_chain.get(chain_id)
        if i is None:
            raise RPCError(-32602, f"unknown chain_id {chain_id!r} "
                           f"(chains: {self.map.chains})")
        return self.cores[i]

    def chain_of_call(self, method: str,
                      params: dict) -> str:
        """Bounded `chain` label for tm_rpc_call_seconds: the shard a
        call routes to, resolved from the mapping — never a raw client
        string. Cheap and exception-free (loop thread)."""
        try:
            if not isinstance(params, dict):
                return ""
            cid = params.get("chain_id")
            if isinstance(cid, str) and cid in self._by_chain:
                return cid
            if method in ("broadcast_tx_sync", "broadcast_tx_async",
                          "broadcast_tx_commit"):
                return self.map.chain_of(
                    key_prefix(_as_bytes(params.get("tx"))))
            if method in ("abci_query", "shard_read"):
                raw = params.get("data" if method == "abci_query"
                                 else "key")
                return self.map.chain_of(_as_bytes(raw))
        except (ValueError, TypeError):
            pass
        return ""

    # ---------------------------------------------------- key-routed

    def broadcast_tx_sync(self, tx: bytes) -> dict:
        return self.core_for_key(key_prefix(tx)).broadcast_tx_sync(tx)

    def broadcast_tx_async(self, tx: bytes) -> dict:
        return self.core_for_key(key_prefix(tx)).broadcast_tx_async(tx)

    def broadcast_tx_commit(self, tx: bytes,
                            timeout: float = 60.0) -> dict:
        return self.core_for_key(key_prefix(tx)).broadcast_tx_commit(
            tx, timeout=timeout)

    def broadcast_tx_batch(self, txs: list) -> dict:
        """Split one batch across shards, reassemble per-tx results in
        INPUT order — the caller cannot tell the log is sharded."""
        if not isinstance(txs, list):
            raise RPCError(-32602, "txs must be a list of hex strings")
        try:
            raw = [bytes.fromhex(t[2:] if t.startswith("0x") else t)
                   for t in txs]
        except (ValueError, AttributeError) as e:
            raise RPCError(-32602, f"bad tx hex: {e}") from e
        groups: Dict[int, List[int]] = {}
        for pos, tx in enumerate(raw):
            groups.setdefault(
                self.map.shard_of(key_prefix(tx)), []).append(pos)
        results: list = [None] * len(raw)
        for i, positions in groups.items():
            self._hits[i].inc(len(positions))
            sub = self.cores[i].broadcast_tx_batch(
                [raw[p].hex() for p in positions])["results"]
            for p, r in zip(positions, sub):
                results[p] = r
        return {"results": results,
                "mapping_version": self.map.version}

    def abci_query(self, path: str = "", data: bytes = b"",
                   height: int = 0, prove: bool = False,
                   chain_id: str = "") -> dict:
        if chain_id:
            core = self._core_for_chain(chain_id)
        else:
            core = self.core_for_key(data)
        return core.abci_query(path, data, height=height, prove=prove)

    def tx_search(self, query: str = "", prove: bool = False,
                  page: int = 1, per_page: int = 30,
                  chain_id: str = "") -> dict:
        """Indexed reads through the front door: a caller usually does
        not know which shard a tx landed on, so without a chain_id the
        search FANS OUT to every shard's indexer and merges (chain-tagged, height-then-index order,
        paginated over the merged set). Shards with indexing disabled
        are skipped; only all-disabled raises — matching the
        single-chain error surface."""
        from tendermint_tpu_torch.state.txindex import NullTxIndexer
        cores = self._cores_for(chain_id)
        merged: list = []
        enabled = 0
        for core, chain in zip(cores, (
                [chain_id] if chain_id else self.map.chains)):
            if core.env.tx_indexer is None or \
                    isinstance(core.env.tx_indexer, NullTxIndexer):
                continue
            enabled += 1
            for r in core.env.tx_indexer.search(query):
                merged.append({**r, "chain_id": chain})
        if not enabled:
            raise RPCError(-32000, "transaction indexing is disabled "
                           "on every shard")
        merged.sort(key=lambda r: (r.get("height", 0),
                                   r.get("index", 0),
                                   r.get("chain_id", "")))
        total = len(merged)
        start = max(0, (int(page) - 1) * int(per_page))
        from tendermint_tpu_torch.rpc.core import jsonify
        return jsonify({"txs": merged[start:start + int(per_page)],
                        "total_count": total,
                        "mapping_version": self.map.version})

    def shard_read(self, key: bytes, since_height: int = 0) -> dict:
        """Certified cross-shard read (shard/reads.py): the value from
        the owning shard plus the FullCommit chain a client-side
        ContinuousCertifier advances through. `since_height` is the
        caller's last certified height on that chain (0 = genesis)."""
        from tendermint_tpu_torch.shard import reads
        i = self.map.shard_of(key)
        self._hits[i].inc()
        doc = reads.serve_read(self.shard_set.nodes[i], key,
                               since_height)
        doc["mapping_version"] = self.map.version
        _m_cross_reads.labels("served").inc()
        return doc

    # -------------------------------------------------- shard-global

    def shards(self) -> dict:
        """The routing table + per-shard frontier: what a smart client
        caches to route locally and to detect a rebalance."""
        heights = self.shard_set.heights()
        for chain, h in heights.items():
            _m_height.labels(chain).set(h)
        return {**self.map.to_obj(), "heights": heights}

    def healthz(self) -> dict:
        base = self.cores[0].healthz()
        heights = self.shard_set.heights()
        base["shards"] = {"mapping_version": self.map.version,
                          "n_shards": self.map.n, "heights": heights}
        base["height"] = min(heights.values()) if heights else 0
        return base

    def metrics(self) -> dict:
        return self.cores[0].metrics()

    def slo(self, sketches: bool = False) -> dict:
        return self.cores[0].slo(sketches=sketches)

    # ------------------------------------------------------------ ws

    def subscribe(self, query: str = "", chain_id: str = "",
                  ws=None) -> dict:
        """chain_id selects one shard's event bus; empty subscribes
        EVERY shard's bus on this socket (the aggregate firehose)."""
        for core in self._cores_for(chain_id):
            core.subscribe(query, ws=ws)
        return {}

    def unsubscribe(self, query: str = "", chain_id: str = "",
                    ws=None) -> dict:
        for core in self._cores_for(chain_id):
            core.unsubscribe(query, ws=ws)
        return {}

    def unsubscribe_all(self, ws=None) -> dict:
        for core in self.cores:
            core.unsubscribe_all(ws=ws)
        return {}

    def _cores_for(self, chain_id: str) -> list:
        if chain_id:
            return [self._core_for_chain(chain_id)]
        return self.cores

    # ----------------------------------------------------- route table

    def routes(self) -> dict:
        r = {
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_async": self.broadcast_tx_async,
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "broadcast_tx_batch": self.broadcast_tx_batch,
            "abci_query": self.abci_query,
            "tx_search": self.tx_search,
            "shard_read": self.shard_read,
            "shards": self.shards,
            "healthz": self.healthz,
            "metrics": self.metrics,
            "slo": self.slo,
        }
        for name in _PASSTHROUGH:
            r[name] = self._chain_scoped(name)
        return r

    def ws_routes(self) -> dict:
        return {"subscribe": self.subscribe,
                "unsubscribe": self.unsubscribe,
                "unsubscribe_all": self.unsubscribe_all}

    def _chain_scoped(self, name: str):
        """A passthrough wrapper whose __signature__ is the original
        handler's plus a leading chain_id param, so RPCFunc keeps its
        per-param coercion (hex->bytes etc.) working unchanged."""
        base = getattr(self.cores[0], name)
        sig = inspect.signature(base)

        def wrapper(chain_id: str = "", **kw):
            core = self._core_for_chain(chain_id)
            return getattr(core, name)(**kw)

        wrapper.__name__ = name
        wrapper.__signature__ = sig.replace(parameters=[
            inspect.Parameter("chain_id",
                              inspect.Parameter.POSITIONAL_OR_KEYWORD,
                              default="", annotation=str),
            *sig.parameters.values()])
        return wrapper


def make_shard_server(shard_set, loop=None):
    """One async front door for N chains: an AsyncRPCServer on the
    shard set's shared ReactorLoop serving the router's merged route
    table, with per-shard broadcast_tx admission batching and the
    bounded chain label wired into rpc_call_seconds."""
    from tendermint_tpu_torch.rpc.aserver import AsyncRPCServer

    router = ShardRouter(shard_set)
    server = AsyncRPCServer(loop if loop is not None
                            else shard_set.ensure_loop())
    for core in router.cores:
        core.enable_tx_batching()

    class _AllBatchers:
        """server.stop() closes ONE _tx_batcher; a shard front door
        runs one per chain — close them all."""

        @staticmethod
        def close() -> None:
            for c in router.cores:
                if c.tx_batcher is not None:
                    c.tx_batcher.close()

    server._tx_batcher = _AllBatchers()
    server.register_all(router.routes())
    for name, fn in router.ws_routes().items():
        server.register(name, fn, ws_only=True)
    server.metrics_provider = telemetry.expose
    server.raw_routes["/healthz"] = ("application/json", router.healthz)
    server.raw_routes["/shards"] = ("application/json", router.shards)
    server.chain_resolver = router.chain_of_call
    return server, router


def _as_bytes(v) -> bytes:
    """Param normalization for label resolution: URI/WS params arrive
    as hex strings, POST params may already be bytes."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    s = str(v or "")
    if s.startswith("0x"):
        s = s[2:]
    return bytes.fromhex(s)
