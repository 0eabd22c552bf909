"""Edge read tier: the port's copy of `tendermint_tpu/serving/edge.py`.

A replica is a ``Node`` WITHOUT a validator key (``priv_validator=None``
— it cannot sign, equivocate or be slashed) that follows a validator net
by state sync and the fast-sync tail, and a ``CertifierFollower`` that
advances a ``ContinuousCertifier`` (lite/certifier.py) height by height
from the replica's OWN block and state stores, on the node's verifier
(a B1 launch a certified height on the card). Reads are served only
through that certifier:

- every read response carries an ``edge`` stamp — the certified height
  and the honest LAG behind the store frontier;
- ``replica_read`` serves the per-key state proof and SELF-VERIFIES it
  against the certifier's own certified app hash before answering
  (``edge_reads_total{result}``); the full commit chain still ships so
  an untrusting client re-verifies end to end (shard/reads.py
  CertifiedReader);
- ``/healthz`` goes not-ok when the lag exceeds TM_CUDA_EDGE_MAX_LAG or
  certification has FAILED (a forged commit in the stores freezes trust
  where it broke; the lag then grows honestly).

``run_replica`` (``cli replica``) takes ``--state-sync`` as the node's
``base.state_sync``; the JAX function exports TM_TPU_STATE_SYNC into its
own environment for the same. It prints ``replica kernels {...}`` (the
node's kernel line with the follower's status and the reads by result
under ``edge``, and the RPC server's counts and calls in flight under
``rpc``) at each newly certified height and when it stops.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from tendermint_tpu_torch import telemetry

_m_cert_height = telemetry.gauge(
    "edge_certified_height",
    "Height the replica's continuous certifier has verified up to")
_m_lag = telemetry.gauge(
    "edge_lag",
    "Store frontier minus certified height (staleness) on this replica")
_m_reads = telemetry.counter(
    "edge_reads_total",
    "Replica-served certified reads, by outcome "
    "(verified / rejected / uncertified)",
    ("result",))
_m_cert_failures = telemetry.counter(
    "edge_cert_failures_total",
    "Continuous-certification failures on the replica's own stores")

#: default /healthz staleness threshold (heights) — TM_CUDA_EDGE_MAX_LAG
DEFAULT_MAX_LAG = 50


class CertifierFollower:
    """Advance a ContinuousCertifier from a node's own stores.

    Seeding anchors trust at the EARLIEST height the stores hold: a
    genesis-grown replica certifies from height 1 with the genesis
    valset; a statesync-restored (or pruned) replica anchors at the
    store base with that height's valset — the explicit trust
    assumption of joining via snapshot, recorded in ``trust_anchor``."""

    def __init__(self, node, poll_s: float = 0.25,
                 max_lag: Optional[int] = None):
        from tendermint_tpu_torch.utils import knobs
        self.node = node
        self.poll_s = poll_s
        self.max_lag = knobs.knob_int(
            "TM_CUDA_EDGE_MAX_LAG", config=max_lag,
            default=DEFAULT_MAX_LAG)
        self.cert = None
        self.trust_anchor = 0         # 0 = genesis; >1 = snapshot base
        self.failed: Optional[str] = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- trust

    def _seed(self) -> bool:
        """Build the certifier once the stores hold material."""
        from tendermint_tpu_torch.lite.certifier import ContinuousCertifier
        from tendermint_tpu_torch.shard.reads import _genesis_valset
        store = self.node.block_store
        if store.height() < 1:
            return False
        base = max(1, store.base())
        if base <= 1:
            vals = self.node.state_store.load_validators(1) or \
                _genesis_valset(self.node.gen_doc)
            next_h = 1
        else:
            vals = self.node.state_store.load_validators(base)
            if vals is None:
                return False
            next_h = base
            self.trust_anchor = base
        self.cert = ContinuousCertifier(
            self.node.gen_doc.chain_id, vals, next_height=next_h,
            verifier=self.node.verifier)
        return True

    def catch_up(self, up_to: Optional[int] = None) -> int:
        """Certify every uncertified height the stores hold (bounded
        by `up_to`). Returns heights advanced; a certification failure
        sets ``failed`` and stops — trust never advances past it."""
        from tendermint_tpu_torch.lite.types import CertificationError
        from tendermint_tpu_torch.shard.reads import full_commit_at
        advanced = 0
        with self._lock:
            if self.cert is None and not self._seed():
                return 0
            store = self.node.block_store
            limit = store.height()
            if up_to is not None:
                limit = min(limit, up_to)
            while self.failed is None and \
                    self.cert.next_height <= limit:
                fc = full_commit_at(store, self.node.state_store,
                                    self.cert.next_height)
                if fc is None:
                    break      # frontier not fully flushed yet
                try:
                    self.cert.advance(fc)
                except CertificationError as e:
                    self.failed = f"height {fc.height}: {e}"
                    _m_cert_failures.inc()
                    self.node.logger.error(
                        "replica certification FAILED; trust frozen",
                        err=str(e), height=fc.height)
                    break
                advanced += 1
            _m_cert_height.set(self.certified_height)
            _m_lag.set(self.lag)
        return advanced

    @property
    def certified_height(self) -> int:
        with self._lock:
            return 0 if self.cert is None else self.cert.certified_height

    @property
    def lag(self) -> int:
        """Store frontier minus certified height — the honest
        staleness bound stamped on every response."""
        with self._lock:
            return max(0, self.node.block_store.height() -
                       self.certified_height)

    def app_hash_at(self, height: int):
        with self._lock:
            if self.cert is None:
                return None
            return self.cert.app_hashes.get(height)

    @property
    def ok(self) -> bool:
        return self.failed is None and self.lag <= self.max_lag

    def status(self) -> dict:
        with self._lock:
            return {
                "role": "replica",
                "certified_height": self.certified_height,
                "lag": self.lag,
                "max_lag": self.max_lag,
                "ok": self.ok,
                "trust_anchor": self.trust_anchor,
                "valset_updates":
                    0 if self.cert is None else self.cert.updates,
                "failed": self.failed,
            }

    # --------------------------------------------------- background

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tm-edge-certify")
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.catch_up()
            except Exception as e:   # never kill the follower silently
                self.node.logger.error("certifier follower error",
                                       err=repr(e))
            self._stop.wait(self.poll_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class ReplicaCore:
    """The replica's RPC surface: RPCCore's read routes with the edge
    staleness stamp, plus ``replica_read`` (proof-carrying certified
    reads) — assembled via rpc.core.make_server's machinery by
    ``make_replica_server``."""

    def __init__(self, env, node, follower: CertifierFollower):
        from tendermint_tpu_torch.rpc.core import RPCCore
        self._core = RPCCore(env)
        self.node = node
        self.follower = follower

    def _stamped(self, doc: dict) -> dict:
        f = self.follower
        doc["edge"] = {"role": "replica",
                       "certified_height": f.certified_height,
                       "lag": f.lag}
        return doc

    # -------------------------------------------------- read routes

    def status(self) -> dict:
        return self._stamped(self._core.status())

    def block(self, height: int = 0) -> dict:
        return self._stamped(self._core.block(height))

    def tx_search(self, query: str = "", prove: bool = False,
                  page: int = 1, per_page: int = 30) -> dict:
        return self._stamped(
            self._core.tx_search(query, prove, page, per_page))

    def abci_query(self, path: str = "", data: bytes = b"",
                   height: int = 0, prove: bool = False) -> dict:
        f = self.follower
        f.catch_up()
        if prove and not height and f.certified_height >= 2:
            # serve the proof at the newest CERTIFIED version: the
            # header at certified_height binds the state after
            # certified_height - 1 (state/validation.py's app_hash rule)
            height = f.certified_height - 1
        return self._stamped(
            self._core.abci_query(path, data, height, prove))

    def replica_read(self, key: bytes = b"",
                     since_height: int = 0) -> dict:
        """A certified read from this replica's stores: value +
        FullCommit chain + per-key state proof (shard/reads.py
        serve_read), self-verified against the follower's OWN
        lite-certified app hash before it leaves the process."""
        from tendermint_tpu_torch.rpc.server import RPCError
        from tendermint_tpu_torch.shard.reads import serve_read
        f = self.follower
        f.catch_up()
        try:
            doc = serve_read(self.node, bytes(key),
                             since_height=int(since_height))
        except ValueError as e:
            raise RPCError(-32000, str(e))
        # the read may have landed on a fresher frontier than the
        # certifier had seen — advance once more so the served height
        # is certified material, then refuse to answer beyond trust
        if doc["height"] > f.certified_height:
            f.catch_up()
        if doc["height"] > f.certified_height:
            _m_reads.labels("uncertified").inc()
            raise RPCError(
                -32000,
                f"read at height {doc['height']} is beyond this "
                f"replica's certified height {f.certified_height}"
                + (f" (certification failed: {f.failed})"
                   if f.failed else ""))
        if doc.get("value_proof") is not None:
            try:
                self._self_verify(doc)
            except Exception as e:
                _m_reads.labels("rejected").inc()
                raise RPCError(
                    -32000, f"replica self-verification failed: {e}")
        _m_reads.labels("verified").inc()
        return self._stamped(doc)

    def _self_verify(self, doc: dict) -> None:
        """value -> tree root -> app_hash: the served proof must
        verify against the app hash of a header THIS replica's
        continuous certifier has certified — never against anything
        merely read from its own (possibly poisoned) block store."""
        from tendermint_tpu_torch import statetree
        value_height = int(doc["value_height"])
        anchor = self.follower.app_hash_at(value_height + 1)
        if anchor is None:
            raise ValueError(
                f"no certified header at {value_height + 1} anchors "
                f"the value proof")
        value = doc.get("value", b"")
        if isinstance(value, str):
            value = bytes.fromhex(value)
        key = doc.get("key", "")
        key = bytes.fromhex(key) if isinstance(key, str) else bytes(key)
        pf = statetree.proof_from_obj(doc["value_proof"])
        statetree.verify(pf, key,
                         value if pf.present else (value or None),
                         anchor)

    # ------------------------------------------------------- health

    def healthz(self) -> dict:
        doc = self._core.healthz()
        edge = self.follower.status()
        doc["edge"] = edge
        # staleness past the threshold (or frozen trust) flips the
        # verdict load balancers act on
        doc["ok"] = bool(doc["ok"] and edge["ok"])
        return doc

    # ------------------------------------------------------ assembly

    def routes(self) -> dict:
        r = self._core.routes()
        r.update({
            "status": self.status,
            "block": self.block,
            "tx_search": self.tx_search,
            "abci_query": self.abci_query,
            "replica_read": self.replica_read,
            "healthz": self.healthz,
        })
        return r

    def ws_routes(self) -> dict:
        return self._core.ws_routes()

    def slo(self, sketches: bool = False) -> dict:
        return self._core.slo(sketches)


def make_replica_server(node, follower: CertifierFollower, loop=None):
    """Assemble the replica's RPC server: the full route table with
    the edge-stamped read routes swapped in, the same raw GET surface
    as a node (/healthz with the edge verdict, /slo, /metrics), on
    the async front door when handed the node's loop (which also
    gives the admission plane — TM_CUDA_RPC_MAX_CONNS /
    TM_CUDA_RPC_RATE — to the edge tier)."""
    from tendermint_tpu_torch.rpc.core import RPCEnv
    from tendermint_tpu_torch.telemetry import profile

    core = ReplicaCore(RPCEnv.from_node(node), node, follower)
    if loop is not None:
        from tendermint_tpu_torch.rpc.aserver import AsyncRPCServer
        server = AsyncRPCServer(loop)
        core._core.enable_tx_batching()
        server._tx_batcher = core._core.tx_batcher
    else:
        from tendermint_tpu_torch.rpc.server import RPCServer
        server = RPCServer()
    server.register_all(core.routes())
    for name, fn in core.ws_routes().items():
        server.register(name, fn, ws_only=True)
    server.metrics_provider = telemetry.expose
    server.timeline_provider = core._core.dump_height_timeline

    def _pprof_text() -> str:
        p = profile.get()
        return "" if p is None else p.collapsed()

    server.raw_routes["/healthz"] = ("application/json", core.healthz)
    server.raw_routes["/slo"] = ("application/json", core.slo)
    server.raw_routes["/debug/pprof"] = (
        "text/plain; charset=utf-8", _pprof_text)
    return server, core


def _replica_line(node, follower, server, threads=None) -> str:
    """The node's kernel line (cli._kernel_line) with the follower's
    status and the replica's reads by result under ``edge``, and the RPC
    server's counts and calls in flight under ``rpc``."""
    from tendermint_tpu_torch.cli import _kernel_line
    line = json.loads(_kernel_line(node, threads))
    line["edge"] = follower.status()
    line["edge"]["reads"] = {
        r: telemetry.value("edge_reads_total", {"result": r}) or 0
        for r in ("verified", "rejected", "uncertified")}
    line["rpc"] = {**getattr(server, "stats", {}),
                   "inflight": getattr(server, "_inflight", 0)}
    return json.dumps(line)


def run_replica(args) -> int:
    """`cli replica`: run an edge read replica — a keyless follower node,
    its certifier follower and the replica RPC server, on `--device`
    (the card by default; without one it exits 1)."""
    from tendermint_tpu_torch.abci.apps import CounterApp, KVStoreApp
    from tendermint_tpu_torch.cli import thread_census
    from tendermint_tpu_torch.config import default_config
    from tendermint_tpu_torch.node import Node, _parse_laddr
    from tendermint_tpu_torch.types.genesis import GenesisDoc
    from tendermint_tpu_torch.utils.log import setup_logging

    config = default_config(args.home)
    setup_logging(config.base.log_level)
    gen_doc = GenesisDoc.load(
        os.path.join(args.home, "config", "genesis.json"))
    if getattr(args, "state_sync", False):
        config.base.state_sync = True
    # NO priv_validator — ever. A replica home carrying one is a
    # deployment error worth failing loudly on.
    pv_path = os.path.join(args.home, "config", "priv_validator.json")
    if os.path.exists(pv_path):
        print(f"REFUSING to start: replica home holds a validator key "
              f"({pv_path})", flush=True)
        return 1
    device = getattr(args, "device", "") or None
    try:
        app = (KVStoreApp(device=device) if args.app == "kvstore"
               else CounterApp())
        node = Node(config, gen_doc, priv_validator=None, app=app,
                    with_p2p=True, fast_sync=True, device=device)
    except RuntimeError as e:
        # no card and no --device cpu: the replica never moves to the CPU
        print(f"cannot start the replica: {e}", file=sys.stderr,
              flush=True)
        return 1
    if args.persistent_peers:
        node.config.p2p.persistent_peers = args.persistent_peers
    node.start()
    follower = CertifierFollower(node, max_lag=args.max_lag or None)
    follower.start()
    rpc_loop = node.loop
    server, _core = make_replica_server(node, follower, loop=rpc_loop)
    host, port = _parse_laddr(args.rpc_laddr or config.rpc.laddr)
    addr = server.serve(host, port)
    print(f"replica rpc listening on {addr[0]}:{addr[1]}", flush=True)
    print(f"replica started: chain={gen_doc.chain_id} "
          f"height={node.height}", flush=True)
    deadline = (time.time() + args.max_seconds
                if args.max_seconds else None)
    last = -1
    try:
        while True:
            time.sleep(0.2)
            fatal = getattr(node, "blockchain_reactor", None)
            fatal = getattr(fatal, "sync_error", None)
            if fatal is not None:
                print(f"SYNC FAILURE: {fatal!r}", flush=True)
                break
            ch = follower.certified_height
            if ch != last:
                last = ch
                print(f"certified height={ch} lag={follower.lag}",
                      flush=True)
                # the counts so far: a killed process leaves these
                print("replica kernels "
                      f"{_replica_line(node, follower, server)}",
                      flush=True)
            if deadline and time.time() > deadline:
                break
    except KeyboardInterrupt:
        pass
    census = thread_census()
    server.stop()
    follower.stop()
    node.stop()
    print(f"replica stopped at certified height "
          f"{follower.certified_height}", flush=True)
    print("replica kernels "
          f"{_replica_line(node, follower, server, census)}", flush=True)
    return 0 if follower.failed is None else 1
