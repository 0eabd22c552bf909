"""RPC core — the route table + handlers over node internals: the port's
copy of `tendermint_tpu/rpc/core.py` (rpc/core/routes.go:8-50 + handlers;
env injection mirrors rpc/core/pipe.go:42-119).

Every handler returns plain JSON-able objects (bytes as hex). The route
set matches the reference: status, net_info, blockchain, genesis, block,
commit, validators, dump_consensus_state, unconfirmed txs, the three
broadcast_tx variants, abci_query/info, tx, tx_search, subscribe /
unsubscribe / unsubscribe_all (websocket), plus the unsafe routes gated
on config (dial_peers, flush_mempool).

The observability routes are those of the JAX table: `metrics`,
`dump_height_timeline`, `debug_profile`, `healthz` (with the snapshot
and state-sync block), `slo` and the unsafe `unsafe_dump_trace`, and
`make_server` installs the raw GET /metrics, /debug/timeline, /healthz,
/slo and /debug/pprof paths on either server. The broadcast routes stamp
the SLO plane's `admit` stage and both WebSocket fan-outs its `deliver`
stage. LEFT_OUT is empty: every route of the JAX table is served.
`net_info` also lists the switch's active bans, which the JAX route does
not.

`make_server(env)` builds the threaded server; `make_server(env, loop=)`
the async front door on the node's ReactorLoop (rpc/aserver.py), with
front-door tx batching: concurrent broadcast_tx_sync / _async calls merge
into one Mempool.check_tx_batch a linger window (TxBatcher)."""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.rpc.server import RPCError
from tendermint_tpu_torch.telemetry import slo as slo_obs
from tendermint_tpu_torch.types.events import Query, TagTxHash

#: routes of the JAX package's table the port does not serve (none)
LEFT_OUT: tuple = ()

_m_tx_batched = telemetry.counter(
    "rpc_tx_batched_total",
    "broadcast_tx admissions served through the front-door batcher")
_m_tx_batch_flushes = telemetry.counter(
    "rpc_tx_batch_flushes_total",
    "check_tx_batch flushes issued by the front-door batcher")


def jsonify(x: Any) -> Any:
    """Deep-convert framework objects to JSON-able plain data."""
    if isinstance(x, (bytes, bytearray)):
        return x.hex()
    if hasattr(x, "to_obj"):
        return jsonify(x.to_obj())
    if isinstance(x, dict):
        return {str(k): jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonify(v) for v in x]
    return x


class RPCEnv:
    """References handlers need (rpc/core/pipe.go setters)."""

    def __init__(self, consensus=None, block_store=None, state_store=None,
                 mempool=None, evidence_pool=None, switch=None,
                 event_bus=None, tx_indexer=None, gen_doc=None,
                 app_conns=None, pubkey: bytes = b"", unsafe: bool = False,
                 blockchain_reactor=None, statesync_reactor=None,
                 snapshot_store=None, stall_detector=None):
        self.consensus = consensus
        self.block_store = block_store
        self.state_store = state_store
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.switch = switch
        self.event_bus = event_bus
        self.tx_indexer = tx_indexer
        self.gen_doc = gen_doc
        self.app_conns = app_conns
        self.pubkey = pubkey
        self.unsafe = unsafe
        self.blockchain_reactor = blockchain_reactor
        self.statesync_reactor = statesync_reactor
        self.snapshot_store = snapshot_store
        self.stall_detector = stall_detector

    @classmethod
    def from_node(cls, node) -> "RPCEnv":
        return cls(
            consensus=node.consensus, block_store=node.block_store,
            state_store=node.state_store, mempool=node.mempool,
            evidence_pool=node.evidence_pool, switch=node.switch,
            event_bus=node.event_bus,
            tx_indexer=getattr(node, "tx_indexer", None),
            gen_doc=node.gen_doc, app_conns=node.app_conns,
            pubkey=(node.consensus.priv_validator.pubkey.ed25519
                    if node.consensus.priv_validator else b""),
            unsafe=node.config.rpc.unsafe,
            blockchain_reactor=getattr(node, "blockchain_reactor", None),
            statesync_reactor=getattr(node, "statesync_reactor", None),
            snapshot_store=getattr(node, "snapshot_store", None),
            stall_detector=getattr(node, "_stall_detector", None))


class TxBatcher:
    """Front-door admission coalescing: concurrent broadcast_tx_sync /
    _async calls arriving within a short linger merge into ONE
    Mempool.check_tx_batch (one mempool lock and one tx-WAL append for
    the batch); each waiter gets its own result back. `stats` counts the
    txs and the flushes."""

    def __init__(self, mempool, wait_s: float = 0.002,
                 max_batch: int = 256):
        self.mempool = mempool
        self.wait_s = wait_s
        self.max_batch = max_batch
        self._cond = threading.Condition()
        self._queue: list = []        #: guarded_by _cond
        self._closed = False          #: guarded_by _cond
        #: guarded_by _cond
        self.stats = {"txs": 0, "flushes": 0, "max_batch_seen": 0}
        # eager worker: part of the node's fixed thread set from
        # construction
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tm-rpc-txbatch")
        self._thread.start()

    def snapshot(self) -> dict:
        with self._cond:
            return dict(self.stats)

    def submit(self, tx: bytes, wait: bool = True):
        """Queue one tx; wait=True blocks for its ResultCheckTx."""
        slot: Optional[queue.SimpleQueue] = \
            queue.SimpleQueue() if wait else None
        with self._cond:
            if self._closed:
                raise RPCError(-32000, "tx batcher closed")
            self._queue.append((bytes(tx), slot))
            self._cond.notify()
        if slot is None:
            return None
        res = slot.get()
        if isinstance(res, BaseException):
            raise res
        return res

    def close(self, timeout: float = 2.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
            time.sleep(self.wait_s)   # linger: let a burst accumulate
            with self._cond:
                batch, self._queue = (self._queue[:self.max_batch],
                                      self._queue[self.max_batch:])
            if not batch:
                continue
            txs = [tx for tx, _ in batch]
            try:
                results = self.mempool.check_tx_batch(txs)
            except Exception as e:
                results = [e] * len(batch)
            _m_tx_batched.inc(len(batch))
            _m_tx_batch_flushes.inc()
            with self._cond:
                self.stats["txs"] += len(batch)
                self.stats["flushes"] += 1
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], len(batch))
            for (_, slot), res in zip(batch, results):
                if slot is not None:
                    slot.put(res)


class RPCCore:
    def __init__(self, env: RPCEnv):
        self.env = env
        # the SLO plane's shard label: the chain this core serves
        self._chain = env.gen_doc.chain_id if env.gen_doc else ""
        self.tx_batcher: Optional[TxBatcher] = None
        self._profiler = None
        self._profiler_lock = threading.Lock()

    def enable_tx_batching(self) -> None:
        """Async front door: coalesce concurrent broadcast_tx admissions
        (a no-op when the mempool lacks check_tx_batch)."""
        if self.tx_batcher is None and \
                hasattr(self.env.mempool, "check_tx_batch"):
            self.tx_batcher = TxBatcher(self.env.mempool)

    def routes(self) -> Dict[str, Any]:
        """rpc/core/routes.go:8-37 (+ unsafe :39-50)."""
        r = {
            "status": self.status,
            "net_info": self.net_info,
            "blockchain": self.blockchain,
            "genesis": self.genesis,
            "block": self.block,
            "block_results": self.block_results,
            "commit": self.commit,
            "validators": self.validators,
            "dump_consensus_state": self.dump_consensus_state,
            "unconfirmed_txs": self.unconfirmed_txs,
            "num_unconfirmed_txs": self.num_unconfirmed_txs,
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_batch": self.broadcast_tx_batch,
            "broadcast_tx_async": self.broadcast_tx_async,
            "abci_query": self.abci_query,
            "abci_info": self.abci_info,
            "tx": self.tx,
            "tx_search": self.tx_search,
            "metrics": self.metrics,
            "dump_height_timeline": self.dump_height_timeline,
            "debug_profile": self.debug_profile,
            "healthz": self.healthz,
            "slo": self.slo,
        }
        if self.env.unsafe:
            r.update({
                "dial_seeds": self.dial_seeds,
                "dial_peers": self.dial_peers,
                "unsafe_flush_mempool": self.unsafe_flush_mempool,
                "unsafe_start_cpu_profiler": self.unsafe_start_cpu_profiler,
                "unsafe_stop_cpu_profiler": self.unsafe_stop_cpu_profiler,
                "unsafe_write_heap_profile": self.unsafe_write_heap_profile,
                "unsafe_dump_trace": self.unsafe_dump_trace,
            })
        return r

    def ws_routes(self) -> Dict[str, Any]:
        return {"subscribe": self.subscribe,
                "unsubscribe": self.unsubscribe,
                "unsubscribe_all": self.unsubscribe_all}

    # ------------------------------------------------------------------ info

    def status(self) -> dict:
        """rpc/core status."""
        cs = self.env.consensus
        store = self.env.block_store
        h = store.height() if store else 0
        meta = store.load_block_meta(h) if store and h > 0 else None
        listen = ""
        if self.env.switch is not None and \
                self.env.switch.listen_address is not None:
            listen = str(self.env.switch.listen_address)
        return jsonify({
            "node_info": (self.env.switch.node_info.to_obj()
                          if self.env.switch else {}),
            "listen_addr": listen,
            "pub_key": self.env.pubkey,
            "latest_block_height": h,
            "latest_block_hash": meta.block_id.hash if meta else b"",
            "latest_app_hash": cs.state.app_hash if cs else b"",
            "latest_block_time_ns":
                meta.header.time_ns if meta else 0,
            "syncing": (self.env.blockchain_reactor is not None and
                        not self.env.blockchain_reactor.synced),
        })

    def net_info(self) -> dict:
        sw = self.env.switch
        if sw is None:
            return {"listening": False, "peers": []}
        return jsonify({
            "listening": sw.listen_address is not None,
            "listen_addr": str(sw.listen_address or ""),
            "n_peers": sw.peers.size(),
            "peers": [{
                "node_info": p.node_info.to_obj(),
                "is_outbound": p.outbound,
                "rtt_s": round(p.rtt_s, 6),
            } for p in sw.peers.list()],
            "banned": {pid: {"strikes": r["strikes"]}
                       for pid, r in sorted(sw.banned.items())
                       if sw.is_banned(pid)},
        })

    def genesis(self) -> dict:
        return jsonify({"genesis": self.env.gen_doc.to_obj()
                        if self.env.gen_doc else None})

    def dump_consensus_state(self) -> dict:
        """rpc/core/consensus.go DumpConsensusState: our round state +
        what we know of every peer's round state."""
        cs = self.env.consensus
        rs = cs.rs
        peer_states = {}
        if self.env.switch is not None:
            reactor = self.env.switch.reactors.get("consensus")
            # snapshot under the reactor's lock: add_peer/remove_peer
            # mutate the dict from peer threads while this RPC iterates
            lock = getattr(reactor, "_lock", None)
            if lock is not None:
                with lock:
                    items = list(reactor.peer_states.items())
            else:
                items = list(getattr(reactor, "peer_states", {}).items())
            for pid, ps in items:
                (h, r, step, has_prop, parts,
                 last_commit_round) = ps.snapshot()
                peer_states[pid] = {
                    "height": h, "round": r, "step": step,
                    "has_proposal": has_prop,
                    "proposal_parts": sorted(parts),
                    "last_commit_round": last_commit_round,
                }
        bus = self.env.event_bus
        return jsonify({
            "round_state": {
                "height": rs.height, "round": rs.round,
                "step": int(rs.step),
                "proposal": rs.proposal.to_obj() if rs.proposal else None,
                "locked_round": rs.locked_round,
                "locked_block_hash":
                    rs.locked_block.hash() if rs.locked_block else b"",
                "validators":
                    rs.validators.to_obj() if rs.validators else None,
            },
            "peer_round_states": peer_states,
            # slow-subscriber visibility: bounded
            # event buffers evict oldest-first and count here
            "event_bus": None if bus is None else {
                "subscriptions": bus.n_subscriptions(),
                "dropped_total": bus.dropped_total,
            },
        })

    # ------------------------------------------------------------ blockchain

    def blockchain(self, min_height: int = 0, max_height: int = 0) -> dict:
        """rpc/core/blocks.go:66 BlockchainInfo: metas for a range,
        newest first, capped at 20."""
        store = self.env.block_store
        h = store.height()
        if max_height <= 0 or max_height > h:
            max_height = h
        if min_height <= 0:
            min_height = max(1, max_height - 19)
        min_height = max(min_height, max_height - 19)
        metas = []
        for hh in range(max_height, min_height - 1, -1):
            meta = store.load_block_meta(hh)
            if meta is not None:
                metas.append(meta.to_obj())
        return jsonify({"last_height": h, "block_metas": metas})

    def block(self, height: int = 0) -> dict:
        store = self.env.block_store
        if height <= 0:
            height = store.height()
        meta = store.load_block_meta(height)
        blk = store.load_block(height)
        if blk is None:
            raise RPCError(-32000, f"no block at height {height}")
        return jsonify({"block_meta": meta.to_obj() if meta else None,
                        "block": blk.to_obj()})

    def block_results(self, height: int = 0) -> dict:
        """rpc/core/blocks.go:332 BlockResults: the ABCI responses
        (DeliverTx results + EndBlock) persisted for `height` by the
        state store (state/store.go:127)."""
        store = self.env.block_store
        h = store.height()
        if height <= 0:
            height = h
        if height > h or height < 1:
            raise RPCError(-32000,
                           f"height {height} must be in [1, {h}]")
        results = self.env.state_store.load_abci_responses(height)
        if results is None:
            raise RPCError(-32000, f"no results for height {height}")
        if "deliver_txs_uniform" in results:
            # the compact persisted form is internal: external clients
            # always see the per-tx deliver_txs shape
            from tendermint_tpu_torch.state.execution import ABCIResponses
            resp = ABCIResponses.from_obj(results)
            results = {"deliver_txs": [r.to_obj()
                                       for r in resp.deliver_txs],
                       "end_block": resp.end_block_obj}
        return jsonify({"height": height, "results": results})

    def commit(self, height: int = 0) -> dict:
        """rpc/core/blocks.go:278: height's commit; the canonical commit
        for the latest height is the SeenCommit."""
        store = self.env.block_store
        h = store.height()
        if height <= 0:
            height = h
        meta = store.load_block_meta(height)
        if meta is None:
            raise RPCError(-32000, f"no block at height {height}")
        if height == h:
            commit = store.load_seen_commit(height)
            canonical = False
        else:
            commit = store.load_block_commit(height)
            canonical = True
        return jsonify({"header": meta.header.to_obj(),
                        "commit": commit.to_obj() if commit else None,
                        "canonical": canonical})

    def validators(self, height: int = 0) -> dict:
        """rpc/core/consensus.go:47."""
        if height <= 0:
            cs = self.env.consensus
            height = cs.state.last_block_height + 1
            valset = cs.state.validators
        else:
            valset = self.env.state_store.load_validators(height)
        return jsonify({"block_height": height,
                        "validators": valset.to_obj()})

    # --------------------------------------------------------------- mempool

    def unconfirmed_txs(self, limit: int = 30) -> dict:
        txs = self.env.mempool.reap(limit)
        return jsonify({"n_txs": len(txs), "txs": txs})

    def num_unconfirmed_txs(self) -> dict:
        return {"n_txs": self.env.mempool.size()}

    def _check_tx(self, tx: bytes):
        from tendermint_tpu_torch.mempool import MempoolFull, TxAlreadyInCache
        if self.tx_batcher is not None:
            # front-door coalescing: admission errors come back as result
            # codes and map onto the direct path's RPCError surface
            res = self.tx_batcher.submit(tx)
            if isinstance(res, Exception):
                raise RPCError(-32000, str(res))
            if res.code != 0 and (
                    res.log == "tx already in cache" or
                    res.log.startswith("mempool is full")):
                raise RPCError(-32000, res.log)
            return res
        try:
            return self.env.mempool.check_tx(tx)
        except TxAlreadyInCache:
            raise RPCError(-32000, "tx already in cache")
        except MempoolFull as e:
            raise RPCError(-32000, str(e))

    def broadcast_tx_async(self, tx: bytes) -> dict:
        """Fire-and-forget (rpc/core/mempool.go:51): with the front-door
        batcher the tx rides its next merged check_tx_batch; the thread
        plane runs the check on a one-off thread."""
        import hashlib
        slo_obs.admit(tx, chain=self._chain)
        if self.tx_batcher is not None:
            self.tx_batcher.submit(tx, wait=False)
        else:
            threading.Thread(target=lambda: self._try_check(tx),
                             daemon=True).start()
        return jsonify({"hash": hashlib.sha256(tx).digest()})

    def _try_check(self, tx: bytes) -> None:
        try:
            self._check_tx(tx)
        except RPCError:
            pass

    def broadcast_tx_sync(self, tx: bytes) -> dict:
        """Wait for CheckTx result (rpc/core/mempool.go:91)."""
        import hashlib
        slo_obs.admit(tx, chain=self._chain)
        res = self._check_tx(tx)
        return jsonify({"code": res.code, "data": res.data,
                        "log": res.log,
                        "hash": hashlib.sha256(tx).digest()})

    def broadcast_tx_batch(self, txs: list) -> dict:
        """Batched CheckTx admission: one RPC round trip and one
        mempool lock for the whole list (no reference equivalent — the
        tm-bench-style per-tx casts cost a server round trip per tx,
        capping injection far below the commit rate the pipelined block
        path sustains). `txs` are hex strings; returns per-tx
        {code, log} aligned with the input."""
        if not isinstance(txs, list):
            raise RPCError(-32602, "txs must be a list of hex strings")
        try:
            raw = [bytes.fromhex(t[2:] if t.startswith("0x") else t)
                   for t in txs]
        except (ValueError, AttributeError) as e:
            raise RPCError(-32602, f"bad tx hex: {e}") from e
        slo_obs.admit_many(raw, chain=self._chain)
        mp = self.env.mempool
        if hasattr(mp, "check_tx_batch"):
            results = mp.check_tx_batch(raw)
        else:  # mock/minimal mempools: per-tx path, errors as codes
            from tendermint_tpu_torch.abci.types import ResultCheckTx
            from tendermint_tpu_torch.mempool import (MempoolFull,
                                                TxAlreadyInCache)
            results = []
            for tx in raw:
                try:
                    results.append(mp.check_tx(tx))
                except TxAlreadyInCache:
                    results.append(ResultCheckTx(
                        code=1, log="tx already in cache"))
                except MempoolFull as e:
                    results.append(ResultCheckTx(code=1, log=str(e)))
        return jsonify({"results": [{"code": r.code, "log": r.log}
                                    for r in results]})

    def broadcast_tx_commit(self, tx: bytes, timeout: float = 60.0) -> dict:
        """CheckTx then wait for the tx to land in a block
        (rpc/core/mempool.go:109): subscribe to EventTx for this hash
        BEFORE submitting, then block on delivery."""
        import hashlib
        slo_obs.admit(tx, chain=self._chain)
        bus = self.env.event_bus
        tx_hash = hashlib.sha256(tx).hexdigest().upper()
        subscriber = f"bcast-{tx_hash[:16]}-{time.monotonic_ns()}"
        query = f"tm.event = 'Tx' AND {TagTxHash} = '{tx_hash}'"
        sub = bus.subscribe(subscriber, query)
        try:
            try:
                check = self._check_tx(tx)
            except RPCError as e:
                # a re-broadcast of a tx that is STILL PENDING should
                # wait for its commit, not error — O(1) to distinguish
                # from a genuine duplicate via the mempool hash index
                mp = self.env.mempool
                if "already in cache" in str(e.args) and \
                        hasattr(mp, "get_by_hash") and mp.get_by_hash(
                            hashlib.sha256(tx).digest()) is not None:
                    from tendermint_tpu_torch.abci.types import ResultCheckTx
                    check = ResultCheckTx(code=0, log="tx already pending")
                else:
                    raise
            if not check.ok:
                return jsonify({"check_tx": check.to_obj(),
                                "deliver_tx": None, "hash": tx_hash,
                                "height": 0})
            try:
                item = sub.get(timeout=timeout)
            except Exception:
                raise RPCError(-32000,
                               "timed out waiting for tx to commit")
            data = item.data
            return jsonify({"check_tx": check.to_obj(),
                            "deliver_tx": data["result"].to_obj(),
                            "hash": tx_hash,
                            "height": data["height"]})
        finally:
            bus.unsubscribe_all(subscriber)

    def unsafe_flush_mempool(self) -> dict:
        self.env.mempool.flush()
        return {}

    # profiling (rpc/core/dev.go:23-43; cProfile/tracemalloc instead of
    # Go's pprof). Per-instance state + lock: multiple in-process nodes
    # each own their profiler, and concurrent starts cannot double-enable.

    def unsafe_start_cpu_profiler(self, filename: str = "") -> dict:
        import cProfile
        with self._profiler_lock:
            if self._profiler is not None:
                raise RPCError(-32000, "profiler already running")
            self._profiler = (cProfile.Profile(), filename or "cpu.prof")
            self._profiler[0].enable()
        return {}

    def unsafe_stop_cpu_profiler(self) -> dict:
        with self._profiler_lock:
            if self._profiler is None:
                raise RPCError(-32000, "profiler not running")
            prof, filename = self._profiler
            self._profiler = None
        prof.disable()
        prof.dump_stats(filename)
        return {"written": filename}

    # --------------------------------------------------------- observability

    def metrics(self) -> dict:
        """JSON-RPC view of the telemetry state. Prometheus scrapers use
        the raw GET /metrics path on the same listener instead (served
        as text/plain by the server, not this handler)."""
        return {"enabled": telemetry.enabled(),
                "namespace": telemetry.namespace(),
                "exposition": telemetry.expose()}

    def dump_height_timeline(self, min_height: int = 0,
                             max_height: int = 0) -> dict:
        """The node's causal span ring (telemetry/causal.py) + merge
        metadata: wall-clock anchor, keepalive RTT per peer, drop
        accounting. A merger fetches this route from every node and
        aligns the buffers into one cluster timeline
        (telemetry/merge.py). Empty (enabled=false) unless the trace
        plane is on."""
        from tendermint_tpu_torch.telemetry import causal
        d = causal.dump(min_height, max_height)
        cs = self.env.consensus
        if cs is not None:
            d["height"] = cs.state.last_block_height
        return jsonify(d)

    def debug_profile(self, action: str = "status",
                      hz: float = 0.0) -> dict:
        """The sampling profiler (telemetry/profile.py) over RPC:
        status | start [hz] | stop | dump. `dump` returns the
        collapsed-stack text plus per-subsystem busy/lock-wait sample
        counts. Raw consumers use GET /debug/pprof instead (collapsed
        text, no JSON envelope)."""
        from tendermint_tpu_torch.telemetry import causal, profile
        action = (action or "status").strip().lower()
        if action == "start":
            p = profile.start(hz=hz or None)
            return {"running": True, "hz": p.hz}
        if action == "stop":
            p = profile.stop()
            return {"running": False,
                    "samples": 0 if p is None else p.snapshot()["samples"]}
        if action == "dump":
            doc = profile.snapshot()
            doc["node"] = causal.node()
            return doc
        if action != "status":
            raise RPCError(-32602, f"unknown action {action!r} "
                           f"(status|start|stop|dump)")
        doc = profile.snapshot()
        doc.pop("collapsed", None)  # status is the cheap probe
        doc["node"] = causal.node()
        return doc

    def slo(self, sketches: bool = False) -> dict:
        """The tx-lifecycle SLO table (telemetry/slo.py): per-stage
        p50/p95/p99/p999 over the cumulative sketches and the
        1s/10s/60s rolling windows, in-flight and drop/timeout
        accounting, tail attribution, and the health verdict.
        `sketches=true` adds the mergeable weighted samples a
        cross-node report concatenates. Also served raw at GET /slo."""
        return jsonify(slo_obs.snapshot(sketches=bool(sketches)))

    def healthz(self) -> dict:
        """One JSON verdict for load balancers and operators: height
        progress, queue saturation (telemetry/queues.py catalog), the
        stall detector's episode state, the profiler's top-5 busy
        subsystems, and sync/snapshot status. `ok` is false while any
        queue sits saturated or the chain is stalled."""
        from tendermint_tpu_torch.telemetry import profile, queues
        cs = self.env.consensus
        sd = self.env.stall_detector
        saturated = queues.saturated()
        stalled = bool(sd is not None and sd.stalled)
        prof = profile.get()
        syncing = (self.env.blockchain_reactor is not None and
                   not self.env.blockchain_reactor.synced)
        # SLO verdict fold-in: sampled txs failing to complete (drops
        # beyond 5% of the 60s window's completions, or a saturated
        # tracker) flip the health bit — always {"ok": True} while
        # the plane is off
        slo_verdict = slo_obs.verdict()
        doc = {
            "ok": (not saturated and not stalled and
                   slo_verdict["ok"]),
            "slo": {"enabled": slo_obs.enabled(), **slo_verdict},
            "height": cs.state.last_block_height
            if cs is not None else 0,
            "syncing": syncing,
            "queues": {"saturated": saturated,
                       "table": queues.table()},
            "stall": {"stalled": stalled,
                      "episodes": 0 if sd is None else sd.fired,
                      "window_s": None if sd is None else sd.window_s},
            "profile": {
                "enabled": profile.enabled(),
                "running": bool(prof is not None and prof.running),
                "top": prof.top(5) if prof is not None else [],
            },
        }
        ss = self.env.snapshot_store
        if ss is not None:
            try:
                heights = ss.list_heights()
                doc["snapshot"] = {
                    "latest_height": max(heights) if heights else 0,
                    "count": len(heights)}
            except Exception as e:
                doc["snapshot"] = {"error": repr(e)}
        sr = self.env.statesync_reactor
        if sr is not None and hasattr(sr, "status"):
            try:
                doc["statesync"] = sr.status()
            except Exception as e:
                doc["statesync"] = {"error": repr(e)}
        return jsonify(doc)

    def unsafe_dump_trace(self, filename: str = "") -> dict:
        """Write the in-memory consensus/verifier timeline as
        Chrome-trace JSON (chrome://tracing, ui.perfetto.dev)."""
        filename = filename or "consensus_trace.json"
        n = len(telemetry.TRACER.events())
        return {"written": telemetry.dump_trace(filename), "events": n}

    def unsafe_write_heap_profile(self, filename: str = "") -> dict:
        """First call arms tracemalloc and returns started=true (there is
        nothing to snapshot yet); later calls write the snapshot."""
        import tracemalloc
        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return {"started": True,
                    "note": "tracemalloc armed; call again to snapshot"}
        filename = filename or "heap.prof"
        snap = tracemalloc.take_snapshot()
        with open(filename, "w") as f:
            for stat in snap.statistics("lineno")[:200]:
                f.write(f"{stat}\n")
        return {"written": filename}

    # ------------------------------------------------------------------ abci

    def abci_query(self, path: str = "", data: bytes = b"",
                   height: int = 0, prove: bool = False) -> dict:
        res = self.env.app_conns.query.query(path, data, height=height,
                                             prove=prove)
        return jsonify({"response": res.to_obj()})

    def abci_info(self) -> dict:
        return jsonify({"response": self.env.app_conns.query.info().to_obj()})

    # ------------------------------------------------------------------- txs

    def tx(self, hash: bytes = b"", prove: bool = False) -> dict:
        """rpc/core/tx.go:70 — requires the tx indexer."""
        indexer = self.env.tx_indexer
        if indexer is None:
            raise RPCError(-32000, "transaction indexing is disabled")
        result = indexer.get(hash)
        if result is None:
            # O(1) mempool probe (Mempool.get_by_hash): a pending tx
            # gets a distinguishable error instead of plain not-found
            mp = self.env.mempool
            if hasattr(mp, "get_by_hash") and \
                    mp.get_by_hash(hash) is not None:
                raise RPCError(
                    -32000, f"tx {hash.hex()} is pending in the "
                    f"mempool (not yet committed)")
            raise RPCError(-32000, f"tx {hash.hex()} not found")
        out = dict(result)
        if prove:
            block = self.env.block_store.load_block(result["height"])
            if block is not None:
                from tendermint_tpu_torch.ops import merkle
                root, aunts = merkle.proof_host(block.data.txs,
                                                result["index"])
                out["proof"] = {
                    "root_hash": root,
                    "proof": aunts,
                    "index": result["index"],
                    "total": len(block.data.txs),
                }
        return jsonify(out)

    def tx_search(self, query: str = "", prove: bool = False,
                  page: int = 1, per_page: int = 30) -> dict:
        indexer = self.env.tx_indexer
        if indexer is None:
            raise RPCError(-32000, "transaction indexing is disabled")
        results = indexer.search(query)
        total = len(results)
        start = max(0, (page - 1) * per_page)
        return jsonify({"txs": results[start:start + per_page],
                        "total_count": total})

    # ------------------------------------------------------------------- p2p

    def dial_peers(self, peers: str = "", persistent: bool = False) -> dict:
        from tendermint_tpu_torch.p2p import NetAddress
        addrs = [NetAddress.from_string(p)
                 for p in peers.split(",") if p]
        self.env.switch.dial_peers_async(addrs, persistent=persistent)
        return {"dialed": [str(a) for a in addrs]}

    def dial_seeds(self, seeds: str = "") -> dict:
        """rpc/core/routes.go:41 unsafe_dial_seeds: one-shot dials into
        the topology, non-persistent."""
        return {"dialed": self.dial_peers(seeds)["dialed"],
                "log": "dialing seeds in rounds"}

    # ---------------------------------------------------------------- events

    def subscribe(self, query: str = "", ws=None) -> dict:
        """WS-only (rpc/core/events.go:87): push matching events as
        jsonrpc notifications with id '#event'."""
        bus = self.env.event_bus
        try:
            Query(query)
        except ValueError as e:
            raise RPCError(-32602, f"bad query: {e}")
        sub = bus.subscribe(ws.subscriber_id, query)

        attach = getattr(ws, "attach_subscription", None)
        if attach is not None:
            # async front door: loop-native fan-out, no thread a
            # subscriber; the drain renders each event as the pump does
            def render(item):
                return {"jsonrpc": "2.0", "id": "#event",
                        "result": {"query": item.query,
                                   "data": jsonify(item.data),
                                   "tags": jsonify(item.tags)}}

            attach(sub, render)
            ws.on_close.append(
                lambda w: bus.unsubscribe_all(w.subscriber_id))
            return {}

        def pump():
            while ws.open and not sub.cancelled:
                try:
                    item = sub.get(timeout=0.5)
                except queue.Empty:
                    continue
                try:
                    ws.send_json({"jsonrpc": "2.0", "id": "#event",
                                  "result": {"query": item.query,
                                             "data": jsonify(item.data),
                                             "tags": jsonify(item.tags)}})
                    slo_obs.deliver_item(item)
                except ConnectionError:
                    return

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        ws.on_close.append(
            lambda w: bus.unsubscribe_all(w.subscriber_id))
        return {}

    def unsubscribe(self, query: str = "", ws=None) -> dict:
        self.env.event_bus.unsubscribe(ws.subscriber_id, query)
        return {}

    def unsubscribe_all(self, ws=None) -> dict:
        self.env.event_bus.unsubscribe_all(ws.subscriber_id)
        return {}


def make_server(env: RPCEnv, loop=None):
    """Assemble a server with the full route table: the threaded
    RPCServer, or, handed the node's ReactorLoop, the async front door
    serving every connection on that loop with broadcast_tx batching."""
    core = RPCCore(env)
    if loop is not None:
        from tendermint_tpu_torch.rpc.aserver import AsyncRPCServer
        server = AsyncRPCServer(loop)
        core.enable_tx_batching()
        server._tx_batcher = core.tx_batcher
    else:
        from tendermint_tpu_torch.rpc.server import RPCServer
        server = RPCServer()
    server.register_all(core.routes())
    for name, fn in core.ws_routes().items():
        server.register(name, fn, ws_only=True)
    # raw Prometheus scrape path; serves the (possibly empty) registry
    # even when telemetry is disabled so scrapers never see a 404 flap
    server.metrics_provider = telemetry.expose
    # raw GET /debug/timeline: the causal span ring as JSON (curl-able
    # without a JSON-RPC envelope; same payload as dump_height_timeline)
    server.timeline_provider = core.dump_height_timeline
    # raw GET /healthz (JSON verdict for load balancers) and GET
    # /debug/pprof (flamegraph collapsed-stack text, the Go-pprof
    # convention path) — plain-HTTP consumers, no JSON-RPC envelope
    from tendermint_tpu_torch.telemetry import profile

    def _pprof_text() -> str:
        p = profile.get()
        return "" if p is None else p.collapsed()

    server.raw_routes["/healthz"] = ("application/json", core.healthz)
    # raw GET /slo: the tx-lifecycle SLO table (per-stage quantiles,
    # windows, tail attribution) — same payload as the `slo` route
    server.raw_routes["/slo"] = ("application/json", core.slo)
    server.raw_routes["/debug/pprof"] = (
        "text/plain; charset=utf-8", _pprof_text)
    return server, core
