"""StateSyncReactor, snapshot transfer on channel 0x60: the port's copy of
`tendermint_tpu/statesync/reactor.py`.

Server side (every node with local snapshots): answers
`snapshots_request` with its manifest headlines, serves full manifests
and digest-verified chunks. Client side (a node joining with empty
stores and `base.state_sync` on): discovers offers, picks the best
(highest height, most advertisers), then fetches chunks from several
peers in parallel:

- every chunk is verified against its manifest digest before it
  touches disk; a bad chunk bans the peer (switch-level disconnect and
  a local blacklist) and the chunk is requested elsewhere;
- per-peer exponential backoff with deterministic jitter on timeout
  (on utils/clock.now_s); repeated strikes ban the peer;
- the restore directory is resumable: chunks are content-addressed
  files, so a crash mid-download revalidates what is on disk and only
  fetches the remainder (`resume_pending_restore` also re-runs a torn
  apply at node start; the apply itself is idempotent).

After the last chunk, `apply_restore` light-verifies the snapshot
height's commit against the validator set that signed it (through the
node's BatchVerifier: B1 on the card), rebuilds the app and aborts
(poisoning the snapshot) if the app hash disagrees, bootstraps the
block and state stores, pins the manifest root, and adopts the restore
dir into the local snapshot library, the durable "applied" marker. The
node then falls into fast sync for the tail above the snapshot.

On the loop plane `receive` runs on the node's ReactorLoop thread; the
restore and its verify run on this reactor's own `tm-statesync` thread.
A verifier that fails on its device (VerifierError) is no verdict on a
snapshot: the restore ends with `restore_error` set and the fast-sync
gate held, and the node stops, where any other failure falls back to
block sync as in the JAX package. The JAX module's metric families
(`sync_*`), its `snapshot.restore` span and `sync.chunk` points and its
queue probe (`sync.chunks`) are fed at the same points as the plain
counts that `status()` carries.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import zlib
from typing import Dict, Optional, Set, Tuple

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.models.verifier import VerifierError
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.storage.snapshot import (
    MANIFEST_NAME,
    SnapshotStore,
    chunk_name,
    light_verify_payload,
    manifest_root,
    observe_restore_seconds,
    payload_app_items,
)
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.telemetry import queues as queue_obs
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.utils import clock, fail
from tendermint_tpu_torch.utils.log import get_logger

_m_chunks = telemetry.counter(
    "sync_chunks_total", "State-sync chunks by outcome", ("result",))
_m_offers = telemetry.counter(
    "sync_offers_total", "Snapshot offers received from peers")
_m_restores = telemetry.counter(
    "sync_restores_total", "State-sync restore outcomes", ("outcome",))
_m_pending = telemetry.gauge(
    "sync_chunks_pending", "Chunks not yet fetched in the active restore")

STATESYNC_CHANNEL = 0x60

ADVERTISE_LIMIT = 4         # newest manifests offered per response
DISCOVERY_TICK_S = 0.25
DISCOVERY_WAIT_S = 1.0      # settle time after the first offer
GIVE_UP_S = 20.0            # no usable offer at all -> fall back
CHUNK_TIMEOUT_S = 8.0
MANIFEST_TIMEOUT_S = 5.0
PER_PEER_INFLIGHT = 4
MAX_STRIKES = 3
BACKOFF_BASE_S = 0.5
BACKOFF_CAP_S = 8.0
MAX_RESTORE_ATTEMPTS = 3


def _jitter(peer_id: str, n: int) -> float:
    """Deterministic per-(peer, attempt) jitter in [0, 1): hash-derived,
    so chaos replay reproduces the exact same retry schedule."""
    return (zlib.crc32(f"{peer_id}:{n}".encode()) % 1000) / 1000.0


def _backoff_s(peer_id: str, strikes: int) -> float:
    base = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2 ** max(0, strikes - 1)))
    return base * (1.0 + 0.5 * _jitter(peer_id, strikes))


class _PeerSync:
    """Client-side per-peer fetch state."""

    __slots__ = ("id", "strikes", "backoff_until", "inflight")

    def __init__(self, peer_id: str):
        self.id = peer_id
        self.strikes = 0
        self.backoff_until = 0.0
        self.inflight = 0

    def available(self, now: float) -> bool:
        return self.inflight < PER_PEER_INFLIGHT and \
            now >= self.backoff_until

    def strike(self, now: float) -> None:
        self.strikes += 1
        self.backoff_until = now + _backoff_s(self.id, self.strikes)

    def reward(self) -> None:
        self.strikes = 0
        self.backoff_until = 0.0


def apply_restore(restore_store: SnapshotStore, manifest: dict,
                  block_store, state_store, snapshot_store, app,
                  chain_id: str, verifier=None,
                  timings: Optional[dict] = None):
    """Verify + apply one fully-downloaded snapshot. IDEMPOTENT: every
    step either rewrites identical rows or is a no-op when already
    done, so a crash anywhere inside (the `statesync.before_apply` /
    `statesync.after_restore` fail points) is repaired by simply
    running it again at the next start. Returns the restored State;
    raises ValueError when the snapshot fails verification (the caller
    poisons it). A verifier that fails on its device raises
    VerifierError, which is no verdict on the snapshot. `timings`, when
    given, receives the stages' seconds: assemble (chunks read and
    checked, payload decoded), verify (the light verification of the
    commit), app (the app's install), stores (bootstraps, pin,
    adoption)."""
    height = manifest["height"]
    t0 = time.perf_counter()
    with causal.span("snapshot.restore", height,
                     chunks=len(manifest["chunks"])):
        state = _apply_restore(restore_store, manifest, block_store,
                               state_store, snapshot_store, app, chain_id,
                               verifier, timings)
    observe_restore_seconds(time.perf_counter() - t0)
    return state


def _apply_restore(restore_store, manifest, block_store, state_store,
                   snapshot_store, app, chain_id, verifier, timings):
    height = manifest["height"]
    t = [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + now - t[0]
        t[0] = now

    payload = restore_store.assemble_payload(
        height, expected_root=manifest["root"])
    stage("assemble_s")
    fail.fail_point("statesync.before_apply")
    state, commit = light_verify_payload(payload, chain_id,
                                         verifier=verifier)
    stage("verify_s")
    if state.app_hash.hex() != manifest.get("app_hash", ""):
        raise ValueError(
            f"snapshot {height}: manifest app_hash disagrees with "
            "its own state")
    validators = [(v.pubkey, v.voting_power)
                  for v in state.validators.validators]
    app_hash = app.restore_items(payload_app_items(payload), height,
                                 validators=validators)
    if app_hash != state.app_hash:
        raise ValueError(
            f"snapshot {height}: restored app hash "
            f"{app_hash.hex()[:12]} != state "
            f"{state.app_hash.hex()[:12]}")
    stage("app_s")
    # block store strictly before state store (the handshake
    # tolerates store ahead of state by one, never the reverse);
    # both bootstraps are single atomic batches and idempotent
    block_store.bootstrap(height, commit)
    state_store.bootstrap(state)
    state_store.pin_snapshot(height, manifest)
    fail.fail_point("statesync.after_restore")
    # the durable "applied" marker: the restore dir becomes a
    # normal local snapshot (handshake app-recovery source)
    snapshot_store.adopt_dir(restore_store.dir_for(height), height)
    stage("stores_s")
    return state


def resume_pending_restore(statesync_dir: str, block_store, state_store,
                           snapshot_store, app, chain_id: str,
                           verifier=None, logger=None):
    """Node-start repair: a restore dir whose chunks are all on disk
    but whose apply was torn by a crash is re-applied (idempotent) and
    adopted. Incomplete downloads are left in place for the reactor to
    resume. Returns the restored State or None."""
    restore_store = SnapshotStore(statesync_dir)
    for height in reversed(restore_store.list_heights()):
        manifest = restore_store.load_manifest(height)
        if manifest is None:
            continue
        try:
            state = apply_restore(restore_store, manifest, block_store,
                                  state_store, snapshot_store, app,
                                  chain_id, verifier=verifier)
        except ValueError as e:
            if logger is not None:
                logger.info("pending state-sync restore not resumable",
                            height=height, err=str(e))
            continue
        if telemetry.enabled():
            _m_restores.labels("resumed").inc()
        if logger is not None:
            logger.info("resumed torn state-sync restore", height=height)
        return state
    return None


class StateSyncReactor(Reactor):
    def __init__(self, snapshot_store: SnapshotStore, chain_id: str,
                 restore: bool = False, statesync_dir: str = "",
                 block_store=None, state_store=None, app=None,
                 verifier=None, on_restored=None,
                 give_up_s: float = GIVE_UP_S,
                 chunk_timeout_s: float = CHUNK_TIMEOUT_S):
        super().__init__("statesync")
        self.logger = get_logger("statesync")
        self.snapshot_store = snapshot_store
        self.chain_id = chain_id
        self.restore = restore
        self.statesync_dir = statesync_dir
        self.block_store = block_store
        self.state_store = state_store
        self.app = app
        self.verifier = verifier
        self.on_restored = on_restored
        self.give_up_s = give_up_s
        self.chunk_timeout_s = chunk_timeout_s
        self.restored_state = None
        self.finished = threading.Event()  # set once restore concluded
        #                                    (success OR fallback)
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # client state, all guarded by _lock
        self._offers: Dict[Tuple[int, str], Set[str]] = {}
        self._poisoned: Set[Tuple[int, str]] = set()
        self._banned: Set[str] = set()
        self._peers: Dict[str, _PeerSync] = {}
        self._manifest: Optional[dict] = None       # active restore
        self._manifest_waiting: Optional[Tuple[int, str]] = None
        self._pending: Set[int] = set()             # chunk indexes left
        self._inflight: Dict[int, Tuple[str, float]] = {}
        # queue observatory: chunks still owed against the manifest's
        # total — a restore that sits saturated is fetch-starved (few
        # advertisers, banned peers, or backoff)
        self._queue_probe = queue_obs.register(
            "sync.chunks", self,
            depth=lambda r: len(r._pending) + len(r._inflight),
            capacity=lambda r: len((r._manifest or {}).get(
                "chunks", ())) or 1)
        #: a restore the verifier's device failed (VerifierError): the
        #: gate stays held and the node stops loudly, never falling back
        self.restore_error: Optional[BaseException] = None
        #: plain counts in place of the JAX module's metric families,
        #: guarded by _lock: chunks by outcome, offers, restores
        self.counts = {"chunks_ok": 0, "chunks_bad": 0,
                       "chunks_timeout": 0, "offers": 0,
                       "restored": 0, "fallback": 0}
        #: the restore's stages in seconds: discovery, manifest, fetch,
        #: and apply_restore's (assemble, verify, app, stores)
        self.timings: Dict[str, float] = {}

    def status(self) -> dict:
        """Restore-side progress (the JAX node serves it on /healthz):
        whether this node is restoring, how many chunks remain, the
        outcome once done, and the plane's counts and stage seconds."""
        with self._lock:
            total = len((self._manifest or {}).get("chunks", ()))
            pending = len(self._pending) + len(self._inflight)
            return {
                "restoring": bool(self.restore and
                                  not self.finished.is_set()),
                "finished": self.finished.is_set(),
                "restored": self.restored_state is not None,
                "chunks_total": total,
                "chunks_pending": pending,
                "peers": len(self._peers),
                "banned": len(self._banned),
                "restore_height": (0 if self.restored_state is None else
                                   self.restored_state.last_block_height),
                "error": (None if self.restore_error is None
                          else repr(self.restore_error)),
                **self.counts,
                "timings": dict(self.timings),
            }

    def get_channels(self):
        return [ChannelDescriptor(STATESYNC_CHANNEL, priority=3,
                                  send_queue_capacity=200)]

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self.restore:
            self._thread = threading.Thread(
                target=self._restore_routine, daemon=True,
                name="tm-statesync")
            self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        self._queue_probe.close()
        with self._cond:
            self._cond.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
            self._thread = None

    # ----------------------------------------------------------------- peers

    def add_peer(self, peer) -> None:
        with self._lock:
            if peer.id not in self._peers:
                self._peers[peer.id] = _PeerSync(peer.id)
        if self.restore and not self.finished.is_set():
            peer.try_send_obj(STATESYNC_CHANNEL,
                              {"type": "snapshots_request"})

    def remove_peer(self, peer, reason) -> None:
        with self._cond:
            self._peers.pop(peer.id, None)
            for offered in self._offers.values():
                offered.discard(peer.id)
            for idx, (pid, _) in list(self._inflight.items()):
                if pid == peer.id:
                    del self._inflight[idx]
            self._cond.notify_all()

    def _ban(self, peer, reason: str) -> None:
        self.logger.error("banning state-sync peer", peer=peer.id,
                          reason=reason)
        with self._cond:
            self._banned.add(peer.id)
            self._cond.notify_all()
        if self.switch is not None:
            self.switch.stop_peer_for_error(peer, RuntimeError(reason))

    # --------------------------------------------------------------- receive

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        with self._lock:
            if peer.id in self._banned:
                return
        msg = encoding.cloads(msg_bytes)
        t = msg.get("type")
        if t == "snapshots_request":
            self._serve_snapshots(peer)
        elif t == "snapshots_response":
            self._on_offers(peer, msg.get("snapshots", []))
        elif t == "manifest_request":
            self._serve_manifest(peer, msg)
        elif t == "manifest_response":
            self._on_manifest(peer, msg)
        elif t == "chunk_request":
            self._serve_chunk(peer, msg)
        elif t == "chunk_response":
            self._on_chunk(peer, msg)
        elif t in ("no_manifest", "no_chunk"):
            self._on_refusal(peer, msg)
        else:
            self._ban(peer, f"unknown statesync msg {t!r}")

    # ----------------------------------------------------------- server side

    def _serve_snapshots(self, peer) -> None:
        offers = []
        for h in reversed(self.snapshot_store.list_heights()):
            m = self.snapshot_store.load_manifest(h)
            if m is None:
                continue
            offers.append({"height": m["height"], "root": m["root"],
                           "chunks": len(m["chunks"]),
                           "format": m["format"]})
            if len(offers) >= ADVERTISE_LIMIT:
                break
        peer.try_send_obj(STATESYNC_CHANNEL, {
            "type": "snapshots_response", "snapshots": offers})

    def _serve_manifest(self, peer, msg) -> None:
        m = self.snapshot_store.load_manifest(int(msg.get("height", 0)))
        if m is None or m["root"] != msg.get("root"):
            peer.try_send_obj(STATESYNC_CHANNEL, {
                "type": "no_manifest", "height": msg.get("height", 0),
                "root": msg.get("root", "")})
            return
        peer.try_send_obj(STATESYNC_CHANNEL, {
            "type": "manifest_response", "height": m["height"],
            "manifest": m})

    def _serve_chunk(self, peer, msg) -> None:
        h = int(msg.get("height", 0))
        idx = int(msg.get("index", -1))
        m = self.snapshot_store.load_manifest(h)
        data = None
        if m is not None and m["root"] == msg.get("root"):
            data = self.snapshot_store.read_chunk(h, idx)
        if data is None:
            peer.try_send_obj(STATESYNC_CHANNEL, {
                "type": "no_chunk", "height": h, "index": idx,
                "root": msg.get("root", "")})
            return
        peer.try_send_obj(STATESYNC_CHANNEL, {
            "type": "chunk_response", "height": h, "index": idx,
            "root": msg.get("root", ""), "data": data.hex()})

    # ----------------------------------------------------------- client side

    def _on_offers(self, peer, snapshots) -> None:
        if not self.restore or self.finished.is_set():
            return
        with self._cond:
            for s in snapshots:
                try:
                    key = (int(s["height"]), str(s["root"]))
                except (KeyError, TypeError, ValueError):
                    continue
                if key in self._poisoned:
                    continue
                self._offers.setdefault(key, set()).add(peer.id)
                self.counts["offers"] += 1
                if telemetry.enabled():
                    _m_offers.inc()
            self._cond.notify_all()

    def _on_manifest(self, peer, msg) -> None:
        m = msg.get("manifest")
        with self._lock:
            want = self._manifest_waiting
        if want is None or not isinstance(m, dict):
            return
        if (m.get("height"), m.get("root")) != want:
            return
        # a forged manifest cannot pass: the root is recomputed from
        # the chunk digests it claims (checked OUTSIDE the lock — the
        # ban path re-acquires it)
        try:
            ok = manifest_root(list(m.get("chunks", []))) == want[1]
        except (TypeError, ValueError):
            ok = False
        if not ok:
            self._ban(peer, "manifest root mismatch")
            return
        with self._cond:
            if self._manifest_waiting == want:
                self._manifest = m
                self._manifest_waiting = None
                self._cond.notify_all()

    def _on_chunk(self, peer, msg) -> None:
        try:
            idx = int(msg["index"])
            data = bytes.fromhex(msg["data"])
        except (KeyError, TypeError, ValueError):
            self._ban(peer, "malformed chunk response")
            return
        with self._lock:
            manifest = self._manifest
            if manifest is None or msg.get("root") != manifest["root"] \
                    or not 0 <= idx < len(manifest["chunks"]):
                return  # stale response from an abandoned attempt
            assigned = self._inflight.get(idx, ("", 0.0))[0]
            if assigned != peer.id:
                return  # unsolicited (or late duplicate): ignore
            expected = manifest["chunks"][idx]
        if hashlib.sha256(data).hexdigest() != expected:
            with self._lock:
                self.counts["chunks_bad"] += 1
            if telemetry.enabled():
                _m_chunks.labels("bad").inc()
            self._ban(peer, f"chunk {idx} digest mismatch")
            return
        dir_ = SnapshotStore(self.statesync_dir).dir_for(
            manifest["height"])
        path = os.path.join(dir_, chunk_name(expected))
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        causal.record("sync.chunk", manifest["height"], index=idx,
                      origin=peer.id[:12], bytes=len(data))
        if telemetry.enabled():
            _m_chunks.labels("ok").inc()
        with self._cond:
            self.counts["chunks_ok"] += 1
            self._pending.discard(idx)
            self._inflight.pop(idx, None)
            ps = self._peers.get(peer.id)
            if ps is not None:
                ps.inflight = max(0, ps.inflight - 1)
                ps.reward()
            _m_pending.set(len(self._pending))
            self._cond.notify_all()

    def _on_refusal(self, peer, msg) -> None:
        """A peer declining (pruned its snapshot, lost a chunk): treat
        like a timeout — back it off and reassign its work."""
        with self._cond:
            ps = self._peers.get(peer.id)
            now = clock.now_s()
            for idx, (pid, _) in list(self._inflight.items()):
                if pid == peer.id and idx == msg.get("index", -1):
                    del self._inflight[idx]
                    if ps is not None:
                        ps.inflight = max(0, ps.inflight - 1)
                        ps.strike(now)
            if self._manifest_waiting is not None and \
                    msg.get("type") == "no_manifest":
                if ps is not None:
                    ps.strike(now)
            self._cond.notify_all()

    # --------------------------------------------------------- the restore

    def _restore_routine(self) -> None:
        try:
            state = self._run_restore()
        except VerifierError as e:
            # the device failed, not the snapshot: no poisoning and no
            # fall-back to block sync (the gate stays held); the node
            # reads restore_error and stops loudly
            self.logger.error("state-sync restore: verifier failed",
                              err=repr(e))
            with self._lock:
                self.restore_error = e
            self.finished.set()
            return
        except Exception as e:
            self.logger.error("state-sync restore failed", err=repr(e))
            state = None
        self.restored_state = state
        if telemetry.enabled():
            _m_restores.labels("ok" if state is not None
                               else "fallback").inc()
        with self._lock:
            self.counts["restored" if state is not None
                        else "fallback"] += 1
        self.finished.set()
        cb = self.on_restored
        if cb is not None:
            cb(state)

    def _run_restore(self):
        """Bounded attempts over offered snapshots, best first."""
        started = time.monotonic()
        for _ in range(MAX_RESTORE_ATTEMPTS):
            if self._stopped:
                return None
            t0 = time.perf_counter()
            key = self._discover(started)
            t1 = time.perf_counter()
            self._time("discovery_s", t1 - t0)
            if key is None:
                self.logger.info("state sync: no usable snapshot "
                                 "offered; falling back to block sync")
                return None
            manifest = self._fetch_manifest(key)
            t2 = time.perf_counter()
            self._time("manifest_s", t2 - t1)
            if manifest is None:
                with self._lock:
                    self._poisoned.add(key)
                    self._offers.pop(key, None)
                continue
            try:
                fetched = self._fetch_chunks(manifest)
                self._time("fetch_s", time.perf_counter() - t2)
                if fetched:
                    restore_store = SnapshotStore(self.statesync_dir)
                    stages: Dict[str, float] = {}
                    try:
                        state = apply_restore(
                            restore_store, manifest, self.block_store,
                            self.state_store, self.snapshot_store,
                            self.app, self.chain_id,
                            verifier=self.verifier, timings=stages)
                    finally:
                        for k, v in stages.items():
                            self._time(k, v)
                    self.logger.info("state sync restored",
                                     height=state.last_block_height)
                    return state
            except ValueError as e:
                # verification failure: this snapshot is poisoned —
                # every peer that advertised it vouched for bad data
                self.logger.error("state sync: snapshot rejected",
                                  height=key[0], err=str(e))
                with self._lock:
                    self._poisoned.add(key)
                    self._offers.pop(key, None)
                    self._manifest = None
                continue
        return None

    def _time(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.timings[stage] = self.timings.get(stage, 0.0) + seconds

    def _discover(self, started: float):
        """Wait for offers; returns the best (height, root) or None
        after the give-up window."""
        first_offer_at = None
        last_req = 0.0
        while not self._stopped:
            now = time.monotonic()
            if now - last_req > 1.0 and self.switch is not None:
                self.switch.broadcast_obj(STATESYNC_CHANNEL,
                                          {"type": "snapshots_request"})
                last_req = now
            with self._cond:
                usable = {k: v for k, v in self._offers.items()
                          if k not in self._poisoned and
                          v - self._banned}
                if usable:
                    if first_offer_at is None:
                        first_offer_at = now
                    if now - first_offer_at >= DISCOVERY_WAIT_S:
                        return max(usable,
                                   key=lambda k: (k[0], len(usable[k])))
                elif now - started > self.give_up_s:
                    return None
                self._cond.wait(DISCOVERY_TICK_S)
        return None

    def _fetch_manifest(self, key) -> Optional[dict]:
        height, root = key
        with self._lock:
            peers = sorted(self._offers.get(key, set()) - self._banned)
            self._manifest = None
            self._manifest_waiting = key
        for pid in peers:
            if self._stopped:
                return None
            peer = None if self.switch is None else \
                self.switch.peers.get(pid)
            if peer is None:
                continue
            peer.try_send_obj(STATESYNC_CHANNEL, {
                "type": "manifest_request", "height": height,
                "root": root})
            deadline = time.monotonic() + MANIFEST_TIMEOUT_S
            with self._cond:
                while self._manifest is None and \
                        time.monotonic() < deadline and not self._stopped:
                    self._cond.wait(0.2)
                if self._manifest is not None:
                    self._manifest_waiting = None
                    return self._manifest
        with self._lock:
            self._manifest_waiting = None
        return None

    def _fetch_chunks(self, manifest: dict) -> bool:
        """Parallel multi-peer chunk download with resume; True when
        every chunk is on disk and verified."""
        height, root = manifest["height"], manifest["root"]
        restore_store = SnapshotStore(self.statesync_dir)
        dir_ = restore_store.dir_for(height)
        os.makedirs(dir_, exist_ok=True)
        with open(os.path.join(dir_, MANIFEST_NAME + ".part"), "wb") as f:
            f.write(encoding.cdumps(manifest))
        os.replace(os.path.join(dir_, MANIFEST_NAME + ".part"),
                   os.path.join(dir_, MANIFEST_NAME))
        # resume: content-addressed files already on disk only need a
        # digest re-check (covers torn writes from a crash mid-download)
        pending = set()
        for i, digest in enumerate(manifest["chunks"]):
            path = os.path.join(dir_, chunk_name(digest))
            ok = False
            try:
                with open(path, "rb") as f:
                    ok = hashlib.sha256(f.read()).hexdigest() == digest
            except OSError:
                ok = False
            if not ok:
                pending.add(i)
        with self._cond:
            self._manifest = manifest
            self._pending = pending
            self._inflight = {}
            _m_pending.set(len(pending))
        self.logger.info("state sync: fetching snapshot", height=height,
                         chunks=len(manifest["chunks"]),
                         resumed=len(manifest["chunks"]) - len(pending))
        stall_deadline = time.monotonic() + self.give_up_s
        last_left = len(pending)
        while not self._stopped:
            to_send = []
            with self._cond:
                if not self._pending:
                    return True
                now = clock.now_s()
                # timeouts: strike the peer, requeue the chunk
                for idx, (pid, sent) in list(self._inflight.items()):
                    if now - sent > self.chunk_timeout_s:
                        del self._inflight[idx]
                        ps = self._peers.get(pid)
                        if ps is not None:
                            ps.inflight = max(0, ps.inflight - 1)
                            ps.strike(now)
                            if ps.strikes >= MAX_STRIKES:
                                self._banned.add(pid)
                        self.counts["chunks_timeout"] += 1
                        if telemetry.enabled():
                            _m_chunks.labels("timeout").inc()
                # assign waiting chunks to available peers, spreading
                # load: fewest-inflight, fewest-strikes first
                waiting = sorted(self._pending - set(self._inflight))
                serving = sorted(
                    (self._offers.get((height, root), set())
                     - self._banned) & set(self._peers),
                    key=lambda p: (self._peers[p].strikes,
                                   self._peers[p].inflight, p))
                for idx in waiting:
                    pick = None
                    for pid in serving:
                        if self._peers[pid].available(now):
                            pick = pid
                            break
                    if pick is None:
                        break
                    self._peers[pick].inflight += 1
                    self._inflight[idx] = (pick, now)
                    to_send.append((pick, idx))
                left = len(self._pending)
                made_progress = bool(to_send) or left < last_left
                last_left = left
                self._cond.wait(0.2)
            for pid, idx in to_send:
                peer = None if self.switch is None else \
                    self.switch.peers.get(pid)
                ok = peer is not None and peer.try_send_obj(
                    STATESYNC_CHANNEL, {"type": "chunk_request",
                                        "height": height, "root": root,
                                        "index": idx})
                if not ok:
                    with self._cond:
                        self._inflight.pop(idx, None)
                        ps = self._peers.get(pid)
                        if ps is not None:
                            ps.inflight = max(0, ps.inflight - 1)
            if made_progress:
                stall_deadline = time.monotonic() + self.give_up_s
            elif time.monotonic() > stall_deadline:
                self.logger.error("state sync: chunk fetch stalled",
                                  height=height,
                                  missing=len(self._pending))
                return False
        return False
