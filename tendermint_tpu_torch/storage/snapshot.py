"""Chunked state snapshots, the recovery plane's durable artifact: the
port's copy of `tendermint_tpu/storage/snapshot.py`.

A snapshot holds what a node needs to stand at height H without the
blocks below it: the State (validator sets, params, app hash), the
commit that sealed H, and the application's key/value state. The
payload is one canonical-JSON blob cut into fixed-size chunks; chunk
files are content-addressed (name = SHA-256 of the bytes) and a
manifest lists the ordered chunk digests and their Merkle root
(`merkle.root_host`, the native tree). The root is pinned in the state
store at publication, so a restore from local disk is verified against
the pin; a restore over p2p verifies every chunk against the manifest
and the manifest against its root before anything is applied.

Publication is crash-atomic: the snapshot is written into a `.tmp-*`
sibling and renamed into place, so a crash mid-write (the
`snapshot.after_chunk` / `snapshot.before_publish` fail points) leaves
no half snapshot visible; the next take sweeps the temp dir.

`SnapshotManager` is the node's side: a snapshot every
`base.snapshot_interval` heights, the newest `base.snapshot_keep` kept,
and pruning of the block and state stores behind a floor that never
passes the latest snapshot, the evidence `max_age` horizon or a peer's
catch-up frontier (`prune.mid_range` fires inside the range sweep).
Everything is off by default (interval 0, retain 0). The JAX module's
telemetry families (`snapshot_*`, `prune_*`) are fed at the same points
as the manager's plain counts (`SnapshotManager.counts`).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import Callable, Iterable, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.utils import fail

_m_taken = telemetry.counter(
    "snapshot_taken_total", "Snapshots published")
_m_height = telemetry.gauge(
    "snapshot_height", "Height of the most recent published snapshot")
_m_write_s = telemetry.histogram(
    "snapshot_write_seconds", "Wall time to build + publish one snapshot")
_m_restore_s = telemetry.histogram(
    "snapshot_restore_seconds",
    "Wall time to assemble + verify + apply one snapshot restore")
_m_pruned = telemetry.counter(
    "prune_heights_total", "Heights pruned from a store", ("store",))
_m_floor = telemetry.gauge(
    "prune_floor", "Most recent prune floor (first retained height)")

FORMAT = 1
MANIFEST_NAME = "manifest.json"
DEFAULT_CHUNK_KB = 256


def chunk_name(digest_hex: str) -> str:
    return digest_hex + ".chunk"


def manifest_root(chunk_hashes_hex: List[str]) -> str:
    """Merkle root over the ordered chunk digests (hex). The restore
    side recomputes this from a fetched manifest before requesting a
    single chunk — a forged manifest fails here, a forged chunk fails
    its own digest check."""
    return merkle.root_host(
        [bytes.fromhex(h) for h in chunk_hashes_hex]).hex()


def build_payload(state, commit, app_items: Iterable) -> dict:
    """The snapshot payload at state.last_block_height: the State, the
    commit sealing it, and the app's complete key/value state."""
    return {
        "state": state.to_obj(),
        "commit": commit.to_obj(),
        "app": [[k.hex(), v.hex()] for k, v in app_items],
    }


def payload_app_items(payload: dict) -> list:
    return [(bytes.fromhex(k), bytes.fromhex(v))
            for k, v in payload["app"]]


def light_verify_payload(payload: dict, chain_id: str, verifier=None):
    """Verify a restored payload the way a light client would: the
    commit for the snapshot height must carry +2/3 of the validator
    set that signed it, and must seal exactly the block id the State
    claims as its last. Returns (state, commit); raises ValueError on
    any mismatch (the caller treats that as a poisoned snapshot)."""
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.types.block import Commit
    state = State.from_obj(payload["state"])
    commit = Commit.from_obj(payload["commit"])
    h = state.last_block_height
    if state.chain_id != chain_id:
        raise ValueError(f"snapshot chain_id {state.chain_id!r} != "
                         f"{chain_id!r}")
    if h < 1 or commit.height() != h:
        raise ValueError(
            f"snapshot commit height {commit.height()} != state {h}")
    if commit.block_id.key() != state.last_block_id.key():
        raise ValueError("snapshot commit seals a different block id "
                         "than the state's last_block_id")
    if state.last_validators is None or state.validators is None:
        raise ValueError("snapshot state is missing validator sets")
    state.last_validators.verify_commit(
        chain_id, state.last_block_id, h, commit, verifier=verifier)
    return state, commit


class SnapshotStore:
    """On-disk snapshot library: `<dir>/<height>/` holds a manifest
    plus content-addressed chunk files. All mutation is atomic at the
    directory level."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir

    def dir_for(self, height: int) -> str:
        return os.path.join(self.root_dir, "%d" % height)

    # ------------------------------------------------------------ writing

    def take(self, height: int, payload_obj: dict,
             chunk_size: int = DEFAULT_CHUNK_KB * 1024) -> dict:
        """Serialize + chunk + publish one snapshot; returns the
        manifest. Idempotent: an already-published height returns its
        existing manifest untouched."""
        final = self.dir_for(height)
        if os.path.exists(os.path.join(final, MANIFEST_NAME)):
            return self.load_manifest(height)
        self._sweep_tmp()
        blob = encoding.cdumps(payload_obj)
        chunk_size = max(1, int(chunk_size))
        tmp = os.path.join(self.root_dir, ".tmp-%d" % height)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        hashes: List[str] = []
        app_hash = payload_obj.get("state", {}).get("app_hash", "")
        for off in range(0, len(blob) or 1, chunk_size):
            chunk = blob[off:off + chunk_size]
            digest = hashlib.sha256(chunk).hexdigest()
            with open(os.path.join(tmp, chunk_name(digest)), "wb") as f:
                f.write(chunk)
            hashes.append(digest)
            fail.fail_point("snapshot.after_chunk")
        manifest = {
            "format": FORMAT,
            "height": height,
            "chain_id": payload_obj.get("state", {}).get("chain_id", ""),
            "app_hash": app_hash,
            "size": len(blob),
            "chunk_size": chunk_size,
            "chunks": hashes,
            "root": manifest_root(hashes),
        }
        with open(os.path.join(tmp, MANIFEST_NAME), "wb") as f:
            f.write(encoding.cdumps(manifest))
        fail.fail_point("snapshot.before_publish")
        os.rename(tmp, final)  # the publication instant: all-or-nothing
        return manifest

    def adopt_dir(self, src_dir: str, height: int) -> None:
        """Atomically move a COMPLETE snapshot directory (a finished
        state-sync restore dir — same layout) into the library."""
        final = self.dir_for(height)
        if os.path.exists(os.path.join(final, MANIFEST_NAME)):
            shutil.rmtree(src_dir, ignore_errors=True)
            return
        os.makedirs(self.root_dir, exist_ok=True)
        os.rename(src_dir, final)

    def _sweep_tmp(self) -> None:
        """Remove temp dirs a crash mid-take left behind."""
        try:
            entries = os.listdir(self.root_dir)
        except OSError:
            return
        for name in entries:
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.root_dir, name),
                              ignore_errors=True)

    # ------------------------------------------------------------ reading

    def list_heights(self) -> List[int]:
        try:
            entries = os.listdir(self.root_dir)
        except OSError:
            return []
        out = []
        for name in entries:
            if name.isdigit() and os.path.exists(
                    os.path.join(self.root_dir, name, MANIFEST_NAME)):
                out.append(int(name))
        return sorted(out)

    def load_manifest(self, height: int) -> Optional[dict]:
        path = os.path.join(self.dir_for(height), MANIFEST_NAME)
        try:
            with open(path, "rb") as f:
                return encoding.cloads(f.read())
        except (OSError, ValueError):
            return None

    def read_chunk(self, height: int, index: int) -> Optional[bytes]:
        """Chunk bytes by manifest index, digest-verified on the way
        out — a bit-rotted file is reported missing, not served."""
        manifest = self.load_manifest(height)
        if manifest is None or not 0 <= index < len(manifest["chunks"]):
            return None
        digest = manifest["chunks"][index]
        try:
            with open(os.path.join(self.dir_for(height),
                                   chunk_name(digest)), "rb") as f:
                data = f.read()
        except OSError:
            return None
        if hashlib.sha256(data).hexdigest() != digest:
            return None
        return data

    def assemble_payload(self, height: int,
                         expected_root: str = "") -> dict:
        """Read + verify every chunk, check the manifest root (and the
        caller's pinned root when given), decode the payload. Raises
        ValueError on any integrity failure."""
        manifest = self.load_manifest(height)
        if manifest is None:
            raise ValueError(f"no snapshot manifest at height {height}")
        root = manifest_root(manifest["chunks"])
        if root != manifest["root"]:
            raise ValueError(f"snapshot {height}: manifest root mismatch")
        if expected_root and root != expected_root:
            raise ValueError(
                f"snapshot {height}: root {root[:12]} != pinned "
                f"{expected_root[:12]}")
        buf = bytearray()
        for i in range(len(manifest["chunks"])):
            chunk = self.read_chunk(height, i)
            if chunk is None:
                raise ValueError(f"snapshot {height}: chunk {i} missing "
                                 "or corrupt")
            buf += chunk
        if len(buf) != manifest["size"]:
            raise ValueError(f"snapshot {height}: size mismatch")
        return encoding.cloads(bytes(buf))

    # ----------------------------------------------------------- retention

    def delete(self, height: int) -> None:
        shutil.rmtree(self.dir_for(height), ignore_errors=True)

    def retain(self, keep: int) -> List[int]:
        """Keep the newest `keep` snapshots; returns deleted heights."""
        heights = self.list_heights()
        if keep <= 0 or len(heights) <= keep:
            return []
        drop = heights[:-keep]
        for h in drop:
            self.delete(h)
        return drop


def restore_app_locally(snapshot_store: SnapshotStore, state_store,
                        app, max_height: int) -> Optional[tuple]:
    """Handshake-side app recovery: rebuild the in-memory app from the
    newest LOCAL snapshot at or below `max_height`, verified against
    the root pinned in the state store (an unpinned snapshot dir is
    ignored — restores are verified, not trusted). Returns
    (height, app_hash) or None when no usable snapshot exists."""
    if app is None or not hasattr(app, "restore_items"):
        return None
    for height in reversed(snapshot_store.list_heights()):
        if height > max_height:
            continue
        pin = state_store.load_snapshot_pin(height)
        if pin is None:
            continue
        try:
            payload = snapshot_store.assemble_payload(
                height, expected_root=pin.get("root", ""))
        except ValueError:
            continue
        from tendermint_tpu_torch.state.state import State
        state = State.from_obj(payload["state"])
        validators = [(v.pubkey, v.voting_power)
                      for v in state.validators.validators]
        app_hash = app.restore_items(
            payload_app_items(payload), height, validators=validators)
        if app_hash != state.app_hash:
            raise ValueError(
                f"local snapshot {height}: restored app hash "
                f"{app_hash.hex()[:12]} != state "
                f"{state.app_hash.hex()[:12]}")
        return height, app_hash
    return None


class SnapshotManager:
    """Node-side orchestration: take a snapshot every `interval`
    heights on the commit path (the app is exactly at the committed
    height there), retain the newest `keep`, then prune the block and
    state stores behind the combined floor. All no-op when interval
    and retain_heights are both 0."""

    def __init__(self, snapshot_store: SnapshotStore, state_store,
                 block_store, app, interval: int = 0, keep: int = 2,
                 chunk_size: int = DEFAULT_CHUNK_KB * 1024,
                 retain_heights: int = 0,
                 peer_floor: Optional[Callable[[], int]] = None,
                 logger=None):
        from tendermint_tpu_torch.utils.log import get_logger
        self.store = snapshot_store
        self.state_store = state_store
        self.block_store = block_store
        self.app = app
        self.interval = max(0, int(interval))
        self.keep = max(1, int(keep))
        self.chunk_size = max(1, int(chunk_size))
        self.retain_heights = max(0, int(retain_heights))
        self.peer_floor = peer_floor
        self.logger = logger or get_logger("snapshot")
        self._warned_no_app = False
        #: snapshots published, heights pruned from each store, the last
        #: floor, and the seconds of the take, the prunes and the
        #: compactions (the telemetry plane's families, as counts)
        self.counts = {"published": 0, "latest": 0, "pruned_blocks": 0,
                       "pruned_state": 0, "floor": 0, "prunes": 0,
                       "take_s": 0.0, "prune_s": 0.0, "compact_s": 0.0}

    @property
    def enabled(self) -> bool:
        return self.interval > 0

    def maybe_snapshot(self, state) -> Optional[dict]:
        """Commit-path hook: called with the post-apply State while the
        app still sits at exactly state.last_block_height. Publishes on
        interval heights, then prunes."""
        h = state.last_block_height
        if self.interval <= 0 or h <= 0 or h % self.interval != 0:
            self._maybe_prune(state)
            return None
        if os.path.exists(os.path.join(self.store.dir_for(h),
                                       MANIFEST_NAME)):
            return None
        items = None
        if self.app is not None and hasattr(self.app, "snapshot_items"):
            items = self.app.snapshot_items()
        if items is None:
            if not self._warned_no_app:
                self._warned_no_app = True
                self.logger.info(
                    "snapshots disabled: app exposes no snapshot_items")
            return None
        commit = self.block_store.load_seen_commit(h)
        if commit is None:
            self.logger.error("snapshot skipped: no seen commit",
                              height=h)
            return None
        t0 = time.perf_counter()
        manifest = self.store.take(
            h, build_payload(state, commit, items), self.chunk_size)
        self.state_store.pin_snapshot(h, manifest)
        for dropped in self.store.retain(self.keep):
            self.state_store.unpin_snapshot(dropped)
        self.counts["published"] += 1
        self.counts["latest"] = h
        take_s = time.perf_counter() - t0
        self.counts["take_s"] += take_s
        if telemetry.enabled():
            _m_taken.inc()
            _m_height.set(h)
            _m_write_s.observe(take_s)
        self.logger.info("snapshot published", height=h,
                         chunks=len(manifest["chunks"]),
                         bytes=manifest["size"])
        self._maybe_prune(state)
        return manifest

    # ------------------------------------------------------------- pruning

    def _maybe_prune(self, state) -> None:
        if self.retain_heights <= 0:
            return
        h = state.last_block_height
        snap = self.state_store.latest_snapshot_height()
        if snap <= 0:
            return  # a pruned store without a snapshot cannot rebuild
            #         the app on restart — never prune snapshotless
        floor = h - self.retain_heights + 1
        floor = min(floor, snap)
        if self.peer_floor is not None:
            floor = min(floor, self.peer_floor())
        if floor <= self.block_store.base():
            return
        t0 = time.perf_counter()
        n_blocks = self.block_store.prune(floor)
        # the state store's extra horizon: evidence within the age
        # window still verifies against historical valsets, so its
        # floor never passes height - max_age
        ev_floor = min(
            floor, h - state.consensus_params.evidence.max_age + 1)
        n_state = 0
        if ev_floor >= 2:
            n_state = self.state_store.prune(ev_floor)
        t1 = time.perf_counter()
        self.counts["prune_s"] += t1 - t0
        if n_blocks or n_state:
            self.block_store.db.compact()
            if self.state_store.db is not self.block_store.db:
                self.state_store.db.compact()
            self.counts["compact_s"] += time.perf_counter() - t1
            self.counts["pruned_blocks"] += n_blocks
            self.counts["pruned_state"] += n_state
            self.counts["floor"] = floor
            self.counts["prunes"] += 1
            if telemetry.enabled():
                _m_pruned.labels("block").inc(n_blocks)
                _m_pruned.labels("state").inc(n_state)
                _m_floor.set(floor)
            self.logger.info("pruned stores", floor=floor,
                             blocks=n_blocks, state_heights=n_state)


def observe_restore_seconds(seconds: float) -> None:
    if telemetry.enabled():
        _m_restore_s.observe(seconds)
