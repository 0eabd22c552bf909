"""BlockPool, the pipelined block downloader of fast sync: the port's copy
of `tendermint_tpu/blockchain/pool.py` (blockchain/pool.go).

Tracks peers and their advertised heights, keeps up to
MAX_PENDING_REQUESTS heights in flight (each assigned to one peer),
collects responses, and hands completed consecutive blocks to the
reactor via `peek_two_blocks`/`peek_window`.

Peer discipline: a timed-out or slow request STRIKES
its peer and puts it on per-peer exponential backoff with
deterministic jitter (clocked via utils/clock.now_s, so chaos
skew/replay reproduce the exact schedule); requests route away from
struck peers toward responsive ones, and only MAX_STRIKES consecutive
failures evict — never the last remaining peer, which is throttled
instead (a slow sync beats a dead one). The JAX package's `fastsync_*`
families and its queue probe (`fastsync.requests`) are fed where the
JAX pool feeds them."""

from __future__ import annotations

import logging
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.p2p.conn.flowrate import FlowMonitor
from tendermint_tpu_torch.telemetry import queues as queue_obs
from tendermint_tpu_torch.utils import clock

logger = logging.getLogger(__name__)

MAX_PENDING_REQUESTS = 1000       # blockchain/pool.go:31
MAX_PENDING_PER_PEER = 50
MIN_RECV_RATE = 7680              # B/s (blockchain/pool.go:35-42)
REQUEST_TIMEOUT_S = 15.0
MIN_RATE_GRACE_S = 2.0
MAX_STRIKES = 3                   # consecutive failures before eviction
BACKOFF_BASE_S = 1.0
BACKOFF_CAP_S = 30.0

# Fast-sync window health: how many completed blocks sit buffered ahead
# of the apply height (the blocks/sec number starves when this gauge
# hits 0 — the verifier is outrunning the network).
_m_window_fill = telemetry.gauge(
    "fastsync_window_fill",
    "Completed blocks buffered ahead of the apply height")
_m_blocks = telemetry.counter(
    "fastsync_blocks_received_total", "Blocks accepted from peers")
_m_requests = telemetry.counter(
    "fastsync_requests_total", "Block requests sent to peers")
_m_height = telemetry.gauge(
    "fastsync_height", "Next height the fast-sync pool will apply")
_m_strikes = telemetry.counter(
    "fastsync_peer_strikes_total",
    "Request timeouts / slow windows charged to peers")


def _jitter(peer_id: str, n: int) -> float:
    """Deterministic per-(peer, strike) jitter in [0, 1): derived from
    a hash, not a RNG, so a chaos replay reproduces the schedule."""
    return (zlib.crc32(f"{peer_id}:{n}".encode()) % 1000) / 1000.0


class BpPeer:
    """blockchain/pool.go:369 bpPeer + strike/backoff discipline."""

    def __init__(self, peer_id: str, height: int):
        self.id = peer_id
        self.height = height
        self.num_pending = 0
        self.recv_monitor = FlowMonitor()
        self.burst_started_at = 0.0
        self.strikes = 0          # consecutive timeouts / slow windows
        self.backoff_until = 0.0  # clock.now_s() deadline
        self.blocks_received = 0

    def on_request(self) -> None:
        if self.num_pending == 0:
            # measure rate per request burst, not per peer lifetime —
            # idle gaps must not dilute the average into an eviction
            # (the reference resets its timeout the same way,
            # blockchain/pool.go resetMonitor/resetTimeout)
            self.recv_monitor = FlowMonitor()
            self.burst_started_at = time.monotonic()
        self.num_pending += 1

    def on_request_failed(self) -> None:
        self.num_pending = max(0, self.num_pending - 1)

    def on_block(self, size: int) -> None:
        self.num_pending = max(0, self.num_pending - 1)
        self.recv_monitor.update(size)
        self.blocks_received += 1
        self.strikes = 0
        self.backoff_until = 0.0

    def strike(self, now: float) -> None:
        """One failure: exponential backoff with deterministic jitter."""
        self.strikes += 1
        base = min(BACKOFF_CAP_S,
                   BACKOFF_BASE_S * (2 ** (self.strikes - 1)))
        self.backoff_until = now + base * (1.0 + 0.5 * _jitter(
            self.id, self.strikes))
        _m_strikes.inc()

    def in_backoff(self, now: float) -> bool:
        return now < self.backoff_until

    def is_slow(self) -> bool:
        if self.num_pending == 0:
            return False
        if time.monotonic() - self.burst_started_at < MIN_RATE_GRACE_S:
            return False
        return self.recv_monitor.rate < MIN_RECV_RATE


class _Request:
    __slots__ = ("height", "peer_id", "block", "sent_at")

    def __init__(self, height: int, peer_id: str):
        self.height = height
        self.peer_id = peer_id
        self.block = None
        self.sent_at = clock.now_s()


class BlockPool:
    def __init__(self, start_height: int,
                 send_request: Callable[[str, int], bool],
                 on_peer_error: Callable[[str, str], None],
                 max_pending_per_peer: int = MAX_PENDING_PER_PEER):
        """send_request(peer_id, height) -> sent ok;
        on_peer_error(peer_id, reason) drops the peer at the switch.
        max_pending_per_peer: in-flight request cap per peer — the
        reference default (pool.go), raised by benches whose single
        in-process peer would otherwise cap the verify window."""
        self.height = start_height           # next height to sync
        self.send_request = send_request
        self.on_peer_error = on_peer_error
        self.max_pending_per_peer = max_pending_per_peer
        self._lock = threading.Lock()
        self.peers: Dict[str, BpPeer] = {}
        self.requests: Dict[int, _Request] = {}
        self._started_at = time.monotonic()
        self._n_filled = 0  # requests holding a completed block
        # queue observatory: the in-flight request window — saturated
        # means the apply side is the fast-sync bottleneck, empty
        # means the network is
        self._queue_probe = queue_obs.register(
            "fastsync.requests", self,
            depth=lambda p: len(p.requests),
            capacity=MAX_PENDING_REQUESTS)

    # ----------------------------------------------------------------- peers

    def set_peer_height(self, peer_id: str, height: int) -> None:
        with self._lock:
            p = self.peers.get(peer_id)
            if p is None:
                self.peers[peer_id] = BpPeer(peer_id, height)
            else:
                p.height = max(p.height, height)

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            self.peers.pop(peer_id, None)
            for req in self.requests.values():
                if req.peer_id == peer_id and req.block is None:
                    req.peer_id = ""          # reassign on next tick

    def max_peer_height(self) -> int:
        with self._lock:
            return max((p.height for p in self.peers.values()), default=0)

    def num_peers(self) -> int:
        with self._lock:
            return len(self.peers)

    # -------------------------------------------------------------- requests

    def reset_height(self, start_height: int) -> None:
        """Adopt a new sync frontier (a state-sync restore landed):
        drop every request below it and resume from there."""
        with self._lock:
            self.height = max(self.height, start_height)
            for h in list(self.requests):
                if h < self.height:
                    req = self.requests.pop(h)
                    if req.block is not None:
                        self._n_filled = max(0, self._n_filled - 1)
                    p = self.peers.get(req.peer_id)
                    if p is not None and req.block is None:
                        p.on_request_failed()
            _m_height.set(self.height)
            _m_window_fill.set(self._n_filled)

    def make_next_requests(self) -> None:
        """Assign un-requested heights to capable peers (the reference's
        makeRequestersRoutine + pickIncrAvailablePeer)."""
        to_send: List[tuple] = []
        with self._lock:
            now = clock.now_s()
            max_h = max((p.height for p in self.peers.values()), default=0)
            # reassign orphaned requests (their peer vanished/timed out)
            for req in self.requests.values():
                if req.block is None and req.peer_id == "":
                    peer = self._pick_peer(req.height, now)
                    if peer is not None:
                        req.peer_id = peer.id
                        req.sent_at = now
                        peer.on_request()
                        to_send.append((peer.id, req.height))
            next_h = self.height
            while len(self.requests) < MAX_PENDING_REQUESTS:
                while next_h in self.requests:
                    next_h += 1
                if next_h > max_h:
                    break
                peer = self._pick_peer(next_h, now)
                if peer is None:
                    break
                req = _Request(next_h, peer.id)
                self.requests[next_h] = req
                peer.on_request()
                to_send.append((peer.id, next_h))
        if to_send:
            _m_requests.inc(len(to_send))
        for peer_id, h in to_send:
            if not self.send_request(peer_id, h):
                with self._lock:
                    req = self.requests.get(h)
                    if req is not None and req.peer_id == peer_id:
                        req.peer_id = ""
                    p = self.peers.get(peer_id)
                    if p is not None:
                        p.on_request_failed()  # drain the phantom pending

    def _pick_peer(self, height: int, now: float) -> Optional[BpPeer]:
        """Route toward responsive peers: capable, not in backoff,
        fewest strikes first, then least loaded. Deterministic
        tie-break by id so replays schedule identically."""
        candidates = [p for p in self.peers.values()
                      if p.height >= height and
                      p.num_pending < self.max_pending_per_peer and
                      not p.in_backoff(now)]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda p: (p.strikes, p.num_pending, p.id))

    def retry_stale_requests(self) -> None:
        """Strike peers behind timed-out / slow requests, reassign the
        work, and evict only peers that struck out — never the last
        one standing."""
        drop: List[tuple] = []
        with self._lock:
            now = clock.now_s()
            struck: Dict[str, str] = {}
            for p in list(self.peers.values()):
                if p.is_slow() and not p.in_backoff(now):
                    struck[p.id] = "slow peer (min recv rate)"
            for req in self.requests.values():
                if req.block is not None:
                    continue
                if req.peer_id and now - req.sent_at > REQUEST_TIMEOUT_S:
                    struck.setdefault(req.peer_id,
                                      "block request timeout")
                    req.peer_id = ""
                    req.sent_at = now
            for peer_id, reason in struck.items():
                p = self.peers.get(peer_id)
                if p is None:
                    continue
                p.strike(now)
                if p.strikes >= MAX_STRIKES and len(self.peers) > 1:
                    drop.append((peer_id, f"{reason} x{p.strikes}"))
        for peer_id, reason in drop:
            logger.info("evicting fast-sync peer %s: %s", peer_id, reason)
            self.remove_peer(peer_id)
            self.on_peer_error(peer_id, reason)
        self.make_next_requests()

    # --------------------------------------------------------------- blocks

    def add_block(self, peer_id: str, block, size: int) -> bool:
        """blockchain/pool.go:224 AddBlock. False = unsolicited/mismatched
        (caller should penalize the peer)."""
        with self._lock:
            req = self.requests.get(block.header.height)
            if req is None or req.block is not None:
                return False
            if req.peer_id and req.peer_id != peer_id:
                return False
            req.block = block
            req.peer_id = peer_id
            p = self.peers.get(peer_id)
            if p is not None:
                p.on_block(size)
            self._n_filled += 1
            _m_blocks.inc()
            _m_window_fill.set(self._n_filled)
            return True

    def peek_two_blocks(self) -> tuple:
        """(first, second) = blocks at (height, height+1), either None
        (blockchain/pool.go:173)."""
        with self._lock:
            first = self.requests.get(self.height)
            second = self.requests.get(self.height + 1)
            return (first.block if first else None,
                    second.block if second else None)

    def peek_window(self, k: int, skip: int = 0) -> List:
        """Up to k+1 consecutive completed blocks starting at
        `height + skip`. The reactor verifies block i with block i+1's
        LastCommit, so a returned list of n blocks yields n-1 verifiable
        ones. `skip` lets the reactor collect the NEXT window while a
        previous window's device dispatch is still in flight (the
        pipelined sync loop)."""
        with self._lock:
            blocks = []
            h = self.height + skip
            while len(blocks) < k + 1:
                req = self.requests.get(h)
                if req is None or req.block is None:
                    break
                blocks.append(req.block)
                h += 1
            return blocks

    def pop_request(self) -> None:
        """Advance past a verified + applied block."""
        with self._lock:
            req = self.requests.pop(self.height, None)
            self.height += 1
            if req is not None and req.block is not None:
                self._n_filled = max(0, self._n_filled - 1)
            _m_window_fill.set(self._n_filled)
            _m_height.set(self.height)

    def redo_request(self, height: int) -> List[str]:
        """Bad block: reassign this height (and its successor — the lying
        commit may be either's) to other peers. Returns the peer ids that
        supplied the bad data so the reactor can disconnect them."""
        bad: List[str] = []
        with self._lock:
            for h in (height, height + 1):
                req = self.requests.get(h)
                if req is not None:
                    if req.peer_id:
                        bad.append(req.peer_id)
                        self.peers.pop(req.peer_id, None)
                    if req.block is not None:
                        self._n_filled = max(0, self._n_filled - 1)
                    fresh = _Request(h, "")
                    fresh.peer_id = ""
                    self.requests[h] = fresh
            _m_window_fill.set(self._n_filled)
        return bad

    def is_caught_up(self) -> bool:
        """blockchain/pool.go:153 IsCaughtUp."""
        with self._lock:
            if not self.peers:
                return time.monotonic() - self._started_at > 5.0
            max_h = max(p.height for p in self.peers.values())
            return self.height >= max_h
