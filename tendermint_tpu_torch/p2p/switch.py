"""Switch — peer lifecycle hub: the port's copy of
`tendermint_tpu/p2p/switch.py` (p2p/switch.go), on the thread plane.

Owns the reactors, routes channels to them, accepts inbound connections,
dials outbound ones (with reconnect + exponential backoff for persistent
peers, :279-330), and broadcasts messages to every connected peer.

The full connection path for either direction:
  raw TCP -> SecretConnection (authenticated encryption, identity pinned)
  -> NodeInfo exchange (version/network/channel compatibility)
  -> Peer(MConnection) started -> reactors notified

Handed the node's ReactorLoop (`loop=`), every peer's socket runs on it
(LoopMConnection) once its handshake is done, and the reactors run their
per-peer routines as the loop's tasks; accepts, handshakes and dials keep
their threads, as in the JAX package. The ban plane's settings and the
frame bursts come from the P2PConfig (`ban_score`, `ban_base_s`,
`fd_headroom`, `burst`, `burst_max`) under their knobs
(TM_CUDA_P2P_BAN_SCORE, _BAN_BASE_S, _FD_HEADROOM, TM_CUDA_P2P_BURST). A wildcard listener asks a UPnP
gateway for its external address when `skip_upnp` is false. The JAX
switch's `p2p_*` families are fed at the same points. With the chaos
plane on (chaos.resolve()), each link is wrapped in a schedule-driven
FuzzedLink once its handshake is done; off, the link is used unchanged.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.chaos import maybe_wrap_link
from tendermint_tpu_torch.config import P2PConfig
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor, SecretConnection
from tendermint_tpu_torch.p2p.conn.burst import Burst
from tendermint_tpu_torch.p2p.conn.mconn import PlainFramedConn
from tendermint_tpu_torch.p2p.key import NodeKey, pubkey_to_id
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.peer import (
    Peer,
    PeerSet,
    read_handshake_msg,
    write_handshake_msg,
)
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.utils import clock, knobs
from tendermint_tpu_torch.utils.log import get_logger

_m_peers = telemetry.gauge(
    "p2p_peers", "Connected peers")
_m_sent = telemetry.counter(
    "p2p_msgs_sent_total", "Messages enqueued to peers, by channel",
    ("channel",))
_m_recv = telemetry.counter(
    "p2p_msgs_recv_total", "Messages received from peers, by channel",
    ("channel",))
_m_bans = telemetry.counter(
    "p2p_bans_total", "Peers banned for falling below the trust "
    "score threshold")
_m_unbans = telemetry.counter(
    "p2p_unbans_total", "Ban expiries observed (peer re-admittable)")
_m_banned = telemetry.gauge(
    "p2p_banned_peers", "Peer ids currently under a ban")
_m_shed = telemetry.counter(
    "p2p_accept_shed_total", "Inbound conns shed at the accept path, "
    "by reason", ("reason",))
_m_peer_errors = telemetry.counter(
    "p2p_peer_errors_total", "Peers stopped for an error, by class "
    "(protocol = invalid frames/messages, network = transport)",
    ("kind",))
_m_hs_fail = telemetry.counter(
    "p2p_handshake_failures_total", "Handshakes aborted, by reason",
    ("reason",))

RECONNECT_ATTEMPTS = 20
RECONNECT_BASE_S = 1.0          # exponential backoff base (switch.go:26-33)
RECONNECT_MULTIPLIER = 2.0
RECONNECT_MAX_S = 300.0

# Trust scoring weights: a protocol violation (corrupt or malformed
# frame, unknown channel/packet, oversized message) is worth this many
# bad events — a transport error stays at 1. Clean traffic scores one
# good event per CLEAN_MSGS_PER_GOOD routed messages, so a long-lived
# honest peer's current interval carries enough good weight that one bad
# burst cannot drop it under the ban threshold.
PROTOCOL_BAD_WEIGHT = 10.0
CLEAN_MSGS_PER_GOOD = 64
#: strikes decay one step per this many ban-base seconds of clean time
BAN_STRIKE_DECAY_MULT = 4.0
_BAN_MAX_DOUBLINGS = 6

_protocol_error_types: Optional[tuple] = None


def _protocol_error(err) -> bool:
    """A peer error that means MALFORMED INPUT (score it hard), as
    opposed to a transport failure (score it lightly): codec
    ValueErrors, AEAD authentication failures from any backend."""
    global _protocol_error_types
    if _protocol_error_types is None:
        from tendermint_tpu_torch.native import AeadTagError
        from tendermint_tpu_torch.p2p.conn import purecrypto
        kinds = [ValueError, AeadTagError, purecrypto.InvalidTag]
        try:
            from cryptography.exceptions import InvalidTag
            kinds.append(InvalidTag)
        except ImportError:
            pass
        _protocol_error_types = tuple(kinds)
    return isinstance(err, _protocol_error_types)


def _redial_jitter(key: str, attempt: int) -> float:
    """Deterministic backoff jitter in [0.5, 1.0): the same (address,
    attempt) always waits the same time, so a replay reproduces the
    redial schedule exactly."""
    h = zlib.crc32(f"{key}#{attempt}".encode())
    return 0.5 + (h % 4096) / 8192.0


class _DeadlineSock:
    """Handshake-only socket wrapper enforcing a TOTAL deadline. The
    per-read settimeout alone lets a slow-loris peer trickle one byte
    per interval forever; here every op re-derives its timeout from the
    one deadline, so the whole handshake is bounded no matter how the
    bytes are paced. After the handshake the link is handed the raw
    socket back — this wrapper polices setup only."""

    def __init__(self, sock: socket.socket, deadline: float):
        self.sock = sock
        self.deadline = deadline

    def _arm(self) -> None:
        remaining = self.deadline - time.monotonic()
        if remaining <= 0:
            raise socket.timeout("handshake deadline exceeded")
        self.sock.settimeout(remaining)

    def recv(self, n: int) -> bytes:
        self._arm()
        return self.sock.recv(n)

    def sendall(self, data: bytes) -> None:
        self._arm()
        self.sock.sendall(data)

    def shutdown(self, how) -> None:
        self.sock.shutdown(how)

    def close(self) -> None:
        self.sock.close()


def dial_tiebreak_keep_new(self_id: str, their_id: str,
                           new_outbound: bool,
                           existing_outbound: bool) -> bool:
    """Simultaneous-dial survivor rule: both ends keep the connection
    DIALED BY THE SMALLER NODE ID, so they independently agree on the
    same single conn and never close each other's keeper. True when the
    newly-registered duplicate should replace the existing peer entry.
    Same-direction duplicates keep the existing conn (a plain double
    dial, today's behavior)."""
    if new_outbound == existing_outbound:
        return False
    new_dialer = self_id if new_outbound else their_id
    old_dialer = self_id if existing_outbound else their_id
    return new_dialer < old_dialer


class SwitchError(Exception):
    pass


class Switch:
    def __init__(self, config: P2PConfig, node_key: NodeKey,
                 node_info: NodeInfo, encrypt: bool = True, loop=None):
        # bound node id: several switches share a process, and a p2p line
        # is useless without knowing WHOSE switch logged it
        self.logger = get_logger(__name__, node=node_info.id[:8])
        self.config = config
        self.node_key = node_key
        self.node_info = node_info
        self.encrypt = encrypt
        # None: the thread-per-connection plane
        self.loop = loop
        self.burst = Burst.from_config(config)
        self.reactors: Dict[str, object] = {}
        self.channel_descs: List[ChannelDescriptor] = []
        self.reactors_by_ch: Dict[int, object] = {}
        self.peers = PeerSet()
        self.dialing: set = set()
        self.reconnecting: set = set()
        self._listener: Optional[socket.socket] = None
        self._listen_addr: Optional[NetAddress] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._started_peers: List[Peer] = []
        self._stopped = False
        self._lock = threading.Lock()
        # serializes the reactors' add_peer / remove_peer notifications
        # with the PeerSet changes they follow: reactors key their peer
        # state by id, so a notification for a connection that is no
        # longer the registered one would pair the live peer with the
        # dead one's state (see _notify_added)
        self._notify_lock = threading.RLock()
        # pluggable filters (switch.go:391-416)
        self.conn_filters: List[Callable[[NetAddress], None]] = []
        self.id_filters: List[Callable[[str], None]] = []
        # the PEX reactor's AddrBook, when the node runs PEX
        self.addr_book = None
        # optional TrustMetricStore: good on handshake + per
        # CLEAN_MSGS_PER_GOOD routed messages, bad (weighted) on
        # error-stop — and enforced: a peer whose trust score falls under
        # ban_score is refused at the handshake until its ban decays
        # (repeat offenders' bans double, strikes decay with clean time)
        self.trust_store = None
        self.banned: Dict[str, dict] = {}   #: guarded_by _lock
        self._ban_score = knobs.knob_int(
            "TM_CUDA_P2P_BAN_SCORE", config=config.ban_score, default=30)
        self._ban_base_s = knobs.knob_float(
            "TM_CUDA_P2P_BAN_BASE_S", config=config.ban_base_s,
            default=60.0)
        self._fd_headroom = knobs.knob_int(
            "TM_CUDA_P2P_FD_HEADROOM", config=config.fd_headroom,
            default=64)

    # ------------------------------------------------------------ ban plane

    def ban_peer(self, peer_id: str, reason: str = "") -> None:
        """Ban with decaying escalation: first offense = ban_base_s,
        each repeat doubles (capped at 2^6), and strikes decay one step
        per BAN_STRIKE_DECAY_MULT * ban_base_s of clean time — a
        repeat offender's bans grow, a peer that stays clean earns its
        way back to first-offense treatment. Strike history survives
        the unban (else every ban would read as a first offense)."""
        now = time.monotonic()
        with self._lock:
            rec = self.banned.get(peer_id)
            strikes = 1
            if rec is not None:
                decayed = int((now - rec["last"]) /
                              (self._ban_base_s * BAN_STRIKE_DECAY_MULT))
                strikes = max(0, rec["strikes"] - decayed) + 1
            duration = self._ban_base_s * (
                2 ** min(strikes - 1, _BAN_MAX_DOUBLINGS))
            if len(self.banned) > 1024 and peer_id not in self.banned:
                # bounded memory under an id-churning flood: drop the
                # stalest strike record, never an ACTIVE ban
                stale = [pid for pid, r in self.banned.items()
                         if not r["active"]]
                if stale:
                    del self.banned[min(
                        stale, key=lambda p: self.banned[p]["last"])]
            self.banned[peer_id] = {"until": now + duration,
                                    "strikes": strikes, "last": now,
                                    "active": True}
            n_banned = sum(1 for r in self.banned.values()
                           if r["active"])
        _m_bans.inc()
        _m_banned.set(n_banned)
        self.logger.error("peer banned", peer=peer_id[:16],
                          strikes=strikes, seconds=round(duration, 1),
                          reason=reason)

    def is_banned(self, peer_id: str) -> bool:
        """Ban check with lazy expiry: an expired ban flips inactive
        (counted as an unban) the first time anyone asks; the strike
        record stays behind for the escalation math."""
        now = time.monotonic()
        with self._lock:
            rec = self.banned.get(peer_id)
            if rec is None or (not rec["active"] and
                               now >= rec["until"]):
                return False
            if now < rec["until"]:
                return True
            rec["active"] = False
            n_banned = sum(1 for r in self.banned.values()
                           if r["active"])
        _m_unbans.inc()
        _m_banned.set(n_banned)
        self.logger.info("peer ban expired", peer=peer_id[:16])
        return False

    def _maybe_ban(self, peer_id: str) -> None:
        if self.trust_store is None or self._ban_score <= 0:
            return
        score = self.trust_store.get_metric(peer_id).trust_score()
        if score < self._ban_score:
            self.ban_peer(peer_id, reason=f"trust score {score} < "
                                          f"{self._ban_score}")

    # ------------------------------------------------------------- reactors

    def add_reactor(self, name: str, reactor) -> None:
        """switch.go:98: register channels, reject collisions."""
        for desc in reactor.get_channels():
            if desc.id in self.reactors_by_ch:
                raise SwitchError(
                    f"channel {desc.id:#x} already registered")
            self.channel_descs.append(desc)
            self.reactors_by_ch[desc.id] = reactor
        self.reactors[name] = reactor
        reactor.set_switch(self)
        self.node_info.channels = [d.id for d in self.channel_descs]

    def reactor(self, name: str):
        return self.reactors.get(name)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        for reactor in self.reactors.values():
            reactor.start()

    def stop(self) -> None:
        self._stopped = True
        if self._listener is not None:
            # shutdown wakes the accept() blocked in the accept thread
            # (close alone does not on Linux, and stop would wait out the
            # join's timeout below)
            for close in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                          self._listener.close):
                try:
                    close()
                except OSError:
                    pass
        # join each peer's conn threads before tearing reactors down:
        # a recv routine that raced the close must finish its on_error
        # (and any logging) while the process — and under pytest, the
        # capture stream — is still intact. The started-peer registry
        # (not the PeerSet) is iterated so a peer a recv thread already
        # removed via stop_peer_for_error still gets joined.
        for peer in self.peers.list():
            self._remove_peer(peer, None, join=True)
        with self._lock:
            started, self._started_peers = self._started_peers, []
        for peer in started:
            peer.stop(join=True)
        if self._accept_thread is not None:
            self._accept_thread.join(2.0)
            self._accept_thread = None
        for reactor in self.reactors.values():
            reactor.stop()

    # ------------------------------------------------------------- listening

    def listen(self, host: str = "127.0.0.1", port: int = 0,
               external_host: str = "") -> NetAddress:
        """Bind + accept loop (p2p/listener.go). Returns the ADVERTISED
        address (with our node ID): `external_host` if given, else the
        bind host — binding a wildcard without an external address would
        advertise an undialable 0.0.0.0 (the reference resolves an
        external address for the same reason, p2p/listener.go:51)."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(64)
        self._listener = ls
        bound = ls.getsockname()
        adv_host = external_host or self.config.external_addr or bound[0]
        if adv_host in ("0.0.0.0", "::") and not self.config.skip_upnp:
            # UPnP external-address detection (p2p/listener.go:51);
            # best effort, within a 1.5 s budget
            from tendermint_tpu_torch.p2p import upnp
            adv_host = upnp.external_address() or adv_host
        if adv_host in ("0.0.0.0", "::"):
            # best effort: a wildcard bind with no configured external
            # address advertises the hostname's primary IP
            try:
                adv_host = socket.gethostbyname(socket.gethostname())
            except OSError:
                pass
        self._listen_addr = NetAddress(adv_host, bound[1],
                                       self.node_info.id)
        self.node_info.listen_addr = f"{adv_host}:{bound[1]}"
        t = threading.Thread(target=self._accept_routine, daemon=True,
                             name="p2p-accept")
        t.start()
        self._accept_thread = t
        return self._listen_addr

    @property
    def listen_address(self) -> Optional[NetAddress]:
        return self._listen_addr

    def _accept_routine(self) -> None:
        while not self._stopped:
            try:
                sock, addrinfo = self._listener.accept()
            except OSError:
                if self._stopped:
                    return
                # transient (ECONNABORTED, EMFILE, ...): keep accepting —
                # exiting here would silently stop all inbound peering
                time.sleep(0.1)
                continue
            if self.peers.size() >= self.config.max_num_peers:
                _m_shed.labels("peers").inc()
                sock.close()
                continue
            if not self._fd_headroom_ok():
                # admission shedding: accepting would spend fds the
                # node needs for its own stores/peers — refuse loudly
                # at the door instead of failing opaquely mid-run
                _m_shed.labels("fd").inc()
                sock.close()
                continue
            threading.Thread(
                target=self._handle_inbound, args=(sock, addrinfo),
                daemon=True).start()

    def _fd_budget(self) -> tuple:
        """(soft fd limit, open fds) — (0, 0) when unknowable (non-
        Linux without /proc): headroom checks then pass."""
        try:
            import resource
            soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
            return soft, len(os.listdir("/proc/self/fd"))
        except (OSError, ValueError, ImportError):
            return 0, 0

    def _fd_headroom_ok(self) -> bool:
        soft, n_open = self._fd_budget()
        if soft <= 0:
            return True
        return soft - n_open >= self._fd_headroom

    def _handle_inbound(self, sock: socket.socket, addrinfo) -> None:
        try:
            self.add_peer_from_socket(sock, outbound=False,
                                      dial_addr=None)
        except Exception:
            try:
                sock.close()
            except OSError:
                pass

    # --------------------------------------------------------------- dialing

    def dial_peer(self, addr: NetAddress, persistent: bool = False) -> Peer:
        """Dial + handshake + add (switch.go:460 addOutboundPeer)."""
        with self._lock:
            if str(addr) in self.dialing:
                raise SwitchError(f"already dialing {addr}")
            self.dialing.add(str(addr))
        try:
            for f in self.conn_filters:
                f(addr)
            sock = socket.create_connection(
                addr.dial_string(),
                timeout=self.config.dial_timeout_s)
            return self.add_peer_from_socket(
                sock, outbound=True, dial_addr=addr, persistent=persistent)
        finally:
            with self._lock:
                self.dialing.discard(str(addr))

    def dial_peers_async(self, addrs: List[NetAddress],
                         persistent: bool = False) -> None:
        """switch.go:333 DialPeersAsync: fire one dial thread per address
        in random order."""
        shuffled = list(addrs)
        random.shuffle(shuffled)
        for addr in shuffled:
            def dial(a=addr):
                try:
                    self.dial_peer(a, persistent=persistent)
                except Exception:
                    if persistent:
                        self._reconnect_to_peer(a)
            threading.Thread(target=dial, daemon=True).start()

    # ------------------------------------------------------------- handshake

    def add_peer_from_socket(self, sock: socket.socket, outbound: bool,
                             dial_addr: Optional[NetAddress],
                             persistent: bool = False) -> Peer:
        """Secret handshake + NodeInfo exchange + register (switch.go:492
        addPeer)."""
        link = None
        try:
            # TOTAL handshake deadline: settimeout alone is a per-read
            # budget a slow-loris peer never trips; the wrapper re-derives
            # every op's timeout from one deadline
            hs_deadline = time.monotonic() + self.config.handshake_timeout_s
            dsock = _DeadlineSock(sock, hs_deadline)
            if self.encrypt:
                link = SecretConnection.make(dsock, self.node_key,
                                             burst=self.burst.resolve()[0])
                remote_id = pubkey_to_id(link.remote_pubkey)
                # ban enforcement at the earliest moment identity is
                # AUTHENTICATED — before we spend NodeInfo parsing (or
                # reactor wiring) on a known-hostile peer
                if self.is_banned(remote_id):
                    _m_hs_fail.labels("banned").inc()
                    raise SwitchError(f"peer {remote_id} is banned")
            else:
                link = PlainFramedConn(dsock)
                remote_id = None

            write_handshake_msg(link,
                                encoding.cdumps(self.node_info.to_obj()))
            their_info = NodeInfo.from_obj(
                encoding.cloads(read_handshake_msg(link)))
            their_info.validate()

            if remote_id is not None and their_info.id != remote_id:
                raise SwitchError(
                    f"NodeInfo.id {their_info.id} != "
                    f"authenticated {remote_id}")
            if dial_addr is not None and dial_addr.id and \
                    their_info.id != dial_addr.id:
                raise SwitchError(
                    f"dialed {dial_addr.id} but got {their_info.id}")
            if their_info.id == self.node_info.id:
                raise SwitchError("self-connection rejected")
            if remote_id is None and self.is_banned(their_info.id):
                # plaintext links authenticate nothing; the claimed id
                # is still enforced so a banned peer cannot reconnect
                _m_hs_fail.labels("banned").inc()
                raise SwitchError(f"peer {their_info.id} is banned")
            for f in self.id_filters:
                f(their_info.id)
            self.node_info.compatible_with(their_info)
        except Exception as e:
            # every handshake failure (the deadline's socket.timeout
            # included) must release the socket — the dial path retries
            # with backoff and would otherwise leak one FD per attempt
            _m_hs_fail.labels("deadline" if isinstance(e, socket.timeout)
                              else "error").inc()
            if link is not None:
                link.close()
            else:
                try:
                    sock.close()
                except OSError:
                    pass
            raise

        # handshake done: the link runs on the RAW socket from here (the
        # deadline wrapper polices setup only)
        link.conn = sock
        sock.settimeout(None)
        # chaos plane: schedule-driven lossy-link wrapper, or — the
        # default, chaos off — the link back unchanged
        link = maybe_wrap_link(link, their_info.id or "")
        peer = Peer(
            link, their_info, self.channel_descs, outbound=outbound,
            persistent=persistent, dial_addr=dial_addr,
            send_rate=self.config.send_rate, recv_rate=self.config.recv_rate,
            ping_interval=self.config.ping_interval_s,
            idle_timeout=self.config.idle_timeout_s, burst=self.burst,
            loop=self.loop)
        peer.set_handlers(self._route, self._peer_error)

        if not self.peers.add(peer):
            # Simultaneous-dial tiebreak. When two peers dial each other
            # at boot, each side ends up registering BOTH connections;
            # rejecting the second unconditionally lets side A keep the
            # conn side B closed and vice versa — both links dead, and
            # the kept-inbound side (no dial_addr) never redials: the
            # net partitions permanently at height 0. Both sides instead
            # agree on ONE survivor: the connection DIALED BY THE SMALLER
            # NODE ID. Same-direction duplicates (a double dial) keep the
            # existing conn, exactly as before.
            existing = self.peers.get(peer.id)
            replaced = False
            if existing is not None and \
                    dial_tiebreak_keep_new(self.node_info.id, peer.id,
                                           outbound, existing.outbound):
                self.logger.info("simultaneous dial: replacing peer conn",
                                 peer=peer.id, kept="out" if outbound
                                 else "in")
                self._remove_peer(existing, "simultaneous-dial tiebreak")
                replaced = self.peers.add(peer)
            if not replaced:
                link.close()
                raise SwitchError(f"duplicate peer {peer.id}")
        _m_peers.set(self.peers.size())
        with self._lock:
            # registry for join-on-stop: a recv thread that removes its
            # own peer from the PeerSet (stop_peer_for_error race) must
            # still be joined by Switch.stop(). Prune entries whose
            # conn threads have exited to bound growth under churn —
            # but KEEP not-yet-started entries (empty thread list,
            # still running): another thread may be between registering
            # and start(). Loop conns have no threads: they are pruned
            # once stopped (their teardown runs on the loop).
            self._started_peers = [
                p for p in self._started_peers
                if (any(t.is_alive() for t in p.mconn._threads)
                    if p.mconn._threads else p.mconn.running)]
            self._started_peers.append(peer)
        peer.start()
        if self.trust_store is not None:
            self.trust_store.get_metric(peer.id).good_events(1)
        self._notify_added(peer)
        return peer

    def _notify_added(self, peer: Peer) -> None:
        """Tell the reactors of `peer` if it is still the registered
        connection of its id. In the JAX package's switch the
        simultaneous-dial tiebreak can replace a connection between its
        registration and this call; the late add_peer then overwrites the
        live connection's consensus PeerRoundState by id, receive() feeds
        the dead one's, and the live peer's gossip never learns the
        peer's round (a net that dials both ways at boot stalls)."""
        with self._notify_lock:
            if self.peers.get(peer.id) is not peer:
                return
            for name, reactor in self.reactors.items():
                try:
                    reactor.add_peer(peer)
                except Exception as e:
                    self.logger.error("reactor add_peer failed",
                                      reactor=name, peer=peer.id,
                                      err=repr(e))

    # --------------------------------------------------------------- routing

    def _route(self, ch_id: int, peer: Peer, msg: bytes) -> None:
        reactor = self.reactors_by_ch.get(ch_id)
        if reactor is None:
            self.stop_peer_for_error(
                peer, ValueError(f"msg on unknown channel {ch_id:#x}"))
            return
        _m_recv.labels(f"{ch_id:#04x}").inc()
        if self.trust_store is not None and \
                peer.note_clean_msg(CLEAN_MSGS_PER_GOOD):
            # steady-state good scoring: a long-lived honest peer must
            # not be banned by one bad burst for lack of good events
            self.trust_store.get_metric(peer.id).good_events(1)
        reactor.receive(ch_id, peer, msg)

    def _peer_error(self, peer: Peer, err: Exception) -> None:
        self.stop_peer_for_error(peer, err)

    # ------------------------------------------------------------- stopping

    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        """switch.go StopPeerForError + reconnect for persistent peers."""
        stale = self.peers.get(peer.id) is not peer
        if not self._stopped and not stale:
            # during Switch.stop() the conn-close races are expected;
            # an "error" log (or a trust penalty) from a dying recv
            # thread — or from a conn the dial tiebreak already
            # replaced — would smear well-behaved peers
            self.logger.error("stopping peer for error", peer=peer.id,
                              err=reason)
            protocol = _protocol_error(reason)
            _m_peer_errors.labels(
                "protocol" if protocol else "network").inc()
            if self.trust_store is not None:
                # invalid frames/messages score much harder than
                # transport flakes — and the score is ENFORCED: under
                # the threshold the peer is banned until the ban decays
                self.trust_store.get_metric(peer.id).bad_events(
                    PROTOCOL_BAD_WEIGHT if protocol else 1.0)
                self._maybe_ban(peer.id)
        self._remove_peer(peer, reason)
        if peer.persistent and peer.dial_addr is not None and \
                not stale and \
                not self._stopped:
            threading.Thread(target=self._reconnect_to_peer,
                             args=(peer.dial_addr,), daemon=True).start()

    def stop_peer_gracefully(self, peer: Peer) -> None:
        self._remove_peer(peer, None)

    def _remove_peer(self, peer: Peer, reason, join: bool = False) -> None:
        with self._notify_lock:
            registered = self.peers.get(peer.id)
            if registered is None:
                return
            # stop without joining under the lock: the peer's own recv
            # thread may be waiting for the lock in stop_peer_for_error
            peer.stop()
            if registered is peer:
                self.peers.remove(peer)
                _m_peers.set(self.peers.size())
                for name, reactor in self.reactors.items():
                    try:
                        reactor.remove_peer(peer, reason)
                    except Exception as e:
                        self.logger.error("reactor remove_peer failed",
                                          reactor=name, peer=peer.id,
                                          err=repr(e))
            # else a DIFFERENT connection owns this id now (the
            # simultaneous-dial tiebreak replaced this one). A late error
            # from the replaced conn's recv thread must only close ITS
            # socket — notifying reactors here would deregister the LIVE
            # peer from the fast-sync pool and the consensus gossip state
            # by id
        if join:
            peer.stop(join=True)
        if registered is peer and self.trust_store is not None:
            self.trust_store.peer_disconnected(peer.id)

    def _connected_to(self, addr: NetAddress) -> bool:
        """Already connected to this address? Matches by ID when known,
        else by dial/listen address — an id-less persistent peer that
        reconnected inbound must not be redialed forever."""
        if addr.id:
            return self.peers.has(addr.id)
        hostport = f"{addr.ip}:{addr.port}"
        for p in self.peers.list():
            if p.dial_addr is not None and \
                    (p.dial_addr.ip, p.dial_addr.port) == (addr.ip, addr.port):
                return True
            if p.node_info.listen_addr == hostport:
                return True
        return False

    def _reconnect_to_peer(self, addr: NetAddress) -> None:
        """Exponential backoff redial (switch.go:279-330) with
        DETERMINISTIC jitter: the wait for (address, attempt) is a pure
        function of both, on the clock of utils/clock. The wait is sliced
        so Switch.stop() never blocks behind a long backoff."""
        key = str(addr)
        with self._lock:
            if key in self.reconnecting:
                return
            self.reconnecting.add(key)
        try:
            for attempt in range(RECONNECT_ATTEMPTS):
                if self._stopped or self._connected_to(addr):
                    return
                try:
                    self.dial_peer(addr, persistent=True)
                    return
                except Exception:
                    backoff = min(
                        RECONNECT_MAX_S,
                        RECONNECT_BASE_S *
                        (RECONNECT_MULTIPLIER ** attempt)) * \
                        _redial_jitter(key, attempt)
                    deadline = clock.now_s() + backoff
                    while not self._stopped and clock.now_s() < deadline:
                        time.sleep(min(0.1, backoff))
        finally:
            with self._lock:
                self.reconnecting.discard(key)

    # ------------------------------------------------------------ broadcast

    def broadcast(self, ch_id: int, msg: bytes) -> None:
        """Best-effort fan-out (switch.go:210-227)."""
        peers = self.peers.list()
        if peers and telemetry.enabled():
            _m_sent.labels(f"{ch_id:#04x}").inc(len(peers))
        for peer in peers:
            peer.try_send(ch_id, msg)

    def broadcast_obj(self, ch_id: int, obj: dict) -> None:
        self.broadcast(ch_id, encoding.cdumps(obj))

    def num_peers(self) -> tuple:
        """(outbound, inbound, dialing)."""
        out = sum(1 for p in self.peers.list() if p.outbound)
        inb = self.peers.size() - out
        return out, inb, len(self.dialing)
