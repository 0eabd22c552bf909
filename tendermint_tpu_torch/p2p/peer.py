"""Peer — one connected node: secret link + MConnection + NodeInfo: the
port's copy of `tendermint_tpu/p2p/peer.py` (p2p/peer.go). Handed the
node's ReactorLoop (`loop=`), the peer's socket runs on it through a
LoopMConnection; without one, on the threaded MConnection."""

from __future__ import annotations

import struct
import threading
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.p2p.conn import ChannelDescriptor, MConnection
from tendermint_tpu_torch.p2p.conn.burst import Burst
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.types import encoding


def write_handshake_msg(link, payload: bytes) -> None:
    """Length-prefixed message over the (frame-oriented) secret link —
    NodeInfo can exceed one frame."""
    link.write(struct.pack(">I", len(payload)) + payload)


def read_handshake_msg(link, max_size: int = 1 << 20) -> bytes:
    buf = link.read()
    if len(buf) < 4:
        raise ConnectionError("handshake: short read")
    (n,) = struct.unpack(">I", buf[:4])
    if n > max_size:
        raise ValueError(f"handshake message too large: {n}")
    buf = buf[4:]
    while len(buf) < n:
        frame = link.read()
        if frame == b"":
            raise ConnectionError("handshake: EOF")
        buf += frame
    return buf[:n]


class Peer:
    def __init__(self, link, node_info: NodeInfo,
                 channel_descs: List[ChannelDescriptor],
                 outbound: bool, persistent: bool = False,
                 dial_addr: Optional[NetAddress] = None,
                 send_rate: float = 512_000, recv_rate: float = 512_000,
                 ping_interval: float = 10.0, idle_timeout: float = 35.0,
                 burst: Burst = Burst(), loop=None):
        self.node_info = node_info
        self.outbound = outbound
        self.persistent = persistent
        self.dial_addr = dial_addr
        self.loop = loop
        # steady-state trust accounting: routed messages since the last
        # good-event credit. Touched only by this peer's one delivery
        # context (its recv thread or the loop).
        self._clean_msgs = 0
        # channels the REMOTE advertised: sends on others are no-ops —
        # the receiving MConnection treats unknown channels as a protocol
        # violation (p2p/node_info.go channel negotiation)
        self._their_channels = set(node_info.channels)
        self._data: Dict[str, object] = {}   # reactor scratch (peer.go:226)
        self._on_receive: Callable[[int, "Peer", bytes], None] = \
            lambda ch, p, m: None
        self._on_error: Callable[["Peer", Exception], None] = \
            lambda p, e: None
        conn_cls = MConnection
        kw = {}
        if loop is not None:
            # the node's ONE event loop owns this peer's socket: no
            # send/recv threads
            from tendermint_tpu_torch.p2p.conn.loop import LoopMConnection
            conn_cls, kw = LoopMConnection, {"loop": loop}
        self.mconn = conn_cls(
            link=link, channel_descs=channel_descs,
            on_receive=lambda ch, m: self._on_receive(ch, self, m),
            on_error=lambda e: self._on_error(self, e),
            send_rate=send_rate, recv_rate=recv_rate,
            ping_interval=ping_interval, idle_timeout=idle_timeout,
            burst=burst, **kw)

    # identity ---------------------------------------------------------------

    @property
    def id(self) -> str:
        return self.node_info.id

    def __repr__(self):
        arrow = "out" if self.outbound else "in"
        return f"Peer<{self.id[:10]} {arrow}>"

    # wiring -----------------------------------------------------------------

    def set_handlers(self, on_receive, on_error) -> None:
        self._on_receive = on_receive
        self._on_error = on_error

    def start(self) -> None:
        self.mconn.start()

    def stop(self, join: bool = False) -> None:
        self.mconn.stop(join=join)

    @property
    def running(self) -> bool:
        return self.mconn.running

    @property
    def rtt_s(self) -> float:
        """Keepalive round trip to this peer (0.0 before first pong)."""
        return self.mconn.rtt_s()

    # messaging --------------------------------------------------------------

    def has_channel(self, ch_id: int) -> bool:
        return not self._their_channels or ch_id in self._their_channels

    def send(self, ch_id: int, msg: bytes) -> bool:
        if not self.has_channel(ch_id):
            return False
        return self.mconn.send(ch_id, msg)

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        if not self.has_channel(ch_id):
            return False
        return self.mconn.try_send(ch_id, msg)

    def note_clean_msg(self, every: int) -> bool:
        """Count one cleanly-routed message; True once per `every` —
        the switch turns that into a trust good_event, so long-lived
        honest peers accumulate standing a single bad burst can't
        erase."""
        self._clean_msgs += 1
        if self._clean_msgs >= every:
            self._clean_msgs = 0
            return True
        return False

    def send_obj(self, ch_id: int, obj: dict) -> bool:
        return self.send(ch_id, encoding.cdumps(obj))

    def try_send_obj(self, ch_id: int, obj: dict) -> bool:
        return self.try_send(ch_id, encoding.cdumps(obj))

    # reactor kv store (peer.go:226-233) -------------------------------------

    def get(self, key: str):
        return self._data.get(key)

    def set(self, key: str, value) -> None:
        self._data[key] = value


class PeerSet:
    """Concurrent peer lookup by ID (p2p/peer_set.go)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id: Dict[str, Peer] = {}

    def add(self, peer: Peer) -> bool:
        with self._lock:
            if peer.id in self._by_id:
                return False
            self._by_id[peer.id] = peer
            return True

    def has(self, id_: str) -> bool:
        with self._lock:
            return id_ in self._by_id

    def get(self, id_: str) -> Optional[Peer]:
        with self._lock:
            return self._by_id.get(id_)

    def remove(self, peer: Peer) -> None:
        with self._lock:
            existing = self._by_id.get(peer.id)
            if existing is peer:
                del self._by_id[peer.id]

    def list(self) -> List[Peer]:
        with self._lock:
            return list(self._by_id.values())

    def size(self) -> int:
        with self._lock:
            return len(self._by_id)
