"""PEXReactor — peer exchange on channel 0x00: the port's copy of
`tendermint_tpu/p2p/pex/pex_reactor.py` (p2p/pex/pex_reactor.go).

Periodically ensures enough outbound peers (dialing from the addr book),
answers address requests (rate-limited per peer), and in seed mode serves
addresses then disconnects. Messages: {"type": "pex_request"} and
{"type": "pex_addrs", "addrs": [...]}."""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.pex.addrbook import AddrBook
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.utils.log import tm_logger

PEX_CHANNEL = 0x00
DEFAULT_ENSURE_PEERS_PERIOD = 30.0
WANT_OUTBOUND = 10  # pex_reactor.go:28-29
MAX_PEX_MSG_ADDRS = 250


class PEXReactor(Reactor):
    def __init__(self, addr_book: AddrBook,
                 ensure_peers_period: float = DEFAULT_ENSURE_PEERS_PERIOD,
                 seed_mode: bool = False):
        super().__init__("pex")
        self.logger = tm_logger("pex")
        self.book = addr_book
        self.period = ensure_peers_period
        self.seed_mode = seed_mode
        self._requests_sent: dict = {}   # peer id -> last request time
        self._last_received: dict = {}   # peer id -> last request from them
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def get_channels(self):
        return [ChannelDescriptor(PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10)]

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._ensure_peers_routine, daemon=True, name="pex")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.book.save()

    # ---------------------------------------------------------------- peers

    def add_peer(self, peer) -> None:
        """Solicit addresses from OUTBOUND peers only — we chose them, so
        they are the trust anchors; an inbound (attacker-chosen) peer must
        never be able to fill our book via a solicited response
        (pex_reactor.go AddPeer)."""
        if peer.outbound:
            if peer.dial_addr is not None:
                self.book.add_address(peer.dial_addr, peer.dial_addr)
                self.book.mark_good(peer.dial_addr)
            if self.book.need_more_addrs():
                self._request_addrs(peer)
        elif peer.node_info.listen_addr:
            # record (not solicit): inbound peers advertise a listen addr
            try:
                addr = NetAddress.from_string(
                    f"{peer.node_info.id}@{peer.node_info.listen_addr}")
                self.book.add_address(addr, addr)
            except ValueError:
                pass

    def remove_peer(self, peer, reason) -> None:
        self._requests_sent.pop(peer.id, None)
        self._last_received.pop(peer.id, None)

    # ------------------------------------------------------------- messages

    def receive(self, ch_id, peer, msg: bytes) -> None:
        obj = encoding.cloads(msg)
        t = obj.get("type")
        if t == "pex_request":
            # rate limit: one request per period/3 per peer (:193-217)
            now = time.monotonic()
            last = self._last_received.get(peer.id, 0.0)
            if now - last < self.period / 3:
                self.switch.stop_peer_for_error(
                    peer, ValueError("pex request flood"))
                return
            self._last_received[peer.id] = now
            self._send_addrs(peer)
            if self.seed_mode and not peer.outbound:
                # seeds serve addresses then hang up (pex_reactor.go:104)
                self.switch.stop_peer_gracefully(peer)
        elif t == "pex_addrs":
            if peer.id not in self._requests_sent:
                self.switch.stop_peer_for_error(
                    peer, ValueError("unsolicited pex_addrs"))
                return
            self._requests_sent.pop(peer.id, None)
            src = peer.dial_addr or NetAddress("0.0.0.0", 1, peer.id)
            for a in obj.get("addrs", [])[:MAX_PEX_MSG_ADDRS]:
                try:
                    addr = NetAddress.from_obj(a)
                    self.book.add_address(addr, src)
                except ValueError:
                    continue
        else:
            self.switch.stop_peer_for_error(
                peer, ValueError(f"unknown pex message {t!r}"))

    def _request_addrs(self, peer) -> None:
        self._requests_sent[peer.id] = time.monotonic()
        peer.try_send_obj(PEX_CHANNEL, {"type": "pex_request"})

    def _send_addrs(self, peer) -> None:
        addrs = [a.to_obj() for a in self.book.get_selection()]
        peer.try_send_obj(PEX_CHANNEL, {"type": "pex_addrs", "addrs": addrs})

    # --------------------------------------------------------- ensure peers

    def _ensure_peers_routine(self) -> None:
        while not self._stop.wait(self.period * (0.9 + 0.2 * random.random())):
            try:
                self.ensure_peers()
            except Exception as e:
                self.logger.error("ensure_peers failed", err=repr(e))

    def ensure_peers(self) -> None:
        """Dial toward WANT_OUTBOUND outbound peers (pex_reactor.go:107)."""
        out, _, dialing = self.switch.num_peers()
        need = WANT_OUTBOUND - (out + dialing)
        if need <= 0:
            return
        # bias toward new addrs when few peers (more exploration)
        bias = min(70, 30 + 10 * need)
        tried = set()
        for _ in range(need * 3):
            addr = self.book.pick_address(bias)
            if addr is None:
                break
            key = str(addr)
            if key in tried:
                continue
            tried.add(key)
            if addr.id and self.switch.peers.has(addr.id):
                continue
            if self.book.is_our_address(addr):
                continue
            self.book.mark_attempt(addr)

            def dial(a=addr):
                try:
                    self.switch.dial_peer(a)
                    self.book.mark_good(a)
                except Exception as e:
                    self.logger.debug("pex dial failed", addr=str(a),
                                      err=repr(e))
            threading.Thread(target=dial, daemon=True).start()
            need -= 1
            if need <= 0:
                break
        # still hungry: ask a random OUTBOUND peer for more addrs.
        # Soliciting inbound peers would arm _requests_sent for an
        # attacker-chosen connection, letting it seed the addr book
        # (eclipse surface) — outbound dials are ones we picked.
        if self.book.need_more_addrs():
            peers = [p for p in self.switch.peers.list() if p.outbound]
            if peers:
                self._request_addrs(random.choice(peers))
