"""EvidenceReactor — evidence gossip on channel 0x38: the port's copy of
`tendermint_tpu/evidence/reactor.py` (evidence/reactor.go).

New peers get the full pending list (:66); fresh evidence drains from the
pool's queue and broadcasts to everyone (:113). Received evidence is
verified by the pool before storage; invalid evidence drops the sender."""

from __future__ import annotations

import threading

from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.state.validation import (BlockValidationError,
                                                   EvidenceTooOldError)
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.evidence import (evidence_from_obj,
                                                 evidence_to_obj)

EVIDENCE_CHANNEL = 0x38


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool):
        super().__init__("evidence")
        self.pool = pool
        self._stopped = False
        self._thread = None

    def get_channels(self):
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=5,
                                  send_queue_capacity=100)]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._broadcast_routine,
                                        daemon=True, name="evidence-bcast")
        self._thread.start()

    def stop(self) -> None:
        self._stopped = True

    def add_peer(self, peer) -> None:
        """Send the full pending list to new peers (evidence/reactor.go:66)."""
        evs = self.pool.pending_evidence()
        if evs:
            peer.try_send_obj(EVIDENCE_CHANNEL, {
                "type": "evidence_list",
                "evidence": [evidence_to_obj(e) for e in evs]})

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        msg = encoding.cloads(msg_bytes)
        if msg.get("type") != "evidence_list":
            if self.switch is not None:
                self.switch.stop_peer_for_error(
                    peer, ValueError("bad evidence message"))
            return
        for ev_obj in msg.get("evidence", []):
            try:
                ev = evidence_from_obj(ev_obj)
            except (ValueError, KeyError):
                if self.switch is not None:
                    self.switch.stop_peer_for_error(
                        peer, ValueError("undecodable evidence"))
                return
            try:
                self.pool.add_evidence(ev)
            except EvidenceTooOldError:
                continue  # gossip race, not misbehavior
            except BlockValidationError:
                if self.switch is not None:
                    self.switch.stop_peer_for_error(
                        peer, ValueError("invalid evidence"))
                return

    def _broadcast_routine(self) -> None:
        """evidence/reactor.go:113: drain the pool's queue, broadcast."""
        while not self._stopped:
            ev = self.pool.drain(timeout=0.5)
            if ev is None or self.switch is None:
                continue
            self.switch.broadcast_obj(EVIDENCE_CHANNEL, {
                "type": "evidence_list",
                "evidence": [evidence_to_obj(ev)]})
