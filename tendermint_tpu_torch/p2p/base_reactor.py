"""Reactor — the protocol-plugin contract: the port's copy of
`tendermint_tpu/p2p/base_reactor.py` (p2p/base_reactor.go:8-31).

A reactor owns a set of channels; the Switch routes each incoming message to
the reactor that registered its channel, and notifies reactors when peers
come and go."""

from __future__ import annotations

from typing import List

from tendermint_tpu_torch.p2p.conn import ChannelDescriptor


class Reactor:
    def __init__(self, name: str):
        self.name = name
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> List[ChannelDescriptor]:
        return []

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def add_peer(self, peer) -> None:
        """Called when a peer is connected + handshaked."""

    def remove_peer(self, peer, reason) -> None:
        """Called when a peer disconnects."""

    def receive(self, ch_id: int, peer, msg: bytes) -> None:
        """One complete message from `peer` on `ch_id`."""
