"""NodeInfo — identity + capability advertisement exchanged at handshake:
the port's copy of `tendermint_tpu/p2p/node_info.py` (p2p/node_info.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from tendermint_tpu_torch.p2p.key import pubkey_to_id

MAX_NUM_CHANNELS = 16


@dataclass
class NodeInfo:
    pubkey: bytes                 # ed25519, ID derives from it
    moniker: str = "node"
    network: str = ""             # chain id; must match to connect
    version: str = "0.1.0"
    channels: List[int] = field(default_factory=list)
    listen_addr: str = ""         # host:port we accept on
    other: List[str] = field(default_factory=list)

    @property
    def id(self) -> str:
        return pubkey_to_id(self.pubkey)

    def validate(self) -> None:
        """p2p/node_info.go:40."""
        if len(self.pubkey) != 32:
            raise ValueError("bad pubkey length")
        if len(self.channels) > MAX_NUM_CHANNELS:
            raise ValueError(f"too many channels ({len(self.channels)})")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError("duplicate channel ids")

    def compatible_with(self, other: "NodeInfo") -> None:
        """Same network + same major version + at least one common channel
        (p2p/node_info.go:64-113). Raises on mismatch."""
        if self.network != other.network:
            raise ValueError(
                f"network mismatch: {self.network!r} vs {other.network!r}")
        major = self.version.split(".")[0]
        other_major = other.version.split(".")[0]
        if major != other_major:
            raise ValueError(
                f"version mismatch: {self.version} vs {other.version}")
        if self.channels and other.channels and \
                not set(self.channels) & set(other.channels):
            raise ValueError("no common channels")

    def to_obj(self):
        return {"pubkey": self.pubkey.hex(), "moniker": self.moniker,
                "network": self.network, "version": self.version,
                "channels": list(self.channels),
                "listen_addr": self.listen_addr, "other": list(self.other)}

    @classmethod
    def from_obj(cls, o):
        return cls(bytes.fromhex(o["pubkey"]), o.get("moniker", ""),
                   o.get("network", ""), o.get("version", "0.0.0"),
                   list(o.get("channels", [])), o.get("listen_addr", ""),
                   list(o.get("other", [])))
