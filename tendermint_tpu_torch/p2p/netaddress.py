"""NetAddress — `id@host:port` endpoints with routability classification:
the port's copy of `tendermint_tpu/p2p/netaddress.py` (p2p/netaddress.go)."""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Optional

from tendermint_tpu_torch.p2p.key import validate_id


@dataclass(frozen=True)
class NetAddress:
    ip: str
    port: int
    id: str = ""  # hex node ID; empty when unknown (e.g. inbound before handshake)

    @classmethod
    def from_string(cls, s: str) -> "NetAddress":
        """Parse `[id@]host:port` (p2p/netaddress.go:60)."""
        id_ = ""
        if "@" in s:
            id_, s = s.split("@", 1)
            validate_id(id_)
        if ":" not in s:
            raise ValueError(f"address {s!r} missing port")
        host, port_s = s.rsplit(":", 1)
        port = int(port_s)
        if not 0 < port < 65536:
            raise ValueError(f"invalid port {port}")
        # resolve non-IP hostnames lazily; keep as given
        return cls(host, port, id_)

    def __str__(self) -> str:
        base = f"{self.ip}:{self.port}"
        return f"{self.id}@{base}" if self.id else base

    def dial_string(self) -> tuple:
        return (self.ip, self.port)

    def _ipobj(self):
        try:
            return ipaddress.ip_address(self.ip)
        except ValueError:
            return None

    def local(self) -> bool:
        ip = self._ipobj()
        return ip is not None and (ip.is_loopback or ip.is_unspecified)

    def routable(self) -> bool:
        """Publicly dialable (p2p/netaddress.go:190 + RFC classification
        :279-295). Non-IP hostnames are assumed routable."""
        ip = self._ipobj()
        if ip is None:
            return True
        return not (ip.is_loopback or ip.is_private or ip.is_link_local or
                    ip.is_multicast or ip.is_unspecified or ip.is_reserved)

    def valid(self) -> bool:
        ip = self._ipobj()
        return ip is not None and not (ip.is_unspecified or
                                       self.ip == "255.255.255.255")

    def same_group(self, other: "NetAddress") -> bool:
        """Same /16 (used by the addrbook bucketing, p2p/pex)."""
        a, b = self._ipobj(), other._ipobj()
        if a is None or b is None:
            return self.ip == other.ip
        if a.version != b.version:
            return False
        prefix = 16 if a.version == 4 else 32
        na = ipaddress.ip_network(f"{a}/{prefix}", strict=False)
        return b in na

    def to_obj(self):
        return {"ip": self.ip, "port": self.port, "id": self.id}

    @classmethod
    def from_obj(cls, o):
        return cls(o["ip"], o["port"], o.get("id", ""))
