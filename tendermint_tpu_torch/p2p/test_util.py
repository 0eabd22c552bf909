"""In-process p2p test harness: the port's copy of
`tendermint_tpu/p2p/test_util.py` (p2p/test_util.go).

`make_connected_switches(n)` builds N fully-meshed switches over
socketpairs — no listening sockets, no ports, works anywhere. This is the
substrate for multi-node consensus/reactor tests, exactly the reference's
MakeConnectedSwitches + Connect2Switches trick (p2p/test_util.go:53)."""

from __future__ import annotations

import socket
import threading
from typing import Callable, List, Optional

from tendermint_tpu_torch.config import P2PConfig
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.types.keys import PrivKey


def make_switch(network: str = "testnet", seed: Optional[bytes] = None,
                encrypt: bool = False, moniker: str = "test",
                config: Optional[P2PConfig] = None,
                other: Optional[List[str]] = None) -> Switch:
    """`other`: the NodeInfo's capability strings (e.g.
    `consensus.compact.wire_capabilities(config)`)."""
    nk = NodeKey(PrivKey.generate(seed))
    info = NodeInfo(pubkey=nk.pubkey, moniker=moniker, network=network,
                    other=list(other or []))
    return Switch(config or P2PConfig(), nk, info, encrypt=encrypt)


def connect_switches(sw1: Switch, sw2: Switch) -> tuple:
    """Connect two switches over a socketpair; returns (peer_in_sw1,
    peer_in_sw2). Runs both handshakes concurrently (they block on each
    other)."""
    s1, s2 = socket.socketpair()
    result = {}
    errors = {}

    def side(name, sw, sock, outbound):
        try:
            result[name] = sw.add_peer_from_socket(
                sock, outbound=outbound, dial_addr=None)
        except Exception as e:  # pragma: no cover - surfaced below
            errors[name] = e
            sock.close()

    t1 = threading.Thread(target=side, args=("a", sw1, s1, True))
    t2 = threading.Thread(target=side, args=("b", sw2, s2, False))
    t1.start(); t2.start()
    t1.join(timeout=30); t2.join(timeout=30)
    if errors:
        raise RuntimeError(f"connect failed: {errors}")
    return result["a"], result["b"]


def make_connected_switches(n: int, reactor_factory: Callable[[int], dict],
                            network: str = "testnet",
                            encrypt: bool = False,
                            config: Optional[P2PConfig] = None,
                            other: Optional[List[str]] = None
                            ) -> List[Switch]:
    """N switches, each with reactor_factory(i)'s reactors added, started,
    and fully meshed."""
    switches = []
    for i in range(n):
        sw = make_switch(network=network, seed=bytes([i + 1]) * 32,
                         encrypt=encrypt, moniker=f"node{i}", config=config,
                         other=other)
        for name, reactor in reactor_factory(i).items():
            sw.add_reactor(name, reactor)
        sw.start()
        switches.append(sw)
    for i in range(n):
        for j in range(i + 1, n):
            connect_switches(switches[i], switches[j])
    return switches
