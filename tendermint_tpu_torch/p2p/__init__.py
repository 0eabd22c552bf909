"""The p2p plane of the port: authenticated encrypted links over TCP
(SecretConnection), prioritised channels (MConnection), peers, the Switch
that dials, accepts, redials and bans, peer exchange (`pex`: AddrBook and
PEXReactor), and the socket net harness (`socknet`) that runs BASELINE
config 1 over loopback TCP."""

from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn import (
    ChannelDescriptor,
    FlowMonitor,
    MConnection,
    SecretConnection,
)
from tendermint_tpu_torch.p2p.key import NodeKey, pubkey_to_id, validate_id
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.peer import Peer, PeerSet
from tendermint_tpu_torch.p2p.switch import Switch, SwitchError

__all__ = [
    "ChannelDescriptor", "FlowMonitor", "MConnection", "NetAddress",
    "NodeInfo", "NodeKey", "Peer", "PeerSet", "Reactor", "SecretConnection",
    "Switch", "SwitchError", "pubkey_to_id", "validate_id",
]
