"""Connection layer of the p2p plane: SecretConnection (authenticated
encryption), MConnection (prioritised channels on threads), frame bursts
and the flow-rate monitor."""

from tendermint_tpu_torch.p2p.conn.flowrate import FlowMonitor
from tendermint_tpu_torch.p2p.conn.mconn import ChannelDescriptor, MConnection
from tendermint_tpu_torch.p2p.conn.secret import SecretConnection

__all__ = ["ChannelDescriptor", "FlowMonitor", "MConnection",
           "SecretConnection"]
