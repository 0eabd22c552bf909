"""Connection-level helpers: the flow-rate monitor."""

from tendermint_tpu_torch.p2p.conn.flowrate import FlowMonitor
