"""Serving plane: the port's copy of `tendermint_tpu/serving/`, the
pieces that turn one-process runs into a deployed, loadable,
horizontally readable net.

  serving.topology  declarative multi-process topologies (validator
                    nets with edge replicas, or a sharded front-door
                    process) materialized into per-node homes, configs
                    and persistent_peers.
  serving.deploy    the deployment driver: spawn the processes,
                    supervise them (a crash is restarted, bounded),
                    optionally shape the WAN between validators with
                    the chaos WireProxy, tear down leak-clean.
  serving.edge      keyless read replicas following the chain by state
                    sync and fast sync, serving reads only through a
                    ContinuousCertifier advancing from their own stores,
                    with the certified-height lag on every response.
  serving.loadgen   the open-loop load harness: a selector-based fleet
                    of virtual clients offering a Poisson-paced mix at a
                    FIXED rate, swept across rates to find the knee.
"""

from tendermint_tpu_torch.serving.topology import (  # noqa: F401
    ProcSpec,
    Topology,
)
from tendermint_tpu_torch.serving.deploy import Deployment  # noqa: F401
