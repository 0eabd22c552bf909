"""ABCI, the application boundary: the port's copy of the in-process half
of `tendermint_tpu/abci/`.

  types.py   result dataclasses
  app.py     BaseApplication with no-op defaults
  client.py  the AppConn surface and the in-process LocalClient
  proxy.py   AppConns (consensus / mempool / query) and
             local_client_creator
  apps/      the kvstore app

The socket client and server, and the counter app, wait for a later
slice.
"""

from tendermint_tpu_torch.abci.types import (
    CodeTypeOK, ResultCheckTx, ResultDeliverTx, ResultEndBlock, ResultInfo,
    ResultQuery, UniformDeliverResults, ValidatorUpdate,
)
from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.client import AppConn, LocalClient
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
