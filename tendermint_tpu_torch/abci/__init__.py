"""ABCI, the application boundary: the port's copy of
`tendermint_tpu/abci/`.

  types.py   result dataclasses and the socket Request / Response
  app.py     BaseApplication with no-op defaults
  client.py  the AppConn surface, the in-process LocalClient, the
             SocketClient and its frames
  server.py  ABCIServer, the socket server that hosts an app
  proxy.py   AppConns (consensus / mempool / query),
             local_client_creator and socket_client_creator
  apps/      the kvstore and counter apps
"""

from tendermint_tpu_torch.abci.types import (
    CodeTypeOK, Request, Response, ResultCheckTx, ResultDeliverTx,
    ResultEndBlock, ResultInfo, ResultQuery, UniformDeliverResults,
    ValidatorUpdate,
)
from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.client import (ABCIClientError, AppConn,
                                              LocalClient, SocketClient)
from tendermint_tpu_torch.abci.proxy import (AppConns, local_client_creator,
                                             socket_client_creator)
from tendermint_tpu_torch.abci.server import ABCIServer
