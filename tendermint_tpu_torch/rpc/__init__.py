"""JSON-RPC over HTTP and WebSocket: the port's copy of
`tendermint_tpu/rpc/` on the thread plane.

  server.py  RPCServer (JSON-RPC POST, URI GET, WebSocket), RPCError,
             RPCFunc
  core.py    RPCEnv, RPCCore (the route table over a node), jsonify,
             make_server
  client.py  JSONRPCClient, URIClient, WSClient, ReconnectingWSClient,
             LocalClient, MockClient
  aserver.py the async front door on the node's event loop
  grpc_service.py, grpc_util.py, proto/
             the gRPC BroadcastAPI (ABCI over gRPC: abci/grpc_app.py)
"""

from tendermint_tpu_torch.rpc.client import (
    JSONRPCClient,
    LocalClient,
    RPCClientError,
    URIClient,
    WSClient,
)
from tendermint_tpu_torch.rpc.core import RPCCore, RPCEnv, jsonify, make_server
from tendermint_tpu_torch.rpc.server import RPCError, RPCServer

__all__ = ["JSONRPCClient", "LocalClient", "RPCClientError", "RPCCore",
           "RPCEnv", "RPCError", "RPCServer", "URIClient", "WSClient",
           "jsonify", "make_server"]
