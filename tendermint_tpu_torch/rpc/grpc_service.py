"""gRPC BroadcastAPI, server and client: the port's copy of
`tendermint_tpu/rpc/grpc_service.py`.

Capability parity with the reference's minimal gRPC surface (its
rpc/grpc/types.proto and client_server.go):
`Ping` and `BroadcastTx`, where BroadcastTx submits through the full
commit path (the reference implements it via core.BroadcastTxCommit) and
returns both the CheckTx and DeliverTx results.

The service is wired with
`grpc.method_handlers_generic_handler` over the protoc-generated
messages instead of generated *_pb2_grpc stubs; the shared scaffolding
(bind policy, stub maps) lives in rpc/grpc_util.py.
"""

from __future__ import annotations

from typing import Optional

import grpc

from tendermint_tpu_torch.rpc.grpc_util import GrpcServerBase, make_stubs, strip_tcp
from tendermint_tpu_torch.rpc.proto import tmtpu_pb2 as pb

_SERVICE = "tendermint_tpu.BroadcastAPI"

_REQ = {"Ping": pb.PingRequest, "BroadcastTx": pb.BroadcastTxRequest}
_RESP = {"Ping": pb.PingResponse, "BroadcastTx": pb.BroadcastTxResponse}


def _tx_result(obj: Optional[dict]) -> pb.TxResult:
    if not obj:
        return pb.TxResult()
    return pb.TxResult(
        code=obj.get("code", 0), data=bytes.fromhex(obj.get("data") or ""),
        log=obj.get("log", ""),
        tags={str(k): str(v) for k, v in (obj.get("tags") or {}).items()},
        gas_wanted=obj.get("gas_wanted", 0))


class BroadcastAPIServer(GrpcServerBase):
    """Serves Ping + BroadcastTx over the RPCCore handlers."""

    SERVICE = _SERVICE

    def __init__(self, core, laddr: str, max_workers: int = 8):
        """core: rpc.core.RPCCore; laddr: 'host:port' or
        'tcp://host:port' (port 0 picks a free port)."""
        self.core = core
        super().__init__(laddr, max_workers=max_workers)

    def handlers(self):
        def ping(request, context):
            return pb.PingResponse()

        def broadcast_tx(request, context):
            from tendermint_tpu_torch.rpc.server import RPCError
            try:
                res = self.core.broadcast_tx_commit(request.tx)
            except RPCError as e:
                context.abort(grpc.StatusCode.INTERNAL, e.message)
                return
            return pb.BroadcastTxResponse(
                check_tx=_tx_result(res.get("check_tx")),
                deliver_tx=_tx_result(res.get("deliver_tx")),
                hash=bytes.fromhex(res.get("hash") or ""),
                height=res.get("height", 0))

        return {"Ping": (ping, _REQ["Ping"], _RESP["Ping"]),
                "BroadcastTx": (broadcast_tx, _REQ["BroadcastTx"],
                                _RESP["BroadcastTx"])}


class BroadcastAPIClient:
    """Client for BroadcastAPIServer (rpc/grpc/client_server.go)."""

    def __init__(self, address: str, timeout: float = 60.0):
        self.timeout = timeout
        self._channel = grpc.insecure_channel(strip_tcp(address))
        self._stubs = make_stubs(self._channel, _SERVICE, _REQ, _RESP)

    def ping(self) -> None:
        self._stubs["Ping"](pb.PingRequest(), timeout=self.timeout)

    def broadcast_tx(self, tx: bytes) -> pb.BroadcastTxResponse:
        return self._stubs["BroadcastTx"](pb.BroadcastTxRequest(tx=tx),
                                          timeout=self.timeout)

    def close(self) -> None:
        self._channel.close()
