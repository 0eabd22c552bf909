"""Shared gRPC scaffolding for the two services (BroadcastAPI,
ABCIApplication): server construction and unary-stub maps. The port's
copy of `tendermint_tpu/rpc/grpc_util.py`.

One place for transport policy:
- SO_REUSEPORT is DISABLED. grpcio enables it by default, under which a
  second node binding the same laddr silently succeeds and the kernel
  round-robins connections between the two processes. The reference's
  net.Listen fails loudly on a busy port (rpc/grpc/client_server.go);
  so do we — add_insecure_port returns 0 and start() raises.
"""

from __future__ import annotations

from concurrent import futures
from typing import Callable, Dict, Mapping

import grpc

_SERVER_OPTIONS = (("grpc.so_reuseport", 0),)


def strip_tcp(addr: str) -> str:
    return addr.replace("tcp://", "")


class GrpcServerBase:
    """Owns a grpc.server bound to laddr serving one generic handler.

    Subclasses implement handlers() -> {method: (fn, Req, Resp)} where fn
    is fn(request, context) -> response.
    """

    SERVICE = ""  # full service name, e.g. "tendermint_tpu.BroadcastAPI"

    def __init__(self, laddr: str, max_workers: int = 8):
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=_SERVER_OPTIONS)
        method_handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req.FromString,
                response_serializer=resp.SerializeToString)
            for name, (fn, req, resp) in self.handlers().items()}
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                self.SERVICE, method_handlers),))
        self.port = self._server.add_insecure_port(strip_tcp(laddr))
        if self.port == 0:
            raise OSError(f"gRPC bind failed on {laddr!r} (port in use?)")

    def handlers(self) -> Dict[str, tuple]:
        raise NotImplementedError

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)


def make_stubs(channel: grpc.Channel, service: str,
               req_map: Mapping[str, type],
               resp_map: Mapping[str, type]) -> Dict[str, Callable]:
    """Unary-unary stubs for every method in req_map."""
    return {
        m: channel.unary_unary(
            f"/{service}/{m}",
            request_serializer=req_map[m].SerializeToString,
            response_deserializer=resp_map[m].FromString)
        for m in req_map}
