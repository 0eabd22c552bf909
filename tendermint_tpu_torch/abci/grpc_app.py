"""ABCI over gRPC: application server, AppConn client and creator. The
port's copy of `tendermint_tpu/abci/grpc_app.py`.

The third ABCI transport alongside local and socket (the reference's
NewGRPCClientCreator in proxy/client.go; its grpc app server lives in
its external abci repo). An
application built on abci/app.BaseApplication can be served
out-of-process with `ABCIGrpcServer(app, addr)`, and the node connects
with `grpc_client_creator(addr)` — each AppConn gets its own channel,
like the socket creator gives each conn its own socket.

Structured sub-objects (header, app state, consensus params) travel as
canonical-JSON bytes (types/encoding.py) — the framework's single
deterministic encoding — inside protoc-generated messages
(rpc/proto/tmtpu.proto).
"""

from __future__ import annotations

from typing import List

import grpc

from tendermint_tpu_torch.abci.types import (ResultCheckTx, ResultDeliverTx,
                                       ResultEndBlock, ResultInfo,
                                       ResultQuery, ValidatorUpdate)
from tendermint_tpu_torch.rpc.grpc_util import (GrpcServerBase, make_stubs,
                                          strip_tcp)
from tendermint_tpu_torch.rpc.proto import tmtpu_pb2 as pb
from tendermint_tpu_torch.types import encoding

_SERVICE = "tendermint_tpu.ABCIApplication"

_METHODS = ("Echo", "Info", "SetOption", "Query", "CheckTx", "InitChain",
            "BeginBlock", "DeliverTx", "DeliverTxBatch", "EndBlock",
            "Commit")

_REQ = {
    "Echo": pb.EchoRequest, "Info": pb.InfoRequest,
    "SetOption": pb.SetOptionRequest, "Query": pb.QueryRequest,
    "CheckTx": pb.CheckTxRequest, "InitChain": pb.InitChainRequest,
    "BeginBlock": pb.BeginBlockRequest, "DeliverTx": pb.DeliverTxRequest,
    "DeliverTxBatch": pb.DeliverTxBatchRequest,
    "EndBlock": pb.EndBlockRequest, "Commit": pb.CommitRequest,
}
_RESP = {
    "Echo": pb.EchoResponse, "Info": pb.InfoResponse,
    "SetOption": pb.SetOptionResponse, "Query": pb.QueryResponse,
    "CheckTx": pb.TxResult, "InitChain": pb.InitChainResponse,
    "BeginBlock": pb.BeginBlockResponse, "DeliverTx": pb.TxResult,
    "DeliverTxBatch": pb.DeliverTxBatchResponse,
    "EndBlock": pb.EndBlockResponse, "Commit": pb.CommitResponse,
}


def _check_tx_pb(r: ResultCheckTx) -> pb.TxResult:
    return pb.TxResult(code=r.code, data=r.data, log=r.log,
                       gas_wanted=r.gas_wanted)


def _deliver_tx_pb(r: ResultDeliverTx) -> pb.TxResult:
    return pb.TxResult(code=r.code, data=r.data, log=r.log,
                       tags={str(k): str(v) for k, v in r.tags.items()})


def _json_or_none(b: bytes):
    return encoding.cloads(b) if b else None


class ABCIGrpcServer(GrpcServerBase):
    """Serves one BaseApplication over gRPC; calls are serialized onto
    the app with the server's own lock, matching the socket server's
    single-app discipline."""

    SERVICE = _SERVICE

    def __init__(self, app, laddr: str = "127.0.0.1:0",
                 max_workers: int = 8):
        import threading
        self.app = app
        self._lock = threading.Lock()
        super().__init__(laddr, max_workers=max_workers)

    # one method per rpc; each takes the decoded request, returns response
    def _do_echo(self, req):
        return pb.EchoResponse(msg=self.app.echo(req.msg))

    def _do_info(self, req):
        r = self.app.info()
        return pb.InfoResponse(data=r.data, version=r.version,
                               last_block_height=r.last_block_height,
                               last_block_app_hash=r.last_block_app_hash)

    def _do_setoption(self, req):
        return pb.SetOptionResponse(
            log=self.app.set_option(req.key, req.value) or "")

    def _do_query(self, req):
        r = self.app.query(req.path, req.data, req.height, req.prove)
        return pb.QueryResponse(code=r.code, key=r.key, value=r.value,
                                proof=r.proof, height=r.height, log=r.log)

    def _do_checktx(self, req):
        return _check_tx_pb(self.app.check_tx(req.tx))

    def _do_initchain(self, req):
        vals = [ValidatorUpdate(v.pubkey, v.power) for v in req.validators]
        self.app.init_chain(vals, req.chain_id,
                            _json_or_none(req.app_state_json))
        return pb.InitChainResponse()

    def _do_beginblock(self, req):
        self.app.begin_block(req.hash, encoding.cloads(req.header_json),
                             _json_or_none(req.absent_json),
                             _json_or_none(req.byzantine_json))
        return pb.BeginBlockResponse()

    def _do_delivertx(self, req):
        return _deliver_tx_pb(self.app.deliver_tx(req.tx))

    def _do_delivertxbatch(self, req):
        return pb.DeliverTxBatchResponse(
            results=[_deliver_tx_pb(self.app.deliver_tx(tx))
                     for tx in req.txs])

    def _do_endblock(self, req):
        r = self.app.end_block(req.height)
        cpu = r.consensus_param_updates
        return pb.EndBlockResponse(
            validator_updates=[pb.ValidatorUpdate(pubkey=v.pubkey,
                                                  power=v.power)
                               for v in r.validator_updates],
            consensus_param_updates_json=(encoding.cdumps(cpu)
                                          if cpu is not None else b""),
            tags={str(k): str(v) for k, v in r.tags.items()})

    def _do_commit(self, req):
        return pb.CommitResponse(data=self.app.commit())

    def handlers(self):
        def wrap(fn):
            def call(request, context):
                with self._lock:
                    return fn(request)
            return call

        return {m: (wrap(getattr(self, f"_do_{m.lower()}")),
                    _REQ[m], _RESP[m])
                for m in _METHODS}


class GrpcClient:
    """AppConn-compatible client over a gRPC channel."""

    def __init__(self, address: str, timeout: float = 10.0):
        self.timeout = timeout
        self._channel = grpc.insecure_channel(strip_tcp(address))
        self._stubs = make_stubs(self._channel, _SERVICE, _REQ, _RESP)

    def _call(self, method: str, request):
        return self._stubs[method](request, timeout=self.timeout)

    def echo(self, msg: str) -> str:
        return self._call("Echo", pb.EchoRequest(msg=msg)).msg

    def info(self) -> ResultInfo:
        r = self._call("Info", pb.InfoRequest())
        return ResultInfo(r.data, r.version, r.last_block_height,
                          r.last_block_app_hash)

    def set_option(self, key: str, value: str) -> str:
        return self._call("SetOption",
                          pb.SetOptionRequest(key=key, value=value)).log

    def query(self, path: str, data: bytes, height: int = 0,
              prove: bool = False) -> ResultQuery:
        r = self._call("Query", pb.QueryRequest(path=path, data=data,
                                                height=height, prove=prove))
        return ResultQuery(r.code, r.key, r.value, r.proof, r.height, r.log)

    def check_tx(self, tx: bytes) -> ResultCheckTx:
        r = self._call("CheckTx", pb.CheckTxRequest(tx=tx))
        return ResultCheckTx(r.code, r.data, r.log, r.gas_wanted)

    def init_chain(self, validators: List, chain_id: str = "",
                   app_state=None) -> None:
        self._call("InitChain", pb.InitChainRequest(
            validators=[pb.ValidatorUpdate(pubkey=v.pubkey, power=v.power)
                        for v in validators],
            chain_id=chain_id,
            app_state_json=(encoding.cdumps(app_state)
                            if app_state is not None else b"")))

    def begin_block(self, block_hash: bytes, header_obj: dict,
                    absent_validators=None,
                    byzantine_validators=None) -> None:
        self._call("BeginBlock", pb.BeginBlockRequest(
            hash=block_hash, header_json=encoding.cdumps(header_obj),
            absent_json=(encoding.cdumps(absent_validators)
                         if absent_validators is not None else b""),
            byzantine_json=(encoding.cdumps(byzantine_validators)
                            if byzantine_validators is not None else b"")))

    def deliver_tx(self, tx: bytes) -> ResultDeliverTx:
        r = self._call("DeliverTx", pb.DeliverTxRequest(tx=tx))
        return ResultDeliverTx(r.code, r.data, r.log, dict(r.tags))

    def deliver_tx_batch(self, txs: List[bytes]) -> List[ResultDeliverTx]:
        r = self._call("DeliverTxBatch", pb.DeliverTxBatchRequest(txs=txs))
        return [ResultDeliverTx(t.code, t.data, t.log, dict(t.tags))
                for t in r.results]

    def end_block(self, height: int) -> ResultEndBlock:
        r = self._call("EndBlock", pb.EndBlockRequest(height=height))
        cpu = (encoding.cloads(r.consensus_param_updates_json)
               if r.consensus_param_updates_json else None)
        return ResultEndBlock(
            [ValidatorUpdate(v.pubkey, v.power)
             for v in r.validator_updates], cpu, dict(r.tags))

    def commit(self) -> bytes:
        return self._call("Commit", pb.CommitRequest()).data

    def close(self) -> None:
        self._channel.close()


def grpc_client_creator(address: str, timeout: float = 10.0):
    """ClientCreator over gRPC (proxy/client.go): every AppConn gets its
    own channel."""
    def create():
        return GrpcClient(address, timeout=timeout)
    return create
