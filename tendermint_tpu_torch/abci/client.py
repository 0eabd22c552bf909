"""ABCI clients, in-process Local and Socket: the port's copy of
`tendermint_tpu/abci/client.py` (proxy/client.go:14,65).

Both present the same synchronous AppConn surface. LocalClient serializes
calls with one lock, exactly like the reference's localClient (the app is
assumed single-threaded). SocketClient frames canonical-JSON Request/
Response over a stream socket: 4-byte big-endian length + payload, the
same bytes as the JAX package's, so either package's client talks to
either package's ABCIServer.

The reference's async callback machinery (DeliverTxAsync + flush) exists to
pipeline the socket; here deliver_tx_batch() sends all requests before
reading all responses — same pipelining, simpler surface.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import List, Optional, Protocol

from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.types import (
    Request, Response, ResultCheckTx, ResultDeliverTx, ResultEndBlock,
    ResultInfo, ResultQuery, ValidatorUpdate,
)
from tendermint_tpu_torch.types import encoding

_LEN = struct.Struct(">I")
_MAX_MSG = 64 << 20


class ABCIClientError(Exception):
    pass


def write_frame(sock_file, obj) -> None:
    payload = encoding.cdumps(obj)
    sock_file.write(_LEN.pack(len(payload)) + payload)


def read_frame(sock_file):
    hdr = sock_file.read(_LEN.size)
    if len(hdr) < _LEN.size:
        raise EOFError("connection closed")
    (length,) = _LEN.unpack(hdr)
    if length > _MAX_MSG:
        raise ABCIClientError(f"frame {length}B exceeds {_MAX_MSG}B")
    payload = sock_file.read(length)
    if len(payload) < length:
        raise EOFError("connection closed mid-frame")
    return encoding.cloads(payload)


class AppConn(Protocol):
    """The synchronous client surface used by consensus/mempool/query."""

    def echo(self, msg: str) -> str: ...
    def info(self) -> ResultInfo: ...
    def set_option(self, key: str, value: str) -> str: ...
    def query(self, path: str, data: bytes, height: int = 0,
              prove: bool = False) -> ResultQuery: ...
    def check_tx(self, tx: bytes) -> ResultCheckTx: ...
    def init_chain(self, validators: List[ValidatorUpdate],
                   chain_id: str = "", app_state: Optional[dict] = None) -> None: ...
    def begin_block(self, block_hash: bytes, header_obj: dict,
                    absent_validators=None, byzantine_validators=None) -> None: ...
    def deliver_tx(self, tx: bytes) -> ResultDeliverTx: ...
    def deliver_tx_batch(self, txs: List[bytes]) -> List[ResultDeliverTx]: ...
    def end_block(self, height: int) -> ResultEndBlock: ...
    def commit(self) -> bytes: ...
    def close(self) -> None: ...


class LocalClient:
    """In-process client; one lock serializes all connections' calls onto
    the app, as proxy's localClient does."""

    def __init__(self, app: BaseApplication,
                 lock: Optional[threading.Lock] = None):
        self.app = app
        self.lock = lock or threading.Lock()

    def echo(self, msg):
        with self.lock:
            return self.app.echo(msg)

    def info(self):
        with self.lock:
            return self.app.info()

    def set_option(self, key, value):
        with self.lock:
            return self.app.set_option(key, value)

    def query(self, path, data, height=0, prove=False):
        with self.lock:
            return self.app.query(path, data, height, prove)

    def check_tx(self, tx):
        with self.lock:
            return self.app.check_tx(tx)

    def init_chain(self, validators, chain_id="", app_state=None):
        with self.lock:
            self.app.init_chain(validators, chain_id, app_state)

    def begin_block(self, block_hash, header_obj,
                    absent_validators=None, byzantine_validators=None):
        with self.lock:
            self.app.begin_block(block_hash, header_obj,
                                 absent_validators, byzantine_validators)

    def deliver_tx(self, tx):
        with self.lock:
            return self.app.deliver_tx(tx)

    def deliver_tx_batch(self, txs):
        with self.lock:
            batch = getattr(self.app, "deliver_tx_batch", None)
            if batch is not None:
                return batch(txs)
            return [self.app.deliver_tx(tx) for tx in txs]

    def end_block(self, height):
        with self.lock:
            return self.app.end_block(height)

    def commit(self):
        with self.lock:
            return self.app.commit()

    def close(self):
        pass


class SocketClient:
    """ABCI over a stream socket (tcp host:port or unix path)."""

    def __init__(self, address: str, timeout: float = 10.0):
        self.address = address
        self._lock = threading.Lock()
        if address.startswith("unix:"):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(address[len("unix:"):])
        else:
            host, _, port = address.rpartition(":")
            self._sock = socket.create_connection((host, int(port)),
                                                  timeout=timeout)
        self._sock.settimeout(timeout)
        self._f = self._sock.makefile("rwb")

    def _call(self, method: str, payload=None):
        with self._lock:
            write_frame(self._f, Request(method, payload).to_obj())
            self._f.flush()
            resp = Response.from_obj(read_frame(self._f))
        if resp.error:
            raise ABCIClientError(f"{method}: {resp.error}")
        return resp.payload

    # -- surface -------------------------------------------------------------

    def echo(self, msg):
        return self._call("echo", {"msg": msg})["msg"]

    def info(self):
        return ResultInfo.from_obj(self._call("info"))

    def set_option(self, key, value):
        return self._call("set_option", {"key": key, "value": value})["log"]

    def query(self, path, data, height=0, prove=False):
        return ResultQuery.from_obj(self._call(
            "query", {"path": path, "data": data.hex(), "height": height,
                      "prove": prove}))

    def check_tx(self, tx):
        return ResultCheckTx.from_obj(self._call("check_tx", {"tx": tx.hex()}))

    def init_chain(self, validators, chain_id="", app_state=None):
        self._call("init_chain",
                   {"validators": [v.to_obj() for v in validators],
                    "chain_id": chain_id, "app_state": app_state})

    def begin_block(self, block_hash, header_obj,
                    absent_validators=None, byzantine_validators=None):
        self._call("begin_block",
                   {"block_hash": block_hash.hex(), "header": header_obj,
                    "absent_validators": absent_validators or [],
                    "byzantine_validators": byzantine_validators or []})

    def deliver_tx(self, tx):
        return ResultDeliverTx.from_obj(
            self._call("deliver_tx", {"tx": tx.hex()}))

    def deliver_tx_batch(self, txs):
        """Pipelined: write all requests, then read all responses — the
        socket-throughput trick behind the reference's DeliverTxAsync
        (state/execution.go:163-241)."""
        with self._lock:
            for tx in txs:
                write_frame(self._f, Request(
                    "deliver_tx", {"tx": tx.hex()}).to_obj())
            self._f.flush()
            out = []
            for _ in txs:
                resp = Response.from_obj(read_frame(self._f))
                if resp.error:
                    raise ABCIClientError(f"deliver_tx: {resp.error}")
                out.append(ResultDeliverTx.from_obj(resp.payload))
            return out

    def end_block(self, height):
        return ResultEndBlock.from_obj(
            self._call("end_block", {"height": height}))

    def commit(self):
        return bytes.fromhex(self._call("commit")["data"])

    def close(self):
        try:
            self._f.close()
            self._sock.close()
        except OSError:
            pass
