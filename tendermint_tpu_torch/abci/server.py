"""ABCI socket server — hosts an Application for out-of-process consensus:
the port's copy of `tendermint_tpu/abci/server.py`.

Counterpart of SocketClient; one thread per connection, requests dispatched
to the app under a shared lock (the app contract is single-threaded
execution, as with the reference's socket server).
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.client import read_frame, write_frame
from tendermint_tpu_torch.abci.types import Request, Response, ValidatorUpdate


class ABCIServer:
    def __init__(self, app: BaseApplication, address: str):
        self.app = app
        self.address = address
        self._app_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._stopping = False
        if address.startswith("unix:"):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(address[len("unix:"):])
        else:
            host, _, port = address.rpartition(":")
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(8)

    @property
    def bound_port(self) -> Optional[int]:
        try:
            return self._sock.getsockname()[1]
        except (OSError, IndexError):
            return None

    def start(self) -> None:
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stopping = True
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rwb")
        try:
            while True:
                try:
                    req = Request.from_obj(read_frame(f))
                except EOFError:
                    return
                resp = self._dispatch(req)
                write_frame(f, resp.to_obj())
                f.flush()
        finally:
            try:
                f.close()
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req: Request) -> Response:
        p = req.payload or {}
        try:
            with self._app_lock:
                out = self._handle(req.method, p)
            return Response(req.method, out)
        except Exception as e:
            return Response(req.method, None, f"{type(e).__name__}: {e}")

    def _handle(self, method: str, p: dict):
        app = self.app
        if method == "echo":
            return {"msg": app.echo(p["msg"])}
        if method == "info":
            return app.info().to_obj()
        if method == "set_option":
            return {"log": app.set_option(p["key"], p["value"])}
        if method == "query":
            return app.query(p["path"], bytes.fromhex(p["data"]),
                             p["height"], p["prove"]).to_obj()
        if method == "check_tx":
            return app.check_tx(bytes.fromhex(p["tx"])).to_obj()
        if method == "init_chain":
            app.init_chain([ValidatorUpdate.from_obj(v)
                            for v in p["validators"]],
                           p.get("chain_id", ""), p.get("app_state"))
            return {}
        if method == "begin_block":
            app.begin_block(bytes.fromhex(p["block_hash"]), p["header"],
                            p.get("absent_validators"),
                            p.get("byzantine_validators"))
            return {}
        if method == "deliver_tx":
            return app.deliver_tx(bytes.fromhex(p["tx"])).to_obj()
        if method == "end_block":
            return app.end_block(p["height"]).to_obj()
        if method == "commit":
            return {"data": app.commit().hex()}
        raise ValueError(f"unknown ABCI method {method!r}")
