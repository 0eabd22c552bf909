"""AppConns: the three logical app connections and client injection (the
port's copy of `tendermint_tpu/abci/proxy.py`).

proxy/multi_app_conn.go:12-18 gives consensus, mempool and query each their
own connection so a slow query can never block block execution. For the
local (in-process) creator all three share one lock — same serialization
the reference's localClient enforces. For the socket creator each is a
separate connection to the app server.
"""

from __future__ import annotations

import threading
from typing import Callable

from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.client import (AppConn, LocalClient,
                                              SocketClient)

ClientCreator = Callable[[], AppConn]


class AppConns:
    def __init__(self, creator: ClientCreator):
        self._creator = creator
        self.consensus: AppConn = creator()
        self.mempool: AppConn = creator()
        self.query: AppConn = creator()

    def close(self) -> None:
        for c in (self.consensus, self.mempool, self.query):
            c.close()


def local_client_creator(app: BaseApplication) -> ClientCreator:
    lock = threading.Lock()  # one lock across all three connections
    return lambda: LocalClient(app, lock)



def socket_client_creator(address: str, timeout: float = 10.0) -> ClientCreator:
    return lambda: SocketClient(address, timeout)
