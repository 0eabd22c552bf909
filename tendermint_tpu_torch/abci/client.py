"""The in-process ABCI client: the port's copy of the AppConn surface
and LocalClient of `tendermint_tpu/abci/client.py`.

LocalClient serializes calls with one lock, exactly like the reference's
localClient (the app is assumed single-threaded). The socket client
waits for a later slice.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Protocol

from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.types import (
    ResultCheckTx, ResultDeliverTx, ResultEndBlock, ResultInfo, ResultQuery,
    ValidatorUpdate,
)


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
