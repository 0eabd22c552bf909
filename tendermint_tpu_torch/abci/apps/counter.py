"""Counter app: the port's copy of `tendermint_tpu/abci/apps/counter.py`,
a serial-tx conformance app (reference's abci counter,
exercised by test/app/counter_test.sh). In serial mode a tx must be the
big-endian encoding of exactly the next expected count; used to prove the
chain delivers txs exactly once, in order."""

from __future__ import annotations

from tendermint_tpu_torch.abci.app import BaseApplication
from tendermint_tpu_torch.abci.types import (
    ResultCheckTx, ResultDeliverTx, ResultInfo, ResultQuery,
)


class CounterApp(BaseApplication):
    def __init__(self, serial: bool = False):
        self.serial = serial
        self.height = 0
        self.tx_count = 0

    def info(self) -> ResultInfo:
        return ResultInfo(data=f"counter:{self.tx_count}",
                          last_block_height=self.height,
                          last_block_app_hash=self._hash())

    def set_option(self, key: str, value: str) -> str:
        if key == "serial":
            self.serial = value == "on"
            return f"serial={self.serial}"
        return ""

    def _value(self, tx: bytes) -> int:
        return int.from_bytes(tx, "big") if tx else 0

    def check_tx(self, tx: bytes) -> ResultCheckTx:
        if self.serial and self._value(tx) < self.tx_count:
            return ResultCheckTx(
                code=2, log=f"tx value {self._value(tx)} < count {self.tx_count}")
        return ResultCheckTx()

    def deliver_tx(self, tx: bytes) -> ResultDeliverTx:
        if self.serial and self._value(tx) != self.tx_count:
            return ResultDeliverTx(
                code=2,
                log=f"expected {self.tx_count}, got {self._value(tx)}")
        self.tx_count += 1
        return ResultDeliverTx()

    def _hash(self) -> bytes:
        return self.tx_count.to_bytes(8, "big").rjust(32, b"\x00")

    def commit(self) -> bytes:
        self.height += 1
        return self._hash()

    def query(self, path: str, data: bytes, height: int,
              prove: bool) -> ResultQuery:
        if path == "tx":
            return ResultQuery(value=str(self.tx_count).encode())
        if path == "hash":
            return ResultQuery(value=str(self.height).encode())
        return ResultQuery(log=f"invalid query path {path!r}")
