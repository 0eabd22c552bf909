"""Application interface: the port's copy of `tendermint_tpu/abci/app.py`.

Method surface mirrors the reference's ABCI application (the external abci
dep driven through proxy/app_conn.go): consensus connection gets
init_chain/begin_block/deliver_tx/end_block/commit, mempool connection gets
check_tx, query connection gets info/query/set_option. BaseApplication
provides no-op defaults so apps override only what they need.
"""

from __future__ import annotations

from typing import List

from tendermint_tpu_torch.abci.types import (
    ResultCheckTx, ResultDeliverTx, ResultEndBlock, ResultInfo, ResultQuery,
)


class BaseApplication:
    # -- query connection ----------------------------------------------------

    def echo(self, msg: str) -> str:
        return msg

    def info(self) -> ResultInfo:
        return ResultInfo()

    def set_option(self, key: str, value: str) -> str:
        return ""

    def query(self, path: str, data: bytes, height: int,
              prove: bool) -> ResultQuery:
        return ResultQuery()

    # -- mempool connection --------------------------------------------------

    def check_tx(self, tx: bytes) -> ResultCheckTx:
        return ResultCheckTx()

    # -- consensus connection ------------------------------------------------

    def init_chain(self, validators: List, chain_id: str = "",
                   app_state: dict | None = None) -> None:
        pass

    def begin_block(self, block_hash: bytes, header_obj: dict,
                    absent_validators: List[int] | None = None,
                    byzantine_validators: List[dict] | None = None) -> None:
        pass

    def deliver_tx(self, tx: bytes) -> ResultDeliverTx:
        return ResultDeliverTx()

    def end_block(self, height: int) -> ResultEndBlock:
        return ResultEndBlock()

    def commit(self) -> bytes:
        """Returns the app hash for the height just executed."""
        return b""

    # -- state-sync snapshot surface ------------------------------------------
    # The analogue of ABCI ListSnapshots/OfferSnapshot/ApplySnapshotChunk
    # for in-process apps: the snapshot writer captures the app's full
    # key/value state at a committed height, and a restoring node
    # installs it wholesale instead of replaying every block.

    def snapshot_items(self):
        """Iterable of (key, value) byte pairs capturing the complete
        app state at the current height, or None when the app does not
        support snapshots (snapshotting is then disabled for the node)."""
        return None

    def restore_items(self, items, height: int, validators=None) -> bytes:
        """Install `items` as the COMPLETE app state at `height`
        (replacing whatever the app held) and adopt `validators`
        ((pubkey, power) pairs) as the active set. Returns the
        resulting app hash — the caller aborts the restore when it
        disagrees with the snapshot's claimed state."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support snapshot restore")
