"""Built-in example applications: the kvstore app and the counter app."""

from tendermint_tpu_torch.abci.apps.counter import CounterApp
from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp

__all__ = ["CounterApp", "KVStoreApp"]
