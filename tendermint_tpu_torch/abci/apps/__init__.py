"""Built-in example applications: the kvstore app."""

from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp

__all__ = ["KVStoreApp"]
