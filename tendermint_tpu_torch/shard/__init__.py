"""The shard plane — N independent chains in one process, one shared
verifier, one front door: the port's copy of `tendermint_tpu/shard/`.

  shard.set     ShardSet: N `Node` values (distinct genesis docs,
                valsets and homes) sharing one BatchVerifier (with its
                coalescer) and ONE ReactorLoop.
  shard.router  ShardRouter: the deterministic key-space -> chain map
                (a hash range over the tx key prefix) behind one
                AsyncRPCServer serving `broadcast_tx_*`, `abci_query`,
                `tx_search`, chain-scoped passthroughs and WebSocket
                subscriptions for every shard, with the `shard_*`
                families.
  shard.reads   certified cross-shard reads: the value plus the
                FullCommit chain a client-side ContinuousCertifier
                advances through (and, with the state tree on, the
                per-key state proof), so a read of shard B is certified,
                not trusted.

Concurrent small verifies of many chains merge in the shared verifier's
coalescer into one dispatch, so the coalesce factor rises with the
shard count.

Knob: TM_CUDA_SHARDS (> config.base.shards > 0) is the shard count a
`ShardSet(n_shards=None)` and `cli shardset` without `--shards` (> 2;
serving/deploy.shard_count) assemble; 0 keeps the single-chain shape. A
TM_TPU_SHARDS variable changes nothing here.
"""

from __future__ import annotations

from tendermint_tpu_torch.utils import knobs as _knobs


def resolve_shards(config: int = 0) -> int:
    """Default shard count: env TM_CUDA_SHARDS > config.base.shards >
    0 (sharding off)."""
    return max(0, _knobs.knob_int("TM_CUDA_SHARDS", config=config))


from tendermint_tpu_torch.shard.reads import (  # noqa: E402,F401
    CertifiedReader,
    ReadProofError,
    full_commit_at,
)
from tendermint_tpu_torch.shard.router import (  # noqa: E402,F401
    ShardMap,
    ShardRouter,
    key_prefix,
    make_shard_server,
)
from tendermint_tpu_torch.shard.set import ShardSet  # noqa: E402,F401
