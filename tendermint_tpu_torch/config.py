"""Configuration of the consensus engine, the mempool and the p2p layer:
the port's copy of those sections of `tendermint_tpu/config.py`
(config/config.go).

Consensus timeouts are round-scaled functions exactly like the
reference's (config/config.go:364-385: propose 3000+500·round ms,
prevote/precommit 1000+500·round ms, commit 1000 ms). test_config()
shrinks them for fast in-process nets, mirroring config.TestConfig.

Settings that the JAX package reads from `TM_TPU_*` environment knobs
are fields here, with the same defaults: the p2p frame bursts (`burst`,
`burst_max`), the ban plane (`ban_score`, `ban_base_s`, `fd_headroom`)
and the compact consensus gossip (`compact`, `vote_agg`). The port reads
no environment knob for them.

The base, RPC and tx-index sections wait for the node slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace


@dataclass
class P2PConfig:
    max_num_peers: int = 50
    send_rate: int = 512000  # B/s (p2p/conn/connection.go:33-35)
    recv_rate: int = 512000
    external_addr: str = ""
    handshake_timeout_s: float = 20.0   # TOTAL handshake deadline
    dial_timeout_s: float = 3.0
    ping_interval_s: float = 10.0
    idle_timeout_s: float = 35.0
    # trust score below ban_score => banned for ban_base_s (doubling per
    # repeat, decaying with clean time); inbound accepts are shed when
    # fewer than fd_headroom fds remain under the process limit
    ban_score: int = 30
    ban_base_s: float = 60.0
    fd_headroom: int = 64
    # frame bursts: every frame of a link write seals, and every frame
    # buffered on receive opens, in one native AEAD call; a send burst
    # coalesces up to burst_max packets. Off: one AEAD call a frame.
    burst: bool = True
    burst_max: int = 64


@dataclass
class MempoolConfig:
    recheck: bool = True
    broadcast: bool = True
    wal_dir: str = "data/mempool.wal"
    size: int = 100000
    cache_size: int = 100000


@dataclass
class ConsensusConfig:
    wal_path: str = "data/cs.wal/wal"
    wal_light: bool = False
    # base timeouts in ms (config/config.go defaults)
    timeout_propose: int = 3000
    timeout_propose_delta: int = 500
    timeout_prevote: int = 1000
    timeout_prevote_delta: int = 500
    timeout_precommit: int = 1000
    timeout_precommit_delta: int = 500
    timeout_commit: int = 1000
    skip_timeout_commit: bool = False
    max_block_size_txs: int = 10000
    create_empty_blocks: bool = True
    create_empty_blocks_interval: int = 0  # seconds
    peer_gossip_sleep_ms: int = 100
    peer_query_maj23_sleep_ms: int = 2000
    # compact block relay (proposal as salted short tx ids, rebuilt from
    # the receiver's mempool) and aggregated vote gossip: both on, as
    # the JAX package's `auto` resolves; off = the legacy wire shapes
    compact: bool = True
    vote_agg: bool = True

    def propose_timeout_s(self, round_: int) -> float:
        return (self.timeout_propose
                + self.timeout_propose_delta * round_) / 1000.0

    def prevote_timeout_s(self, round_: int) -> float:
        return (self.timeout_prevote
                + self.timeout_prevote_delta * round_) / 1000.0

    def precommit_timeout_s(self, round_: int) -> float:
        return (self.timeout_precommit
                + self.timeout_precommit_delta * round_) / 1000.0

    def commit_timeout_s(self) -> float:
        return self.timeout_commit / 1000.0


@dataclass
class Config:
    home: str = ""
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)

    def path(self, *parts: str) -> str:
        return os.path.join(self.home, *parts)


def test_config(home: str = "") -> Config:
    """All consensus timeouts shrunk ~30x (config.TestConfig)."""
    c = Config(home=home)
    c.consensus = replace(
        c.consensus,
        timeout_propose=100, timeout_propose_delta=1,
        timeout_prevote=10, timeout_prevote_delta=1,
        timeout_precommit=10, timeout_precommit_delta=1,
        timeout_commit=10, skip_timeout_commit=True,
        peer_gossip_sleep_ms=5, peer_query_maj23_sleep_ms=250)
    return c
