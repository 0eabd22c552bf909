"""The node's configuration tree: the port's copy of
`tendermint_tpu/config.py` (config/config.go:35-44).

Consensus timeouts are round-scaled functions exactly like the
reference's (config/config.go:364-385: propose 3000+500·round ms,
prevote/precommit 1000+500·round ms, commit 1000 ms). test_config()
shrinks them for fast in-process nets, mirroring config.TestConfig.

Settings that the JAX package reads from `TM_TPU_*` environment knobs
are fields here, with the same defaults: the p2p frame bursts (`burst`,
`burst_max`), the ban plane (`ban_score`, `ban_base_s`, `fd_headroom`),
the compact consensus gossip (`compact`, `vote_agg`), the socket plane
(`base.reactor`: auto|loop|threads, auto being the event loop), the
verifier's dispatch coalescing (`base.verifier_coalesce`: auto|on|off,
`verifier_coalesce_wait_ms`, `verifier_coalesce_max_batch`) and the
pipelined block hot path (`base.pipeline`: auto|on|off, auto being on;
pipeline.py) and the recovery plane (`base.snapshot_interval`,
`snapshot_keep`, `snapshot_chunk_kb`, `retain_heights`, `state_sync`).
Each has its `TM_CUDA_*` knob (utils/knobs.py), which wins over the
field at the field's resolver, as the JAX package's `TM_TPU_*` knob does.
`validate()` refuses a value outside those sets when the config is
loaded. The observability planes' keys
(`base.telemetry`, `telemetry_namespace`, `trace`, `prof`, `prof_hz`,
`queue_watch`, `slo`, `slo_sample`) carry the JAX package's names and
defaults, except the namespace (`tmcuda`); their `TM_CUDA_*` knobs
(utils/knobs.py) win over them, as the JAX package's knobs do. So does
`TM_CUDA_MESH` over the verifier's device mesh (`base.verifier_mesh`:
auto|off|N, the JAX key).

`config/config.json` is one file for both packages. default_config()
reads a JAX-written file: the JAX package keeps the bursts and the
compact gossip under `base` (`p2p_burst`, `p2p_burst_max`, `compact`,
`vote_agg`, each auto|on|off), and the loader maps those keys onto the
port's fields. `reactor`, `pipeline`, the `verifier_coalesce*` keys,
the five recovery keys and the eight observability keys have the same
names and meanings in both packages, and so do `chaos` and
`chaos_seed`. Keys the port does not have are ignored, as the JAX loader
ignores any key its dataclasses lack. save_config() writes those
four settings only as the JAX keys, so the file holds one key for each
and the JAX package reads a port-written file the same way. A file that
names the port's field itself (`p2p.burst`, say) is read as written: the
JAX key maps onto a field only where the field's own section leaves it
out.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field, replace

from tendermint_tpu_torch.utils import knobs


@dataclass
class BaseConfig:
    chain_id: str = ""
    moniker: str = "anonymous"
    fast_sync: bool = True
    db_dir: str = "data"
    log_level: str = "info"
    # the node's BatchVerifier (models/verifier.py): auto|cuda|python
    verifier_backend: str = "auto"
    # the verifier's device mesh (parallel/mesh.py): auto|off|N, N a
    # power of two; "auto" shards every batch over the largest power of
    # two of the devices present (one card: unsharded). TM_CUDA_MESH wins
    verifier_mesh: str = "auto"
    # cross-call dispatch coalescing (models/coalescer.py): auto|on|off
    # merge concurrent calls of at most the verifier's auto threshold
    # into one launch; wait_ms caps a merge's linger, max_batch its
    # items (0: the verifier's BATCH_CHUNK)
    verifier_coalesce: str = "auto"
    verifier_coalesce_wait_ms: float = 2.0
    verifier_coalesce_max_batch: int = 0
    # socket plane (p2p/conn/loop.py): "loop" (= "auto") runs every peer
    # socket, gossip routine and RPC connection of the node on ONE event
    # loop thread; "threads" is the thread-per-connection plane
    reactor: str = "auto"
    # pipelined block hot path (pipeline.py): native part-set build,
    # streaming proposal gossip, the precomputed next proposal and
    # group-commit persistence. auto|on|off; "off" is the serial path
    pipeline: str = "auto"
    # recovery plane (storage/snapshot.py, statesync/): a chunked state
    # snapshot every `snapshot_interval` heights (0: off), the newest
    # `snapshot_keep` kept, `snapshot_chunk_kb` KiB chunks;
    # `retain_heights` > 0 prunes the block and state stores behind a
    # floor that never passes the latest snapshot, the evidence horizon
    # or a peer's catch-up frontier; `state_sync` lets a fresh node join
    # by fetching a snapshot over p2p instead of replaying every block.
    # All at 0 / off: no snapshot, no pruning, no channel 0x60.
    snapshot_interval: int = 0
    snapshot_keep: int = 2
    snapshot_chunk_kb: int = 256
    retain_heights: int = 0
    state_sync: bool = False
    # telemetry plane (telemetry/): metrics + tracing on by default; the
    # exposition namespace prefixes every family (`tmcuda_...`; "tm"
    # gives the JAX package's names). TM_CUDA_TELEMETRY=off overrides
    # `telemetry` unconditionally.
    telemetry: bool = True
    telemetry_namespace: str = "tmcuda"
    # causal tracing plane (telemetry/causal.py): per-height consensus
    # spans, trace-stamped p2p envelopes, the dump_height_timeline RPC
    # and GET /debug/timeline. "off" keeps the wire format byte-for-byte
    # untraced. TM_CUDA_TRACE wins.
    trace: str = "off"
    # runtime introspection plane (telemetry/profile.py + queues.py):
    # `prof` on starts the sampling profiler at `prof_hz` sweeps/sec
    # (prof_* families, GET /debug/pprof, the debug_profile RPC);
    # `queue_watch` (off | on | <poll seconds>) runs the bounded-queue
    # observatory (queue_* families, the /healthz verdict)
    prof: str = "off"
    prof_hz: float = 0.0  # 0 = profile.DEFAULT_HZ (13)
    queue_watch: str = "on"
    # tx-lifecycle SLO plane (telemetry/slo.py): `slo` on stamps sampled
    # txs at each stage boundary (admit -> checktx -> propose -> commit
    # -> publish -> deliver) into per-stage quantile sketches served at
    # /slo and folded into /healthz; `slo_sample` is the deterministic
    # hash-based sampling rate.
    slo: str = "off"
    slo_sample: float = 1.0
    # chaos plane (chaos/): link fault injection. "off" (the default) is
    # a no-op — p2p links stay on the existing code paths. Any other
    # value is a link fault spec, e.g. "drop=0.05,delay=0.1,delay_ms=30";
    # chaos_seed makes the injected fault pattern reproducible.
    # TM_CUDA_CHAOS (which may carry its own seed=N) wins over both.
    chaos: str = "off"
    chaos_seed: int = 0
    # shard plane (shard/): the chain count `cli shardset` assembles
    # without --shards (serving/deploy.shard_count) — N independent
    # chains in one process behind one front door, sharing one verifier
    # and one ReactorLoop. 0 leaves it to the flag's default, 2.
    # TM_CUDA_SHARDS wins.
    shards: int = 0


# grpc_laddr, when set, serves the gRPC BroadcastAPI
# (rpc/grpc_service.py) beside or instead of the JSON-RPC listener. No
# link of either package reads flush_throttle_ms and
# max_msg_packet_payload_size; they are kept so that config.json
# round-trips between the packages. skip_upnp false makes a wildcard
# listener ask a UPnP gateway for its external address (p2p/upnp.py).
@dataclass
class RPCConfig:
    laddr: str = "tcp://0.0.0.0:46657"
    grpc_laddr: str = ""
    unsafe: bool = False


@dataclass
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:46656"
    seeds: str = ""
    persistent_peers: str = ""
    max_num_peers: int = 50
    flush_throttle_ms: int = 100
    max_msg_packet_payload_size: int = 1024
    send_rate: int = 512000  # B/s (p2p/conn/connection.go:33-35)
    recv_rate: int = 512000
    pex: bool = True
    seed_mode: bool = False
    addr_book_strict: bool = True
    skip_upnp: bool = True
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
class TxIndexConfig:
    indexer: str = "kv"           # kv | null
    index_tags: str = ""
    index_all_tags: bool = False


@dataclass
class Config:
    home: str = ""
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)

    def path(self, *parts: str) -> str:
        return os.path.join(self.home, *parts)


SECTIONS = ("base", "rpc", "p2p", "mempool", "consensus", "tx_index")


def _mode_on(v) -> bool:
    """A JAX auto|on|off mode (or a bool) as the port's bool: only off is
    off."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() not in ("off", "0", "false", "no")


# the port's fields that the JAX package keeps under `base` (as
# p2p_burst, p2p_burst_max, compact and vote_agg)
JAX_BASE_FIELDS = (("p2p", "burst"), ("p2p", "burst_max"),
                   ("consensus", "compact"), ("consensus", "vote_agg"))


def _apply_jax_base(cfg: Config, overrides: dict) -> None:
    """The JAX package's `base` keys for settings the port keeps in
    another section, each where that section of the file does not set
    the port's field itself."""
    base = overrides["base"]

    def unset(section: str, name: str) -> bool:
        values = overrides.get(section)
        return not (isinstance(values, dict) and name in values)

    if "p2p_burst" in base and unset("p2p", "burst"):
        mode = str(base["p2p_burst"]).strip().lower()
        cfg.p2p.burst = _mode_on(mode)
        if mode.isdigit() and unset("p2p", "burst_max"):
            cfg.p2p.burst_max = int(mode)
    if int(base.get("p2p_burst_max") or 0) > 0 and unset("p2p", "burst_max"):
        cfg.p2p.burst_max = int(base["p2p_burst_max"])
    if "compact" in base and unset("consensus", "compact"):
        cfg.consensus.compact = _mode_on(base["compact"])
    if "vote_agg" in base and unset("consensus", "vote_agg"):
        cfg.consensus.vote_agg = _mode_on(base["vote_agg"])


def default_config(home: str = "") -> Config:
    """Defaults, overlaid with `<home>/config/config.json` when present
    (the reference loads $TMHOME/config.toml via viper, config/toml.go)."""
    cfg = Config(home=home)
    path = os.path.join(home, "config", "config.json") if home else ""
    if path and os.path.exists(path):
        with open(path) as f:
            overrides = json.load(f)
        for section, values in overrides.items():
            target = getattr(cfg, section, None) \
                if section in SECTIONS else None
            if target is None or not isinstance(values, dict):
                continue
            for k, v in values.items():
                if hasattr(target, k):
                    setattr(target, k, v)
        if isinstance(overrides.get("base"), dict):
            _apply_jax_base(cfg, overrides)
    validate(cfg)
    return cfg


_OFF = ("off", "0", "false", "no", "none", "disabled")


def parse_coalesce(spec) -> str:
    """'auto' | 'on' | 'off', with the spellings the JAX package's
    `_parse_coalesce_spec` accepts; anything else raises."""
    s = str(spec).strip().lower()
    if s in ("auto", ""):
        return "auto"
    if s in ("on", "1", "true", "yes"):
        return "on"
    if s in ("off", "0", "false", "no", "none"):
        return "off"
    raise ValueError(f"verifier coalesce must be auto|on|off, got {spec!r}")


def resolve_reactor(mode) -> str:
    """-> 'loop' | 'threads': TM_CUDA_REACTOR over the `base.reactor`
    value `mode`, with the spellings of the JAX package's
    `loop.resolve`: auto is the event loop, an off value the thread
    plane; anything else raises."""
    m = knobs.knob_str("TM_CUDA_REACTOR",
                       config=None if mode is None else str(mode),
                       default="auto")
    if m in ("threads", "thread"):
        return "threads"
    if m in ("loop", "auto", "on", ""):
        return "loop"
    if m in _OFF:
        return "threads"
    raise ValueError(f"reactor must be loop|threads|auto, got {mode!r}")


def validate(cfg: Config) -> None:
    """Refuse a socket plane, coalescing or mesh setting outside its set,
    as the JAX package does when a node builds its verifier and its
    loop."""
    b = cfg.base
    resolve_reactor(b.reactor)
    parse_coalesce(b.verifier_coalesce)
    from tendermint_tpu_torch.parallel.mesh import parse_mesh_spec
    parse_mesh_spec(b.verifier_mesh)
    if float(b.verifier_coalesce_wait_ms) < 0:
        raise ValueError(f"verifier_coalesce_wait_ms must be >= 0, got "
                         f"{b.verifier_coalesce_wait_ms!r}")
    if int(b.verifier_coalesce_max_batch) < 0:
        raise ValueError(f"verifier_coalesce_max_batch must be >= 0, got "
                         f"{b.verifier_coalesce_max_batch!r}")


def save_config(cfg: Config) -> str:
    """Persist every section as config/config.json; the bursts and the
    compact gossip go only under the JAX package's `base` keys."""
    path = os.path.join(cfg.home, "config", "config.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    obj = {name: asdict(getattr(cfg, name)) for name in SECTIONS}
    for section, name in JAX_BASE_FIELDS:
        del obj[section][name]
    obj["base"].update(
        p2p_burst="on" if cfg.p2p.burst else "off",
        p2p_burst_max=cfg.p2p.burst_max,
        compact="on" if cfg.consensus.compact else "off",
        vote_agg="on" if cfg.consensus.vote_agg else "off")
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    return path


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
