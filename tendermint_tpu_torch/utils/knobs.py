"""The port's catalog of every TM_CUDA_* environment knob.

The port's copy of the JAX package's knob catalog, under the port's own
prefix: a TM_TPU_* variable changes nothing in this package. Every knob
is declared once here, with its type, default, the config field it
shadows (if any), and a one-line description; reading a name absent
from the catalog raises. The env-wins-over-config contract lives in one
place: every helper takes an optional `config=` value and returns env >
config > default. FALSY is the single vocabulary for "off".

Import-light by design (stdlib `os` only): telemetry reads knobs at
import time, so this module imports nothing of the package back.

The catalog holds a counterpart of every JAX knob that has a meaning in
the port: the verifier's backend, host threshold and coalescing, the host
oracle's table gate and cache, the native host plane's off switch, the
p2p frame plane, ban plane and socket plane, the pipelined commit path
and compact gossip, the recovery plane, the device mesh, the
observability planes, the async front door, the kvstore's commit
backend, the shard and edge planes, chaos and the lock watch. Three JAX
knobs have none: TM_TPU_NO_PALLAS (the CUDA kernel is the only device
route), TM_TPU_FETCH_WORKERS (no fetch pool: the port waits on CUDA
events) and TM_TPU_MESH_FORCE_HOST_DEVICES (its counterpart is
TM_CUDA_MESH_FORCE_DEVICES).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

#: every spelling of "off" accepted anywhere in the tree
FALSY = frozenset(("off", "0", "false", "no", "none", "disabled"))
TRUTHY = frozenset(("on", "1", "true", "yes"))


@dataclass(frozen=True)
class Knob:
    name: str            # TM_CUDA_* env var
    kind: str            # bool | int | float | str | spec
    default: str         # rendered in docs (the effective default)
    config: str          # config field it shadows ("" = env-only)
    description: str     # one line for the rendered catalog
    where: str           # module that consumes it


# The catalog, in docs order.
CATALOG: tuple[Knob, ...] = (
    # -- verification plane ------------------------------------------------
    Knob("TM_CUDA_VERIFIER", "str", "auto", "base.verifier_backend",
         "Default-verifier backend: auto|cuda|python.",
         "models/verifier.py"),
    Knob("TM_CUDA_MESH", "str", "auto", "base.verifier_mesh",
         "Device mesh for sharded verify: auto|off|N (power of two); "
         "Merkle roots of >= 64 leaves shard only at an explicit N.",
         "models/verifier.py, ops/merkle.py"),
    Knob("TM_CUDA_MESH_FORCE_DEVICES", "int", "0 (off)", "",
         "Lay N logical devices round-robin over the cards present (or "
         "the CPU), each with its own stream: 2-, 4- and 8-wide meshes "
         "on one card.",
         "parallel/mesh.py"),
    Knob("TM_CUDA_AUTO_THRESHOLD", "int", "128", "",
         "Batches at or below this size verify scalar on host.",
         "models/verifier.py"),
    Knob("TM_CUDA_COALESCE", "str", "auto", "base.verifier_coalesce",
         "Cross-call dispatch coalescing: auto|on|off.",
         "models/verifier.py"),
    Knob("TM_CUDA_COALESCE_WAIT_MS", "float", "2.0",
         "base.verifier_coalesce_wait_ms",
         "Max linger per merged dispatch window, milliseconds.",
         "models/verifier.py"),
    Knob("TM_CUDA_COALESCE_MAX_BATCH", "int", "0 (= BATCH_CHUNK)",
         "base.verifier_coalesce_max_batch",
         "Items that force a merged dispatch out early.",
         "models/verifier.py"),
    Knob("TM_CUDA_HOST_TABLE_MIN", "int", "4", "",
         "Min host batch size routed to the precomputed-table oracle "
         "(read once, at import).",
         "types/keys.py"),
    Knob("TM_CUDA_HOST_TABLE_CACHE", "int", "256", "",
         "Per-pubkey double-table LRU capacity (host oracle; read once, "
         "at import).",
         "utils/ed25519_fast.py"),
    # -- native host plane -------------------------------------------------
    Knob("TM_CUDA_NO_NATIVE", "bool", "unset (native on)", "",
         "Any non-empty value takes the pure host routes (codec, kv "
         "core, verify prep, hostops SHA-256 and Merkle) where the port "
         "has one; a native function without one raises at first use, "
         "from its loader, naming it. Read once a process. Never "
         "disables a CUDA kernel; a failed native build still raises.",
         "native.py"),
    # -- p2p frame plane ---------------------------------------------------
    Knob("TM_CUDA_P2P_BURST", "spec", "auto", "base.p2p_burst",
         "Burst frame plane: off|on|auto|<max packets per burst>.",
         "p2p/conn/burst.py"),
    Knob("TM_CUDA_P2P_FLUSH_LINGER_MS", "float", "4.0", "",
         "Loop-mode send-burst rate limiter: an idle conn's send "
         "flushes immediately, but after a flush the next waits out "
         "this window so sustained gossip seals full bursts; 0 "
         "restores flush-per-wakeup.",
         "p2p/conn/loop.py"),
    # -- hostile-peer hardening --------------------------------------------
    Knob("TM_CUDA_P2P_BAN_SCORE", "int", "30", "p2p.ban_score",
         "Trust-score ban threshold: a peer scoring below this after a "
         "bad event is banned until the ban decays; 0 disables "
         "enforcement (scores still recorded).",
         "p2p/switch.py"),
    Knob("TM_CUDA_P2P_BAN_BASE_S", "float", "60.0", "p2p.ban_base_s",
         "First-offense ban duration, seconds; repeat offenses double "
         "it (capped at 64x) and strikes decay with clean time.",
         "p2p/switch.py"),
    Knob("TM_CUDA_P2P_FD_HEADROOM", "int", "64", "p2p.fd_headroom",
         "Accept-path admission shedding: inbound conns are refused "
         "while fewer than this many fds remain under the process "
         "RLIMIT_NOFILE.",
         "p2p/switch.py"),
    # -- socket plane, commit path -----------------------------------------
    Knob("TM_CUDA_REACTOR", "str", "auto (= loop)", "base.reactor",
         "Socket plane: loop runs every peer socket, gossip routine and "
         "RPC connection on ONE selector event loop per node; threads "
         "restores the per-connection thread plane.",
         "config.py"),
    Knob("TM_CUDA_PIPELINE", "str", "auto", "base.pipeline",
         "Pipelined per-height hot path (native part-set build, "
         "streaming proposal gossip, overlapped finalize, group-commit "
         "persistence): auto|on|off. off = serial path byte-for-byte.",
         "pipeline.py"),
    Knob("TM_CUDA_COMPACT", "str", "auto (on)", "base.compact",
         "Compact block relay: gossip header + salted short tx ids, "
         "receivers rebuild the block from their mempool and fetch "
         "only missing txs, falling back to full part gossip on miss "
         "or timeout. auto|on|off; off = legacy wire byte-for-byte.",
         "consensus/compact.py, consensus/reactor.py"),
    Knob("TM_CUDA_VOTE_AGG", "str", "auto (on)", "base.vote_agg",
         "Aggregated vote gossip: batch every vote a peer lacks for "
         "one (height, round, type) into a single message, verified "
         "as ONE coalesced dispatch via VoteSet.add_votes_batch. "
         "auto|on|off; off = one scalar vote message per pass.",
         "consensus/compact.py, consensus/reactor.py"),
    # -- recovery plane ----------------------------------------------------
    Knob("TM_CUDA_SNAPSHOT_INTERVAL", "int", "0 (off)",
         "base.snapshot_interval",
         "Publish a chunked state snapshot every N heights; 0 disables "
         "the whole snapshot/prune plane.",
         "node.py"),
    Knob("TM_CUDA_SNAPSHOT_KEEP", "int", "2", "base.snapshot_keep",
         "How many newest snapshots to retain on disk.",
         "node.py"),
    Knob("TM_CUDA_SNAPSHOT_CHUNK_KB", "int", "256",
         "base.snapshot_chunk_kb",
         "Snapshot chunk size in KiB (content-addressed transfer unit).",
         "node.py"),
    Knob("TM_CUDA_RETAIN_HEIGHTS", "int", "0 (keep all)",
         "base.retain_heights",
         "Prune block/state stores to the newest N heights — floored "
         "at the latest snapshot, the evidence horizon, and any peer's "
         "catch-up frontier.",
         "node.py"),
    Knob("TM_CUDA_STATE_SYNC", "bool", "off", "base.state_sync",
         "A fresh node joins via p2p snapshot restore (statesync/) and "
         "fast-syncs only the tail; off = full block replay.",
         "node.py"),
    # -- telemetry ---------------------------------------------------------
    Knob("TM_CUDA_TELEMETRY", "bool", "unset (config decides, on)",
         "base.telemetry",
         "off disables all metrics/tracing; any other value forces on.",
         "telemetry/registry.py"),
    Knob("TM_CUDA_TRACE", "str", "off", "base.trace",
         "Causal tracing plane: on stamps p2p envelopes with trace "
         "context and records per-height consensus spans and the hot "
         "path's spans (verify.prep/rows/upload/launch/wait, "
         "sync.collect/wait/save, block.decode, votes.check/count: one "
         "a call or chunk, on the wall clock a device trace shares); "
         "off keeps the wire format byte-for-byte untraced and costs "
         "one knob check a site.",
         "telemetry/causal.py"),
    Knob("TM_CUDA_TRACE_CAP", "int", "65536", "",
         "Causal span ring capacity; overflow drops oldest and counts "
         "trace_events_dropped_total.",
         "telemetry/causal.py"),
    Knob("TM_CUDA_TRACE_STALL_S", "float", "0 (off)", "",
         "Stall-detector window: with tracing on, no height progress "
         "for this many seconds dumps timeline + consensus state "
         "(flight recorder).",
         "node.py"),
    Knob("TM_CUDA_PROF", "str", "off", "base.prof",
         "Sampling profiler: on walks sys._current_frames() at "
         "TM_CUDA_PROF_HZ, attributing samples to subsystems/threads "
         "(prof_*, /debug/pprof, debug_profile RPC); off = no "
         "sampler thread, one flag check per entry point.",
         "telemetry/profile.py"),
    Knob("TM_CUDA_PROF_HZ", "float", "13", "base.prof_hz",
         "Profiler sampling rate, sweeps per second.",
         "telemetry/profile.py"),
    Knob("TM_CUDA_SLO", "str", "off", "base.slo",
         "Tx-lifecycle SLO plane: on stamps sampled transactions at "
         "each stage boundary (front-door admit -> CheckTx -> proposal "
         "-> commit -> event publish -> WS delivery) into per-stage "
         "quantile sketches (/slo route, slo_*); off = one cached "
         "flag check per entry point, nothing hashed, wire untouched.",
         "telemetry/slo.py"),
    Knob("TM_CUDA_SLO_SAMPLE", "float", "1.0", "base.slo_sample",
         "SLO sampling probability: a tx is tracked iff the first 8 "
         "bytes of its sha256 fall under rate*2^64 — deterministic, so "
         "every node samples the SAME txs and cross-node reports join.",
         "telemetry/slo.py"),
    Knob("TM_CUDA_QUEUE_WATCH", "spec", "on (0.25s poll)",
         "base.queue_watch",
         "Queue observatory: off | on | <poll seconds>. Registers "
         "every bounded queue into one catalog (queue_* gauges, "
         "/healthz verdict) with a once-per-episode saturation "
         "watchdog; off skips registration entirely.",
         "telemetry/queues.py"),
    Knob("TM_CUDA_NODE_PROFILE", "str", "unset (off)", "",
         "Path: `cli node` samples every thread's frame with SIGPROF at "
         "~97 Hz of CPU time and writes the top frames there on exit.",
         "cli.py"),
    # -- async reactor core ----------------------------------------------
    Knob("TM_CUDA_RPC_MAX_CONNS", "int", "0 (= 4096 loop mode)", "",
         "Admission cap on concurrent RPC/WebSocket connections in "
         "loop mode; over-cap connects get an immediate 503.",
         "rpc/aserver.py"),
    Knob("TM_CUDA_RPC_RATE", "float", "0 (off)", "",
         "Per-client-IP JSON-RPC request rate limit (requests/sec, "
         "2x burst) in loop mode; over-limit calls get a structured "
         "rate-limit error and count tm_rpc_rate_limited_total.",
         "rpc/aserver.py"),
    # -- app -------------------------------------------------------------
    Knob("TM_CUDA_STATE_TREE", "bool", "off", "",
         "KVStore commit backend: on = authenticated state tree "
         "(statetree/, docs/state.md) — app_hash is a critbit Merkle "
         "root, per-key inclusion/absence proofs bind values to "
         "certified headers; off = bucketed accumulator (no proofs). "
         "Chain-level: every validator must agree, the two backends "
         "hash differently by design.",
         "abci/apps/kvstore.py"),
    # -- shard plane -----------------------------------------------------
    Knob("TM_CUDA_SHARDS", "int", "0 (off)", "base.shards",
         "Default chain count a ShardSet assembles (ShardSet("
         "n_shards=None), and `cli shardset` without --shards): N "
         "independent chains in one process behind one front door, "
         "sharing one verifier and one ReactorLoop; 0 = single-chain "
         "shape (`cli shardset`: 2).",
         "shard/__init__.py"),
    # -- edge serving plane ----------------------------------------------
    Knob("TM_CUDA_EDGE_MAX_LAG", "int", "50", "",
         "Staleness threshold (heights) for an edge read replica: when "
         "certified-height lag exceeds it — or continuous certification "
         "has failed — the replica's /healthz flips not-ok so load "
         "balancers drain it. Every response still carries the honest "
         "lag either way.",
         "serving/edge.py"),
    # -- chaos -------------------------------------------------------------
    Knob("TM_CUDA_CHAOS", "spec", "off", "base.chaos",
         "Link fault spec, e.g. drop=0.05,delay=0.1,delay_ms=30,seed=7.",
         "chaos/__init__.py"),
    # -- analysis / sanitizers ---------------------------------------------
    Knob("TM_CUDA_LOCKCHECK", "bool", "off", "",
         "on wraps threading locks with the lock-order watchdog "
         "(analysis/lockwatch.py); chaos runs report cycles.",
         "analysis/lockwatch.py"),
    Knob("TM_CUDA_DIVERGENCE", "bool", "off", "",
         "on records a canonical per-height transition digest (block "
         "bytes, ABCI responses, validator updates, app_hash) for "
         "cross-node and dual-hash-seed divergence detection "
         "(analysis/divergence.py).",
         "analysis/divergence.py"),
)

#: the JAX package's knobs that have no TM_CUDA_* counterpart, and why
NO_COUNTERPART = (
    ("TM_TPU_NO_PALLAS", "the CUDA kernel is the only device route; its "
     "plain PyTorch version serves CPU tensors only"),
    ("TM_TPU_FETCH_WORKERS", "there is no fetch pool: a verify waits on "
     "one CUDA event after the verdicts' copy"),
    ("TM_TPU_MESH_FORCE_HOST_DEVICES", "its counterpart is "
     "TM_CUDA_MESH_FORCE_DEVICES (logical devices over the cards or the "
     "CPU)"),
)

NAMES = frozenset(k.name for k in CATALOG)
_BY_NAME = {k.name: k for k in CATALOG}


def get(name: str) -> Knob:
    return _BY_NAME[name]


def _check(name: str) -> None:
    # loud at the call site: an uncataloged knob raises, and
    # failing here too means a renamed knob can't silently read defaults
    if name not in NAMES:
        raise KeyError(f"{name} is not in the TM_CUDA knob catalog "
                       f"(tendermint_tpu_torch/utils/knobs.py)")


def knob_raw(name: str) -> Optional[str]:
    """The raw env value, stripped; None when unset or blank."""
    _check(name)
    v = os.environ.get(name)  # the one sanctioned raw env read —
    #                           `name` is catalog-checked just above
    if v is None:
        return None
    v = v.strip()
    return v if v else None


def knob_str(name: str, config: Optional[str] = None,
             default: str = "") -> str:
    """env > config > default, lower-cased and stripped (mode knobs)."""
    v = knob_raw(name)
    if v is not None:
        return v.lower()
    if config is not None and str(config).strip():
        return str(config).strip().lower()
    return default


def knob_spec(name: str, config: Optional[str] = None,
              default: str = "") -> str:
    """Like knob_str but case-preserving (spec strings carry values)."""
    v = knob_raw(name)
    if v is not None:
        return v
    if config is not None and str(config).strip():
        return str(config).strip()
    return default


def knob_bool(name: str, config: Optional[bool] = None,
              default: bool = False) -> bool:
    """env > config > default with the unified truthy vocabulary:
    FALSY values disable, anything else set enables."""
    v = knob_raw(name)
    if v is not None:
        return v.lower() not in FALSY
    if config is not None:
        return bool(config)
    return default


def knob_set(name: str) -> bool:
    """True when the env var is set non-blank, regardless of value (the
    set-means-on contract: exporting anything, even \"0\", disables)."""
    return knob_raw(name) is not None


def knob_flag3(name: str) -> Optional[bool]:
    """Tri-state env flag: None when unset (config decides), False for
    FALSY values, True otherwise (telemetry's contract)."""
    v = knob_raw(name)
    if v is None:
        return None
    return v.lower() not in FALSY


def knob_int(name: str, config: Optional[int] = None,
             default: int = 0) -> int:
    v = knob_raw(name)
    if v is not None:
        return int(v)
    if config is not None:
        return int(config)
    return default


def knob_float(name: str, config: Optional[float] = None,
               default: float = 0.0) -> float:
    v = knob_raw(name)
    if v is not None:
        return float(v)
    if config is not None:
        return float(config)
    return default


def parse_bool(value: str, default: bool = False) -> bool:
    """Unified truthy parse for config-file strings (no env read)."""
    s = str(value).strip().lower()
    if not s:
        return default
    return s not in FALSY


def knobs_md() -> str:
    """The catalog as a Markdown table."""
    lines = [
        "# TM_CUDA_* environment knobs",
        "",
        "Rendered by `knobs_md()` from the catalog in",
        "`tendermint_tpu_torch/utils/knobs.py`.",
        "",
        "Every knob follows the same precedence: **environment wins",
        "over config wins over default**. An operator exporting a knob",
        "overrides whatever the config file says. \"Off\" accepts any",
        "of: " + ", ".join(f"`{v}`" for v in sorted(FALSY)) + ".",
        "",
        "| Knob | Type | Default | Config field | Consumer | What it does |",
        "|---|---|---|---|---|---|",
    ]
    for k in CATALOG:
        cfg = f"`{k.config}`" if k.config else "—"
        lines.append(f"| `{k.name}` | {k.kind} | {k.default} | {cfg} "
                     f"| `{k.where}` | {k.description} |")
    lines += ["", "## JAX knobs without a counterpart", ""]
    for name, why in NO_COUNTERPART:
        lines.append(f"- `{name}`: {why}.")
    lines.append("")
    return "\n".join(lines)
