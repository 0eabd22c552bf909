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

The catalog holds the device mesh's spec and its forced device count
(TM_CUDA_MESH, TM_CUDA_MESH_FORCE_DEVICES), the knobs of the
observability planes, the async front door's admission envelope
(TM_CUDA_RPC_MAX_CONNS, TM_CUDA_RPC_RATE), the kvstore's commit backend (TM_CUDA_STATE_TREE), the shard plane's
default count (TM_CUDA_SHARDS), the edge replicas' staleness threshold
(TM_CUDA_EDGE_MAX_LAG), the chaos plane's link faults (TM_CUDA_CHAOS)
and the lock-order watchdog (TM_CUDA_LOCKCHECK). The other planes
(reactor, pipeline, coalescer, compact relay, p2p, recovery) take their
settings from config fields only.
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
    Knob("TM_CUDA_MESH", "str", "auto", "base.verifier_mesh",
         "Device mesh for sharded verify: auto|off|N (power of two); "
         "Merkle roots of >= 64 leaves shard only at an explicit N.",
         "models/verifier.py, ops/merkle.py"),
    Knob("TM_CUDA_MESH_FORCE_DEVICES", "int", "0 (off)", "",
         "Lay N logical devices round-robin over the cards present (or "
         "the CPU), each with its own stream: 2-, 4- and 8-wide meshes "
         "on one card.",
         "parallel/mesh.py"),
    # -- telemetry ---------------------------------------------------------
    Knob("TM_CUDA_TELEMETRY", "bool", "unset (config decides, on)",
         "base.telemetry",
         "off disables all metrics/tracing; any other value forces on.",
         "telemetry/registry.py"),
    Knob("TM_CUDA_TRACE", "str", "off", "base.trace",
         "Causal tracing plane: on stamps p2p envelopes with trace "
         "context and records per-height consensus spans; off keeps "
         "the wire format byte-for-byte untraced.",
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
    lines.append("")
    return "\n".join(lines)
