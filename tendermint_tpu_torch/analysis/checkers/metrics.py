"""metrics — the metric-catalog lint: the port's copy of
`tendermint_tpu/analysis/checkers/metrics.py`.

Not an AST checker: it imports every instrumented module of the port so
each registers its families into the process-wide registry, then
validates the catalog and the exposition (under the port's namespace,
`tmcuda`). analysis/lint.py includes it unless --no-metrics.

Rules:
- no duplicate FULL names after namespacing (a histogram `x` and a
  counter `x_bucket` would collide in exposition)
- every metric leads with a known subsystem prefix so dashboards group
- counters end in `_total`; `_seconds`/`_bytes` metrics are histograms
  or gauges
- the exposition parses line by line
- every literal causal span name is in telemetry.causal.SPAN_CATALOG
"""

from __future__ import annotations

import os
import re
from typing import List

from tendermint_tpu_torch.analysis.engine import Finding

CHECKER_ID = "metrics"

# Every subsystem that registers metrics must appear here — a new
# instrumented module extends this set.
KNOWN_SUBSYSTEMS = {
    "verifier", "consensus", "mempool", "fastsync", "p2p", "merkle",
    "rpc", "node", "storage", "evidence", "lite", "telemetry", "event",
    "chaos", "mesh", "pipeline", "partset", "trace",
    "snapshot", "sync", "prune", "prof", "queue", "loop", "wire",
    "slo", "shard", "statetree", "compact", "voteagg",
    "edge", "load", "deploy", "divergence",
}

INSTRUMENTED_MODULES = [
    "tendermint_tpu_torch.models.verifier",
    "tendermint_tpu_torch.models.coalescer",
    "tendermint_tpu_torch.ops.merkle",
    "tendermint_tpu_torch.parallel.mesh",     # mesh_* sharded dispatches
    "tendermint_tpu_torch.consensus.state",
    "tendermint_tpu_torch.consensus.reactor",
    "tendermint_tpu_torch.mempool.mempool",
    "tendermint_tpu_torch.blockchain.pool",
    "tendermint_tpu_torch.p2p.switch",
    "tendermint_tpu_torch.p2p.conn.secret",   # p2p_seal/open_seconds
    "tendermint_tpu_torch.p2p.conn.mconn",    # p2p_frames_per_burst
    "tendermint_tpu_torch.types.events",      # event_dropped_total
    "tendermint_tpu_torch.rpc.core",
    "tendermint_tpu_torch.chaos",             # chaos_* fault plane
    "tendermint_tpu_torch.pipeline",          # pipeline_* stages
    "tendermint_tpu_torch.types.part_set",    # partset_build_seconds
    "tendermint_tpu_torch.telemetry.trace",   # trace_events_dropped_total
    "tendermint_tpu_torch.telemetry.causal",
    "tendermint_tpu_torch.telemetry.merge",
    "tendermint_tpu_torch.storage.snapshot",  # snapshot_* / prune_*
    "tendermint_tpu_torch.statesync.reactor",  # sync_* restore plane
    "tendermint_tpu_torch.telemetry.profile",  # prof_* sampling profiler
    "tendermint_tpu_torch.telemetry.queues",  # queue_* backpressure
    "tendermint_tpu_torch.p2p.conn.loop",     # loop_* reactor-loop core
    "tendermint_tpu_torch.rpc.aserver",       # rpc_* async front door
    "tendermint_tpu_torch.analysis.divergence",  # divergence_* digests
    "tendermint_tpu_torch.chaos.wire",        # wire_* TCP fault proxy
    "tendermint_tpu_torch.telemetry.slo",     # slo_* tx-lifecycle plane
    "tendermint_tpu_torch.state.execution",
    "tendermint_tpu_torch.node",
    "tendermint_tpu_torch.shard.router",      # shard_* router plane
    "tendermint_tpu_torch.statetree.store",   # statetree_* commit plane
    "tendermint_tpu_torch.statetree.codec",
    "tendermint_tpu_torch.consensus.compact",  # compact_*/voteagg_*
    "tendermint_tpu_torch.serving.edge",      # edge_* certified reads
    "tendermint_tpu_torch.serving.loadgen",   # load_* open-loop harness
    "tendermint_tpu_torch.serving.deploy",    # deploy_* process driver
]

# Causal span names follow the same closed-catalog discipline as metric
# families: every literal name at a span/point call site must be
# declared in telemetry.causal.SPAN_CATALOG, or dashboards and the
# trace merger silently miss it. The regex covers the three call
# shapes in the tree: causal.span/point/record(...) and the consensus
# state machine's _cspan/_cpoint helpers.
_SPAN_NAME_RE = re.compile(
    r'(?:causal\.(?:span|point|record)|_cspan|_cpoint)\(\s*'
    r'[\'"]([a-z0-9_.]+)[\'"]')

_LINE_RE = re.compile(
    r'^[a-z_][a-z0-9_]*(\{[a-z0-9_]+="(?:[^"\\]|\\.)*"'
    r'(,[a-z0-9_]+="(?:[^"\\]|\\.)*")*\})? -?[0-9.e+Inf-]+$')

_CATALOG = "tendermint_tpu_torch/analysis/checkers/metrics.py"


def run() -> List[Finding]:
    """Import the instrumented modules and lint the registry. Findings
    carry the catalog path (the registry has no single source line)."""
    import importlib
    for mod in INSTRUMENTED_MODULES:
        importlib.import_module(mod)
    from tendermint_tpu_torch import telemetry

    findings: List[Finding] = []

    def problem(msg: str) -> None:
        findings.append(Finding(CHECKER_ID, _CATALOG, 0, msg))

    names = telemetry.REGISTRY.names()
    if not names:
        problem("registry is empty — instrumented modules registered "
                "nothing")

    exposed = set()
    for name in names:
        fam = telemetry.REGISTRY.get(name)
        subsystem = name.split("_", 1)[0]
        if subsystem not in KNOWN_SUBSYSTEMS or "_" not in name:
            problem(f"{name}: not namespaced by a known subsystem "
                    f"(known: {sorted(KNOWN_SUBSYSTEMS)})")
        if fam.kind == "counter" and not name.endswith("_total"):
            problem(f"{name}: counters must end in _total")
        if fam.kind == "counter" and (
                name.endswith("_seconds") or name.endswith("_bytes")):
            problem(f"{name}: unit-suffixed metrics must be "
                    f"histograms or gauges")
        series = {name}
        if fam.kind == "histogram":
            series = {name + s for s in ("_bucket", "_sum", "_count")}
        elif fam.kind == "summary":
            series = {name, name + "_sum", name + "_count"}
        clash = series & exposed
        if clash:
            problem(f"{name}: exposition series collide: {clash}")
        exposed |= series

    from tendermint_tpu_torch.telemetry import registry
    for line in telemetry.expose(
            namespace=registry.DEFAULT_NAMESPACE).splitlines():
        if not line or line.startswith("#"):
            continue
        if not _LINE_RE.match(line):
            problem(f"unparseable exposition line: {line!r}")

    findings.extend(span_findings())

    run.summary = (f"{len(names)} families, {len(exposed)} "
                   f"exposed series names")
    return findings


def span_findings(root: str = "") -> List[Finding]:
    """Lint causal span-name call sites against SPAN_CATALOG. `root`
    defaults to the installed tendermint_tpu_torch package tree (tests
    point it at fixture dirs)."""
    from tendermint_tpu_torch.telemetry.causal import SPAN_CATALOG
    if not root:
        import tendermint_tpu_torch
        pkg = os.path.dirname(os.path.abspath(tendermint_tpu_torch.__file__))
        try:
            root = os.path.relpath(pkg)
        except ValueError:  # different drive (windows): keep absolute
            root = pkg
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                continue
            for i, line in enumerate(lines, 1):
                for m in _SPAN_NAME_RE.finditer(line):
                    if m.group(1) not in SPAN_CATALOG:
                        findings.append(Finding(
                            CHECKER_ID, path, i,
                            f"span name {m.group(1)!r} not declared in "
                            f"telemetry.causal.SPAN_CATALOG"))
    return findings


run.summary = ""
