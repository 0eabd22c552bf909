"""slo_report — N per-node /slo payloads -> one cluster latency table.

Fetches every node's tx-lifecycle SLO snapshot (the `slo` RPC route
with sketches=true, or snapshot files on disk), concatenates the
weighted quantile-sketch samples — sampling is deterministic and
hash-based, so every node tracked the SAME txs and the merge is a
straight weighted union — and prints one per-stage p50/p95/p99/p999
table for the cluster, plus per-node completion/drop accounting.

Usage:
    python -m tendermint_tpu_torch.scripts.slo_report \\
        http://127.0.0.1:46657 http://127.0.0.1:46659 ...
    python -m tendermint_tpu_torch.scripts.slo_report \\
        --files slo0.json slo1.json ... [--report report.json]

Nodes must run with TM_CUDA_SLO=on; a node with the plane off is
reported and skipped. The merge lives in telemetry/slo.py."""

from __future__ import annotations

import argparse
import json
import sys

from tendermint_tpu_torch.telemetry import slo


def fetch(url: str) -> dict:
    """One node's SLO snapshot (with mergeable sketches) over its
    JSON-RPC endpoint."""
    from tendermint_tpu_torch.rpc.client import JSONRPCClient
    return JSONRPCClient(url).call("slo", sketches=True)


def select(docs: list) -> tuple:
    """(the snapshots merged, a note for each skipped): a node with the
    plane off, or without sketches, is skipped."""
    live, notes = [], []
    for d in docs:
        if not d.get("enabled"):
            notes.append(f"[slo_report] node {d.get('node', '?')}: SLO "
                         f"plane off (TM_CUDA_SLO?), skipped")
            continue
        if not d.get("sketches"):
            notes.append(f"[slo_report] node {d.get('node', '?')}: no "
                         f"sketches in payload (call with sketches=true), "
                         f"skipped")
            continue
        live.append(d)
    return live, notes


def render(live: list, merged: dict) -> str:
    """The report's table: the cluster's counts, one row a stage, and
    each node's tail attribution, as printed."""
    out = [f"[slo_report] {len(live)} nodes, "
           f"{merged['sampled_total']} sampled, "
           f"{merged['completed_total']} delivered, "
           f"{merged['dropped']} dropped, "
           f"{merged['in_flight']} in flight"]
    stages = merged["stages"]
    if stages:
        width = max(len(s) for s in stages)
        out.append(f"  {'stage'.ljust(width)}  {'count':>7}  {'p50':>9}  "
                   f"{'p95':>9}  {'p99':>9}  {'p999':>9}  (ms)")
        for name in slo.SERIES:
            row = stages.get(name)
            if row is None:
                continue
            out.append(f"  {name.ljust(width)}  {row['count']:>7}  "
                       f"{row['p50_ms']:>9}  {row['p95_ms']:>9}  "
                       f"{row['p99_ms']:>9}  {row['p999_ms']:>9}")
    for d in live:
        att = d.get("attribution", {})
        if att.get("ready"):
            out.append(f"  node {d.get('node', '?')}: p99 tail dominated "
                       f"by '{att['dominant_stage']}' "
                       f"(mean legs ms: {att['mean_leg_ms']})")
    return "".join(line + "\n" for line in out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="node RPC base URLs (http://host:port)")
    ap.add_argument("--files", nargs="*", default=[],
                    help="read snapshot files instead of fetching "
                         "over RPC")
    ap.add_argument("--report", default="",
                    help="also write the merged table + per-node "
                         "accounting as JSON")
    args = ap.parse_args(argv)

    docs = []
    for path in args.files:
        with open(path) as f:
            docs.append(json.load(f))
    for url in args.sources:
        docs.append(fetch(url))
    if not docs:
        ap.error("no sources: pass node URLs or --files")

    live, notes = select(docs)
    for note in notes:
        print(note, file=sys.stderr)
    if not live:
        print("[slo_report] no SLO-enabled nodes", file=sys.stderr)
        return 1

    merged = slo.merge_snapshots(live)
    sys.stdout.write(render(live, merged))

    if args.report:
        report = {
            "merged": merged,
            "per_node": [
                {"node": d.get("node", "?"),
                 "sampled_total": d.get("sampled_total", 0),
                 "completed_total": d.get("completed_total", 0),
                 "dropped": d.get("dropped", {}),
                 "verdict": d.get("verdict", {}),
                 "attribution": d.get("attribution", {})}
                for d in live],
        }
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[slo_report] full report -> {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
