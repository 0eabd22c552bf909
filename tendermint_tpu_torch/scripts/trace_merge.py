"""trace_merge — N per-node span buffers -> one cluster timeline.

Fetches every node's causal span ring (the `dump_height_timeline` RPC
route, or dump files on disk), aligns their wall clocks from the paired
(send, recv) readings trace-stamped p2p envelopes carry, and writes:

- a single Perfetto/Chrome trace (load at https://ui.perfetto.dev):
  one track per node, every consensus span on the reference clock;
- a per-height latency-attribution table: time-to-first-part,
  full-block, +2/3 prevote, +2/3 precommit, apply, persist — p50/p95
  per stage, plus each height's coverage of observed wall-clock.

Usage:
    python -m tendermint_tpu_torch.scripts.trace_merge --out merged.json \\
        http://127.0.0.1:46657 http://127.0.0.1:46659 ...
    python -m tendermint_tpu_torch.scripts.trace_merge \\
        --files dump0.json dump1.json ...
        [--out merged.json] [--report report.json] [--min-height H]

Nodes must run with TM_CUDA_TRACE=on; an `enabled: false` dump is
reported and skipped. The merge lives in telemetry/merge.py.
"""

from __future__ import annotations

import argparse
import json
import sys

from tendermint_tpu_torch.telemetry import merge


def fetch(url: str, min_height: int = 0, max_height: int = 0) -> dict:
    """One node's span ring over its JSON-RPC endpoint."""
    from tendermint_tpu_torch.rpc.client import JSONRPCClient
    return JSONRPCClient(url).call("dump_height_timeline",
                                   min_height=min_height,
                                   max_height=max_height)


def select(dumps: list) -> tuple:
    """(the dumps merged, a note for each skipped): a node with tracing
    off and no spans is skipped."""
    live, notes = [], []
    for d in dumps:
        if not d.get("enabled", True) and not d.get("spans"):
            notes.append(f"[trace_merge] node {d.get('node', '?')}: "
                         f"tracing disabled (TM_CUDA_TRACE off), skipped")
            continue
        live.append(d)
    return live, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="node RPC base URLs (http://host:port)")
    ap.add_argument("--files", nargs="*", default=[],
                    help="read dump files instead of fetching over RPC")
    ap.add_argument("--out", default="merged_trace.json",
                    help="Perfetto trace output path")
    ap.add_argument("--report", default="",
                    help="also write the full merge report (offsets, "
                         "RTT floors, attribution) as JSON")
    ap.add_argument("--min-height", type=int, default=0)
    ap.add_argument("--max-height", type=int, default=0)
    args = ap.parse_args(argv)

    dumps = []
    for path in args.files:
        with open(path) as f:
            dumps.append(json.load(f))
    for url in args.sources:
        dumps.append(fetch(url, args.min_height, args.max_height))
    if not dumps:
        ap.error("no sources: pass node URLs or --files")

    live, notes = select(dumps)
    for note in notes:
        print(note, file=sys.stderr)
    if not live:
        print("[trace_merge] no traced nodes", file=sys.stderr)
        return 1

    report = merge.merge_report(live)
    with open(args.out, "w") as f:
        json.dump(report["perfetto"], f)
    print(f"[trace_merge] {len(live)} nodes, "
          f"{len(report['perfetto']['traceEvents'])} events -> "
          f"{args.out} (load at https://ui.perfetto.dev)")

    attr = report["attribution"]
    print(f"[trace_merge] clock offsets (ms): "
          f"{report['clock_offsets_ms']}")
    print(f"[trace_merge] {attr['heights']} heights attributed "
          f"(skipped {attr['heights_skipped']}), mean coverage "
          f"{attr['coverage_mean']:.1%}")
    stages = attr.get("stages_ms_p50_p95", {})
    if stages:
        width = max(len(s) for s in stages)
        print(f"  {'stage'.ljust(width)}   p50 ms   p95 ms")
        for stage, row in stages.items():
            print(f"  {stage.ljust(width)} {row['p50_ms']:8.2f} "
                  f"{row['p95_ms']:8.2f}")

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[trace_merge] full report -> {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
