"""profile_merge — N per-node profiler dumps -> one cluster flamegraph.

Fetches every node's sampling-profiler table (the `debug_profile`
RPC route with action=dump, or dump files on disk), merges the
collapsed stacks — each node's tree re-rooted under a ``node:<id>``
frame so one flamegraph shows the whole cluster side by side — and
writes the merged collapsed-stack text (flamegraph.pl / speedscope
"collapsed" format). A per-subsystem busy/lock-wait summary table
prints to stdout.

Usage:
    python -m tendermint_tpu_torch.scripts.profile_merge \\
        --out merged.collapsed http://127.0.0.1:46657 ...
    python -m tendermint_tpu_torch.scripts.profile_merge \\
        --files dump0.json dump1.json ...
        [--out merged.collapsed] [--report report.json]

Nodes must run with TM_CUDA_PROF=on (or have had the profiler started
via `debug_profile action=start`); a dump with zero samples is
reported and skipped. The merge lives in telemetry/profile.py.
"""

from __future__ import annotations

import argparse
import json
import sys

from tendermint_tpu_torch.telemetry import profile


def fetch(url: str) -> dict:
    """One node's profiler table over its JSON-RPC endpoint."""
    from tendermint_tpu_torch.rpc.client import JSONRPCClient
    return JSONRPCClient(url).call("debug_profile", action="dump")


def select(dumps: list) -> tuple:
    """(the dumps merged, a note for each skipped): a node without busy
    or lock-wait samples is skipped."""
    live, notes = [], []
    for d in dumps:
        prof = d.get("profile", d)
        if not prof.get("samples") and not prof.get("wait_samples"):
            notes.append(f"[profile_merge] node {d.get('node', '?')}: no "
                         f"samples (TM_CUDA_PROF off?), skipped")
            continue
        live.append(d)
    return live, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="node RPC base URLs (http://host:port)")
    ap.add_argument("--files", nargs="*", default=[],
                    help="read dump files instead of fetching over RPC")
    ap.add_argument("--out", default="merged.collapsed",
                    help="merged collapsed-stack output path")
    ap.add_argument("--report", default="",
                    help="also write the merge summary (per-node and "
                         "cluster subsystem shares) as JSON")
    args = ap.parse_args(argv)

    dumps = []
    for path in args.files:
        with open(path) as f:
            dumps.append(json.load(f))
    for url in args.sources:
        dumps.append(fetch(url))
    if not dumps:
        ap.error("no sources: pass node URLs or --files")

    live, notes = select(dumps)
    for note in notes:
        print(note, file=sys.stderr)
    if not live:
        print("[profile_merge] no profiled nodes", file=sys.stderr)
        return 1

    merged = profile.merge_dumps(live)
    with open(args.out, "w") as f:
        f.write(merged["collapsed"] + "\n")
    n_stacks = len(merged["collapsed"].splitlines())
    print(f"[profile_merge] {len(live)} nodes, {merged['samples']} "
          f"busy + {merged['wait_samples']} lock-wait samples, "
          f"{n_stacks} stacks -> {args.out}")
    print("[profile_merge] render: flamegraph.pl < "
          f"{args.out} > flame.svg  (or paste into speedscope.app)")

    shares = merged["shares"]
    if shares:
        width = max(len(s) for s in shares)
        print(f"  {'subsystem'.ljust(width)}  busy%   lock-wait")
        for sub, share in shares.items():
            waits = merged["lock_wait"].get(sub, 0)
            print(f"  {sub.ljust(width)} {share * 100:6.2f}   {waits}")

    if args.report:
        report = {
            "nodes": merged["nodes"],
            "samples_busy": merged["samples"],
            "samples_lock_wait": merged["wait_samples"],
            "shares": shares,
            "lock_wait_by_subsystem": merged["lock_wait"],
            "per_node": [
                {"node": d.get("node", "?"),
                 "samples": d.get("profile", d).get("samples", 0),
                 "shares": d.get("profile", d).get("shares", {})}
                for d in live],
        }
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[profile_merge] full report -> {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
