"""tmlint runner for the port: the whole static-analysis suite over
`tendermint_tpu_torch/` and `chip_smoke.py` in one command (the
counterpart of the JAX package's `scripts/lint.py`).

    python -m tendermint_tpu_torch.analysis.lint               # AST
        # checkers + KNOBS.md drift + metrics registry lint
    python -m tendermint_tpu_torch.analysis.lint --no-metrics  # pure AST
    python -m tendermint_tpu_torch.analysis.lint --taint       # add the
        # inter-procedural determinism taint pass
    python -m tendermint_tpu_torch.analysis.lint --json PATH   # also
        # write a JSON report (runs the taint pass too)
    python -m tendermint_tpu_torch.analysis.lint --graph-stats # call-
        # graph resolution stats (flowgraph) as JSON, then exit
    python -m tendermint_tpu_torch.analysis.lint --knobs-md    # write
        # tendermint_tpu_torch/KNOBS.md from the knob catalog, then exit

Exit 0 with a summary when the tree is clean; 1 with one line per
finding otherwise. A finding is fixed, or suppressed with a justified
`tmlint: allow(<checker>): <why>` pragma; every pragma must carry a
justification and suppress something, and the tree's count of them is
held to a budget.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
KNOBS_MD = os.path.join(PKG, "KNOBS.md")
#: allow pragmas the tree may carry
MAX_PRAGMAS = 20


def check_knobs_md():
    """KNOBS.md must match the catalog byte for byte."""
    from tendermint_tpu_torch.analysis.engine import Finding
    from tendermint_tpu_torch.utils import knobs
    try:
        with open(KNOBS_MD, encoding="utf-8") as f:
            have = f.read()
    except FileNotFoundError:
        have = None
    if have != knobs.knobs_md():
        state = "missing" if have is None else "stale"
        return [Finding(
            "knob-registry", os.path.relpath(KNOBS_MD, REPO), 0,
            f"KNOBS.md is {state} — regenerate it with `python -m "
            f"tendermint_tpu_torch.analysis.lint --knobs-md`")]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tendermint_tpu_torch.analysis.lint",
        description="tmlint over the port's package and chip_smoke.py")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write a JSON report to PATH (runs the taint "
                         "pass too)")
    ap.add_argument("--knobs-md", action="store_true",
                    help="write KNOBS.md from the catalog and exit")
    ap.add_argument("--no-metrics", action="store_true",
                    help="skip the metrics registry lint (no heavy "
                         "imports; pure-AST run)")
    ap.add_argument("--taint", action="store_true",
                    help="run the inter-procedural consensus-"
                         "determinism taint pass (implied by --json)")
    ap.add_argument("--graph-stats", action="store_true",
                    help="print project call-graph resolution stats "
                         "as JSON and exit")
    ap.add_argument("--max-pragmas", type=int, default=MAX_PRAGMAS,
                    help=f"fail when the tree carries more allow "
                         f"pragmas than this (default {MAX_PRAGMAS})")
    ap.add_argument("paths", nargs="*",
                    help="scan set override (default: the port's "
                         "package and chip_smoke.py)")
    args = ap.parse_args(argv)
    t0 = time.monotonic()

    from tendermint_tpu_torch.utils import knobs
    if args.graph_stats:
        from tendermint_tpu_torch.analysis.flowgraph import FlowGraph
        print(json.dumps(FlowGraph.build(REPO).stats(), indent=1,
                         sort_keys=True))
        return 0
    if args.knobs_md:
        with open(KNOBS_MD, "w", encoding="utf-8") as f:
            f.write(knobs.knobs_md())
        print(f"lint: wrote {os.path.relpath(KNOBS_MD, REPO)} "
              f"({len(knobs.CATALOG)} knobs)")
        return 0

    from tendermint_tpu_torch.analysis import run_tree
    from tendermint_tpu_torch.analysis.checkers import all_checkers
    from tendermint_tpu_torch.analysis.engine import Finding
    findings, pragmas, n_files = run_tree(REPO, paths=args.paths or None)
    findings += check_knobs_md()

    checkers_run = [c.id for c in all_checkers()] + ["pragma"]
    metrics_summary = "skipped"
    if not args.no_metrics:
        from tendermint_tpu_torch.analysis.checkers import metrics
        findings += metrics.run()
        metrics_summary = metrics.run.summary or "failed"
        checkers_run.append("metrics")

    taint_stats = None
    if args.taint or args.json:
        from tendermint_tpu_torch.analysis.checkers.taint import run_taint
        taint_report = run_taint(REPO)
        findings += taint_report.findings
        taint_stats = taint_report.stats
        checkers_run.append("taint")

    if len(pragmas) > args.max_pragmas:
        findings.append(Finding(
            "pragma", "(tree)", 0,
            f"{len(pragmas)} allow pragmas exceed the budget of "
            f"{args.max_pragmas} — fix code instead of suppressing"))

    if args.json:
        report = {
            "tool": "tmlint (python -m tendermint_tpu_torch.analysis.lint)",
            "files_scanned": n_files,
            "checkers": checkers_run,
            "metrics": metrics_summary,
            "taint": taint_stats,
            "lint_seconds": round(time.monotonic() - t0, 3),
            "clean": not findings,
            "findings": [f.to_obj() for f in findings],
            "pragmas": [p.to_obj() for p in pragmas],
        }
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"lint: wrote {args.json}")

    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        print(f"lint: {f}")
    if findings:
        print(f"lint: FAILED — {len(findings)} finding(s) across "
              f"{n_files} files")
        return 1
    taint_summary = "skipped" if taint_stats is None else (
        f"{taint_stats['reachable_functions']} reachable fns, "
        f"{taint_stats['seam_cuts']} seam cuts")
    print(f"lint: OK — {n_files} files, {len(pragmas)} pragma(s), "
          f"metrics: {metrics_summary}, taint: {taint_summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
