"""Metric-catalog lint of the port: a thin entry over the tmlint metrics
checker (analysis/checkers/metrics.py), which analysis/lint.py also
runs. Exit 0 + "OK" when clean; 1 with one line per violation.

    python -m tendermint_tpu_torch.scripts.check_metrics
"""

import sys

from tendermint_tpu_torch.analysis.checkers import metrics


def main() -> int:
    findings = metrics.run()
    if findings:
        for f in findings:
            print(f"check_metrics: {f.message}")
        return 1
    print(f"check_metrics: OK ({metrics.run.summary})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
