"""Operator tools of the port, each run as
``python -m tendermint_tpu_torch.scripts.<name>``: the counterparts of
the JAX package's `scripts/trace_merge.py`, `slo_report.py`,
`profile_merge.py` and `check_metrics.py`, with their arguments, output
files, report text and exit codes, on the port's merge functions and its
JSONRPCClient."""
