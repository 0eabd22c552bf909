"""One run of one benchmark cell of `tendermint_tpu_torch` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its inputs from the seed, builds
the program's objects and warms up the shapes the cell uses (all of it
`setup_s`), drives the cell's traffic for `--seconds`, frees the program's
state, holds what the window produced against the plain reference, and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` a `breakdown`, and `checks`,
each number compared beside its limit, which also close standard error.

It exits non-zero with no result line when no CUDA card is there (or fewer
than the cell asks for), when JAX or the JAX package is loaded once the
window has closed, or when the program cannot be imported. It never runs
on the CPU. `--control accept_all` puts a verifier that accepts every
signature in the program's place: the control run that has to come out
not correct (never used by the benchmark's own runs).

Only the standard library is imported at the top: the signing workers
are spawned and import this module again.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_IMPORT = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started, from /proc; 0 if unreadable."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _share_bytecode(root) -> None:
    """Keep the bytecode of every import (torch's included) under a fixed
    directory of the checkout, for this process and the ones it spawns:
    the card's host sets PYTHONDONTWRITEBYTECODE, and without a cache an
    import of torch compiles its sources again in every run."""
    cache = str(root / ".pycache")
    os.makedirs(cache, exist_ok=True)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = cache


def _parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="", choices=("", "accept_all"))
    return p.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    age = _process_age_s()
    t0 = time.perf_counter() - age if age > 0 else T_IMPORT
    args = _parse(argv)
    from portbench import harness
    root = harness.ROOT
    _share_bytecode(root)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    bench = harness.load_benchmark(root.parent)
    cell = harness.cell_of(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark runs only on the card", 2)
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{cell['name']} needs {cell['chips']} cards, found "
                     f"{torch.cuda.device_count()}", 2)
    code, lines, result = harness.run_once(
        root, bench, cell, args.seed, args.seconds, bool(args.trace),
        args.control, torch.device("cuda", 0), t0)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    if result is not None:
        print(result, flush=True)
    return code

if __name__ == "__main__":
    sys.exit(main())
