"""Analysis planes of the port: the port's copy of
`tendermint_tpu/analysis/`.

  analysis.engine      tmlint: one AST walk per file, checkers subscribe
                       to node events; findings carry file:line +
                       checker id and honor `# tmlint: allow(<id>): why`
                       pragmas.
  analysis.flowgraph   the project-wide call graph the taint pass walks.
  analysis.checkers    determinism, lock-discipline, knob-registry,
                       exception-hygiene, async-blocking,
                       ambient-singleton (AST), metrics (registry lint)
                       and taint (inter-procedural determinism).
  analysis.lint        the runner: `python -m
                       tendermint_tpu_torch.analysis.lint [--taint]`
                       over the port's package and chip_smoke.py.
  analysis.lockwatch   the runtime complement: TM_CUDA_LOCKCHECK=on
                       records the lock acquisition graph and
                       cross-thread unguarded-attribute touches.
  analysis.divergence  per-height transition digests and the
                       dual-hash-seed replay.
"""

from tendermint_tpu_torch.analysis.engine import (  # noqa: F401
    Checker,
    Engine,
    Finding,
    Pragma,
)


def run_tree(root: str = ".", paths=None):
    """Engine with every AST checker over the default scan set (the
    port's package and chip_smoke.py). Returns (findings, pragmas,
    n_files)."""
    from tendermint_tpu_torch.analysis.checkers import all_checkers
    eng = Engine(all_checkers(), root=root)
    return eng.run(paths)
