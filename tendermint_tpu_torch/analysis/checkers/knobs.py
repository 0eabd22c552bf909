"""knob-registry — every TM_CUDA_* name must be in the catalog.

The catalog is tendermint_tpu_torch/utils/knobs.py;
tendermint_tpu_torch/KNOBS.md is rendered from it (`python -m
tendermint_tpu_torch.analysis.lint --knobs-md`). This checker flags any
string literal that IS a TM_CUDA_* name (env reads, env writes in
harnesses, subprocess env dicts) when the name has no catalog entry — so
a typo'd or undocumented knob fails the lint instead of silently reading
defaults forever. The docs-drift half lives in analysis/lint.py, which
re-renders the catalog and diffs the file.

utils/knobs.py itself is exempt: it is the catalog.
"""

from __future__ import annotations

import ast
import re

from tendermint_tpu_torch.analysis.engine import Checker, FileContext
from tendermint_tpu_torch.utils import knobs as knob_catalog

_KNOB_NAME_RE = re.compile(r"^TM_CUDA_[A-Z0-9_]+$")
_EXEMPT = ("tendermint_tpu_torch/utils/knobs.py",)


class KnobRegistryChecker(Checker):
    id = "knob-registry"
    events = (ast.Constant,)

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        v = node.value
        if not (isinstance(v, str) and _KNOB_NAME_RE.match(v)):
            return
        if ctx.rel.replace("\\", "/") in _EXEMPT:
            return
        if v not in knob_catalog.NAMES:
            ctx.report(self.id, node,
                       f"{v} is not in the knob catalog "
                       f"(tendermint_tpu_torch/utils/knobs.py) — add a Knob "
                       f"entry and regenerate tendermint_tpu_torch/KNOBS.md "
                       f"with `python -m tendermint_tpu_torch.analysis.lint "
                       f"--knobs-md`")
