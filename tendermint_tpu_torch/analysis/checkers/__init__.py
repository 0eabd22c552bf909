"""The tmlint checker catalog: the port's copy of
`tendermint_tpu/analysis/checkers/`, over the port's own tree.

AST checkers run inside the engine's single tree walk; the metrics
checker is a registry lint (it imports the instrumented modules) and the
taint pass walks the call graph, both invoked separately by
analysis/lint.py — `all_checkers()` returns only the AST ones so
`analysis.run_tree` stays import-light.
"""

from tendermint_tpu_torch.analysis.checkers.ambient import (  # noqa: F401
    AmbientSingletonChecker,
)
from tendermint_tpu_torch.analysis.checkers.asyncblock import (  # noqa: F401
    AsyncBlockingChecker,
)
from tendermint_tpu_torch.analysis.checkers.determinism import (  # noqa: F401
    DeterminismChecker,
)
from tendermint_tpu_torch.analysis.checkers.exceptions import (  # noqa: F401
    ExceptionHygieneChecker,
)
from tendermint_tpu_torch.analysis.checkers.knobs import (  # noqa: F401
    KnobRegistryChecker,
)
from tendermint_tpu_torch.analysis.checkers.locks import (  # noqa: F401
    LockDisciplineChecker,
)


def all_checkers():
    return [DeterminismChecker(), LockDisciplineChecker(),
            KnobRegistryChecker(), ExceptionHygieneChecker(),
            AsyncBlockingChecker(), AmbientSingletonChecker()]
