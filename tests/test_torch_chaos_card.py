"""The port's chaos plane alone (no jax): chaos.runner.run_chaos on
SMOKE_SPEC (drops, delays and a crash of node 2 at
consensus.after_wal_end_height, restarted through its handshake and
WAL).

On the CPU the run repeats to the same fault log, with no violation. The
test marked `cuda` runs it with a BatchVerifier("cuda") as the default
verifier (the nodes and the lite certifier share it, as on phase 17 of
chip_smoke.py): its fault_log_sha256, heights and steps must equal the
CPU run's, since the trajectory depends on the verdicts only, and every
verify is a B1 launch of 8 lanes. It needs no jax: `python -m pytest
--noconftest -m cuda tests/test_torch_chaos_card.py`.
"""

import pytest
import torch

from tendermint_tpu_torch.chaos.runner import SMOKE_SPEC, run_chaos
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ladder

torch.set_num_threads(1)

RUN = dict(spec=SMOKE_SPEC, seed=42, n=4, target_height=4, max_steps=400,
           settle_steps=20)


def _key(r: dict) -> tuple:
    return (r["fault_log_sha256"], r["max_height"], r["steps"],
            r["checks"], r["lite"]["certified_height"])


def test_smoke_run_repeats_on_cpu():
    a, b = (run_chaos(device="cpu", **RUN) for _ in range(2))
    assert _key(a) == _key(b)
    assert a["violations"] == [] and a["faults_injected"]["crash"] == 1
    assert a["lite"]["certified_height"] == a["max_height"]


@pytest.mark.cuda
def test_cuda_smoke_run_matches_cpu_and_launches_b1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    want = run_chaos(device="cpu", **RUN)
    saved = tverifier._default
    tverifier.set_default_verifier(
        tverifier.BatchVerifier("cuda", coalesce="off"))
    before = dict(ladder.launches)
    try:
        got = run_chaos(**RUN)
    finally:
        tverifier.set_default_verifier(saved)
    launched = {k: ladder.launches[k] - before[k] for k in before}
    assert _key(got) == _key(want)
    assert got["violations"] == []
    assert launched["verify"] > 0 and launched["verify_pre"] == 0
