"""The port's 4-validator kvstore net (consensus.testnet.Testnet, BASELINE
config 1) alone, on consensus.testnet.run_schedule, the schedule
chip_smoke.py's consensus phase drives: fresh txs fed to every mempool
before each height on a clock stepped one second a height, a validator
joining and leaving, an equivocation, a forged prevote and a crash and
restart of node 3, every node agreeing at every height.

On the CPU the schedule at 50 txs a height runs on the host verifier
twice to the same chain. The test marked `cuda` runs it at 1000 txs a
height on BatchVerifier("cuda"), whose block hashes must equal the same
schedule's on BatchVerifier("python"). Each consensus check verifies 1-4
signatures, whose batch pads to 8 lanes, below the predecompression
cache's 64 (ops/ed25519._PREDECOMP_MIN_BATCH): the port runs all of them
on its hand-written B1 (ladder_kernel<true>) and B2 does not launch. The
JAX package at 8 lanes takes no Pallas kernel at all: its
verify_from_bytes_best runs the jnp ladder below 512 lanes. It needs no
jax: `python -m pytest --noconftest -m cuda
tests/test_torch_consensus_card.py`.
"""

import pytest
import torch

from tendermint_tpu_torch.consensus.testnet import (FILE_NODE, MAX_BLOCK_TXS,
                                                    N_VALS, T0, Schedule,
                                                    Testnet, run_schedule,
                                                    standby_key)
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.utils import clock

torch.set_num_threads(1)

SCHEDULE = Schedule(heights=10, txs=MAX_BLOCK_TXS, join_at=3, leave_at=6,
                    equivocate_at=5, forge_at=7, restart_after=8)


def run_net(verifier, sched, home):
    """Block hashes of `sched` on a net whose nodes all verify on
    `verifier`."""
    net = Testnet(verifier_of=lambda i: verifier, home=str(home),
                  file_nodes=(FILE_NODE,))
    now = [T0]
    clock.set_source(lambda: now[0])
    fed = []
    try:
        net.start()
        for h, refused in run_schedule(net, sched, standby_key(), now, fed):
            assert refused in (None, True)
            assert net.heights() == [h] * N_VALS
            assert len({n.app.app_hash for n in net.nodes}) == 1
            assert len({n.block_store.load_block_meta(h).block_id.hash
                        for n in net.nodes}) == 1
            if h == sched.restart_after:
                net.stop_node(FILE_NODE)
                net.restart_node(FILE_NODE)
        blocks = [net.nodes[0].block_store.load_block(x)
                  for x in range(1, h + 1)]
        assert sorted(tx for b in blocks for tx in b.data.txs) == sorted(fed)
        assert sum(len(b.evidence.evidence) for b in blocks) == 1
        return [b.hash() for b in blocks]
    finally:
        clock.set_source(None)
        net.close()


def test_net_runs_to_the_same_chain_twice_on_cpu(tmp_path):
    py = tverifier.BatchVerifier("python")
    sched = SCHEDULE._replace(txs=50)
    assert (run_net(py, sched, tmp_path / "a")
            == run_net(py, sched, tmp_path / "b"))


@pytest.mark.cuda
def test_cuda_net_matches_host_verifier_and_launches_b1(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    before = dict(ladder.launches)
    cuda = run_net(tverifier.BatchVerifier("cuda"), SCHEDULE,
                   tmp_path / "cuda")
    after = dict(ladder.launches)
    assert cuda == run_net(tverifier.BatchVerifier("python"), SCHEDULE,
                           tmp_path / "python")
    assert after["verify"] > before["verify"]
    assert after["verify_pre"] == before["verify_pre"]
    assert after["sign_rb"] == before["sign_rb"]
