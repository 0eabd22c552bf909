"""The port's socket net on the card: four validators over
make_connected_switches(encrypt=True) (BASELINE config 1 over loopback
TCP, socknet.bench_config's timeouts) commit 5 heights of txs with every
node's BlockExecutor on BatchVerifier("cuda"), agree on every block, and
the hand-written B1 (ladder_kernel<true>) must have launched: each
consensus check verifies 1-4 signatures, padded to 8 lanes, below the
predecompression cache's 64, so B2 does not.

It needs no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_p2p_card.py`.
"""

import time

import pytest
import torch

from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.p2p import socknet
from tendermint_tpu_torch.p2p.test_util import make_connected_switches

WAIT_S = 30.0
HEIGHTS = 5


def run_net(verifier) -> list:
    """Block hashes of heights 1..HEIGHTS, every node agreeing."""
    cfg = socknet.bench_config()
    keys = socknet.validator_keys()
    gen = socknet.genesis(keys)
    nodes = [socknet.build_node(i, k, gen, cfg, verifier)
             for i, k in enumerate(keys)]
    switches = make_connected_switches(
        len(nodes), lambda i: nodes[i].reactors(), network=gen.chain_id,
        encrypt=True, config=cfg.p2p, other=["compact/1", "voteagg/1"])
    for n, sw in zip(nodes, switches):
        n.switch = sw
    try:
        txs = [b"card/k%d=v" % i for i in range(cfg.consensus
                                                 .max_block_size_txs)]
        assert all(r.ok for r in nodes[0].mempool.check_tx_batch(txs))
        deadline = time.monotonic() + WAIT_S
        while min(n.block_store.height() for n in nodes) < HEIGHTS:
            assert time.monotonic() < deadline, \
                [n.block_store.height() for n in nodes]
            time.sleep(0.01)
        hashes = [{n.block_store.load_block_meta(h).block_id.hash
                   for n in nodes} for h in range(1, HEIGHTS + 1)]
        assert all(len(s) == 1 for s in hashes)
        return [s.pop() for s in hashes]
    finally:
        for n in nodes:
            n.close()


@pytest.mark.cuda
def test_cuda_socket_net_commits_and_launches_b1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    before = dict(ladder.launches)
    assert len(run_net(tverifier.BatchVerifier("cuda"))) == HEIGHTS
    launched = {k: v - before.get(k, 0) for k, v in ladder.launches.items()}
    assert launched["verify"] > 0, launched
    assert launched["verify_pre"] == 0 and launched["sign_rb"] == 0, launched
