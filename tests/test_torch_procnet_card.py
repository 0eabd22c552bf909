"""Four port node processes on the card: BASELINE config 1 from a
`cli testnet` tree, each process `cli node --p2p` on
verifier_backend "cuda" (its own CUDA context on the one card), fed
over WebSocket RPC, reach height 5, agree on every block, and each
process reports B1 launches in its stop line: every consensus check
verifies 1-4 signatures, padded to 8 lanes.

It needs no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_procnet_card.py`.
"""

import pytest
import torch

from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.procnet import ProcNet, bench_settings, free_block

HEIGHTS = 5
BOOT_S = 120.0


@pytest.mark.cuda
def test_cuda_process_net_commits_and_every_process_launches_b1(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    _build.ladder_lib()   # built once here; the nodes load it
    net = ProcNet(str(tmp_path), base_port=free_block(8))
    net.write_tree("procnet-card")
    net.configure(bench_settings("cuda"))
    net.start_all(extra=["--no-fast-sync"])
    try:
        net.wait_height(2, BOOT_S)
        ws = net.ws(0)
        try:
            txs = [b"card/k%d=v" % i for i in range(500)]
            ws.call("broadcast_tx_batch", txs=[t.hex() for t in txs])
        finally:
            ws.close()
        net.wait_height(HEIGHTS, BOOT_S)
        assert net.disagreements(HEIGHTS) == []
        assert net.early_exits() == {}
    finally:
        codes = net.stop_all()
    assert codes == {i: 0 for i in range(4)}
    for i in range(4):
        (line,) = net.kernel_lines(i)
        assert line["device"].startswith("cuda"), line
        assert line["launches"]["verify"] > 0, (i, line)
        assert line["launches"]["sign_rb"] == 0, (i, line)
