"""The port's shard plane alone (no jax): ShardSet(8) behind its front
door, the chains' verifies merged by the one shared verifier's coalescer,
and a certified cross-shard read.

On the CPU (device="cpu") the eight chains commit on one verifier object
whose coalescer merges calls of different chains into one dispatch. The
test marked `cuda` runs ShardSet(8) on the card with a
BatchVerifier("cuda") (coalescing "auto") as the process default, as
phase 18a of chip_smoke.py does: every merged dispatch is a B1 launch,
and reads of keys on two shards verify through CertifiedReader on the
card. It needs no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_shard_card.py`.
"""

import time

import pytest
import torch

from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.shard import ShardSet

torch.set_num_threads(1)


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _drive(s: ShardSet) -> dict:
    """Start, feed keys through the front door, read two of them from
    different shards through the certified reader; the read results."""
    from tendermint_tpu_torch.rpc import JSONRPCClient
    s.start()
    assert _wait(lambda: s.frontier() >= 3), s.heights()
    host, port = s.serve()
    c = JSONRPCClient(f"http://{host}:{port}")
    keys = [b"card/%d" % i for i in range(32)]
    r = c.call("broadcast_tx_batch", txs=[(k + b"=v").hex() for k in keys])
    assert all(x["code"] == 0 for x in r["results"])
    picked = {}
    for k in keys:
        picked.setdefault(s.router.map.chain_of(k), k)
    two = list(picked.values())[:2]
    assert len(two) == 2
    reader = s.reader()
    out = {}
    for k in two:
        assert _wait(lambda: reader.read(k)["value"] == b"v", 30)
        out[k] = reader.read(k)
    return out


def test_eight_shards_merge_on_one_cpu_verifier():
    s = ShardSet(8, chain_prefix="cpu8", device="cpu")
    try:
        reads = _drive(s)
        assert {r["chain_id"] for r in reads.values()} <= set(s.chains)
        assert all(n.verifier is s.verifier for n in s.nodes)
        assert _wait(lambda: s.verifier.coalescer_stats()["calls_max"] >= 2)
    finally:
        s.stop()


@pytest.mark.cuda
def test_cuda_eight_shards_launch_b1_on_merged_dispatches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from tendermint_tpu_torch.node import prebuild
    saved = tverifier._default
    v = tverifier.BatchVerifier("cuda")
    prebuild(v)
    tverifier.set_default_verifier(v)
    before = dict(ladder.launches)
    s = ShardSet(8, chain_prefix="card8")
    try:
        assert all(n.verifier is v for n in s.nodes)
        reads = _drive(s)
        assert _wait(lambda: v.coalescer_stats()["calls_max"] >= 2)
    finally:
        s.stop()
        tverifier.set_default_verifier(saved)
        v.close()
    launched = {k: ladder.launches[k] - before[k] for k in before}
    co = v.coalescer_stats()
    assert launched["verify"] > 0
    assert co["dispatches"] > 0 and co["merged_calls"] > co["dispatches"]
    assert v.stats["cuda_sigs"] > 0
    for r in reads.values():
        assert r["value"] == b"v"
        assert r["certified_height"] >= r["height"] > 0
