"""The port's device mesh alone (no jax): logical devices laid over the
devices present, the sharded verify and the sharded Merkle root.

On the CPU the mesh's bookkeeping is checked: TM_CUDA_MESH_FORCE_DEVICES
lays N logical devices round-robin over the real ones, meshes are cached
per device tuple, and a shard layout of the padded batch divides by the
mesh. The test marked `cuda` runs the sharded verify on the card at 2, 4
and 8 logical devices laid over cuda:0 (one stream each, as
BatchVerifier gives them) and holds its verdicts to the plain version on
the CPU, one kernel launch a shard; the sharded root to hashlib's. It
needs no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_mesh_card.py`.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import ladder, merkle
from tendermint_tpu_torch.parallel import mesh as pmesh
from tendermint_tpu_torch.utils import ed25519_fast, ed25519_ref

TAMPER = (5, 130, 299)


def _items(n: int, seed: int = 7):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        a, prefix = ed25519_ref.secret_expand(rng.bytes(32))
        pub = ed25519_ref.point_compress(ed25519_fast._mul_base(a))
        msg = b"mesh card %d" % i
        sig = ed25519_fast.sign_expanded(a, prefix, pub, msg)
        if i in TAMPER:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        out.append((pub, msg, sig))
    return out


def test_logical_devices_round_robin_and_cached_meshes(monkeypatch):
    monkeypatch.delenv("TM_CUDA_MESH_FORCE_DEVICES", raising=False)
    assert pmesh.logical_devices("cpu") == (torch.device("cpu"),)
    monkeypatch.setenv("TM_CUDA_MESH_FORCE_DEVICES", "4")
    assert pmesh.logical_devices("cpu") == (torch.device("cpu"),) * 4
    m = pmesh.make_mesh(4, "cpu")
    assert m.size == 4 and pmesh.make_mesh(4, "cpu") is m
    assert pmesh.make_mesh(2, "cpu").devices == m.devices[:2]
    with pytest.raises(RuntimeError):
        pmesh.make_mesh(8, "cpu")
    with pytest.raises(ValueError):
        pmesh.logical_devices("tpu")
    monkeypatch.setenv("TM_CUDA_MESH_FORCE_DEVICES", "-1")
    with pytest.raises(ValueError):
        pmesh.logical_devices("cpu")


@pytest.mark.cuda
def test_cuda_sharded_verify_and_root_equal_the_plain_versions(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    monkeypatch.setenv("TM_CUDA_MESH_FORCE_DEVICES", "8")
    items = _items(300)
    n = len(items)
    pk, rb, sb, hb, pre = ted.prepare_batch_bytes(*zip(*items))
    m = ted._bucket(n)
    plain = ted.verify_prepared_async(pk, rb, sb, hb, device="cpu")
    plain = plain.numpy()[:n] & pre
    assert sorted(np.flatnonzero(~plain).tolist()) == list(TAMPER)
    leaves = [msg for _, msg, _ in items]
    digests = merkle.pad_digests(np.frombuffer(
        b"".join(merkle.leaf_hash(x) for x in leaves),
        np.uint8).reshape(n, 32))
    for k in (2, 4, 8):
        mesh = pmesh.make_mesh(k, "cuda")
        assert mesh.devices == (torch.device("cuda", 0),) * k
        streams = [torch.cuda.Stream(d) for d in mesh.devices]
        before = dict(ladder.launches)
        got = pmesh.sharded_verify_kernel(mesh)(pk, rb, sb, hb,
                                                streams=streams)
        got = got.result()
        assert got.shape == (m,)
        assert np.array_equal(got[:n] & pre, plain), k
        launched = sum(ladder.launches[x] - before[x]
                       for x in ("verify", "verify_pre"))
        assert launched == k
        root = pmesh.sharded_merkle_root(mesh)(digests, n)
        assert root.device == torch.device("cuda", 0)
        assert root.cpu().numpy().tobytes() == merkle.root_plain(leaves)
        v = tverifier.BatchVerifier("cuda", mesh=str(k), coalesce="off")
        try:
            assert np.array_equal(v.verify(items), plain)
            assert v.mesh_devices == k and v._min_bucket == max(8, k)
        finally:
            v.close()
