"""The state tree's device route on the card (tests marked `cuda`; they
skip without one).

- `ops/merkle.sha256_many_host` on 4,096 seeded 65-byte payloads (one
  length, above the 512 threshold) takes the device route: one batch of
  the plain PyTorch SHA-256 on the card, counted once under
  merkle_sha_batches_total{impl="device"}, digests equal to hashlib. A
  batch of mixed lengths takes the native route, counted under "native".
- A StateTree on the card commits 4,096 fresh keys (its leaf and first
  inner waves on the device) to the root of a tree on the CPU that
  hashes every wave with hashlib.

It needs no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_statetree_card.py`.
"""

import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.statetree import StateTree

SEED = 20261016


def _counts():
    return {k: telemetry.value("merkle_sha_batches_total", {"impl": k}) or 0
            for k in ("device", "native", "host")}


@pytest.mark.cuda
def test_cuda_sha256_many_host_device_route_matches_hashlib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    telemetry.set_enabled(True)
    rng = np.random.RandomState(SEED)
    payloads = [rng.bytes(65) for _ in range(4096)]
    before = _counts()
    got = merkle.sha256_many_host(payloads)
    assert got == [hashlib.sha256(p).digest() for p in payloads]
    mixed = payloads[:100] + [b"", b"x" * 200]
    assert merkle.sha256_many_host(mixed) == \
        [hashlib.sha256(p).digest() for p in mixed]
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == \
        {"device": 1, "native": 1, "host": 0}


@pytest.mark.cuda
def test_cuda_state_tree_commit_matches_hashlib_tree():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    telemetry.set_enabled(True)
    pairs = [(b"card/%d" % i, b"%08d" % i) for i in range(4096)]
    card, host = StateTree(), StateTree(device="cpu", native_lib=False)
    assert card.device.type == "cuda"
    before = _counts()
    for t in (card, host):
        for k, v in pairs:
            t.set(k, v)
    root = card.commit(1)
    assert _counts()["device"] - before["device"] >= 3
    saved = merkle._SHA_DEVICE_MIN
    merkle._SHA_DEVICE_MIN = 1 << 62   # every wave of the host tree: hashlib
    try:
        assert host.commit(1) == root
    finally:
        merkle._SHA_DEVICE_MIN = saved
    value, proof = card.prove(b"card/77", 1)
    assert value == b"%08d" % 77
