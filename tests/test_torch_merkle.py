"""The port's SHA-256 and Merkle planes against the JAX package's.

ops/sha256.py (torch, int64 words) against the JAX package's jnp
functions (uint32 words) and hashlib: compress, the word/byte packing,
the padding and hash_fixed at lengths 0 to 200 (0, 55, 56, 64 and 119
among them). ops/merkle.py's device half on the CPU against its host
half and the JAX package's root, leaf and level functions; the host
half's proofs, tree proofs, repeated-digest root, padding and batched
hashing against the JAX package's; the empty and singleton trees as
tests/test_merkle.py pins them. Inputs from numpy seeds; tolerance 0.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import merkle as jmerkle
from tendermint_tpu.ops import sha256 as jsha
from tendermint_tpu_torch.ops import merkle as tmerkle
from tendermint_tpu_torch.ops import sha256 as tsha

torch.set_num_threads(1)
CPU = "cpu"


def _rows(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _items(seed, n, max_len=50):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(rng.randint(0, max_len))) for _ in range(n)]


def test_compress_matches_jax():
    rng = np.random.RandomState(3)
    state = rng.randint(0, 1 << 32, (6, 8), dtype=np.uint64).astype(np.uint32)
    block = rng.randint(0, 1 << 32, (6, 16), dtype=np.uint64).astype(np.uint32)
    state[0] = 0
    block[1] = 0xFFFFFFFF
    state[2] = np.array(jsha.IV)
    want = np.asarray(jsha.compress(jnp.asarray(state), jnp.asarray(block)))
    got = tsha.compress(torch.from_numpy(state.astype(np.int64)),
                        torch.from_numpy(block.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_words_and_padding_match_jax():
    data = _rows(4, (5, 64))
    data[0] = 0xFF                  # every byte with bit 7 set
    words = tsha.bytes_to_words(torch.from_numpy(data))
    want = np.asarray(jsha.bytes_to_words(jnp.asarray(data)))
    np.testing.assert_array_equal(words.numpy(), want.astype(np.int64))
    assert int(words[0, 0]) == 0xFFFFFFFF
    np.testing.assert_array_equal(tsha.words_to_bytes(words).numpy(), data)
    for length in range(0, 130):
        n_t, sfx_t = tsha._pad_np(length)
        n_j, sfx_j = jsha._pad_np(length)
        assert n_t == n_j
        np.testing.assert_array_equal(sfx_t, sfx_j)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 65, 119, 200])
def test_hash_fixed_matches_hashlib_and_jax(length):
    data = _rows(10 + length, (4, length))
    got = tsha.hash_fixed(torch.from_numpy(data)).numpy()
    for i in range(4):
        assert got[i].tobytes() == hashlib.sha256(data[i].tobytes()).digest()
    if length in (0, 55, 56, 64, 119):
        want = np.asarray(jsha.hash_fixed(jnp.asarray(data)))
        np.testing.assert_array_equal(got, want)


def test_hash_fixed_broadcasts_over_batch_dims():
    data = _rows(5, (2, 3, 65))
    got = tsha.hash_fixed(torch.from_numpy(data)).numpy()
    assert got.shape == (2, 3, 32)
    for i in range(2):
        for j in range(3):
            assert got[i, j].tobytes() == \
                hashlib.sha256(data[i, j].tobytes()).digest()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9, 33])
def test_device_root_matches_host(n):
    items = _items(20 + n, n)
    want = jmerkle.root_host(items)
    assert tmerkle.root(items, device=CPU) == want
    assert tmerkle.root_host(items) == want
    if n in (1, 2, 3, 5, 8, 9):     # padded sizes 1 to 16: bounded compiles
        assert jmerkle.root(items) == want


def test_device_functions_match_jax():
    items = _rows(6, (8, 40))
    leaves = tmerkle.leaf_hash_device(torch.from_numpy(items))
    np.testing.assert_array_equal(
        leaves.numpy(), np.asarray(jmerkle.leaf_hash_device(jnp.asarray(items))))
    for i in range(8):
        assert leaves[i].numpy().tobytes() == \
            tmerkle.leaf_hash(items[i].tobytes())
    up = tmerkle._level_up(leaves)
    np.testing.assert_array_equal(
        up.numpy(), np.asarray(jmerkle._level_up(jnp.asarray(leaves.numpy()))))
    padded = tmerkle.pad_digests(leaves.numpy()[:5])
    np.testing.assert_array_equal(padded, jmerkle.pad_digests(
        leaves.numpy()[:5]))
    assert padded.shape == (8, 32) and not padded[5:].any()
    got = tmerkle.root_from_digests(torch.from_numpy(padded), 5)
    assert got.numpy().tobytes() == np.asarray(jmerkle.root_from_digests(
        jnp.asarray(padded), n_leaves=5)).tobytes()
    assert got.numpy().tobytes() == \
        tmerkle.root_from_digests_host(padded[:5].tobytes())


def test_empty_and_singleton():
    assert tmerkle.root([], device=CPU) == jmerkle.root_host([])
    assert tmerkle.root([b""], device=CPU) == jmerkle.root_host([b""])
    assert tmerkle.root([b""], device=CPU) != tmerkle.root([], device=CPU)
    # size binding: the same digests under another count give another root
    assert tmerkle.root([b"a"], device=CPU) != \
        tmerkle.root([b"a", bytes(32)], device=CPU)
    assert tmerkle.root_from_digests_host(b"") == \
        jmerkle.root_from_digests_host(b"")


def test_proofs_match_jax_and_reject():
    items = _items(30, 11, 10)
    root = tmerkle.root_host(items)
    assert root == jmerkle.root_host(items)
    n = len(items)
    for idx in (0, 1, 5, 10):
        proof_root, aunts = tmerkle.proof_host(items, idx)
        assert (proof_root, aunts) == jmerkle.proof_host(items, idx)
        cases = [(root, n, idx, items[idx], aunts),
                 (root, n, idx, b"evil", aunts),
                 (root, n, (idx + 1) % n, items[idx], aunts),
                 (root, n, idx, items[idx], aunts[:-1]),
                 (root, n + 1, idx, items[idx], aunts),
                 (root, n, -1, items[idx], aunts),
                 (b"\x00" * 32, n, idx, items[idx], aunts)]
        got = [tmerkle.verify_proof_host(*c) for c in cases]
        assert got == [jmerkle.verify_proof_host(*c) for c in cases]
        assert got == [True] + [False] * 6


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 13])
def test_tree_proofs_match_jax(n):
    items = _items(40 + n, n, 70)
    root, proofs = tmerkle.tree_proofs_host(items)
    j_root, j_proofs = jmerkle.tree_proofs_host(items)
    assert root == j_root
    assert [list(p) for p in proofs] == [list(p) for p in j_proofs]
    for i in range(n):
        assert tmerkle.verify_proof_host(root, n, i, items[i], proofs[i])
        assert (root, proofs[i]) == tmerkle.proof_host(items, i)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31,
                               100, 1000])
def test_root_from_repeated_digest_matches_generic(n):
    d = tmerkle.leaf_hash(b"repeat-me")
    got = tmerkle.root_from_repeated_digest(d, n)
    assert got == tmerkle.root_from_digests_host(d * n)
    assert got == jmerkle.root_from_repeated_digest(d, n)


def test_sha256_many_host_matches_jax():
    payloads = _items(50, 20, 300) + [b""]
    got = tmerkle.sha256_many_host(payloads)
    assert got == jmerkle.sha256_many_host(payloads)
    assert got == [hashlib.sha256(p).digest() for p in payloads]
    assert tmerkle.sha256_many_host([]) == []
