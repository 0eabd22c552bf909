"""The port's native host ops (csrc/hostops.cpp through
tendermint_tpu_torch.native) against hashlib, the port's plain Merkle
functions and the JAX package's native ones, on the CPU, tolerance 0.

- SHA-256 batches, Merkle roots (from items, from digests as a list and
  as one flat blob), single proofs at every index of small trees and
  every proof of one tree build, over 0, 1, odd, power-of-two and
  5,000-item trees with empty and multi-block items;
- part-set skeletons at part sizes 1, 64 and 65536 around the part
  boundaries;
- the portable SHA-256 compress: a second build of the same source with
  the SHA-NI route compiled out, held to hashlib at every padding
  boundary;
- a failed build of the host ops, the codec or the kv core raises with
  the compiler's output.
"""

import hashlib

import numpy as np
import pytest

from tendermint_tpu import native as jnative
from tendermint_tpu.ops import merkle as jmerkle
from tendermint_tpu_torch import native
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import merkle

SIZES = (0, 1, 2, 3, 5, 7, 8, 16, 33, 64, 5000)


def _items(n: int, seed: int) -> list:
    """n seeded items of 0..199 bytes: empty ones and items of one, two
    and more SHA-256 blocks."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, 200, n)
    if n > 2:
        lens[0], lens[1] = 0, 64
    return [rng.randint(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in lens]


@pytest.mark.parametrize("n", SIZES)
def test_sha256_batch_matches_hashlib_and_jax(n):
    items = _items(n, 1000 + n)
    want = [hashlib.sha256(it).digest() for it in items]
    assert native.sha256_batch(items) == want
    assert native.sha256_batch(items) == (jnative.sha256_batch(items)
                                          if n else [])


@pytest.mark.parametrize("n", SIZES)
def test_roots_match_plain_and_jax(n):
    items = _items(n, 2000 + n)
    want = merkle.root_plain(items)
    assert native.merkle_root(items) == want
    assert merkle.root_host(items) == want == jmerkle.root_host(items)
    assert want == jnative.merkle_root(items)
    digests = [merkle.leaf_hash(it) for it in items]
    flat = b"".join(digests)
    want_d = merkle.root_from_digests_plain(digests)
    assert want_d == want
    for arg in (digests, flat, bytearray(flat), memoryview(flat)):
        assert merkle.root_from_digests_host(arg) == want_d
    assert merkle.root_from_digests_plain(flat) == want_d
    assert want_d == jmerkle.root_from_digests_host(flat)


@pytest.mark.parametrize("n", SIZES)
def test_tree_proofs_match_plain_and_jax(n):
    items = _items(n, 3000 + n)
    got = merkle.tree_proofs_host(items)
    assert got == merkle.tree_proofs_plain(items)
    assert got == jmerkle.tree_proofs_host(items)
    root, proofs = got
    for i in (range(n) if n <= 64 else range(0, n, 97)):
        assert merkle.verify_proof_host(root, n, i, items[i], proofs[i])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 16, 33])
def test_every_proof_index_of_small_trees(n):
    items = _items(n, 4000 + n)
    for i in range(n):
        got = merkle.proof_host(items, i)
        assert got == merkle.proof_plain(items, i)
        assert got == jmerkle.proof_host(items, i)
        assert got == native.merkle_proof(items, i)


def _data(n: int, seed: int) -> bytes:
    return np.random.RandomState(seed).randint(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("part_size", [1, 64, 65536])
def test_partset_build_around_part_boundaries(part_size):
    lens = sorted({0, 1, 2, 7, 65, part_size - 1, part_size, part_size + 1,
                   2 * part_size, 3 * part_size + 1})
    for ln in lens:
        data = _data(ln, part_size + ln)
        chunks = [data[i:i + part_size]
                  for i in range(0, len(data), part_size)] or [b""]
        want = merkle.tree_proofs_plain(chunks)
        got = native.partset_build(data, part_size)
        assert got == want, (part_size, ln)
        assert got == jnative.partset_build(data, part_size)


def test_partset_build_refuses_a_part_size_of_zero():
    with pytest.raises(ValueError, match="part_size must be positive"):
        native.partset_build(b"abc", 0)


def test_portable_compress_matches_hashlib():
    """The SHA-NI route compiled out: every padding case of one and two
    blocks, and whole trees, against hashlib."""
    lib = native.hostops_lib(portable=True)
    assert native.sha256_shani(lib) is False
    rng = np.random.RandomState(7)
    items = [rng.randint(0, 256, k, dtype=np.uint8).tobytes()
             for k in list(range(0, 200)) + [1000, 4096, 4097]]
    assert native.sha256_batch(items, lib=lib) == \
        [hashlib.sha256(it).digest() for it in items]
    for n in (1, 3, 8, 33, 300):
        sub = items[:n]
        assert native.merkle_root(sub, lib=lib) == merkle.root_plain(sub)
        assert native.merkle_tree_proofs(sub, lib=lib) == \
            merkle.tree_proofs_plain(sub)
    data = _data(5000, 9)
    assert native.partset_build(data, 64, lib=lib) == \
        native.partset_build(data, 64)


def test_default_build_reports_its_compress():
    """The default build takes SHA-NI exactly when the CPU has it (the
    JAX package's probe, CPUID leaf 7 bit 29 with SSE4.1 and SSSE3)."""
    with open("/proc/cpuinfo") as f:
        flags = next((ln for ln in f if ln.startswith("flags")), "")
    has = " sha_ni" in flags and " sse4_1" in flags and " ssse3" in flags
    assert native.sha256_shani() is has


BROKEN = {"hostops": ("HOSTOPS_SRC", "hostops.cpp", native.hostops_build),
          "codec": ("CODEC_SRC", "codec.cpp", native.codec_build),
          "kvcore": ("KV_SRC", "kvcore.cpp", native.kv_build)}


@pytest.mark.parametrize("lib", sorted(BROKEN))
def test_failed_build_raises_with_compiler_output(lib, tmp_path,
                                                  monkeypatch):
    attr, name, build = BROKEN[lib]
    bad = tmp_path / name
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, attr, bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=f"building {name} failed") as e:
        build()
    assert "error" in str(e.value)
    # nothing was installed under the broken source's name
    assert not list((tmp_path / "_build").glob("*.so"))
