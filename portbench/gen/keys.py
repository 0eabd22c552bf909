"""Validator keys and Ed25519 signatures made from the run's seed with
OpenSSL (`cryptography`), in a pool of worker processes.

A validator's private seed is SHA-256 of the run's seed, a tag and its
number, so the same `--seed` gives the same keys. Signing is
deterministic (RFC 8032), so the same seed gives the same signatures.
The workers are spawned (no fork of a process that holds threads) and
import only `cryptography`.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey)


def seed_bytes(seed: int, tag: str, i: int) -> bytes:
    return hashlib.sha256(b"portbench|" + tag.encode() + b"|"
                          + seed.to_bytes(16, "little", signed=True)
                          + i.to_bytes(8, "little")).digest()


def _key(seed32: bytes):
    return Ed25519PrivateKey.from_private_bytes(seed32)


def pubkey(seed32: bytes) -> bytes:
    return _key(seed32).public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)


def _work(job):
    """(seeds, msgs_by_key) -> (pubkeys, sigs_by_key)."""
    seeds, msgs = job
    pubs, sigs = [], []
    for s, ms in zip(seeds, msgs):
        k = _key(s)
        pubs.append(k.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw))
        sigs.append([k.sign(m) for m in ms])
    return pubs, sigs


def workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def sign_matrix(seeds: list, msgs_by_key: list) -> tuple:
    """Public keys, and each key's signatures of its messages:
    (pubkeys [n], sigs_by_key [n][m_i]); key i signs msgs_by_key[i]."""
    n = len(seeds)
    w = workers()
    if n < 256 or w == 1:
        return _work((seeds, msgs_by_key))
    step = -(-n // w)
    jobs = [(seeds[lo:lo + step], msgs_by_key[lo:lo + step])
            for lo in range(0, n, step)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(jobs)) as pool:
        parts = pool.map(_work, jobs)
    pubs, sigs = [], []
    for p, s in parts:
        pubs += p
        sigs += s
    return pubs, sigs


class Signer:
    """Keys held in this process, for signing one message at a time."""

    def __init__(self, seeds: list):
        self._keys = [_key(s) for s in seeds]
        self.pubkeys = [k.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
            for k in self._keys]

    def sign(self, i: int, msg: bytes) -> bytes:
        return self._keys[i].sign(msg)
