"""Batched SHA-256 in plain PyTorch: the hash plane of the Merkle device
half.

Counterpart of `tendermint_tpu/ops/sha256.py`, which is jnp (no Pallas
kernel). Fixed shapes: hashing L bytes needs L known, which is how the
Merkle plane uses it (leaves and inner nodes have known sizes).

torch's uint32 supports few operations, so words travel as int64 holding
values below 2^32, masked with `& 0xFFFFFFFF` after every add and left
shift. A left rotation by at most 30 bits keeps every intermediate below
2^62. Bytes are uint8; they are cast to int64 before any shift, so a byte
shifted past bit 7 never wraps. Every function broadcasts over leading
batch dimensions and runs on the device of its input tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)

IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

_M = 0xFFFFFFFF


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M


def compress(state, block):
    """One SHA-256 compression: state int64[..., 8], block int64[..., 16]
    (words below 2^32) -> int64[..., 8]. The 48 schedule steps and 64
    rounds unroll in Python; each step is elementwise over the batch."""
    w = list(block.unbind(-1))
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M) & g)
        t1 = (h + s1 + ch + _K[t] + w[t]) & _M
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & _M, a, b, c,
                                  (d + t1) & _M, e, f, g)
    return (state + torch.stack((a, b, c, d, e, f, g, h), -1)) & _M


def bytes_to_words(data):
    """uint8[..., 4k] big-endian -> int64[..., k]."""
    q = data.to(torch.int64).reshape(data.shape[:-1] + (-1, 4))
    return (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]


def words_to_bytes(words):
    """int64[..., k] (values below 2^32) -> uint8[..., 4k] big-endian."""
    b = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], -1)
    return b.reshape(words.shape[:-1] + (-1,)).to(torch.uint8)


def _pad_np(length: int) -> tuple:
    """Static SHA-256 padding for a message of `length` bytes: returns
    (total_blocks, uint8[pad_len] suffix)."""
    rem = (length + 9) % 64
    pad_len = 9 + (64 - rem if rem else 0)
    suffix = np.zeros(pad_len, dtype=np.uint8)
    suffix[0] = 0x80
    bitlen = length * 8
    suffix[-8:] = np.frombuffer(bitlen.to_bytes(8, "big"), dtype=np.uint8)
    return (length + pad_len) // 64, suffix


def hash_fixed(data):
    """SHA-256 of uint8[..., L] for a fixed L -> uint8[..., 32], on the
    device of `data`. The padding is a constant suffix; the (L + pad) / 64
    compressions run one after another."""
    length = data.shape[-1]
    nblocks, suffix = _pad_np(length)
    batch = data.shape[:-1]
    sfx = torch.from_numpy(suffix).to(data.device).expand(
        batch + (len(suffix),))
    words = bytes_to_words(torch.cat([data, sfx], -1))
    state = torch.tensor(IV, dtype=torch.int64,
                         device=data.device).expand(batch + (8,))
    for i in range(nblocks):
        state = compress(state, words[..., 16 * i:16 * (i + 1)])
    return words_to_bytes(state)
