"""Sharded verify and Merkle roots over a mesh of CUDA devices.

Counterpart of `tendermint_tpu/parallel/mesh.py`. One mesh axis, the
batch: each device verifies a contiguous shard of the signatures with
the hand-written kernels (B1, or B2 on a predecompression hit), and the
verdicts come back into one pinned host buffer. The Merkle root reduces
each device's shard of the leaf digests to a subtree root, gathers the
n subtree roots onto the mesh's first device (the JAX `all_gather`),
finishes the tree there and applies the `0x02 || u64 n` header hash.

A mesh is a value: an ordered tuple of `torch.device`s, cached per
device tuple. The devices it may use are `logical_devices(kind)`: the
cards present (`torch.cuda.device_count()`), or the CPU alone for
`kind="cpu"`. `TM_CUDA_MESH_FORCE_DEVICES=N` (the counterpart of
`TM_TPU_MESH_FORCE_HOST_DEVICES`) lays N logical devices round-robin
over those (`cuda:i mod count`, or `cpu`), so that 2-, 4- and 8-wide
meshes run on one card or on the CPU. Logical devices that alias one
card share its constant tables (`ops/ladder` keys them by the real
`torch.device`); each has a stream of its own where the caller gives
one (`BatchVerifier` does).

A 1-device mesh hands back the plain unsharded route, as the JAX
builders do. The JAX module's `shard_map_impl` picks which JAX API
partitions the batch; a mesh here is a loop over devices, so it has no
counterpart and is not carried.

`parse_mesh_spec` and `resolve_mesh_size` are the spec grammar shared by
`models/verifier.py` and `ops/merkle.py`, byte for byte the JAX one
(`ops/merkle.py` takes a root through the mesh only at an explicit
width: see there).
`record_dispatch` feeds the two `mesh_*` families under the JAX names.
"""

from __future__ import annotations

import struct
import threading

import numpy as np
import torch

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.utils import knobs

_mesh_lock = threading.Lock()
_mesh_cache: dict = {}  #: guarded_by _mesh_lock; device tuple -> Mesh

# One dispatch = one sharded launch set from the verifier or the Merkle
# root plane. Occupancy is real rows / padded rows: with the contiguous
# padding layout that is also the mean per-shard fill.
_m_dispatch = telemetry.counter(
    "mesh_dispatch_total", "Sharded-kernel dispatches", ("kind",))
_m_occupancy = telemetry.histogram(
    "mesh_shard_occupancy",
    "Real (unpadded) rows / padded rows per sharded dispatch",
    buckets=telemetry.RATIO_BUCKETS)


def record_dispatch(kind: str, n_real: int, n_padded: int) -> None:
    """Telemetry of every sharded dispatch (the verifier's chunk loop,
    the Merkle root plane). No-op when telemetry is off."""
    if not telemetry.enabled():
        return
    _m_dispatch.labels(kind).inc()
    if n_padded > 0:
        _m_occupancy.observe(n_real / n_padded)


# ---------------------------------------------------------------------------
# Spec helpers (shared by models/verifier.py and ops/merkle.py)
# ---------------------------------------------------------------------------

def parse_mesh_spec(mesh) -> "str | int":
    """'auto' | 'off' | power-of-two int. Raises ValueError on anything
    else: a config or env typo fails at construction, not at the first
    batched verify where a ValueError reads as bad peer data."""
    s = str(mesh).strip().lower()
    if s in ("auto", ""):
        return "auto"
    if s in ("off", "0", "1", "none"):
        return "off"
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"verifier mesh must be auto|off|N, got {mesh!r}") from None
    if n < 2 or n & (n - 1):
        raise ValueError(
            f"verifier mesh size must be a power of two >= 2, got {n}")
    return n


def resolve_mesh_size(spec, n_avail: int) -> int:
    """Devices a parsed spec resolves to with n_avail present. 'off' ->
    1; 'auto' -> the largest power of two that fits (padded batches are
    powers of two); an explicit N > n_avail raises RuntimeError, which
    no verify-path caller catches as a bad-input signal."""
    if spec == "off":
        return 1
    if spec == "auto":
        n = 1
        while n * 2 <= n_avail:
            n *= 2
        return n
    if spec > n_avail:
        raise RuntimeError(
            f"verifier mesh={spec} but only {n_avail} devices present")
    return spec


def logical_devices(kind: str = "cuda") -> tuple:
    """The devices a mesh of `kind` ("cuda" or "cpu") may use, in order:
    the cards present, or the CPU; with TM_CUDA_MESH_FORCE_DEVICES=N,
    N logical devices laid round-robin over them."""
    if kind == "cuda":
        real = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        real = [torch.device("cpu")]
    else:
        raise ValueError(f"a mesh runs on cuda or cpu, not {kind!r}")
    force = knobs.knob_int("TM_CUDA_MESH_FORCE_DEVICES", default=0)
    if force < 0:
        raise ValueError(
            f"TM_CUDA_MESH_FORCE_DEVICES must be >= 0, got {force}")
    if force and real:
        return tuple(real[i % len(real)] for i in range(force))
    return tuple(real)


class Mesh:
    """An ordered tuple of devices; shard i of a batch goes to
    devices[i]. Equal device tuples share one cached Mesh."""

    def __init__(self, devices: tuple):
        self.devices = tuple(devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def make_mesh(n_devices=None, kind: str = "cuda") -> Mesh:
    """Mesh over the first n logical devices of `kind` (all of them by
    default), cached per device tuple so that the verifier, the Merkle
    plane and the tests share one value. n above the devices present
    raises RuntimeError."""
    devs = logical_devices(kind)
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise RuntimeError(
            f"a mesh of {n} devices but only {len(devs)} present")
    key = devs[:n]
    with _mesh_lock:
        mesh = _mesh_cache.get(key)
        if mesh is None:
            mesh = _mesh_cache[key] = Mesh(key)
        return mesh


# ---------------------------------------------------------------------------
# Sharded verify
# ---------------------------------------------------------------------------

class ShardedVerdicts:
    """The verdicts of one sharded dispatch: bool[m] in a host buffer
    (pinned when the mesh is on cards), complete once every device's
    event has fired. `result()` waits for them and returns the numpy
    verdicts; a failed wait raises RuntimeError."""

    def __init__(self, host: torch.Tensor, events: list):
        self.host = host
        self.events = events

    def result(self) -> np.ndarray:
        for ev in self.events:
            ev.synchronize()
        return self.host.numpy()


def sharded_verify_kernel(mesh: Mesh):
    """-> verify(pk, rb, s_bytes, h_bytes, streams=None) ->
    ShardedVerdicts, for prepared uint8[N, 32] host arrays (the packed
    scalars of `ops/ed25519.prepare_batch_bytes`). The batch is padded
    to a power of two of at least max(8, mesh size), cut into one
    contiguous shard a device, and each shard goes through
    `ops/ed25519.verify_prepared_async` on its device: B1, or B2 where
    the shard (padded to its own bucket) reaches the predecompression
    cache. On a card each shard runs on `streams[i]` (default: the
    device's current stream), which first waits for the device's
    current stream; its verdicts are copied to the pinned buffer and
    one event is recorded a device. The caller masks the verdicts with
    its host precheck. A 1-device mesh is the plain unsharded route."""
    from tendermint_tpu_torch.ops import ed25519

    devices = mesh.devices
    k = len(devices)

    def verify(pk, rb, s_bytes, h_bytes, streams=None) -> ShardedVerdicts:
        m = ed25519._bucket(pk.shape[0], min_size=max(8, k))
        per = m // k
        pk, rb, s_bytes, h_bytes = (ed25519._pad_to(x, m) for x in
                                    (pk, rb, s_bytes, h_bytes))
        on_card = devices[0].type == "cuda"
        host = torch.empty(m, dtype=torch.bool, pin_memory=on_card)
        events = []
        for i, dev in enumerate(devices):
            sl = slice(i * per, (i + 1) * per)
            args = (pk[sl], rb[sl], s_bytes[sl], h_bytes[sl])
            if dev.type != "cuda":
                res = ed25519.verify_prepared_async(*args, device=dev)
                host[sl] = res[:per]
                continue
            with torch.cuda.device(dev):
                current = torch.cuda.current_stream(dev)
                stream = streams[i] if streams is not None else current
                if stream is not current:
                    stream.wait_stream(current)
                with torch.cuda.stream(stream):
                    res = ed25519.verify_prepared_async(*args, device=dev)
                    host[sl].copy_(res[:per], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
            events.append(ev)
        return ShardedVerdicts(host, events)

    return verify


# ---------------------------------------------------------------------------
# Sharded Merkle root
# ---------------------------------------------------------------------------

def sharded_merkle_root(mesh: Mesh):
    """-> root(digests uint8[M, 32], n_leaves) -> uint8[32] on the mesh's
    first device, for M a power of two the mesh size divides (zero rows
    past n_leaves, `ops/merkle.pad_digests`). Each device reduces its
    contiguous shard to a subtree root with `ops/merkle._level_up` (the
    shards a real device holds in one batch); the n subtree roots are
    gathered onto the first device (a same-device copy where logical
    devices alias one card), the tree is finished there and the header
    hash applied. A 1-device mesh is the plain device root
    (`ops/merkle.root_from_digests`)."""
    from tendermint_tpu_torch.ops import merkle, sha256

    devices = mesh.devices
    k = len(devices)
    first = devices[0]

    # shards laid on one real device (logical devices) reduce together:
    # one batched level a device, each shard's subtree still its own
    groups: dict = {}
    for i, dev in enumerate(devices):
        groups.setdefault(dev, []).append(i)

    def root(digests, n_leaves: int) -> torch.Tensor:
        if isinstance(digests, np.ndarray):
            digests = torch.from_numpy(np.array(digests, np.uint8))
        if k == 1:
            return merkle.root_from_digests(digests.to(first), n_leaves)
        m = digests.shape[-2]
        if m % k or m & (m - 1):
            raise ValueError(f"{m} leaf rows do not shard over {k} devices")
        shards = digests.reshape(k, m // k, 32)
        subtrees = [None] * k
        for dev, idx in groups.items():
            level = shards[idx].to(dev)          # [shards here, per, 32]
            while level.shape[-2] > 1:
                level = merkle._level_up(level)
            for j, i in enumerate(idx):
                subtrees[i] = level[j]           # [1, 32]
        roots = torch.cat([s.to(first) for s in subtrees])
        while roots.shape[-2] > 1:
            roots = merkle._level_up(roots)
        header = torch.tensor(
            list(b"\x02" + struct.pack("<Q", n_leaves)), dtype=torch.uint8,
            device=first)
        return sha256.hash_fixed(torch.cat([header, roots[0]]))

    return root


def verify_step(mesh: Mesh):
    """The full sharded step of a fast-sync block check: the batched
    commit verify and the Merkle root of the same batch's leaf digests.
    Returns step(pk, rb, s_bytes, h_bytes, leaf_digests, n_leaves) ->
    (verdicts bool[m] numpy, root uint8[32] on the first device)."""
    verify = sharded_verify_kernel(mesh)
    root = sharded_merkle_root(mesh)

    def step(pk, rb, s_bytes, h_bytes, leaf_digests, n_leaves: int):
        return (verify(pk, rb, s_bytes, h_bytes).result(),
                root(leaf_digests, n_leaves))

    return step
