"""BatchVerifier: the one signature-verification boundary of the port.

Counterpart of `tendermint_tpu/models/verifier.py`:

    verifier.verify(items: list[(pubkey, msg, sig)]) -> bool[N]

Backends:
  "cuda"    the batch path: host prep, BATCH_CHUNK-sized padded chunks,
            the verify kernels on `device` (their plain versions when the
            device is the CPU, as in the tests).
  "python"  the scalar host loop (types/keys.verify_many).
  "auto"    scalar at or below auto_threshold (default 128), batch above:
            small interactive commits stay off the dispatch round trip.

A batch call prepares its items in one native call (`ops/ed25519.
prep_items`). A batch holding secp256k1 keys (33-byte SEC1) is split:
those verify on the host (`types/keys.verify_any`), the rest go through
the same call recursively, and the verdicts are put back in order. Other
batches the native prep declines (members that are not `bytes`) take the
general prep of `ops/ed25519.prepare_batch_bytes`.

On the card every call dispatches its chunks on the verifier's own CUDA
stream and records one event after the verdicts' copy to pinned host
memory; the resolver waits on that event only, then masks with the host
precheck. Coalescing of concurrent small calls, telemetry and the
multi-device mesh come in later slices (`mesh_devices` is always 0).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from tendermint_tpu_torch import native
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519
from tendermint_tpu_torch.types import keys
from tendermint_tpu_torch.utils import device as _device

BATCH_CHUNK = 8192


class BatchVerifier:
    def __init__(self, backend: str = "auto", device=None,
                 auto_threshold: int = 128):
        if backend not in ("auto", "cuda", "python"):
            raise ValueError(
                f"verifier backend must be auto|cuda|python, got {backend!r}")
        self.backend = backend
        self.auto_threshold = auto_threshold
        self.device = None if backend == "python" else _device.resolve(device)
        self.mesh_devices = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None
                        and self.device.type == "cuda" else None)
        self._stats_lock = threading.Lock()
        #: guarded_by _stats_lock
        self.stats = {"calls": 0, "sigs": 0, "cuda_sigs": 0}

    def verify(self, items: Sequence[tuple]) -> np.ndarray:
        """items: (pubkey32, message, signature64) triples -> bool[N]."""
        return self.verify_async(items)()

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        return bool(self.verify([(pubkey, msg, sig)])[0])

    def close(self) -> None:
        """Nothing to stop in this slice (no coalescer thread)."""

    def verify_async(self, items: Sequence[tuple]):
        """Dispatch without waiting; returns a zero-arg resolver of
        bool[N]."""
        n = len(items)
        with self._stats_lock:
            self.stats["calls"] += 1
            self.stats["sigs"] += n
        if n == 0:
            out0 = np.zeros(0, np.bool_)
            return lambda: out0
        if not (self.backend == "cuda" or (
                self.backend == "auto" and n > self.auto_threshold)):
            out1 = np.array(keys.verify_many(items), np.bool_)
            return lambda: out1
        prep = ed25519.prep_items(items)
        if prep is not None:
            return self._dispatch(n, *prep)
        secp_idx = [i for i, it in enumerate(items)
                    if keys.is_secp256k1(it[0])]
        if secp_idx:
            return self._verify_mixed(items, secp_idx)
        pk, rb, sb, hb, pre = ed25519.prepare_batch_bytes(
            [it[0] for it in items], [it[1] for it in items],
            [it[2] for it in items])
        return self._dispatch(n, pk, rb, sb, hb, pre)

    def _verify_mixed(self, items, secp_idx):
        """secp256k1 items on the host now, the rest through verify_async;
        the resolver puts the verdicts back in the items' order."""
        n = len(items)
        secp_ok = {i: keys.verify_any(*items[i]) for i in secp_idx}
        out = np.zeros(n, np.bool_)
        for i, ok in secp_ok.items():
            out[i] = ok
        ed_idx = [i for i in range(n) if i not in secp_ok]
        if not ed_idx:
            return lambda: out
        inner = self.verify_async([items[i] for i in ed_idx])
        with self._stats_lock:
            # this call is already counted
            self.stats["calls"] -= 1
            self.stats["sigs"] -= len(ed_idx)

        def resolve_mixed() -> np.ndarray:
            out[ed_idx] = inner()
            return out

        return resolve_mixed

    def _dispatch(self, n, pk, rb, sb, hb, pre):
        with self._stats_lock:
            self.stats["cuda_sigs"] += n
        if self._stream is None:
            return self._dispatch_cpu(n, pk, rb, sb, hb, pre)
        return self._dispatch_cuda(n, pk, rb, sb, hb, pre)

    def _chunks(self, n, pk, rb, sb, hb):
        out = []
        for lo in range(0, n, BATCH_CHUNK):
            hi = min(lo + BATCH_CHUNK, n)
            out.append((lo, hi, ed25519.verify_prepared_async(
                pk[lo:hi], rb[lo:hi], sb[lo:hi], hb[lo:hi],
                device=self.device)))
        return out

    def _dispatch_cpu(self, n, pk, rb, sb, hb, pre):
        out = np.zeros(n, np.bool_)
        for lo, hi, res in self._chunks(n, pk, rb, sb, hb):
            out[lo:hi] = res.numpy()[:hi - lo]
        out &= pre
        return lambda: out

    def _dispatch_cuda(self, n, pk, rb, sb, hb, pre):
        stream = self._stream
        # the stream waits for work already queued on the caller's stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            pending = self._chunks(n, pk, rb, sb, hb)
            host = []
            for lo, hi, res in pending:
                h = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
                h.copy_(res, non_blocking=True)
                host.append((lo, hi, h))
            done = torch.cuda.Event()
            done.record(stream)

        def resolve() -> np.ndarray:
            done.synchronize()
            out = np.zeros(n, np.bool_)
            for lo, hi, h in host:
                out[lo:hi] = h.numpy()[:hi - lo]
            return out & pre

        return resolve

    def warmup(self, n_sigs: int) -> None:
        """Build the kernels and the host prep extension now, so that no
        verify pays a build, and run the chunk shapes a verify of n_sigs
        items dispatches."""
        if n_sigs <= 0 or self.backend == "python":
            return
        native.module()
        if self.device.type == "cuda":
            _build.ladder_lib()
        shapes = {min(BATCH_CHUNK, n_sigs)}
        tail = n_sigs % BATCH_CHUNK
        if n_sigs > BATCH_CHUNK and tail:
            shapes.add(tail)
        for s in shapes:
            ed25519.verify_batch([b"\x00" * 32] * s, [b""] * s,
                                 [b"\x00" * 64] * s, device=self.device)

    def warmup_buckets(self, max_chunk: int = BATCH_CHUNK) -> None:
        """Run every power-of-two bucket from 512 to max_chunk twice (the
        second pass goes through the predecompressed kernel)."""
        if self.backend == "python":
            return
        b = 512
        while b <= max_chunk:
            for _ in range(2):
                ed25519.verify_batch([b"\x00" * 32] * b, [b""] * b,
                                     [b"\x00" * 64] * b,
                                     device=self.device)
            b *= 2


_default: BatchVerifier | None = None
_default_lock = threading.Lock()


def default_verifier() -> BatchVerifier:
    """Process-wide verifier: backend "auto" on the current CUDA device
    (raises when there is none)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = BatchVerifier("auto")
        return _default


def set_default_verifier(v: BatchVerifier | None) -> None:
    global _default
    with _default_lock:
        _default = v
