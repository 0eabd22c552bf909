"""BatchVerifier: the one signature-verification boundary of the port.

Counterpart of `tendermint_tpu/models/verifier.py`:

    verifier.verify(items: list[(pubkey, msg, sig)]) -> bool[N]

Backends:
  "cuda"    the batch path: host prep, BATCH_CHUNK-sized padded chunks,
            the verify kernels on `device` (their plain versions when the
            device is the CPU, as in the tests).
  "python"  the scalar host loop (types/keys.verify_many).
  "auto"    scalar at or below auto_threshold (TM_CUDA_AUTO_THRESHOLD,
            default 128), batch above: small interactive commits stay
            off the dispatch round trip.

A batch call prepares its items in one native call (`ops/ed25519.
prep_items`). A batch holding secp256k1 keys (33-byte SEC1) is split:
those verify on the host (`types/keys.verify_any`), the rest go through
the same call recursively, and the verdicts are put back in order. Other
batches the native prep declines (members that are not `bytes`) take the
general prep of `ops/ed25519.prepare_batch_bytes`.

On the card every call dispatches its chunks on the verifier's own CUDA
stream and records one event after the verdicts' copy to pinned host
memory; the resolver waits on that event only, then masks with the host
precheck. A launch or a wait that fails raises VerifierError: nothing
falls back to the plain versions, and the consensus state machine and
the fast-sync loop halt on it.

Calls of 1..auto_threshold items route through a DispatchCoalescer
(models/coalescer.py) unless `coalesce` is "off" (the default "auto"
coalesces, as the JAX verifier's does; TM_CUDA_COALESCE wins over the
argument, and TM_CUDA_COALESCE_WAIT_MS / _MAX_BATCH fill a window or an
early-flush size left None): concurrent small calls merge into
one dispatch on the coalescer's thread, each caller getting back its own
verdicts. That thread launches on the verifier's own device and stream.
A merged dispatch that fails is re-run call by call on the same path; a
VerifierError of the device reaches every caller of the merge.

Multi-device: `mesh` ("off" by default; `default_verifier()` takes
TM_CUDA_MESH, default "auto", and a node `base.verifier_mesh`) shards
each chunk over a device mesh (parallel/mesh.py), resolved lazily on the
first batch dispatch: "auto" takes the largest power of two of the
devices present, so one card (or the CPU) stays unsharded; N asks for
N and raises RuntimeError there when fewer are present. Sharded, the
bucket floor is max(8, N), so that every padded chunk, a merged
coalescer dispatch included, divides by the mesh; each shard launches B1
or B2 on its device's own stream (one stream a mesh device, the
coalescer's thread using the same), and its verdicts land in one pinned
host buffer. A failed launch or wait on any device raises VerifierError,
with no fallback to the plain version or to fewer devices.
`mesh_devices` is N once sharded, else 0, and the
`verifier_mesh_devices` gauge follows it.

Telemetry: the JAX verifier's families under the same names, with the
port's backend labels (`cuda` for the batch path, `python` for the host
loop). `verifier_dispatch_seconds` and the causal `verify.dispatch` span
run from the dispatch to the verdicts on the host (after the readback
and the host mask), not to the launch's return. Inside it, the batch
path's causal spans split the time: `verify.prep`, and a chunk's
`verify.rows`, `verify.upload` and `verify.launch` (ops/ed25519), then
`verify.wait` in the resolver. The plain `stats` below are fed at the
same points as the families.

`stats` (under one lock):
  calls            direct dispatches: calls that bypassed the coalescer,
                   merged dispatches and fallback re-dispatches
  direct_calls     verify_async calls that bypassed the coalescer
  coalesced_calls  verify_async calls submitted to the coalescer
  coalesced_dispatches
                   the coalescer's dispatches of this verifier (its
                   merges and their per-call fallbacks). It and
                   direct_calls are counted with `calls`, so
                   calls == direct_calls + coalesced_dispatches holds in
                   any snapshot; the coalescer's own `dispatches +
                   isolated_calls` count the same dispatches under its
                   own lock, each before its dispatch runs
  sigs, cuda_sigs  items dispatched, and of those on the batch path
  empty_calls      direct dispatches of no item (in `calls`; the
                   families count none of them, as in the JAX package)
  dispatch_s       host time of the direct dispatches, on the thread
                   that ran each (the caller's, or the coalescer's for
                   a merged one)
  wait_s           the time each verify_async call's resolver first
                   blocks for its verdicts, on the caller's thread: for
                   a coalesced call the linger, the merged dispatch if
                   it is not done yet, and the device wait
  loop_waits, loop_wait_s
                   those first waits made on a node's event-loop thread
                   (`tm-reactor-loop*`): time the loop was blocked on
                   verdicts, as when the consensus state machine runs
                   inline on a receive
The coalescer's own counts (merged dispatches, calls a merge, fallbacks)
are `coalescer_stats()`.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from tendermint_tpu_torch import native, telemetry
from tendermint_tpu_torch.config import parse_coalesce
from tendermint_tpu_torch.models.coalescer import DispatchCoalescer
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519
from tendermint_tpu_torch.parallel import mesh as _pmesh
from tendermint_tpu_torch.types import keys
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.utils import clock
from tendermint_tpu_torch.utils import device as _device
from tendermint_tpu_torch.utils import knobs

# The JAX verifier's families: batch sizes arriving at the boundary, the
# backend the routing picked, how full the padded chunks run, and the
# dispatch -> resolved-verdicts wall time.
_m_batch_size = telemetry.histogram(
    "verifier_batch_size", "Signatures per verify() call",
    buckets=telemetry.POW2_BUCKETS)
_m_calls = telemetry.counter(
    "verifier_calls_total", "verify() calls by chosen backend",
    ("backend",))
_m_sigs = telemetry.counter(
    "verifier_sigs_total", "Signatures verified by backend", ("backend",))
_m_dispatch = telemetry.histogram(
    "verifier_dispatch_seconds",
    "Wall time from verify dispatch to resolved verdicts", ("backend",))
_m_occupancy = telemetry.histogram(
    "verifier_chunk_occupancy",
    "Per-chunk fill ratio vs the padded power-of-two bucket",
    buckets=telemetry.RATIO_BUCKETS)
_m_mesh_devices = telemetry.gauge(
    "verifier_mesh_devices",
    "Devices in the verifier's active sharding mesh (0 = unsharded)")
# the predecompression cache's outcomes (ops/ed25519._predecomp_note
# feeds them): hit = batch served from cached rows, fill = seen keys
# decompressed once and stored, full = unseen keys on the fused kernel
_m_predecomp = telemetry.counter(
    "verifier_predecomp_batches_total",
    "Device batches through the ed25519 predecompressed-pubkey cache, "
    "by outcome", ("outcome",))
_m_predecomp_evictions = telemetry.counter(
    "verifier_predecomp_evictions_total",
    "Per-pubkey rows evicted from the ed25519 predecompression LRU "
    "(valset churn beyond cache capacity)")
_m_predecomp_keys = telemetry.gauge(
    "verifier_predecomp_keys",
    "Pubkey rows currently resident in the predecompression LRU")

BATCH_CHUNK = 8192
#: the name prefix of a node's event-loop thread (p2p/conn/loop.py)
LOOP_THREAD_PREFIX = "tm-reactor-loop"


class VerifierError(RuntimeError):
    """A batch dispatch or its wait failed on the device."""


def _observed(inner, backend: str, n: int, t0: float, t0_ns: int):
    """The resolver `inner` timed once, on its first call: dispatch
    seconds and the `verify.dispatch` span close when the verdicts are
    on the host."""
    done = []
    lock = threading.Lock()

    def resolve() -> np.ndarray:
        out = inner()
        with lock:
            first = not done
            done.append(True)
        if first:
            dt = time.perf_counter() - t0
            if telemetry.enabled():
                _m_dispatch.labels(backend).observe(dt)
            if causal.enabled():
                causal.record("verify.dispatch", -1, t0_ns=t0_ns,
                              dur_ns=int(dt * 1e9), n=n, backend=backend)
        return out

    return resolve


def _merge_counts(a: dict, b: dict) -> dict:
    """Two coalescers' counts as one: sums, and maxima for *_max."""
    return {k: max(a[k], b[k]) if k.endswith("_max") else a[k] + b[k]
            for k in a}


class BatchVerifier:
    def __init__(self, backend: str = "auto", device=None,
                 auto_threshold: int | None = None,
                 coalesce: str | None = None,
                 coalesce_wait_ms: float | None = None,
                 coalesce_max_batch: int | None = None, mesh: str = "off"):
        if backend not in ("auto", "cuda", "python"):
            raise ValueError(
                f"verifier backend must be auto|cuda|python, got {backend!r}")
        self.backend = backend
        # None reads the knob (default 128); an explicit value wins
        if auto_threshold is None:
            auto_threshold = knobs.knob_int("TM_CUDA_AUTO_THRESHOLD",
                                            default=128)
        self.auto_threshold = auto_threshold
        self.device = None if backend == "python" else _device.resolve(device)
        # eager: a config or env typo fails here, at startup
        self.mesh = _pmesh.parse_mesh_spec(mesh)
        self.mesh_devices = 0   # N >= 2 once a mesh is resolved
        self._mesh_resolved = self.mesh == "off" or self.device is None
        self._mesh_kernel = None  # sharded_verify_kernel of the mesh
        self._streams = None      # one stream a mesh device, on a card
        self._min_bucket = 8
        if telemetry.enabled():
            _m_mesh_devices.set(self.mesh_devices)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None
                        and self.device.type == "cuda" else None)
        # the coalescing mode: TM_CUDA_COALESCE wins over the argument
        # (an operator's "off" silences any config); the window and the
        # early-flush size: an explicit argument wins, None reads the knob
        self.coalesce = parse_coalesce(knobs.knob_str(
            "TM_CUDA_COALESCE", config=coalesce, default="auto"))
        if coalesce_wait_ms is None:
            coalesce_wait_ms = knobs.knob_float("TM_CUDA_COALESCE_WAIT_MS",
                                                default=2.0)
        if coalesce_max_batch is None:
            coalesce_max_batch = knobs.knob_int(
                "TM_CUDA_COALESCE_MAX_BATCH", default=0)
        if coalesce_wait_ms < 0:
            raise ValueError(f"coalesce wait must be >= 0 ms, got "
                             f"{coalesce_wait_ms}")
        self._coalesce_wait_s = coalesce_wait_ms / 1e3
        self._coalesce_max_batch = int(coalesce_max_batch) or BATCH_CHUNK
        self._coalescer = None  #: guarded_by _resolve_lock
        #: the counts of coalescers closed before; guarded_by _resolve_lock
        self._retired = dict.fromkeys(DispatchCoalescer.STATS, 0)
        self._resolve_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        #: guarded_by _stats_lock (see the module docstring)
        self.stats = {"calls": 0, "direct_calls": 0, "coalesced_calls": 0,
                      "coalesced_dispatches": 0,
                      "sigs": 0, "cuda_sigs": 0, "empty_calls": 0,
                      "dispatch_s": 0.0,
                      "wait_s": 0.0, "loop_waits": 0, "loop_wait_s": 0.0}

    def _resolve_mesh(self) -> None:
        """Build the mesh on the first batch dispatch. Thread-safe:
        concurrent verify calls (reactor windows, evidence, RPC, the
        coalescer) never dispatch with a half-set kernel and bucket
        floor. An explicit N above the devices present raises
        RuntimeError before the mesh counts as resolved."""
        with self._resolve_lock:
            if self._mesh_resolved:
                return
            kind = self.device.type
            n = _pmesh.resolve_mesh_size(
                self.mesh, len(_pmesh.logical_devices(kind)))
            if n >= 2:
                mesh = _pmesh.make_mesh(n, kind)
                self._mesh_kernel = _pmesh.sharded_verify_kernel(mesh)
                if kind == "cuda":
                    self._streams = [torch.cuda.Stream(d)
                                     for d in mesh.devices]
                self._min_bucket = max(8, n)
                self.mesh_devices = n
            if telemetry.enabled():
                _m_mesh_devices.set(self.mesh_devices)
            self._mesh_resolved = True

    def verify(self, items: Sequence[tuple]) -> np.ndarray:
        """items: (pubkey32, message, signature64) triples -> bool[N]."""
        return self.verify_async(items)()

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        return bool(self.verify([(pubkey, msg, sig)])[0])

    def close(self) -> None:
        """Stop the coalescer's dispatcher, if one was started. The
        verifier stays usable: a later coalesced call starts a fresh
        one."""
        with self._resolve_lock:
            c, self._coalescer = self._coalescer, None
        if c is not None:
            c.close()
            with self._resolve_lock:
                self._retired = _merge_counts(self._retired, c.snapshot())

    def coalescer_stats(self) -> dict:
        """The coalescer's counts, those of coalescers closed before
        included (zeros before the first coalesced call)."""
        with self._resolve_lock:
            c, retired = self._coalescer, dict(self._retired)
        return retired if c is None else _merge_counts(retired,
                                                        c.snapshot())

    def _coalescer_get(self) -> DispatchCoalescer:
        with self._resolve_lock:
            if self._coalescer is None:
                self._coalescer = DispatchCoalescer(
                    # looked up at each dispatch, so that a wrapper of
                    # the instance's direct path sees merged dispatches
                    lambda items: self._verify_async_direct(
                        items, "coalesced_dispatches"),
                    max_batch=self._coalesce_max_batch,
                    max_wait_s=self._coalesce_wait_s)
            return self._coalescer

    def verify_async(self, items: Sequence[tuple]):
        """Dispatch without waiting; returns a zero-arg resolver of
        bool[N]. Calls of 1..auto_threshold items go through the
        coalescer unless coalesce is "off"."""
        n = len(items)
        coalesced = self.coalesce != "off" and 0 < n <= self.auto_threshold
        if coalesced:
            with self._stats_lock:
                self.stats["coalesced_calls"] += 1
            inner = self._coalescer_get().submit(items)
        else:
            inner = self._verify_async_direct(items, "direct_calls")
        timed = []

        def resolve() -> np.ndarray:
            t1 = time.perf_counter()
            out = inner()
            if not timed:
                timed.append(True)
                dt = time.perf_counter() - t1
                on_loop = threading.current_thread().name.startswith(
                    LOOP_THREAD_PREFIX)
                with self._stats_lock:
                    self.stats["wait_s"] += dt
                    if on_loop:
                        self.stats["loop_waits"] += 1
                        self.stats["loop_wait_s"] += dt
            return out

        return resolve

    def _verify_async_direct(self, items: Sequence[tuple],
                             path: str = ""):
        """The non-coalescing dispatch (also the coalescer's merge
        target: it never re-enters verify_async). `path` names the stat
        that counts this dispatch by its path ("direct_calls" or
        "coalesced_dispatches"), bumped with `calls` under one lock."""
        t0 = time.perf_counter()
        inner = self._verify_async(items, path)
        with self._stats_lock:
            self.stats["dispatch_s"] += time.perf_counter() - t0
        return inner

    def _verify_async(self, items: Sequence[tuple], path: str = "",
                      count: bool = True):
        n = len(items)
        with self._stats_lock:
            if count:
                self.stats["calls"] += 1
                self.stats["sigs"] += n
            if path:
                self.stats[path] += 1
        if n == 0:
            with self._stats_lock:
                self.stats["empty_calls"] += 1
            out0 = np.zeros(0, np.bool_)
            return lambda: out0
        t0, t0_ns = time.perf_counter(), clock.wall_ns()
        _m_batch_size.observe(n)
        if not (self.backend == "cuda" or (
                self.backend == "auto" and n > self.auto_threshold)):
            out1 = np.array(keys.verify_many(items), np.bool_)
            if telemetry.enabled():
                _m_calls.labels("python").inc()
                _m_sigs.labels("python").inc(n)
            return _observed(lambda: out1, "python", n, t0, t0_ns)
        prep = ed25519.prep_items(items)
        if prep is not None:
            return _observed(self._dispatch(n, *prep), "cuda", n, t0, t0_ns)
        secp_idx = [i for i, it in enumerate(items)
                    if keys.is_secp256k1(it[0])]
        if secp_idx:
            return self._verify_mixed(items, secp_idx)
        pk, rb, sb, hb, pre = ed25519.prepare_batch_bytes(
            [it[0] for it in items], [it[1] for it in items],
            [it[2] for it in items])
        return _observed(self._dispatch(n, pk, rb, sb, hb, pre), "cuda", n,
                         t0, t0_ns)

    def _verify_mixed(self, items, secp_idx):
        """secp256k1 items on the host now, the rest through the batch
        path; the resolver puts the verdicts back in the items' order."""
        n = len(items)
        secp_ok = {i: keys.verify_any(*items[i]) for i in secp_idx}
        out = np.zeros(n, np.bool_)
        for i, ok in secp_ok.items():
            out[i] = ok
        ed_idx = [i for i in range(n) if i not in secp_ok]
        if not ed_idx:
            return lambda: out
        # this call is already counted
        inner = self._verify_async([items[i] for i in ed_idx], count=False)

        def resolve_mixed() -> np.ndarray:
            out[ed_idx] = inner()
            return out

        return resolve_mixed

    def _dispatch(self, n, pk, rb, sb, hb, pre):
        if not self._mesh_resolved:
            self._resolve_mesh()
        with self._stats_lock:
            self.stats["cuda_sigs"] += n
        if telemetry.enabled():
            _m_calls.labels("cuda").inc()
            _m_sigs.labels("cuda").inc(n)
        if self._stream is None:
            return self._dispatch_cpu(n, pk, rb, sb, hb, pre)
        try:
            inner = self._dispatch_cuda(n, pk, rb, sb, hb, pre)
        except RuntimeError as e:
            raise VerifierError(f"verify dispatch failed on "
                                f"{self.device}: {e}") from e

        def resolve() -> np.ndarray:
            try:
                return inner()
            except RuntimeError as e:
                raise VerifierError(f"verify failed on {self.device}: "
                                    f"{e}") from e

        return resolve

    def _chunks(self, n, pk, rb, sb, hb):
        """(lo, hi, verdicts) a BATCH_CHUNK chunk: a bool tensor on the
        device, or with a mesh the chunk's ShardedVerdicts."""
        out = []
        for lo in range(0, n, BATCH_CHUNK):
            hi = min(lo + BATCH_CHUNK, n)
            b = ed25519._bucket(hi - lo, min_size=self._min_bucket)
            if telemetry.enabled():
                _m_occupancy.observe((hi - lo) / b)
            args = (pk[lo:hi], rb[lo:hi], sb[lo:hi], hb[lo:hi])
            if self.mesh_devices >= 2:
                _pmesh.record_dispatch("verify", hi - lo, b)
                res = self._mesh_kernel(*args, streams=self._streams)
            else:
                res = ed25519.verify_prepared_async(*args,
                                                    device=self.device)
            out.append((lo, hi, res))
        return out

    def _dispatch_cpu(self, n, pk, rb, sb, hb, pre):
        pending = self._chunks(n, pk, rb, sb, hb)

        def resolve() -> np.ndarray:
            with causal.span("verify.wait", -1, n=n):
                out = np.zeros(n, np.bool_)
                for lo, hi, res in pending:
                    got = res.result() if self.mesh_devices >= 2 \
                        else res.numpy()
                    out[lo:hi] = got[:hi - lo]
                return out & pre

        return resolve

    def _dispatch_mesh_cuda(self, n, pk, rb, sb, hb, pre):
        # each shard runs on its device's stream, which waits for that
        # device's current stream (parallel/mesh.sharded_verify_kernel)
        pending = self._chunks(n, pk, rb, sb, hb)

        def resolve() -> np.ndarray:
            with causal.span("verify.wait", -1, n=n):
                out = np.zeros(n, np.bool_)
                for lo, hi, res in pending:
                    out[lo:hi] = res.result()[:hi - lo]
                return out & pre

        return resolve

    def _dispatch_cuda(self, n, pk, rb, sb, hb, pre):
        if self.mesh_devices >= 2:
            return self._dispatch_mesh_cuda(n, pk, rb, sb, hb, pre)
        stream = self._stream
        # the current device and stream are per thread, and a merged
        # dispatch runs on the coalescer's: both are named explicitly.
        # The stream waits for work already queued on the caller's.
        with torch.cuda.device(self.device):
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                pending = self._chunks(n, pk, rb, sb, hb)
                host = []
                for lo, hi, res in pending:
                    h = torch.empty(res.shape, dtype=res.dtype,
                                    pin_memory=True)
                    h.copy_(res, non_blocking=True)
                    host.append((lo, hi, h))
                done = torch.cuda.Event()
                done.record(stream)

        def resolve() -> np.ndarray:
            with causal.span("verify.wait", -1, n=n):
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
        if not self._mesh_resolved:
            self._resolve_mesh()
        if not native.disabled():
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
    """Process-wide verifier: the backend from TM_CUDA_VERIFIER
    (auto|cuda|python, default auto) on the current CUDA device (raises
    when there is none, but for "python"), the threshold and coalescing
    from their knobs, the mesh from TM_CUDA_MESH (auto|off|N, default
    auto: sharded over every card of a multi-card host, unsharded on
    one)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = BatchVerifier(
                knobs.knob_str("TM_CUDA_VERIFIER", default="auto"),
                mesh=knobs.knob_str("TM_CUDA_MESH", default="auto"))
        return _default


def set_default_verifier(v: BatchVerifier | None) -> None:
    global _default
    with _default_lock:
        _default = v
