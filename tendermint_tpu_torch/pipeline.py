"""The pipelined block hot path: the mode, stage accounting and group
commit. The port's copy of `tendermint_tpu/pipeline.py`.

Everything between "block decided" and "next height proposable" runs,
on the serial path, as sequential Python: serialize, split and hash the
part set, gossip the parts, ApplyBlock, then a store commit for each
write. With the pipeline on (config.base.pipeline "auto" or "on", the
default) consensus/state.py builds the part set natively and gossips it
as it streams, precomputes the next proposal on a worker, and commits a
height's store writes as one group. "off" keeps every call site on the
serial code byte for byte.

- `configure()` / `resolve()`: the mode, TM_CUDA_PIPELINE over
  config.base.pipeline (node.py configures it) over "auto".
- stage accounting: `stage_timer` / `observe_stage` sum the seconds of
  each per-height stage (serialize | partset | gossip | apply | persist
  | precompute), `note_precompute` counts the precompute outcomes (used
  | discarded | failed), `observe_overlap` sums a commit's overlapped
  seconds against its serial ones (the overlap ratio: overlapped over
  overlapped plus serial, as the JAX package defines it), and
  `note_flush` counts group flushes. `stats()` reads them all, as
  `coalescer_stats()` reads the coalescer's. The JAX package's families
  (`pipeline_stage_seconds`, `pipeline_overlap_ratio`,
  `pipeline_precompute_total`) are fed at the same points.
- `GroupCommit`: every store write of a height (save_block,
  save_abci_responses, save_state) staged into one `StagedDB` a db and
  flushed as one batch each, in registration order (the block store
  before the state store: the ABCI handshake tolerates store == state +
  1 but not state ahead of store), then the side effects deferred with
  `after_flush`. The caller writes the height's ENDHEIGHT marker (its
  one WAL fsync) only after flush() returns.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.storage.db import KVStore, StagedDB
from tendermint_tpu_torch.utils import knobs

_m_stage = telemetry.histogram(
    "pipeline_stage_seconds",
    "Per-height hot-path stage wall time (serialize | partset | gossip "
    "| apply | persist | precompute)", ("stage",))
_m_overlap = telemetry.histogram(
    "pipeline_overlap_ratio",
    "Per commit: fraction of stage time overlapped off the critical "
    "path (0 = fully serial)")
_m_precompute = telemetry.counter(
    "pipeline_precompute_total",
    "Next-proposal precompute outcomes", ("outcome",))

STAGES = ("serialize", "partset", "gossip", "apply", "persist",
          "precompute")
PRECOMPUTE_OUTCOMES = ("used", "discarded", "failed")

# config.base.pipeline, as node.py configured it
_configured = "auto"

_lock = threading.Lock()
_stats = {"stage_s": {s: 0.0 for s in STAGES},
          "stage_n": {s: 0 for s in STAGES},
          "precompute": {o: 0 for o in PRECOMPUTE_OUTCOMES},
          "group_flushes": 0, "overlapped_s": 0.0, "serial_s": 0.0}


def configure(mode: str = "auto") -> None:
    global _configured
    _configured = str(mode or "auto").strip().lower()


def resolve() -> bool:
    """True when the pipelined hot path is on: TM_CUDA_PIPELINE >
    config.base.pipeline > "auto" (on); any spelling that is not off
    enables."""
    return knobs.knob_str("TM_CUDA_PIPELINE", config=_configured,
                          default="auto") not in knobs.FALSY


def observe_stage(stage: str, seconds: float) -> None:
    if telemetry.enabled():
        _m_stage.labels(stage).observe(seconds)
    with _lock:
        _stats["stage_s"][stage] += seconds
        _stats["stage_n"][stage] += 1


def observe_overlap(overlapped_s: float, total_s: float) -> None:
    """One commit's stage seconds off the critical path (`overlapped_s`)
    out of all its stage seconds (`total_s`)."""
    if telemetry.enabled() and total_s > 0:
        _m_overlap.observe(min(1.0, max(0.0, overlapped_s / total_s)))
    if total_s > 0:
        with _lock:
            _stats["overlapped_s"] += overlapped_s
            _stats["serial_s"] += total_s - overlapped_s


def note_precompute(outcome: str) -> None:
    """outcome: used | discarded | failed."""
    if telemetry.enabled():
        _m_precompute.labels(outcome).inc()
    with _lock:
        _stats["precompute"][outcome] += 1


def note_flush() -> None:
    with _lock:
        _stats["group_flushes"] += 1


def stats() -> dict:
    """The counts since the process started: the mode, group_flushes,
    stage_ms and stage_n by stage, precompute outcomes, and overlap_ratio
    (overlapped over overlapped plus serial seconds, summed over the
    commits)."""
    with _lock:
        s = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in _stats.items()}
    total = s["overlapped_s"] + s["serial_s"]
    return {"mode": "on" if resolve() else "off",
            "group_flushes": s["group_flushes"],
            "stage_ms": {k: 1e3 * v for k, v in s["stage_s"].items()},
            "stage_n": s["stage_n"], "precompute": s["precompute"],
            "overlap_ratio": s["overlapped_s"] / total if total else 0.0}


class stage_timer:
    """`with stage_timer("apply"):` one observation a block."""

    def __init__(self, stage: str):
        self.stage = stage
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if exc[0] is None:
            observe_stage(self.stage, self.seconds)
        return False


class GroupCommit:
    """One height's store writes, staged and flushed as one batch a db.
    The flush follows registration order: the caller stages the block
    store before the state store, so a crash between the two db commits
    leaves store_height == state_height + 1 (the handshake's
    replay-forward case), never the state ahead of the store."""

    def __init__(self):
        self._order: List[StagedDB] = []
        self._by_id: dict = {}
        self._after: List[Callable[[], None]] = []

    def staged(self, db: KVStore) -> StagedDB:
        """The staging view of `db`: one a store, however many times it
        is asked for (block and state stores on one db flush as one
        batch)."""
        w = self._by_id.get(id(db))
        if w is None:
            w = StagedDB(db)
            self._by_id[id(db)] = w
            self._order.append(w)
        return w

    def after_flush(self, fn: Callable[[], None]) -> None:
        """Defer a side effect (the event fan-out) until the height's
        writes are durable: subscribers never see a block the stores
        could still lose to a crash."""
        self._after.append(fn)

    def flush(self) -> None:
        for w in self._order:
            w.flush_into_inner()
        note_flush()
        after, self._after = self._after, []
        for fn in after:
            fn()
