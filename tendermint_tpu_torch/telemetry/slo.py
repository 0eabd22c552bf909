"""Tx-lifecycle SLO plane — per-transaction latency from the RPC front
door to event delivery.

Every measurement plane before this one observes NODE-INTERNAL phases
(height spans, CPU shares, queue depths). This module observes the
USER-VISIBLE unit of work: one transaction's journey

    admit    broadcast_tx_* accepted at the RPC front door
    checktx  the mempool's app CheckTx said OK
    propose  the tx appeared in a (received or self-built) proposal
             block
    commit   the tx's block finalized (the post-commit boundary in
             consensus/state.py)
    publish  the tx's EventTx hit the EventBus (after the group flush
             in pipelined mode — subscribers never see an uncommitted
             block)
    deliver  the EventTx was written into a WebSocket subscriber's
             send buffer (loop-native fan-out or the threaded pump)

Sampling is DETERMINISTIC and hash-based: a tx is tracked iff the
first 8 bytes of its sha256 fall under ``TM_CUDA_SLO_SAMPLE`` * 2^64,
so every node of a cluster samples the SAME txs and a cross-node
report (merge_snapshots) joins naturally. Stage stamps use
``utils/clock.monotonic_ns`` (``time.monotonic_ns`` unless a test
pins it) — per-process monotonic by construction, and the
tracker still counts any ordering violation it ever observes
(``monotonic_violations``, asserted zero by the bench).

Each leg (stage N-1 -> stage N, plus the two end-to-end aggregates
``e2e_commit`` and ``e2e_delivery``) records into a per-stage
QuantileSketch (telemetry/registry.py — exact until cap, bounded rank
error after) AND into a rolling ring that serves 1s/10s/60s windowed
quantiles. Tail attribution joins the completed-tx ring against the
causal span plane: for the txs at or above the e2e p99, which leg
dominated, and (when TM_CUDA_TRACE is on) how their commit heights'
consensus sub-stages break down.

``TM_CUDA_SLO=off`` (the default) is the zero-overhead contract every
prior knob honors: every public entry point reduces to one cached
flag check, no tx is ever hashed, and nothing touches the wire (this
plane never stamps envelopes at all)."""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.telemetry.registry import quantile_of_items
from tendermint_tpu_torch.utils import clock, knobs

#: stage order IS the lifecycle: a later stamp closes the leg from the
#: nearest EARLIER stamped stage (intermediate stages may be missing —
#: e.g. a tx that arrived by gossip has no local admit).
STAGES = ("admit", "checktx", "propose", "commit", "publish", "deliver")
_STAGE_IDX = {s: i for i, s in enumerate(STAGES)}

#: leg series (keyed by the stage that CLOSES the leg) + the two
#: end-to-end aggregates the bench extractors gate on.
SERIES = STAGES[1:] + ("e2e_commit", "e2e_delivery")

QUANTILES = (0.5, 0.95, 0.99, 0.999)
_QLABEL = {0.5: "p50_ms", 0.95: "p95_ms", 0.99: "p99_ms",
           0.999: "p999_ms"}
WINDOWS_S = (1.0, 10.0, 60.0)

INFLIGHT_CAP = 16384      # sampled txs tracked concurrently
ENTRY_TIMEOUT_S = 120.0   # sampled tx never delivered: expire + count
WINDOW_RING_CAP = 8192    # samples kept per series for window queries
COMPLETED_RING_CAP = 2048  # finished txs kept for tail attribution
SKETCH_CAP = 512

_m_stage = telemetry.summary(
    "slo_stage_seconds",
    "Per-transaction lifecycle leg latency (sampled txs), by the stage "
    "that closes the leg; e2e_commit/e2e_delivery are admit-anchored. "
    "The chain label is shard attribution: stamped at admit by the "
    "server-side router/core (bounded — never a client string), \"\" "
    "for gossip-arrived or unsharded traffic",
    ("stage", "chain"), quantiles=QUANTILES, cap=SKETCH_CAP)
_m_sampled = telemetry.counter(
    "slo_sampled_total", "Transactions admitted into the SLO tracker")
_m_completed = telemetry.counter(
    "slo_completed_total",
    "Sampled transactions that reached event delivery")
_m_dropped = telemetry.counter(
    "slo_dropped_total",
    "Sampled transactions evicted before delivery, by reason",
    ("reason",))
_m_inflight = telemetry.gauge(
    "slo_inflight", "Sampled transactions currently being tracked")

# config.base.slo / slo_sample snapshots (node.py configure()); env
# wins inside the resolvers, so components built without a Node honor
# the knobs too.
_configured_mode = "off"
_configured_sample: Optional[float] = None

# hot-path cache: one attribute load when off (resolved lazily so
# env changes before first use are honored; reset() clears it)
_on_cache: Optional[bool] = None
_rate_cache: Optional[float] = None


def configure(mode: str = "off", sample: Optional[float] = None) -> None:
    global _configured_mode, _configured_sample, _on_cache, _rate_cache
    _configured_mode = str(mode or "off").strip().lower()
    _configured_sample = sample
    _on_cache = None
    _rate_cache = None


def enabled() -> bool:
    """True when the SLO plane tracks. env TM_CUDA_SLO >
    config.base.slo > default off. Any FALSY spelling disables."""
    global _on_cache
    if _on_cache is None:
        _on_cache = knobs.knob_str(
            "TM_CUDA_SLO", config=_configured_mode,
            default="off") not in knobs.FALSY
    return _on_cache


def sample_rate() -> float:
    """Sampling probability in [0, 1]. env TM_CUDA_SLO_SAMPLE >
    config.base.slo_sample > 1.0 (track every tx while on)."""
    global _rate_cache
    if _rate_cache is None:
        r = knobs.knob_float("TM_CUDA_SLO_SAMPLE",
                             config=_configured_sample, default=1.0)
        _rate_cache = min(1.0, max(0.0, r))
    return _rate_cache


def sampled(digest: bytes) -> bool:
    """Deterministic hash-based sampling decision: same tx digest =>
    same verdict on every node (the cross-node join contract)."""
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int.from_bytes(digest[:8], "big") < int(rate * (1 << 64))


def tx_key(tx: bytes) -> str:
    """The tracker key: uppercase sha256 hex — identical to the
    EventBus TagTxHash, so delivery marking is a dict lookup."""
    return hashlib.sha256(tx).hexdigest().upper()


class _Entry:
    __slots__ = ("stamps", "height", "chain")

    def __init__(self, t_ns: int, chain: str = ""):
        self.stamps: Dict[str, int] = {"admit": t_ns}
        self.height = 0
        self.chain = chain


class _Series:
    """One leg's latency record: cumulative sketch + rolling ring."""

    __slots__ = ("sketch", "ring")

    def __init__(self):
        self.sketch = telemetry.QuantileSketch(SKETCH_CAP)
        self.ring: deque = deque(maxlen=WINDOW_RING_CAP)

    def observe(self, now_s: float, seconds: float) -> None:
        self.sketch.observe(seconds)
        self.ring.append((now_s, seconds))


class SLOTracker:
    """Process-global lifecycle tracker. All mutation under one lock;
    entry points are cheap no-ops while the plane is off. In-process
    multi-node testnets share one tracker (stamps are first-wins
    idempotent, so the earliest node to reach a stage defines it)."""

    def __init__(self, now_ns=clock.monotonic_ns,
                 inflight_cap: int = INFLIGHT_CAP,
                 timeout_s: float = ENTRY_TIMEOUT_S):
        self._now_ns = now_ns
        self.inflight_cap = int(inflight_cap)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._inflight: "OrderedDict[str, _Entry]" = OrderedDict()
        self._series: Dict[str, _Series] = {s: _Series() for s in SERIES}
        self._completed: deque = deque(maxlen=COMPLETED_RING_CAP)
        self._drops: deque = deque(maxlen=WINDOW_RING_CAP)
        self._ops_since_sweep = 0
        self.sampled_total = 0
        self.completed_total = 0
        # shard attribution: per-chain sampled/completed
        # counts — keys only ever come from server-side admit(chain=)
        self.sampled_by_chain: Dict[str, int] = {}
        self.completed_by_chain: Dict[str, int] = {}
        # overflow: evicted by the in-flight cap; timeout: expired
        # before COMMITTING (a real SLO failure); undelivered: expired
        # after committing (no Tx subscriber was listening — accounted,
        # but not a health failure)
        self.dropped = {"overflow": 0, "timeout": 0, "undelivered": 0}
        self.timeout_last_stage: Dict[str, int] = {}
        self.monotonic_violations = 0

    # ------------------------------------------------------------ stamps

    def admit(self, tx: bytes, chain: str = "") -> None:
        """Front-door admission (broadcast_tx_* entry). `chain` is
        shard attribution, supplied by the SERVER (the router's
        mapping or the core's own genesis chain id — bounded, never a
        client-minted string)."""
        if not enabled():
            return
        digest = hashlib.sha256(tx).digest()
        if not sampled(digest):
            return
        key = digest.hex().upper()
        now = self._now_ns()
        with self._lock:
            if key in self._inflight:
                return  # resubmission: the first journey stands
            while len(self._inflight) >= self.inflight_cap:
                old_key, old = self._inflight.popitem(last=False)
                self._account_drop("overflow", old, now)
            self._inflight[key] = _Entry(now, chain)
            self.sampled_total += 1
            if chain:
                self.sampled_by_chain[chain] = \
                    self.sampled_by_chain.get(chain, 0) + 1
            self._maybe_sweep(now)
        _m_sampled.inc()
        _m_inflight.set(len(self._inflight))

    def admit_many(self, txs, chain: str = "") -> None:
        if not enabled():
            return
        for tx in txs:
            self.admit(tx, chain=chain)

    def mark(self, tx: bytes, stage: str, height: int = 0) -> None:
        if not enabled() or not self._inflight:
            return
        self.mark_hex(tx_key(tx), stage, height)

    def mark_many(self, txs, stage: str, height: int = 0) -> None:
        """Stamp a whole block's txs (proposal inclusion / commit).
        Short-circuits before hashing anything when nothing is
        tracked — the common case off the sampled front door."""
        if not enabled() or not self._inflight:
            return
        for tx in txs:
            self.mark_hex(tx_key(tx), stage, height)

    def mark_hex(self, key: str, stage: str, height: int = 0) -> None:
        """Stamp one stage for a tracked tx (idempotent, first wins).
        Closes the leg from the nearest earlier stamped stage and, at
        commit/deliver, the admit-anchored end-to-end aggregate."""
        if not enabled() or not self._inflight:
            return
        idx = _STAGE_IDX.get(stage)
        if idx is None:
            raise ValueError(f"unknown SLO stage {stage!r} "
                             f"(catalog: {STAGES})")
        now = self._now_ns()
        now_s = now / 1e9
        legs: List[tuple] = []
        done = None
        chain = ""
        with self._lock:
            e = self._inflight.get(key)
            if e is None or stage in e.stamps:
                return
            chain = e.chain
            prev_t = None
            for s in STAGES[idx - 1::-1]:
                if s in e.stamps:
                    prev_t = e.stamps[s]
                    break
            e.stamps[stage] = now
            if height and not e.height:
                e.height = height
            if prev_t is not None:
                if now < prev_t:
                    self.monotonic_violations += 1
                legs.append((stage, max(0, now - prev_t)))
            if stage == "commit":
                legs.append(("e2e_commit", now - e.stamps["admit"]))
            elif stage == "deliver":
                legs.append(("e2e_delivery", now - e.stamps["admit"]))
                done = self._finalize(key, e, now)
            for name, dur_ns in legs:
                self._series[name].observe(now_s, dur_ns / 1e9)
            self._maybe_sweep(now)
        for name, dur_ns in legs:
            _m_stage.labels(name, chain).observe(dur_ns / 1e9)
        if done is not None:
            _m_completed.inc()
            _m_inflight.set(len(self._inflight))
            self._causal_point(done)

    def deliver_item(self, item) -> None:
        """Delivery stamp from an EventTx actually written to a
        subscriber (loop fan-out drain / threaded pump). Cheap for
        non-Tx events: two dict lookups."""
        if not enabled() or not self._inflight:
            return
        tags = getattr(item, "tags", None)
        if not tags or tags.get("tm.event") != "Tx":
            return
        key = tags.get("tx.hash")
        if key:
            self.mark_hex(str(key), "deliver",
                          int(tags.get("tx.height") or 0))

    # ---------------------------------------------------------- internal

    def _finalize(self, key: str, e: _Entry, now: int) -> dict:
        """_lock held. Move a delivered tx to the completed ring."""
        self._inflight.pop(key, None)
        self.completed_total += 1
        if e.chain:
            self.completed_by_chain[e.chain] = \
                self.completed_by_chain.get(e.chain, 0) + 1
        admit = e.stamps["admit"]
        legs_ms = {}
        prev = admit
        for s in STAGES[1:]:
            t = e.stamps.get(s)
            if t is None:
                continue
            legs_ms[s] = round((t - prev) / 1e6, 3)
            prev = t
        rec = {"hash": key[:16], "h": e.height, "legs_ms": legs_ms,
               "total_ms": round((now - admit) / 1e6, 3),
               "t_s": now / 1e9}
        self._completed.append(rec)
        return rec

    def _account_drop(self, reason: str, e: _Entry, now: int) -> None:
        """_lock held."""
        self.dropped[reason] += 1
        last = max(e.stamps, key=lambda s: _STAGE_IDX[s])
        self.timeout_last_stage[last] = \
            self.timeout_last_stage.get(last, 0) + 1
        self._drops.append((now / 1e9, reason))
        _m_dropped.labels(reason).inc()

    def _maybe_sweep(self, now: int) -> None:
        """_lock held. Amortized expiry of txs that will never finish
        (no subscriber, lost to a mempool eviction...) — no reaper
        thread, just bookkeeping every 256 ops."""
        self._ops_since_sweep += 1
        if self._ops_since_sweep < 256:
            return
        self._ops_since_sweep = 0
        horizon = now - int(self.timeout_s * 1e9)
        for key in [k for k, e in self._inflight.items()
                    if e.stamps["admit"] < horizon]:
            e = self._inflight.pop(key)
            self._account_drop(
                "undelivered" if "commit" in e.stamps else "timeout",
                e, now)

    def sweep(self) -> None:
        """Force the amortized expiry pass now (tests / /slo scrape)."""
        with self._lock:
            self._ops_since_sweep = 256
            self._maybe_sweep(self._now_ns())

    def _causal_point(self, rec: dict) -> None:
        """Join artifact for the causal span plane: one slo.sample point
        per completed tx at its commit height, so a merged cluster
        timeline can overlay user-visible latency on consensus spans."""
        from tendermint_tpu_torch.telemetry import causal
        if causal.enabled() and rec["h"]:
            causal.point("slo.sample", rec["h"], tx=rec["hash"],
                         total_ms=rec["total_ms"])

    # ------------------------------------------------------------- query

    def _quantiles_ms(self, items) -> dict:
        return {_QLABEL[q]:
                round(quantile_of_items(items, q) * 1e3, 3)
                if items else None for q in QUANTILES}

    def snapshot(self, windows: bool = True,
                 sketches: bool = False) -> dict:
        """The /slo payload: per-series cumulative quantiles, rolling
        windows, in-flight/drop/timeout accounting, tail attribution,
        and the health verdict. `sketches` adds the mergeable weighted
        samples merge_snapshots concatenates across nodes."""
        from tendermint_tpu_torch.telemetry import causal
        if not enabled():
            return {"enabled": False, "node": causal.node()}
        self.sweep()   # a scrape must see timeouts even while idle
        with self._lock:
            series = {name: list(s.ring)
                      for name, s in self._series.items()}
            doc = {
                "enabled": True,
                "node": causal.node(),
                "sample_rate": sample_rate(),
                "in_flight": len(self._inflight),
                "sampled_total": self.sampled_total,
                "completed_total": self.completed_total,
                "dropped": dict(self.dropped),
                "timeout_last_stage": dict(self.timeout_last_stage),
                "monotonic_violations": self.monotonic_violations,
            }
            if self.sampled_by_chain:
                doc["chains"] = {
                    chain: {"sampled": n,
                            "completed":
                                self.completed_by_chain.get(chain, 0)}
                    for chain, n in sorted(self.sampled_by_chain.items())}
            sketch_items = {name: s.sketch.items()
                            for name, s in self._series.items()}
            counts = {name: s.sketch.count
                      for name, s in self._series.items()}
        doc["stages"] = {
            name: {"count": counts[name],
                   **self._quantiles_ms(sketch_items[name])}
            for name in SERIES if counts[name]}
        if windows:
            now_s = self._now_ns() / 1e9
            doc["windows"] = {}
            for w in WINDOWS_S:
                horizon = now_s - w
                wdoc = {}
                for name in SERIES:
                    vals = [(v, 1) for t, v in series[name]
                            if t >= horizon]
                    if vals:
                        wdoc[name] = {"count": len(vals),
                                      **self._quantiles_ms(vals)}
                doc["windows"][f"{int(w)}s"] = wdoc
        if sketches:
            doc["sketches"] = {
                name: [[round(v, 9), w] for v, w in items]
                for name, items in sketch_items.items() if items}
        doc["attribution"] = self.tail_attribution()
        doc["verdict"] = self.verdict()
        return doc

    def tail_attribution(self, q: float = 0.99,
                         min_completed: int = 20) -> dict:
        """Which stage do the slowest txs spend their time in? Takes
        the completed txs at or above the e2e `q`-quantile, averages
        their per-leg shares, and names the dominant leg. When the
        causal plane is on, the tail heights' consensus sub-stages
        (first part -> full block -> quorums -> commit) ride along —
        the drill-down from 'the commit leg dominates' to WHICH
        consensus phase."""
        with self._lock:
            completed = list(self._completed)
        if len(completed) < min_completed:
            return {"ready": False, "completed": len(completed),
                    "need": min_completed}
        totals = [(c["total_ms"], 1) for c in completed]
        cut = quantile_of_items(totals, q)
        tail = [c for c in completed if c["total_ms"] >= cut][-64:]
        mean_legs: Dict[str, float] = {}
        for c in tail:
            for leg, ms in c["legs_ms"].items():
                mean_legs[leg] = mean_legs.get(leg, 0.0) + ms
        mean_legs = {leg: round(ms / len(tail), 3)
                     for leg, ms in mean_legs.items()}
        dominant = max(mean_legs, key=mean_legs.get) if mean_legs \
            else None
        doc = {
            "ready": True,
            "q": q,
            "threshold_ms": round(cut, 3),
            "tail_count": len(tail),
            "mean_leg_ms": mean_legs,
            "dominant_stage": dominant,
            "heights": sorted({c["h"] for c in tail if c["h"]}),
        }
        sub = self._consensus_substages(doc["heights"])
        if sub:
            doc["consensus_substages_ms"] = sub
        return doc

    def _consensus_substages(self, heights) -> Optional[dict]:
        """Mean per-phase wall of the tail heights from the LOCAL
        causal ring (cluster-wide alignment is trace_merge's job)."""
        from tendermint_tpu_torch.telemetry import causal
        if not causal.enabled() or not heights:
            return None
        want = set(heights)
        # earliest stamp per (height, boundary) from the span ring
        marks: Dict[int, Dict[str, int]] = {}
        for ev in causal.dump()["spans"]:
            if ev["h"] in want:
                by = marks.setdefault(ev["h"], {})
                t = ev["t"]
                if ev["n"] not in by or t < by[ev["n"]]:
                    by[ev["n"]] = t
        order = ("height.begin", "part.first", "block.full",
                 "quorum.prevote", "quorum.precommit", "commit")
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for by in marks.values():
            chain = [(n, by[n]) for n in order if n in by]
            for (n0, t0), (n1, t1) in zip(chain, chain[1:]):
                key = f"{n0}->{n1}"
                sums[key] = sums.get(key, 0.0) + (t1 - t0) / 1e6
                counts[key] = counts.get(key, 0) + 1
        if not sums:
            return None
        return {k: round(sums[k] / counts[k], 3) for k in sums}

    def verdict(self) -> dict:
        """The /healthz fold-in: ok unless sampled txs are visibly
        failing to complete (drops in the last 60s beyond 5% of the
        window's completions) or the tracker itself is saturated."""
        now_s = self._now_ns() / 1e9
        with self._lock:
            recent_drops = sum(1 for t, r in self._drops
                               if t >= now_s - 60.0
                               and r != "undelivered")
            recent_done = sum(1 for t, v in
                              self._series["e2e_delivery"].ring
                              if t >= now_s - 60.0)
            inflight = len(self._inflight)
        reasons = []
        if inflight >= 0.9 * self.inflight_cap:
            reasons.append("tracker_saturated")
        if recent_drops and recent_drops > 0.05 * recent_done:
            reasons.append("drops_exceed_5pct_of_completions")
        return {"ok": not reasons, "reasons": reasons,
                "window_s": 60,
                "completions_60s": recent_done,
                "drops_60s": recent_drops}

    def reset(self) -> None:
        with self._lock:
            self._inflight.clear()
            self._series = {s: _Series() for s in SERIES}
            self._completed.clear()
            self._drops.clear()
            self._ops_since_sweep = 0
            self.sampled_total = 0
            self.completed_total = 0
            self.sampled_by_chain = {}
            self.completed_by_chain = {}
            self.dropped = {"overflow": 0, "timeout": 0,
                            "undelivered": 0}
            self.timeout_last_stage = {}
            self.monotonic_violations = 0


#: the process-wide tracker every instrumented call site stamps into
TRACKER = SLOTracker()


# module-level conveniences (the call-site surface)

def admit(tx: bytes, chain: str = "") -> None:
    TRACKER.admit(tx, chain=chain)


def admit_many(txs, chain: str = "") -> None:
    TRACKER.admit_many(txs, chain=chain)


def mark(tx: bytes, stage: str, height: int = 0) -> None:
    TRACKER.mark(tx, stage, height)


def mark_many(txs, stage: str, height: int = 0) -> None:
    TRACKER.mark_many(txs, stage, height)


def mark_hex(key: str, stage: str, height: int = 0) -> None:
    TRACKER.mark_hex(key, stage, height)


def deliver_item(item) -> None:
    TRACKER.deliver_item(item)


def snapshot(windows: bool = True, sketches: bool = False) -> dict:
    return TRACKER.snapshot(windows=windows, sketches=sketches)


def verdict() -> dict:
    if not enabled():
        return {"ok": True, "reasons": [], "enabled": False}
    return TRACKER.verdict()


def reset() -> None:
    """Tests: clear the tracker AND the knob caches."""
    global _on_cache, _rate_cache
    _on_cache = None
    _rate_cache = None
    TRACKER.reset()


def merge_snapshots(docs) -> dict:
    """N nodes' `snapshot(sketches=True)` payloads -> one cluster
    per-stage quantile table. Sketch samples
    are weighted, so concatenation IS the merge."""
    merged_items: Dict[str, list] = {}
    totals = {"sampled_total": 0, "completed_total": 0, "in_flight": 0,
              "dropped": 0, "monotonic_violations": 0}
    nodes = []
    for doc in docs:
        if not doc.get("enabled"):
            continue
        nodes.append(doc.get("node", "?"))
        totals["sampled_total"] += doc.get("sampled_total", 0)
        totals["completed_total"] += doc.get("completed_total", 0)
        totals["in_flight"] += doc.get("in_flight", 0)
        totals["dropped"] += sum(doc.get("dropped", {}).values())
        totals["monotonic_violations"] += \
            doc.get("monotonic_violations", 0)
        for name, items in doc.get("sketches", {}).items():
            merged_items.setdefault(name, []).extend(
                (float(v), int(w)) for v, w in items)
    stages = {}
    for name in SERIES:
        items = merged_items.get(name)
        if not items:
            continue
        stages[name] = {
            "count": sum(w for _, w in items),
            **{_QLABEL[q]:
               round(quantile_of_items(items, q) * 1e3, 3)
               for q in QUANTILES}}
    return {"nodes": nodes, **totals, "stages": stages}
