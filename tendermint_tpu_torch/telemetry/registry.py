"""Metrics registry — dependency-free Counter / Gauge / Histogram with
Prometheus text-format exposition.

Design constraints (ADR-009-style metrics):

- Zero third-party dependencies: the container must not need
  prometheus_client; exposition is the stable text format 0.0.4.
- Labelled and thread-safe: children are created on first `labels()`
  call and cached; every mutation takes the child's lock (observe on a
  histogram updates several fields and must be atomic vs exposition).
- Global no-op mode: `TM_CUDA_TELEMETRY=off` (or config
  `base.telemetry=false`) turns every instrument method into a single
  flag check + return, so unobserved hot paths (per-signature verifier
  dispatches, per-frame p2p routing) cost ~nothing. Hot call sites that
  do extra work to *compute* a metric value guard with `enabled()`.
- Names are registered UN-namespaced (`verifier_batch_size`); the
  namespace prefix (default `tmcuda`) is applied at exposition time so one
  process-wide registry can serve whatever namespace the node config
  picked without re-creating metric objects.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

from tendermint_tpu_torch.utils import knobs

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

#: the port's exposition namespace; the `tm_*` families belong to the
#: JAX package (a node configured with `telemetry_namespace: "tm"`
#: exposes byte-comparable text)
DEFAULT_NAMESPACE = "tmcuda"

# Prometheus default buckets (client_golang DefBuckets) — latencies.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    .005, .01, .025, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0)
# Power-of-two buckets — batch sizes, leaf counts (verifier chunking is
# power-of-two bucketed, ops/ed25519._bucket, so these align exactly).
POW2_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(15))  # 1 .. 16384
# Fill-ratio buckets — chunk occupancy, pool windows.
RATIO_BUCKETS: Tuple[float, ...] = (
    0.125, 0.25, 0.5, 0.75, 0.9, 1.0)

# Default quantiles a Summary family exposes (the SLO plane's table:
# median, tail, deep tail).
DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99, 0.999)


def _env_enabled() -> Optional[bool]:
    """TM_CUDA_TELEMETRY: unset -> None (config decides, default on);
    FALSY values -> False; anything else -> True."""
    return knobs.knob_flag3("TM_CUDA_TELEMETRY")


class _TelemetryState:
    """Process-wide on/off flag + exposition namespace. The flag is read
    unlocked on every instrument call (a torn read is impossible for a
    Python bool attribute), so the disabled cost is one attribute load."""

    def __init__(self):
        env = _env_enabled()
        self.enabled: bool = True if env is None else env
        self.env_forced: bool = env is not None
        self.namespace: str = DEFAULT_NAMESPACE


_state = _TelemetryState()


def enabled() -> bool:
    return _state.enabled


def set_enabled(on: bool) -> None:
    """Hard override (tests / tooling) — ignores the env pin."""
    _state.enabled = bool(on)


def namespace() -> str:
    return _state.namespace


def configure(enabled: Optional[bool] = None,
              namespace: Optional[str] = None) -> None:
    """Node-level wiring (config.base.telemetry*). The env var
    TM_CUDA_TELEMETRY always wins over config: an operator exporting
    `off` must silence an instrumented binary regardless of what the
    config file says (the acceptance contract for no-op mode)."""
    if namespace is not None:
        if not _NAME_RE.match(namespace):
            raise ValueError(
                f"telemetry namespace must match {_NAME_RE.pattern}, "
                f"got {namespace!r}")
        _state.namespace = namespace
    if enabled is not None and not _state.env_forced:
        _state.enabled = bool(enabled)


# --------------------------------------------------------------------------
# children (one per label-value combination)
# --------------------------------------------------------------------------


class _NoopChild:
    """Returned by labels() while disabled: every method is a no-op, so
    call sites never need to branch themselves."""

    __slots__ = ()

    def inc(self, value: float = 1.0) -> None:
        pass

    def dec(self, value: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


_NOOP = _NoopChild()


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if not _state.enabled:
            return
        if value < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += value


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, value: float = 1.0) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self.value += value

    def dec(self, value: float = 1.0) -> None:
        self.inc(-value)


class _HistogramChild:
    __slots__ = ("_lock", "_uppers", "counts", "sum", "count")

    def __init__(self, uppers: Sequence[float]):
        self._lock = threading.Lock()
        self._uppers = uppers
        self.counts = [0] * (len(uppers) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not _state.enabled:
            return
        i = bisect.bisect_left(self._uppers, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> Tuple[list, float, int]:
        with self._lock:
            return list(self.counts), self.sum, self.count


class QuantileSketch:
    """Fixed-capacity quantile estimator (the SLO plane's per-stage
    latency structure).

    Histogram's DEFAULT_BUCKETS are far too coarse for sub-millisecond
    front-door legs (everything lands in the first bucket), and keeping
    every sample exact grows without bound over a soak. This is the
    classic multi-level compactor sketch: observations enter a level-0
    buffer; when a level fills, it is sorted and every OTHER element is
    promoted one level up with doubled weight (the surviving parity
    alternates per compaction, so rank bias cancels instead of
    accumulating). Memory is O(cap * log(n / cap)); quantiles are EXACT
    until the first compaction (n <= cap) and carry a bounded rank
    error (~levels / cap) after — test-asserted against sorted ground
    truth in tests/test_slo.py.

    Deterministic by construction (no RNG: the alternating-parity
    compactor replaces KLL's coin flip), so two nodes fed the same
    stream expose identical quantiles. Thread-safe."""

    __slots__ = ("_lock", "_cap", "_levels", "_parity", "count", "sum",
                 "_min", "_max")

    def __init__(self, cap: int = 512):
        if cap < 8:
            raise ValueError(f"sketch cap must be >= 8, got {cap}")
        self._lock = threading.Lock()
        self._cap = int(cap)
        self._levels: list = [[]]   # level i holds items of weight 2^i
        self._parity: list = [0]
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._levels[0].append(v)
            i = 0
            while len(self._levels[i]) >= self._cap:
                buf = sorted(self._levels[i])
                keep = self._parity[i]
                self._parity[i] ^= 1
                self._levels[i] = []
                if i + 1 == len(self._levels):
                    self._levels.append([])
                    self._parity.append(0)
                self._levels[i + 1].extend(buf[keep::2])
                i += 1

    def items(self):
        """Weighted samples [(value, weight), ...] — the mergeable form
        a cross-node report concatenates."""
        with self._lock:
            out = []
            for i, buf in enumerate(self._levels):
                w = 1 << i
                out.extend((v, w) for v in buf)
            return out

    def quantile(self, q: float) -> float:
        """Value at rank q*(n-1) over the weighted sample set; exact
        min/max at q=0/1 regardless of compaction. NaN when empty."""
        return quantile_of_items(self.items(), q,
                                 lo=self._min, hi=self._max)

    def quantiles(self, qs) -> dict:
        items = self.items()
        return {q: quantile_of_items(items, q, lo=self._min,
                                     hi=self._max) for q in qs}

    def reset(self) -> None:
        with self._lock:
            self._levels = [[]]
            self._parity = [0]
            self.count = 0
            self.sum = 0.0
            self._min = math.inf
            self._max = -math.inf


def quantile_of_items(items, q: float, lo: float = math.inf,
                      hi: float = -math.inf) -> float:
    """Quantile over weighted (value, weight) pairs — shared by
    QuantileSketch and the cross-node merge (slo.merge_snapshots)."""
    if not items:
        return math.nan
    q = min(1.0, max(0.0, float(q)))
    if q == 0.0 and lo is not math.inf and not math.isinf(lo):
        return lo
    if q == 1.0 and hi is not -math.inf and not math.isinf(hi):
        return hi
    items = sorted(items)
    total = sum(w for _, w in items)
    target = q * (total - 1)
    cum = 0
    for v, w in items:
        cum += w
        if cum - 1 >= target:
            return v
    return items[-1][0]


class _SummaryChild:
    """One labelled summary: a QuantileSketch exposed as the Prometheus
    summary type (`x{quantile="0.99"} v` + `x_sum` + `x_count`)."""

    __slots__ = ("sketch",)

    def __init__(self, cap: int):
        self.sketch = QuantileSketch(cap)

    def observe(self, value: float) -> None:
        if not _state.enabled:
            return
        self.sketch.observe(value)

    def reset(self) -> None:
        self.sketch.reset()

    @property
    def count(self) -> int:
        return self.sketch.count

    @property
    def sum(self) -> float:
        return self.sketch.sum


# --------------------------------------------------------------------------
# families
# --------------------------------------------------------------------------


class _Family:
    """One named metric + all its labelled children. Unlabelled families
    own a single implicit child and proxy the instrument methods, so
    `REG.counter("x").inc()` and `REG.counter("x", labelnames=("a",))
    .labels(a="1").inc()` read the same at call sites."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self._implicit = None
        if not labelnames:
            self._implicit = self._new_child()
            self._children[()] = self._implicit

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        if not _state.enabled:
            return _NOOP
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(str(kv[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"metric {self.name!r} missing label {e.args[0]!r}"
                ) from None
            if len(kv) != len(self.labelnames):
                extra = set(kv) - set(self.labelnames)
                raise ValueError(
                    f"metric {self.name!r} got unexpected labels {extra}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {len(values)} values")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._new_child())
        return child

    def children(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, value: float = 1.0) -> None:
        if self._implicit is None:
            raise ValueError(f"counter {self.name!r} has labels; "
                             f"call .labels() first")
        self._implicit.inc(value)


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        if self._implicit is None:
            raise ValueError(f"gauge {self.name!r} has labels; "
                             f"call .labels() first")
        self._implicit.set(value)

    def inc(self, value: float = 1.0) -> None:
        if self._implicit is None:
            raise ValueError(f"gauge {self.name!r} has labels; "
                             f"call .labels() first")
        self._implicit.inc(value)

    def dec(self, value: float = 1.0) -> None:
        self.inc(-value)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        uppers = tuple(float(b) for b in buckets)
        if list(uppers) != sorted(set(uppers)):
            raise ValueError(f"histogram {name!r} buckets must be sorted "
                             f"and unique: {buckets}")
        if uppers and math.isinf(uppers[-1]):
            uppers = uppers[:-1]  # +Inf is implicit
        self.buckets = uppers
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        if self._implicit is None:
            raise ValueError(f"histogram {self.name!r} has labels; "
                             f"call .labels() first")
        self._implicit.observe(value)


class Summary(_Family):
    """Quantile-sketch family (Prometheus summary type): per-child
    QuantileSketch, exposed as `x{quantile="0.5"} v` lines plus _sum and
    _count. Built for the SLO plane's sub-ms latency legs, where
    DEFAULT_BUCKETS resolve nothing."""

    kind = "summary"

    def __init__(self, name, help, labelnames,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES,
                 cap: int = 512):
        qs = tuple(float(q) for q in quantiles)
        if any(not 0.0 <= q <= 1.0 for q in qs) or \
                list(qs) != sorted(set(qs)):
            raise ValueError(f"summary {name!r} quantiles must be "
                             f"sorted, unique, in [0,1]: {quantiles}")
        self.quantiles = qs
        self.cap = int(cap)
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _SummaryChild(self.cap)

    def observe(self, value: float) -> None:
        if self._implicit is None:
            raise ValueError(f"summary {self.name!r} has labels; "
                             f"call .labels() first")
        self._implicit.observe(value)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


def _fmt(v: float) -> str:
    """Prometheus sample value / `le` formatting: integral floats print
    as integers (le=\"256\" not le=\"256.0\"), +Inf as +Inf."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labelstr(names: Tuple[str, ...], values: Tuple[str, ...],
              extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Registry:
    """Name -> family map. Registration is idempotent for an identical
    (kind, labelnames, buckets) re-declaration — instrumented modules may
    be imported in any order or re-imported — and loud on any mismatch,
    which is what the family catalog test leans on."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ create

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def summary(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                quantiles: Sequence[float] = DEFAULT_QUANTILES,
                cap: int = 512) -> Summary:
        return self._register(Summary, name, help, labelnames,
                              quantiles=quantiles, cap=cap)

    def _register(self, cls, name, help, labelnames, **kw) -> _Family:
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"bad metric name {name!r} "
                             f"(must match {_NAME_RE.pattern})")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                same = (type(fam) is cls and fam.labelnames == labelnames)
                if same and cls is Histogram:
                    want = tuple(float(b) for b in kw.get(
                        "buckets", DEFAULT_BUCKETS))
                    if want and math.isinf(want[-1]):
                        want = want[:-1]
                    same = fam.buckets == want
                if same and cls is Summary:
                    want_q = tuple(float(q) for q in kw.get(
                        "quantiles", DEFAULT_QUANTILES))
                    same = fam.quantiles == want_q and \
                        fam.cap == int(kw.get("cap", 512))
                if not same:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}; conflicting "
                        f"re-registration")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    # ------------------------------------------------------------- query

    def names(self):
        with self._lock:
            return sorted(self._families)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def value(self, name: str, labels: Optional[dict] = None):
        """Test/bench convenience: counter/gauge -> float; histogram ->
        {'sum': s, 'count': n, 'buckets': {upper: cumulative}}.
        Returns None for an unknown name or unseen label combination."""
        fam = self.get(name)
        if fam is None:
            return None
        key = ()
        if labels:
            key = tuple(str(labels[n]) for n in fam.labelnames)
        child = dict(fam.children()).get(key)
        if child is None:
            return None
        if isinstance(fam, Histogram):
            counts, s, n = child.snapshot()
            uppers = list(fam.buckets) + [math.inf]
            cum, out = 0, {}
            for upper, c in zip(uppers, counts):
                cum += c
                out[upper] = cum
            return {"sum": s, "count": n, "buckets": out}
        if isinstance(fam, Summary):
            return {"sum": child.sum, "count": child.count,
                    "quantiles": child.sketch.quantiles(fam.quantiles)}
        return child.value

    def reset(self) -> None:
        """Zero every child (keeps families — bench windows, tests)."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for _, child in fam.children():
                if isinstance(child, _HistogramChild):
                    with child._lock:
                        child.counts = [0] * len(child.counts)
                        child.sum = 0.0
                        child.count = 0
                elif isinstance(child, _SummaryChild):
                    child.reset()
                else:
                    with child._lock:
                        child.value = 0.0

    def clear(self) -> None:
        """Drop every family (unit tests building fresh registries)."""
        with self._lock:
            self._families.clear()

    # -------------------------------------------------------- exposition

    def expose(self, namespace: Optional[str] = None) -> str:
        """Prometheus text format 0.0.4. Families with labels but no
        children yet still print their HELP/TYPE header, so the full
        catalog is discoverable from a fresh process."""
        ns = _state.namespace if namespace is None else namespace
        lines = []
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]
        for fam in fams:
            full = f"{ns}_{fam.name}" if ns else fam.name
            lines.append(f"# HELP {full} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {full} {fam.kind}")
            for values, child in sorted(fam.children()):
                if isinstance(fam, Summary):
                    qvals = child.sketch.quantiles(fam.quantiles)
                    for q, v in qvals.items():
                        if math.isnan(v):
                            continue  # empty sketch: only _sum/_count
                        ls = _labelstr(fam.labelnames, values,
                                       extra=(("quantile", _fmt(q)),))
                        lines.append(f"{full}{ls} {_fmt(v)}")
                    ls = _labelstr(fam.labelnames, values)
                    lines.append(f"{full}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{full}_count{ls} {child.count}")
                elif isinstance(fam, Histogram):
                    counts, s, n = child.snapshot()
                    cum = 0
                    for upper, c in zip(fam.buckets, counts):
                        cum += c
                        ls = _labelstr(fam.labelnames, values,
                                       extra=(("le", _fmt(upper)),))
                        lines.append(f"{full}_bucket{ls} {cum}")
                    ls = _labelstr(fam.labelnames, values,
                                   extra=(("le", "+Inf"),))
                    lines.append(f"{full}_bucket{ls} {n}")
                    ls = _labelstr(fam.labelnames, values)
                    lines.append(f"{full}_sum{ls} {_fmt(s)}")
                    lines.append(f"{full}_count{ls} {n}")
                else:
                    ls = _labelstr(fam.labelnames, values)
                    lines.append(f"{full}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


# The process-wide registry every instrumented module registers into.
REGISTRY = Registry()
