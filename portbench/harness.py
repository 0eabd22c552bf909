"""The harness: one run of one cell, driven by data.

A cell is an entry of `workloads` in BENCHMARK.json. Its files are found
by name: the configuration `portbench/configs/<config>.json`, the traffic
`portbench/traffic/<cell>.json`, whose `kind` names the traffic kind
`portbench/traffic_kinds/<kind>.py`, and one reader
`portbench/metrics/<metric>.py` for each per-layer metric. A later cell or
metric is new files and new entries; nothing here names one.

A traffic kind is a module with `setup(ctx)`, `window(ctx, seconds)`,
`release(ctx)`, `check(ctx)` (each number compared, with its limit) and
`report(ctx)` (lines for standard error), plus `SPANS`, the host calls
(target, attribute, span name, whether it returns a resolver; targets as
`traffic_kinds/common.span_target` finds them) whose spans name the
device's idle gaps in a traced run. It may mark the steps of its set-up
with `ctx.mark(name)`, for the set-up line on standard error. A metric
reader has `read(ctx)` (None when it finds nothing) and may have
`install(ctx)`, run before the window of a traced run.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tendermint_tpu")
_ABSENT = object()


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` that the cell reports: those that list it
    under `workloads`, or list no cells."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (`tendermint_tpu_torch` is not
    `tendermint_tpu`)."""
    names = {m.split(".", 1)[0] for m in list(modules if modules is not None
                                              else sys.modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def quantile(values: list, q: float):
    """The q-quantile by linear interpolation between order statistics;
    None for no values."""
    if not values:
        return None
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Probe:
    """Host spans and counts of a traced run. `wrap` replaces a callable
    attribute by one that records (name, start, end) in time.time_ns()
    (the profiler's clock) on every call; with `resolver`, the call
    returns a zero-argument resolver, whose own calls are recorded under
    `<name>.resolve`. `restore` puts every wrapped attribute back."""

    def __init__(self):
        self.spans: list = []
        self._saved: list = []
        self._wrapped: set = set()

    def wrap(self, obj, attr: str, name: str, resolver: bool = False) -> None:
        key = (id(obj), attr)
        if key in self._wrapped:
            return
        inner = getattr(obj, attr)
        spans = self.spans
        clock = time.time_ns

        def resolve_of(res):
            def timed_resolve(*a, **kw):
                t0 = clock()
                try:
                    return res(*a, **kw)
                finally:
                    spans.append((name + ".resolve", t0, clock()))
            return timed_resolve

        def call(*a, **kw):
            t0 = clock()
            try:
                out = inner(*a, **kw)
            finally:
                spans.append((name, t0, clock()))
            return resolve_of(out) if resolver else out

        # what to put back: the attribute as the object itself holds it
        # (a classmethod stays a classmethod), or nothing for a method
        # that an instance takes from its class
        own = vars(obj).get(attr, _ABSENT)
        self._saved.append((obj, attr, own))
        self._wrapped.add(key)
        setattr(obj, attr, call)

    def restore(self) -> None:
        for obj, attr, own in reversed(self._saved):
            if own is _ABSENT:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        self._saved.clear()
        self._wrapped.clear()

    def total_s(self, name: str, lo_ns: int = 0, hi_ns: int = 1 << 62):
        """Seconds of the spans of `name` that start in [lo, hi)."""
        return sum(t1 - t0 for n, t0, t1 in self.spans
                   if n == name and lo_ns <= t0 < hi_ns) / 1e9

    def count(self, name: str, lo_ns: int = 0, hi_ns: int = 1 << 62) -> int:
        return sum(1 for n, t0, _ in self.spans
                   if n == name and lo_ns <= t0 < hi_ns)


class Ctx:
    """What a run's parts share: the cell, its configuration and traffic,
    the seed, the device, the probe of a traced run, and whatever the
    traffic kind puts under `state` (its inputs, the program's objects)
    and `window_stats` (the window's counts)."""

    def __init__(self, root: Path, bench: dict, cell: dict, seed: int,
                 device, trace: bool, control: str = ""):
        self.root = root
        self.bench = bench
        self.cell = cell
        self.config = json.loads(
            (root / "configs" / f"{cell['config']}.json").read_text())
        self.config.setdefault("name", cell["config"])
        self.traffic = json.loads(
            (root / "traffic" / f"{cell['name']}.json").read_text())
        self.seed = seed
        self.device = device
        self.trace = trace
        self.control = control
        self.probe = Probe() if trace else None
        self.state: dict = {}
        self.window_stats: dict = {}
        self.device_trace = None
        self.marks: list = []

    def mark(self, name: str) -> None:
        """Note the end of a step of set-up, for the set-up line."""
        self.marks.append((name, time.perf_counter()))

    def kind(self):
        k = self.traffic["kind"]
        return load_module(self.root / "traffic_kinds" / f"{k}.py",
                           f"portbench_kind_{k}")


def per_layer_readers(ctx: Ctx) -> list:
    out = []
    for m in metrics_of(ctx.bench, ctx.cell["name"], "per_layer"):
        mod = load_module(ctx.root / "metrics" / f"{m['name']}.py",
                          f"portbench_metric_{m['name'].replace('.', '_')}")
        out.append((m, mod))
    return out


def bytes_written() -> int:
    """Bytes this process has caused to be written to storage so far
    (/proc/self/io write_bytes), or its bytes written through write
    calls (wchar) where the first reads 0; -1 if neither is readable."""
    try:
        with open("/proc/self/io") as fh:
            io = dict(line.split(": ") for line in fh.read().splitlines())
        return int(io["write_bytes"]) or int(io["wchar"])
    except (OSError, KeyError, ValueError):
        return -1


def setup_line(t0: float, marks: list, t_window: float) -> str:
    """Set-up's steps in seconds, from the process's start to the
    window: the interpreter and imports (`start`), then each step that
    the traffic kind and the harness marked."""
    steps, last = [], t0
    for name, t in marks + [("probe", t_window)]:
        steps.append(f"{name} {t - last:.3f} s")
        last = t
    return "setup: " + ", ".join(steps)


def host_line(use0, use1, wall_s: float) -> str:
    """The window's host use from two getrusage readings: CPU seconds
    and context switches, the involuntary ones being preemptions by
    other work on the host's cores."""
    return (f"host: the window took {wall_s:.3f} s; "
            f"{use1.ru_utime - use0.ru_utime:.3f} s user and "
            f"{use1.ru_stime - use0.ru_stime:.3f} s system CPU, "
            f"{use1.ru_nvcsw - use0.ru_nvcsw} voluntary and "
            f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary switches")


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown, checks: list) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)


def run_once(root: Path, bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, control: str, device, t0: float,
             ctx_hook=None) -> tuple:
    """Set up, measure, check: (exit code, standard-error lines, the
    result line or None). `t0` is the process's start on the
    perf_counter clock. `ctx_hook(ctx)`, if given, runs after the Ctx is
    made (the tests shrink the configuration there)."""
    import torch
    from portbench import devtrace
    on_card = device.type == "cuda"
    ctx = Ctx(root, bench, cell, seed, device, trace, control)
    ctx.mark("start")
    if ctx_hook is not None:
        ctx_hook(ctx)
    kind = ctx.kind()
    kind.setup(ctx)
    # the inputs made at set-up (hundreds of thousands of objects) would
    # otherwise be walked by every full collection in the window, a cost
    # the program does not have in a node
    gc.collect()
    gc.freeze()
    ctx.mark("collect")
    readers = per_layer_readers(ctx) if trace else []
    tracer = None
    if trace:
        for _, mod in readers:
            if hasattr(mod, "install"):
                mod.install(ctx)
        from portbench.traffic_kinds.common import span_target
        for path, attr, name, resolver in kind.SPANS:
            ctx.probe.wrap(span_target(ctx, path), attr, name,
                           resolver=resolver)
        tracer = devtrace.Tracer() if on_card else None
    if tracer is not None:
        tracer.start()
    t_window = time.perf_counter()
    setup_s = t_window - t0
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    kind.window(ctx, seconds)
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    window_wall_s = time.perf_counter() - t_window
    if tracer is not None:
        tracer.stop()
        ctx.device_trace = devtrace.summary(
            tracer.events, tracer.t0_ns, tracer.t1_ns, ctx.probe.spans)
    if ctx.probe is not None:
        ctx.probe.restore()
    peak = max((torch.cuda.max_memory_allocated(d)
                for d in range(torch.cuda.device_count())), default=0) \
        if on_card else 0
    stats = ctx.window_stats
    if trace:
        metrics = {}
        for m, mod in readers:
            v = mod.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in metrics_of(bench, cell["name"], "end_to_end"):
            if m["name"] in stats:
                metrics[m["name"]] = {"value": stats[m["name"]],
                                      "unit": m["unit"]}
    kind.release(ctx)
    checks = kind.check(ctx)
    correct = all(v <= limit for _, v, limit in checks)
    lines = list(kind.report(ctx))
    lines.append(setup_line(t0, ctx.marks, t_window))
    lines.append(host_line(use0, use1, window_wall_s))
    lines.append(f"disk: this process wrote {bytes_written()} bytes "
                 f"(set-up, window and check)")
    hits = forbidden_modules()
    if hits:
        return 3, lines + ["portbench: JAX or the JAX package is loaded: "
                           + ", ".join(hits)], None
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else device.type,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    breakdown = None
    if ctx.device_trace is not None:
        tr = ctx.device_trace
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    lines += [f"check {name} = {value} (limit {limit})"
              for name, value, limit in checks]
    return 0, lines, result_line(correct, stats.get("attempted", 0),
                                 stats.get("failed", 0), metrics,
                                 device_info, breakdown, checks)
