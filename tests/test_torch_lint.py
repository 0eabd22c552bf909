"""The port's static-analysis checkers (tendermint_tpu_torch/analysis)
against the JAX package's.

- Every AST checker case of tests/test_lint.py runs on the same source
  snippet through both packages' engines (the package name and the knob
  prefix written per package) and gives the same checker ids and lines.
- Every taint source-scanner case of tests/test_taint.py gives the same
  (kind, line) hits in both packages (the device-float case reads
  `jax.numpy` in the JAX package and `torch` in the port), and the
  flowgraph resolves the same fixture the same way.
- The pragma rules: a justified pragma suppresses, a bare one, a stale
  one and an unknown checker's are findings, in both packages alike.
- The port's own tree is clean: `python -m
  tendermint_tpu_torch.analysis.lint --taint` exits 0 over
  tendermint_tpu_torch/ and chip_smoke.py, every blessed taint seam
  names a live port test, KNOBS.md matches the catalog, and the runtime
  lock watcher reads guard annotations with the engine's reader.
"""

import json
import os
import subprocess
import sys

import pytest

from tendermint_tpu.analysis import Engine as JEngine
from tendermint_tpu.analysis.checkers import all_checkers as jcheckers
from tendermint_tpu.analysis.checkers import taint as jtaint
from tendermint_tpu.analysis import flowgraph as jflow
from tendermint_tpu_torch.analysis import Engine as TEngine
from tendermint_tpu_torch.analysis import engine as tengine
from tendermint_tpu_torch.analysis import flowgraph as tflow
from tendermint_tpu_torch.analysis import lockwatch, run_tree
from tendermint_tpu_torch.analysis.checkers import all_checkers as tcheckers
from tendermint_tpu_torch.analysis.checkers import taint as ttaint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (JAX package, its knob prefix), (the port, its prefix)
SIDES = {"jax": ("tendermint_tpu", "TM_TPU_", JEngine, jcheckers),
         "port": ("tendermint_tpu_torch", "TM_CUDA_", TEngine, tcheckers)}

LOCKED_CLASS = (
    "import threading\n"
    "class Box:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._items = []  #: guarded_by _lock\n"
    "%s"
)

#: name -> (source, path under the package, run the end-of-run checks)
CASES = {
    "determinism_wallclock_random": (
        "import time, random\n"
        "def ts():\n"
        "    return time.time_ns()\n"
        "def jitter():\n"
        "    return random.random()\n", "consensus/fixture.py", False),
    "determinism_bare_import_and_set_iteration": (
        "from time import time\n"
        "def ts():\n"
        "    return time()\n"
        "def order(xs):\n"
        "    for x in set(xs):\n"
        "        yield x\n", "types/fixture.py", False),
    "determinism_monotonic_seeded_sorted": (
        "import random, time\n"
        "from {pkg}.utils import clock\n"
        "def good(xs):\n"
        "    t0 = time.monotonic(); tp = time.perf_counter()\n"
        "    ts = clock.now_ns()\n"
        "    rng = random.Random(7); v = rng.random()\n"
        "    for x in sorted(set(xs)):\n"
        "        pass\n"
        "    return t0, tp, ts, v\n", "consensus/fixture.py", False),
    "determinism_out_of_scope": (
        "import time\nts = time.time()\n", "rpc/fixture.py", False),
    "determinism_ops_scope": (
        "import time\nts = time.time()\n", "ops/fixture.py", False),
    "determinism_state_scope": (
        "import time\nts = time.time()\n", "state/fx.py", False),
    "locks_unguarded_read": (LOCKED_CLASS % (
        "    def bad(self):\n"
        "        return len(self._items)\n"), "consensus/fixture.py", False),
    "locks_with_init_and_locked_suffix": (LOCKED_CLASS % (
        "    def good(self):\n"
        "        with self._lock:\n"
        "            return self._drain_locked()\n"
        "    def _drain_locked(self):\n"
        "        out = list(self._items)\n"
        "        self._items = []\n"
        "        return out\n"), "consensus/fixture.py", False),
    "locks_unguarded_store": (LOCKED_CLASS % (
        "    def bad(self):\n"
        "        self._items = []\n"), "consensus/fixture.py", False),
    "locks_thread_not_daemon": (
        "import threading\n"
        "def spawn(fn):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n", "consensus/fixture.py", False),
    "locks_thread_daemon": (
        "import threading\n"
        "def spawn(fn):\n"
        "    t = threading.Thread(target=fn, daemon=True)\n"
        "    t.start()\n", "consensus/fixture.py", False),
    "locks_thread_joined": (
        "import threading\n"
        "def spawn(fn):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n"
        "    t.join()\n", "consensus/fixture.py", False),
    "knobs_uncataloged": (
        "import os\nv = os.environ.get('{pfx}BOGUS_KNOB')\n",
        "consensus/fixture.py", False),
    "knobs_cataloged": (
        "import os\nv = os.environ.get('{pfx}TELEMETRY')\n",
        "consensus/fixture.py", False),
    "knobs_catalog_file_exempt": (
        "NAMES = ['{pfx}NOT_REAL']\n", "utils/knobs.py", False),
    "knobs_uncataloged_list": (
        "NAMES = ['{pfx}NOT_REAL']\n", "consensus/fixture.py", False),
    "exceptions_silent_broad_in_loop": (
        "def pump(q):\n"
        "    while True:\n"
        "        try:\n"
        "            q.get()\n"
        "        except Exception:\n"
        "            pass\n", "consensus/fixture.py", False),
    "exceptions_logged": (
        "def pump(q, log):\n"
        "    while True:\n"
        "        try:\n"
        "            q.get()\n"
        "        except Exception as e:\n"
        "            log.error('pump failed', err=repr(e))\n",
        "consensus/fixture.py", False),
    "exceptions_narrow": (
        "import queue\n"
        "def pump(q):\n"
        "    while True:\n"
        "        try:\n"
        "            q.get()\n"
        "        except queue.Empty:\n"
        "            continue\n", "consensus/fixture.py", False),
    "exceptions_unlooped": (
        "def close(conn):\n"
        "    try:\n"
        "        conn.close()\n"
        "    except Exception:\n"
        "        pass\n", "consensus/fixture.py", False),
    "async_blocking_loop_module": (
        "import time\n"
        "TMLINT_LOOP_MODULE = True\n"
        "def tick(sock, q, ev, sel):\n"
        "    time.sleep(0.1)\n"
        "    sock.recv(10)\n"
        "    ev.wait()\n"
        "    q.get(timeout=1)\n"
        "    sel.select(0.1)\n", "p2p/conn/fixture.py", False),
    "async_blocking_unmarked_module": (
        "import time\n"
        "def tick(sock):\n"
        "    time.sleep(0.1)\n"
        "    sock.recv(10)\n", "p2p/conn/fixture.py", False),
    "ambient_global_rebind": (
        "_default = None\n"
        "def get_default():\n"
        "    global _default\n"
        "    if _default is None:\n"
        "        _default = object()\n"
        "    return _default\n", "consensus/fixture.py", False),
    "ambient_mutated_container": (
        "_registry = {{}}\n"
        "def register(name, fn):\n"
        "    _registry[name] = fn\n"
        "_order = []\n"
        "def push(x):\n"
        "    _order.append(x)\n", "consensus/fixture.py", False),
    "ambient_readonly_tables_and_locals": (
        "_LEVELS = {{'debug': 10, 'info': 20}}\n"
        "_IDX = {{s: i for i, s in enumerate(('a', 'b'))}}\n"
        "NAMES = ('x', 'y')\n"
        "class Reg:\n"
        "    table = {{}}\n"
        "    def put(self, k, v):\n"
        "        self.table[k] = v\n"
        "def lookup(name):\n"
        "    cache = {{}}\n"
        "    cache[name] = _LEVELS.get(name)\n"
        "    return cache[name]\n", "consensus/fixture.py", False),
    "ambient_blessed_default_verifier": (
        "_default = None\n"
        "def default_verifier():\n"
        "    global _default\n"
        "    _default = _default or object()\n"
        "    return _default\n", "models/verifier.py", False),
    "ambient_same_code_in_a_new_module": (
        "_default = None\n"
        "def default_verifier():\n"
        "    global _default\n"
        "    _default = _default or object()\n"
        "    return _default\n", "shard/newmod.py", False),
    "ambient_pragma_at_binding": (
        "_cache = {{}}  # tmlint: allow(ambient-singleton): bounded "
        "LRU, reset() in tests\n"
        "def put(k, v):\n"
        "    _cache[k] = v\n", "consensus/fixture.py", False),
    "pragma_above_with_justification": (
        "import time\n"
        "# tmlint: allow(determinism): fixture needs a real clock\n"
        "ts = time.time()\n", "consensus/fixture.py", True),
    "pragma_same_line": (
        "import time\n"
        "ts = time.time()  # tmlint: allow(determinism): fixture clock\n",
        "consensus/fixture.py", True),
    "pragma_without_justification": (
        "import time\n"
        "ts = time.time()  # tmlint: allow(determinism)\n",
        "consensus/fixture.py", True),
    "pragma_stale": (
        "x = 1  # tmlint: allow(determinism): nothing here\n",
        "consensus/fixture.py", True),
    "pragma_unknown_checker": (
        "x = 1  # tmlint: allow(nonesuch): misspelled\n",
        "consensus/fixture.py", True),
}


def _lint(side: str, name: str):
    pkg, pfx, engine, checkers = SIDES[side]
    src, rel, finish = CASES[name]
    eng = engine(checkers(), root=REPO)
    found = eng.run_source(src.format(pkg=pkg, pfx=pfx), rel=f"{pkg}/{rel}")
    if finish:
        eng.finish()
        found = eng.findings
    return sorted((f.checker, f.line) for f in found)


@pytest.mark.parametrize("name", sorted(CASES))
def test_checker_case_same_ids_and_lines_as_jax(name):
    want = _lint("jax", name)
    assert _lint("port", name) == want


def test_checker_cases_find_what_the_jax_tests_expect():
    """The parity above is not parity in silence: the cases that must
    find something do, in the port."""
    def ids(name):
        return sorted({c for c, _ in _lint("port", name)})
    assert ids("determinism_wallclock_random") == ["determinism"]
    assert _lint("port", "locks_unguarded_read") == [("lock-discipline", 7)]
    assert ids("knobs_uncataloged") == ["knob-registry"]
    assert ids("exceptions_silent_broad_in_loop") == ["exception-hygiene"]
    assert len(_lint("port", "async_blocking_loop_module")) == 5
    assert _lint("port", "ambient_mutated_container") == [
        ("ambient-singleton", 1), ("ambient-singleton", 4)]
    assert _lint("port", "ambient_same_code_in_a_new_module") == [
        ("ambient-singleton", 1)]
    for name in ("pragma_without_justification", "pragma_stale",
                 "pragma_unknown_checker"):
        assert ids(name) == ["pragma"], name
    for name in ("determinism_monotonic_seeded_sorted", "locks_thread_joined",
                 "ambient_blessed_default_verifier", "pragma_same_line"):
        assert _lint("port", name) == [], name


def test_guard_annotations_one_reader_for_engine_and_lockwatch():
    src = LOCKED_CLASS % ""
    got = [(a.cls, a.attr, a.lock, a.line)
           for a in tengine.parse_guard_annotations(src)]
    from tendermint_tpu.analysis.engine import parse_guard_annotations
    assert got == [(a.cls, a.attr, a.lock, a.line)
                   for a in parse_guard_annotations(src)]
    assert got == [("Box", "_items", "_lock", 5)]
    assert lockwatch.parse_guard_annotations is \
        tengine.parse_guard_annotations


# ------------------------------------------------------------- taint --

#: name -> (source, function): test_taint.py's scanner cases
SCANS = {
    "wallclock_rng_env": (
        "import os, random, time\n"
        "def f():\n"
        "    a = time.time()\n"
        "    b = random.random()\n"
        "    c = os.getenv('HOME')\n"
        "    d = os.environ['HOME']\n"
        "    return a, b, c, d\n"),
    "order_sources": (
        "def f(xs, m):\n"
        "    for x in {{1, 2, 3}}:\n"
        "        pass\n"
        "    for k in m.table.keys():\n"
        "        pass\n"
        "    s = set(xs)\n"
        "    for x in s:\n"
        "        pass\n"),
    "order_laundered": (
        "def f(xs, m):\n"
        "    for x in sorted(set(xs)):\n"
        "        pass\n"
        "    for k in sorted(m.table.keys()):\n"
        "        pass\n"
        "    s = set(xs)\n"
        "    s = sorted(s)\n"
        "    for x in s:\n"
        "        pass\n"
        "    total = sum(v for v in m.table.values())\n"),
    "hashid_lookup_key_exemption": (
        "def f(x, cache):\n"
        "    cache[id(x)] = 1\n"
        "    v = cache.get(id(x))\n"
        "    same = id(x) == id(v)\n"
        "    return hash(x)\n"),
    "devicefloat_and_integer_evidence": (
        "import {dev} as jnp\n"
        "def f(a):\n"
        "    x = jnp.sum(a)\n"
        "    y = jnp.sum(a, dtype=jnp.uint32)\n"
        "    z = jnp.sum(a << 8)\n"
        "    return x, y, z\n"),
    "knob_reads_against_blessed_set": (
        "from {pkg}.utils.knobs import knob_bool, knob_str\n"
        "def f(name):\n"
        "    a = knob_bool('{pfx}STATE_TREE')\n"
        "    b = knob_str('{pfx}TELEMETRY')\n"
        "    c = knob_str(name)\n"),
}


def _scan(side: str, name: str):
    pkg, pfx = SIDES[side][:2]
    flow, taint = (jflow, jtaint) if side == "jax" else (tflow, ttaint)
    src = SCANS[name].format(
        pkg=pkg, pfx=pfx, dev="jax.numpy" if side == "jax" else "torch")
    rel = f"{pkg}/fixture/s.py"
    g = flow.FlowGraph()
    g.add_source(src, rel)
    g.link()
    fi = g.functions[f"{flow.module_qname(rel)}.f"]
    hits = taint._SourceScan(fi, g.modules[fi.module].imports, False,
                             taint.blessed_knobs()).run()
    return sorted((h.kind, h.lineno) for h in hits)


@pytest.mark.parametrize("name", sorted(SCANS))
def test_taint_scan_case_same_hits_as_jax(name):
    assert _scan("port", name) == _scan("jax", name)


def test_taint_scan_cases_find_what_the_jax_tests_expect():
    kinds = {n: [k for k, _ in _scan("port", n)] for n in SCANS}
    assert kinds["wallclock_rng_env"] == ["env", "env", "rng", "wallclock"]
    assert kinds["order_sources"] == ["order"] * 3
    assert kinds["order_laundered"] == []
    assert kinds["hashid_lookup_key_exemption"] == ["hashid"]
    assert _scan("port", "devicefloat_and_integer_evidence") == [
        ("devicefloat", 3)]
    assert kinds["knob_reads_against_blessed_set"] == ["knob", "knob"]


def _fixture_graph(flow, pkg):
    g = flow.FlowGraph()
    g.add_source(
        "import helper\n"
        "from helper import util as u\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self.n = 0\n"
        "    def put_thing(self, x):\n"
        "        self.bump()\n"
        "        helper.work(x)\n"
        "        u(x)\n"
        "    def bump(self):\n"
        "        self.n += 1\n"
        "def make():\n"
        "    b = Box()\n"
        "    b.put_thing(1)\n", f"{pkg}/fixture/a.py")
    g.add_source("def work(x):\n    return x\n"
                 "def util(x):\n    return x\n", "helper.py")
    g.link()
    return g


def test_flowgraph_resolves_the_fixture_as_jax():
    out = {}
    for side, flow in (("jax", jflow), ("port", tflow)):
        pkg = SIDES[side][0]
        g = _fixture_graph(flow, pkg)
        calls = {}
        for fn in ("Box.put_thing", "make"):
            for c in g.callees(f"{pkg}.fixture.a.{fn}"):
                calls[(fn, c.label)] = (c.kind, tuple(
                    t.replace(pkg + ".", "") for t in c.targets))
        st = g.stats()
        out[side] = (calls, st["files"], st["functions"], st["by_kind"])
    assert out["port"] == out["jax"]
    assert out["port"][0][("make", "b.put_thing")] == (
        "method", ("fixture.a.Box.put_thing",))


def test_taint_pragma_suppression_and_staleness(tmp_path):
    (tmp_path / "mod.py").write_text(
        "def f(xs):\n"
        "    # tmlint: allow(taint): fixture justification\n"
        "    for x in set(xs):\n"
        "        pass\n"
        "    y = 1  # tmlint: allow(taint): suppresses nothing\n",
        encoding="utf-8")
    out = {}
    for side, flow, taint in (("jax", jflow, jtaint),
                              ("port", tflow, ttaint)):
        g = flow.FlowGraph.build(str(tmp_path), paths=["mod.py"])
        finding = type(taint._stale_seams.__globals__["Finding"](
            "taint", "mod.py", 3, "x"))("taint", "mod.py", 3, "order")
        kept, stale = taint._apply_pragmas(str(tmp_path), g, [finding])
        out[side] = (kept, [(f.line, f.message) for f in stale])
    assert out["port"] == out["jax"]
    assert out["port"][0] == [] and out["port"][1][0][0] == 5


def test_port_catalogs_are_the_ports_own_and_live():
    assert len(ttaint.SINKS) == len(jtaint.SINKS)
    assert [q.replace("tendermint_tpu_torch.", "") for q, _ in ttaint.SINKS] \
        == [q.replace("tendermint_tpu.", "") for q, _ in jtaint.SINKS]
    for seam in ttaint.BLESSED:
        assert seam.test.startswith("tests/test_torch_"), seam
        if seam.kind == "knob":
            assert seam.target.startswith("TM_CUDA_"), seam
        else:
            assert seam.target.startswith("tendermint_tpu_torch."), seam
    assert ttaint._stale_seams(REPO) == []
    dead = ttaint.Seam("knob", "TM_CUDA_MESH",
                       "tests/test_torch_lint.py::test_no_such_test", "x")
    saved = ttaint.BLESSED
    ttaint.BLESSED = (dead,)
    try:
        out = ttaint._stale_seams(REPO)
    finally:
        ttaint.BLESSED = saved
    assert len(out) == 1 and "test_no_such_test" in out[0].message


# ------------------------------------------------------------ the tree --

def test_port_tree_is_clean_under_the_ast_checkers():
    findings, pragmas, n_files = run_tree(REPO)
    assert findings == [], "\n".join(str(f) for f in findings)
    assert n_files > 150
    assert all(p.justification and p.used or p.checker == "taint"
               for p in pragmas)
    assert all(p.path.startswith("tendermint_tpu_torch/")
               or p.path == "chip_smoke.py" for p in pragmas)


def test_port_taint_pass_is_clean():
    rep = ttaint.run_taint(REPO)
    assert rep.findings == [], "\n".join(str(f) for f in rep.findings)
    st = rep.stats
    assert st["reachable_functions"] > 300 and st["seam_cuts"] > 50
    assert st["sinks"] == len(ttaint.SINKS)


def test_lint_cli_passes_with_taint_and_metrics(tmp_path):
    out = tmp_path / "report.json"
    r = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.analysis.lint",
         "--taint", "--json", str(out)], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint: OK" in r.stdout and "seam cuts" in r.stdout
    rep = json.loads(out.read_text())
    assert rep["clean"] and rep["findings"] == []
    assert "metrics" in rep["checkers"] and "taint" in rep["checkers"]
    assert rep["files_scanned"] > 150


def test_lint_cli_graph_stats_and_knobs_md():
    r = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.analysis.lint",
         "--graph-stats"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    st = json.loads(r.stdout)
    assert st["parse_errors"] == 0 and st["resolution_rate"] > 0.5
    from tendermint_tpu_torch.analysis import lint
    from tendermint_tpu_torch.utils import knobs
    with open(lint.KNOBS_MD, encoding="utf-8") as f:
        assert f.read() == knobs.knobs_md()
    assert lint.check_knobs_md() == []
