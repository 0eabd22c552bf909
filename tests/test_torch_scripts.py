"""The port's operator tools (tendermint_tpu_torch/scripts/) against the
JAX package's scripts/ on the same seeded dump files, on the CPU.

- trace_merge, slo_report and profile_merge: the same arguments give the
  same exit code, the same report text on stdout, the same skip lines on
  stderr (the port names its TM_CUDA_* knob where the JAX script names
  TM_TPU_*) and byte-equal output files (the Perfetto trace, the full
  reports, the collapsed stacks), nodes without data included; with no
  node left, both exit 1.
- check_metrics, each in a fresh interpreter: both exit 0 with the OK
  line on their own registries (the port's registry holds two families
  more, rpc_tx_batched_total and rpc_tx_batch_flushes_total, which the
  JAX lint's module list does not import), and on the same seeded bad
  families both exit 1 with the same findings.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import profile_merge as jprofile_merge  # noqa: E402
import slo_report as jslo_report  # noqa: E402
import trace_merge as jtrace_merge  # noqa: E402
from tendermint_tpu.telemetry import slo as jslo  # noqa: E402
from tendermint_tpu_torch.scripts import (  # noqa: E402
    profile_merge as tprofile_merge)
from tendermint_tpu_torch.scripts import slo_report as tslo_report  # noqa
from tendermint_tpu_torch.scripts import (  # noqa: E402
    trace_merge as ttrace_merge)

TOOLS = {"trace_merge": (jtrace_merge, ttrace_merge),
         "slo_report": (jslo_report, tslo_report),
         "profile_merge": (jprofile_merge, tprofile_merge)}


def _write(d: Path, docs: list) -> list:
    d.mkdir(parents=True, exist_ok=True)
    names = []
    for i, doc in enumerate(docs):
        name = f"dump{i}.json"
        (d / name).write_text(json.dumps(doc))
        names.append(name)
    return names


def _run_both(tool, docs, extra, tmp_path, monkeypatch, capsys):
    """Each package's tool on the same files, from its own directory with
    the same relative paths: (rc, stdout, stderr, {output file: bytes})
    for jax and port."""
    out = {}
    for pkg, mod in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / pkg
        names = _write(d, docs)
        monkeypatch.chdir(d)
        rc = mod.main(["--files", *names, *extra])
        cap = capsys.readouterr()
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())
                 if p.name not in names}
        out[pkg] = (rc, cap.out, cap.err.replace("TM_CUDA_", "TM_TPU_"),
                    files)
    return out["jax"], out["port"]


# ---------------------------------------------------------- trace_merge

def _trace_dumps(seed):
    from test_torch_trace import _dumps
    return _dumps(seed) + [{"node": "quiet", "enabled": False,
                            "spans": []}]


@pytest.mark.parametrize("seed", [1, 2])
def test_trace_merge_equals_jax(tmp_path, monkeypatch, capsys, seed):
    j, t = _run_both("trace_merge", _trace_dumps(seed),
                     ["--out", "merged.json", "--report", "report.json"],
                     tmp_path, monkeypatch, capsys)
    assert t == j
    assert j[0] == 0 and set(j[3]) == {"merged.json", "report.json"}
    assert "tracing disabled" in j[2] and "heights attributed" in j[1]


def test_trace_merge_no_traced_node_exits_1(tmp_path, monkeypatch, capsys):
    j, t = _run_both("trace_merge", [{"node": "a", "enabled": False}],
                     ["--out", "m.json"], tmp_path, monkeypatch, capsys)
    assert t == j and j[0] == 1 and j[3] == {}


# ----------------------------------------------------------- slo_report

@pytest.fixture
def slo_docs():
    """Two seeded nodes' SLO snapshots with sketches (the JAX tracker on
    pinned clocks), a node with the plane off and one without sketches."""
    from test_torch_slo import _run, _script
    jslo.configure("on", 1.0)
    jslo.reset()
    try:
        docs = []
        for seed in (1, 12):
            doc = _run(jslo, _script(seed), 16384).snapshot(sketches=True)
            doc["node"] = f"n{seed}"
            docs.append(doc)
        bare = _run(jslo, _script(3), 16384).snapshot()
        bare["node"] = "bare"
        bare.pop("sketches", None)
    finally:
        jslo.configure("off")
        jslo.reset()
    return docs + [{"enabled": False, "node": "off"}, bare]


def test_slo_report_equals_jax(tmp_path, monkeypatch, capsys, slo_docs):
    j, t = _run_both("slo_report", slo_docs, ["--report", "report.json"],
                     tmp_path, monkeypatch, capsys)
    assert t == j
    assert j[0] == 0 and set(j[3]) == {"report.json"}
    assert "SLO plane off" in j[2] and "no sketches" in j[2]
    assert "e2e_commit" in j[1]


def test_slo_report_no_data_exits_1(tmp_path, monkeypatch, capsys):
    j, t = _run_both("slo_report", [{"enabled": False, "node": "off"}], [],
                     tmp_path, monkeypatch, capsys)
    assert t == j and j[0] == 1 and "no SLO-enabled nodes" in j[2]


# -------------------------------------------------------- profile_merge

def _profile_dumps(seed):
    rng = np.random.default_rng(seed)
    subs = ("consensus", "p2p", "verifier", "rpc", "other")
    out = []
    for n in range(3):
        stacks = {}
        for _ in range(12):
            chain = ";".join(f"m{int(rng.integers(0, 5))}.f"
                             f"{int(rng.integers(0, 4))}"
                             for _ in range(int(rng.integers(1, 5))))
            stacks[f"main;{chain}"] = int(rng.integers(1, 50))
        subsys = {s: int(rng.integers(0, 60)) for s in subs}
        waits = {s: int(rng.integers(0, 9)) for s in subs[:2]}
        out.append({"node": f"node{n}", "samples": sum(subsys.values()),
                    "wait_samples": sum(waits.values()),
                    "subsystems": subsys, "lock_wait": waits,
                    "shares": {}, "collapsed": "\n".join(
                        f"{k} {v}" for k, v in stacks.items())})
    out.append({"node": "idle", "profile": {"samples": 0,
                                            "wait_samples": 0}})
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_profile_merge_equals_jax(tmp_path, monkeypatch, capsys, seed):
    j, t = _run_both("profile_merge", _profile_dumps(seed),
                     ["--out", "merged.collapsed", "--report",
                      "report.json"], tmp_path, monkeypatch, capsys)
    assert t == j
    assert j[0] == 0 and set(j[3]) == {"merged.collapsed", "report.json"}
    assert "no samples" in j[2] and "node:node2;" in \
        j[3]["merged.collapsed"].decode()


def test_profile_merge_no_samples_exits_1(tmp_path, monkeypatch, capsys):
    j, t = _run_both("profile_merge", _profile_dumps(4)[-1:], [],
                     tmp_path, monkeypatch, capsys)
    assert t == j and j[0] == 1


# -------------------------------------------------------- check_metrics

_JAX_CHECK = ("import sys; sys.path.insert(0, 'scripts'); "
              "import check_metrics as c; ")
_PORT_CHECK = ("import sys; "
               "from tendermint_tpu_torch.scripts import check_metrics as c; ")
_BAD = ("from {pkg} import telemetry as t; "
        "t.counter('verifier_badly_named', 'x'); "
        "t.counter('nosuchplane_x_total', 'x'); "
        "t.gauge('consensus_a_total', 'x'); t.counter('mempool_b', 'x'); ")


def _check(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code + "sys.exit(c.main())"],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=300)
    return p.returncode, p.stdout


def test_check_metrics_clean_exits_0_as_jax():
    (jrc, jout), (trc, tout) = _check(_JAX_CHECK), _check(_PORT_CHECK)
    assert jrc == trc == 0
    assert jout.startswith("check_metrics: OK (")
    assert tout.startswith("check_metrics: OK (")
    jn, tn = (int(o.split("(")[1].split()[0]) for o in (jout, tout))
    assert tn == jn + 2


def test_check_metrics_findings_equal_jax():
    jrc, jout = _check(_JAX_CHECK + _BAD.format(pkg="tendermint_tpu"))
    trc, tout = _check(_PORT_CHECK + _BAD.format(pkg="tendermint_tpu_torch"))
    assert jrc == trc == 1
    assert tout == jout
    assert jout.count("check_metrics: ") == 3
