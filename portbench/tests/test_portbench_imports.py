"""The run's check of sys.modules compares top-level names whole, and a
run stops with no result when JAX or the JAX package is loaded."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness


def test_top_level_names_compare_whole():
    assert harness.forbidden_modules(["tendermint_tpu_torch.ops",
                                      "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["tendermint_tpu.ops.ed25519",
                                      "jax.numpy", "flax"]) == \
        ["flax", "jax", "tendermint_tpu"]


def test_the_benchmark_itself_loads_neither():
    assert harness.forbidden_modules() == []


def _hook(ctx):
    ctx.config.update(validators=16, heights=1)
    ctx.traffic.update(callers=1, sample_lanes=2)


def test_a_planted_jax_package_module_stops_the_run(monkeypatch):
    monkeypatch.setenv("TM_CUDA_COALESCE", "off")
    monkeypatch.setitem(sys.modules, "tendermint_tpu",
                        types.ModuleType("tendermint_tpu"))
    bench = harness.load_benchmark(harness.ROOT.parent)
    code, lines, result = harness.run_once(
        harness.ROOT, bench, harness.cell_of(bench, "valset10k-batch"),
        3, 0.3, False, "", torch.device("cpu"), time.perf_counter(),
        ctx_hook=_hook)
    assert code != 0 and result is None
    assert "tendermint_tpu" in lines[-1]


def test_the_command_never_runs_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    root = harness.ROOT.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "valset10k-batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_without_the_program_the_command_fails(tmp_path):
    root = harness.ROOT.parent
    subprocess.run(["cp", "-r", str(harness.ROOT), str(tmp_path)],
                   check=True)
    (tmp_path / "BENCHMARK.json").write_text(
        (root / "BENCHMARK.json").read_text())
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "valset10k-batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
