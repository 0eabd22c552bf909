"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.ROOT).parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer",
               "moves", "workloads"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_units_sources_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        # every cell the metric lists reports the metric it moves
        for cell in m["workloads"]:
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = harness.metrics_of(BENCH, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.metrics_of(BENCH, w["name"], "per_layer")


def test_configs_files_and_reduced_keys():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and _line(c["source"])
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert cfg["guarantees"] and _line(c["why"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    w = harness.cell_of(BENCH, cell)
    assert w["chips"] == 1 and _line(w["why"])
    assert (w["config"], w["traffic"]) and w["traffic"] == cell
    traffic = json.loads((harness.ROOT / "traffic" / f"{cell}.json")
                         .read_text())
    assert traffic["config"] == w["config"] and traffic["why"] == w["why"]
    assert traffic["chips"] == w["chips"]
    kind = harness.load_module(
        harness.ROOT / "traffic_kinds" / f"{traffic['kind']}.py", "k")
    for fn in ("setup", "window", "release", "check", "report"):
        assert callable(getattr(kind, fn))
    for m in harness.metrics_of(BENCH, cell, "per_layer"):
        mod = harness.load_module(
            harness.ROOT / "metrics" / f"{m['name']}.py", "m")
        assert callable(mod.read)


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_the_file_is_small():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
