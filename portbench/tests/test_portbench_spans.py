"""The readers of the program's own spans (portbench/metrics/_spans.py and
the eight metrics on it): their arithmetic on hand-made rings, the
window's cut at install, nothing read from an empty ring or from one
that dropped events, and, through `harness.run_once` with `--trace 1` on
the CPU at a small size, a value for each in every cell it lists."""

import json
import time
import types

import pytest
import torch

from portbench import harness
from portbench.metrics import _spans

BENCH = harness.load_benchmark(harness.ROOT.parent)
NEW = ("rows_us_per_sig", "submit_us_per_sig", "vote_check_us_per_vote",
       "vote_count_us_per_vote", "sync_wait_ms_per_window",
       "collect_ms_per_window", "save_ms_per_block", "decode_ms_per_block")


@pytest.fixture
def causal(monkeypatch):
    from tendermint_tpu_torch.telemetry import causal
    monkeypatch.delenv("TM_CUDA_TRACE", raising=False)
    yield causal
    causal.configure("off")
    causal.clear()
    causal.set_capacity(None)


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def _ctx(**stats):
    ctx = types.SimpleNamespace(window_stats=stats, state={})
    _spans.install(ctx)
    return ctx


def _put(causal, ctx, name, dur_ns, at_ns=1_000, h=-1, **args):
    """One span `at_ns` after the window's start (before it if < 0)."""
    causal.record(name, h, t0_ns=ctx.span_window[0] + at_ns, dur_ns=dur_ns,
                  **args)


def test_readers_arithmetic(causal):
    ctx = _ctx(sigs_dispatched=20_000)
    for _ in range(2):
        _put(causal, ctx, "verify.rows", 5_000_000, n=8192, outcome="hit")
        _put(causal, ctx, "verify.upload", 1_000_000, n=8192, bytes=1)
        _put(causal, ctx, "verify.launch", 3_000_000, n=8192,
             kernel="verify_pre")
    _put(causal, ctx, "votes.check", 2_000_000, h=3, n=256, type=1)
    _put(causal, ctx, "votes.check", 1_000_000, h=3, n=44, type=1)
    _put(causal, ctx, "votes.count", 9_000_000, h=3, n=250)
    for d in (10_000_000, 30_000_000):
        _put(causal, ctx, "sync.wait", d, h=1, blocks=256)
        _put(causal, ctx, "sync.collect", 2 * d, h=1, blocks=256, sigs=9)
    for d in (1_000_000, 2_000_000, 6_000_000):
        _put(causal, ctx, "sync.save", d, h=4)
        _put(causal, ctx, "block.decode", d // 2, h=4, bytes=9)
    want = {"rows_us_per_sig": 0.5, "submit_us_per_sig": 0.4,
            "vote_check_us_per_vote": 10.0, "vote_count_us_per_vote": 36.0,
            "sync_wait_ms_per_window": 20.0, "collect_ms_per_window": 40.0,
            "save_ms_per_block": 3.0, "decode_ms_per_block": 1.5}
    for name, value in want.items():
        assert _reader(name).read(ctx) == pytest.approx(value), name


def test_only_spans_that_start_in_the_window_count(causal):
    ctx = _ctx(sigs_dispatched=1_000)
    _put(causal, ctx, "verify.rows", 9_000_000, at_ns=-1, n=1_000)
    _put(causal, ctx, "sync.save", 9_000_000, at_ns=-5_000, h=1)
    assert _reader("rows_us_per_sig").read(ctx) is None
    assert _reader("save_ms_per_block").read(ctx) is None
    _put(causal, ctx, "verify.rows", 2_000_000, at_ns=0, n=1_000)
    _put(causal, ctx, "sync.save", 4_000_000, at_ns=0, h=2)
    assert _reader("rows_us_per_sig").read(ctx) == pytest.approx(2.0)
    assert _reader("save_ms_per_block").read(ctx) == pytest.approx(4.0)


def test_a_second_install_keeps_the_window(causal):
    ctx = _ctx(sigs_dispatched=10)
    start = ctx.span_window
    _put(causal, ctx, "verify.launch", 1_000, n=10, kernel="verify")
    _spans.install(ctx)              # every reader of the cell installs
    assert ctx.span_window == start
    assert _reader("submit_us_per_sig").read(ctx) == pytest.approx(0.1)


def test_nothing_from_an_empty_ring(causal):
    ctx = _ctx(sigs_dispatched=10_000, add_votes_s=1.0)
    for name in NEW:
        assert _reader(name).read(ctx) is None, name
    # no install: the plane was never read for this window
    bare = types.SimpleNamespace(window_stats={"sigs_dispatched": 1},
                                 state={})
    assert _reader("rows_us_per_sig").read(bare) is None


def test_nothing_from_a_ring_that_dropped_events(causal, monkeypatch):
    causal.set_capacity(4)
    ctx = _ctx(sigs_dispatched=100)
    for _ in range(4):
        _put(causal, ctx, "verify.rows", 1_000, n=100, outcome="hit")
        _put(causal, ctx, "sync.save", 1_000, h=1)
    assert causal.dropped() > ctx.span_window[1]
    assert _reader("rows_us_per_sig").read(ctx) is None
    assert _reader("save_ms_per_block").read(ctx) is None
    # a program without the drop count cannot show a whole window
    monkeypatch.delattr(causal, "dropped")
    ctx = _ctx(sigs_dispatched=100)
    assert ctx.span_window[1] is None
    _put(causal, ctx, "verify.rows", 1_000, n=100, outcome="hit")
    assert _reader("rows_us_per_sig").read(ctx) is None


def _small(cell):
    def hook(ctx):
        if cell == "valset10k-batch":
            ctx.config.update(validators=80, heights=2)
            ctx.traffic.update(callers=1, sample_lanes=4)
        elif cell == "valset10k-votes":
            # 64-vote messages pad to the key cache's smallest batch
            ctx.config.update(validators=72, heights=2)
            ctx.traffic.update(msg_votes=64, sample_votes=4)
        else:
            ctx.config.update(validators=4, verify_window=6)
            ctx.traffic.update(blocks=14, txs=6, warm_blocks=14,
                               forge_at=[[2, 3], [5, 6]])
    return hook


@pytest.mark.parametrize("cell", ["valset10k-batch", "valset10k-votes",
                                  "fastsync64-5ktx"])
def test_a_traced_run_reads_every_new_metric_of_its_cell(causal, cell,
                                                         monkeypatch):
    monkeypatch.setenv("TM_CUDA_COALESCE", "off")
    monkeypatch.setenv("TM_CUDA_AUTO_THRESHOLD", "4")
    code, lines, result = harness.run_once(
        harness.ROOT, BENCH, harness.cell_of(BENCH, cell), 2 ** 31 + 7,
        0.6, True, "", torch.device("cpu"), time.perf_counter(),
        ctx_hook=_small(cell))
    assert code == 0, lines
    out = json.loads(result)
    assert out["correct"], out["checks"]
    want = [m["name"] for m in BENCH["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]]
    assert want
    for name in want:
        assert out["metrics"][name]["value"] > 0, (name, out["metrics"])
