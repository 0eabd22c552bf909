"""The metric arithmetic: rates over all the window's work, tails over
every request, the device trace's busy time, gaps and kernel time, and
readers that find nothing return nothing."""

import types

import pytest

from portbench import devtrace, harness


def _ctx(**stats):
    return types.SimpleNamespace(window_stats=stats, device_trace=None,
                                 probe=harness.Probe(), state={})


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def test_quantile_over_every_request():
    lat = [i / 100 for i in range(1, 101)]
    assert harness.quantile(lat, 0.95) == pytest.approx(0.9505)
    assert harness.quantile([], 0.95) is None
    assert _reader("batch_p95_ms").read(_ctx(latencies_s=lat)) == \
        pytest.approx(950.5)
    assert _reader("batch_p95_ms").read(_ctx()) is None


def test_per_signature_and_per_window_readers():
    c = _ctx(sigs_dispatched=20000, launches=4, hit=3, fill=1, full=0)
    c.probe.spans += [("prep", 0, 10_000_000), ("prep", 5, 10_000_005),
                      ("dispatch", 0, 1_000_000),
                      ("dispatch.resolve", 0, 3_000_000)]
    assert _reader("launches_per_ksig").read(c) == pytest.approx(0.2)
    assert _reader("prep_us_per_sig").read(c) == pytest.approx(1.0)
    assert _reader("predecomp_hit_rate").read(c) == pytest.approx(75.0)
    assert _reader("verify_ms_per_window").read(c) == pytest.approx(4.0)
    c.window_stats["add_votes_s"] = 0.008
    assert _reader("vote_verify_share").read(c) == pytest.approx(50.0)
    empty = _ctx()
    for name in ("launches_per_ksig", "prep_us_per_sig",
                 "predecomp_hit_rate", "verify_ms_per_window",
                 "vote_verify_share", "apply_ms_per_block",
                 "verify_roofline.valset", "device_idle.sync"):
        assert _reader(name).read(empty) is None


def test_device_trace_summary():
    ev = [("ladder_kernel<false>", 10, 30), ("Memcpy HtoD", 25, 40),
          ("ladder_kernel<false>", 60, 70), ("late", 200, 300)]
    spans = [("prep", 0, 100), ("rows", 40, 60)]
    s = devtrace.summary(ev, 0, 100, spans)
    assert s["busy_s"] == pytest.approx(40e-9)       # 10-40 and 60-70
    assert s["kernel_s"] == pytest.approx(30e-9)     # copies left out
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["device_ops"][0][0] == "ladder_kernel<false>"
    # gaps 0-10, 40-60 (inside rows), 70-100: the longest first
    assert [g[0] for g in s["idle_gaps"]] == ["prep", "rows", "prep"]
    c = _ctx(sigs_dispatched=10000, launches=2)
    c.device_trace = s
    assert _reader("device_idle.valset").read(c) == pytest.approx(60.0)
    assert _reader("verify_roofline.valset").read(c) > 0


def test_rate_counts_only_work_done_inside_the_window(monkeypatch):
    from portbench.traffic_kinds import batch
    ctx = types.SimpleNamespace(
        traffic={"callers": 1, "in_flight": 2, "forge_every": 10 ** 9,
                 "forge_offset": 1},
        config={"validators": 4}, seed=1, state={}, window_stats={})
    clock = iter([0.0] + [0.1 * i for i in range(1, 400)])
    monkeypatch.setattr(batch.time, "perf_counter", lambda: next(clock))

    class V:
        def verify_async(self, items):
            return lambda: [True] * len(items)

    ctx.state.update(items=[[(b"", b"", b"")] * 4], verifier=V())
    monkeypatch.setattr(batch.common, "counters",
                        lambda: {"launches": 0, "hit": 0, "fill": 0,
                                 "full": 0})
    batch.window(ctx, 1.0)
    s = ctx.window_stats
    done_in = sum(1 for d in ctx.state["done"] if d[2] <= 1.0)
    assert s["sigs_per_s"] == pytest.approx(done_in * 4 / 1.0)
    assert s["attempted"] == len(ctx.state["done"]) > done_in
    assert len(s["latencies_s"]) == s["attempted"]
